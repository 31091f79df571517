// Orientation kernel: per live keypoint, the 36-bin Gaussian-weighted
// gradient-orientation histogram of its raw pyramid window.
//
// Replaces the TPU kernel sift_tpu/kernels/fused_stages.py
// (orientation_hist_fused / _ori_kernel / _ori_group).
//
// Bound on the H100: operations, at a very low level of either - a live
// keypoint reads about (2r+3)^2 pixels of a slab that sits in L2 (a few
// MB at 752x480) and spends ~60 float operations per pixel (square root,
// polynomial atan2, two exp), so a frame's few thousand keypoints are
// some 10^8 operations and the launch itself is a visible share of the
// time.  What the design does about it: the work is made proportional to
// the frame, not to the capacity.  One 64-thread block per keypoint slot;
// a block past the live count (read from device memory, no host sync)
// zeroes its row and returns; threads stride over only the pixels inside the
// keypoint's OWN radius and image bounds, not the static window; bins
// are per-warp private in shared memory (shared atomicAdd), reduced in a
// fixed order at the end.  f32 accumulation throughout.
//
// Window contract (same as the TPU kernel's, so both can be fed the same
// arrays): pixel (i, p) of keypoint k is slab[ys0[k]+i, xs0[k]+p],
// offy = par[k,0]+i, offx = par[k,1]+p.  Origins need no alignment.
#include "common.cuh"

#define ORI_BINS 36
#define ORI_THREADS 64
#define ORI_WARPS (ORI_THREADS / 32)

__global__ void __launch_bounds__(ORI_THREADS)
orientation_hist_kernel(const float* __restrict__ slab, int hs, int ws,
                        const int* __restrict__ ys0,
                        const int* __restrict__ xs0,
                        const float* __restrict__ par, int npar,
                        const DevInt count, const DevInt start,
                        float* __restrict__ out, int K, int rows,
                        int lanes) {
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  float* orow = out + (size_t)k * ORI_BINS;
  int lo, hi;
  live_rows(count, start, K, &lo, &hi);
  if (k < lo || k >= hi) {  // count gating: the row is zero
    if (tid < ORI_BINS) orow[tid] = 0.0f;
    return;
  }

  __shared__ float bins[ORI_WARPS][ORI_BINS];
  const KpWindow kw = load_window(par + (size_t)k * npar, rows, lanes);
  if (!(kw.vld > 0.0f)) {
    if (tid < ORI_BINS) orow[tid] = 0.0f;
    return;
  }
  for (int b = tid; b < ORI_WARPS * ORI_BINS; b += ORI_THREADS)
    (&bins[0][0])[b] = 0.0f;
  __syncthreads();

  const int nrow = kw.i_hi - kw.i_lo + 1;
  const int ncol = kw.p_hi - kw.p_lo + 1;
  if (nrow > 0 && ncol > 0) {
    // Origins clamped into the slab, so no read can leave it.
    const int y0 = min(max(ys0[k], 0), hs - rows);
    const int x0 = min(max(xs0[k], 0), ws - lanes);
    const float* base = slab + (size_t)y0 * ws + x0;
    float* wbins = bins[tid >> 5];
    const int total = nrow * ncol;
    for (int t = tid; t < total; t += ORI_THREADS) {
      const int i = kw.i_lo + t / ncol;
      const int p = kw.p_lo + t % ncol;
      const float offy = kw.dy0 + (float)i;
      const float offx = kw.dx0 + (float)p;
      const bool my = (offy >= kw.ylo) && (offy <= kw.yhi) &&
                      (fabsf(offy) <= kw.rad);
      const bool mx = (offx >= kw.xlo) && (offx <= kw.xhi) &&
                      (fabsf(offx) <= kw.rad);
      if (!(my && mx)) continue;
      const float* v = base + (size_t)i * ws + p;
      const float dx = v[1] - v[-1];
      const float dy = v[-ws] - v[ws];
      const float mag = sqrtf(dx * dx + dy * dy);
      const float ori = atan2_deg(dy, dx);
      const float wy = expf(offy * offy * kw.es);
      const float wx = expf(offx * offx * kw.es) * kw.vld;
      const float contrib = mag * wy * wx;
      // bin = round-half-even(ori * 36/360), wrapped into [0, 36).
      float b = rintf(ori * F(36.0 / 360.0));
      b = b >= (float)ORI_BINS ? b - (float)ORI_BINS : b;
      b = b < 0.0f ? b + (float)ORI_BINS : b;
      atomicAdd(&wbins[(int)b], contrib);
    }
  }
  __syncthreads();
  if (tid < ORI_BINS) {
    float s = bins[0][tid];
#pragma unroll
    for (int wi = 1; wi < ORI_WARPS; ++wi) s += bins[wi][tid];
    orow[tid] = s;
  }
}

// slab: [hs, ws] f32; ys0/xs0: [K] i32 window origins, clamped here to
// [0, hs - rows] x [0, ws - lanes]; par: [K, npar] f32; count / start:
// each a value (bytes 0) or an int32 / int64 on the card (bytes 4 / 8 at
// ptr); out: [K, 36] f32, rows outside [start, start + count) written 0.
// Launches on ``stream``, does not synchronise; returns
// cudaGetLastError().
SIFT_API int sift_orientation_hist(const void* slab, int hs, int ws,
                                   const void* ys0, const void* xs0,
                                   const void* par, int npar,
                                   const void* count_ptr, int count_bytes,
                                   long long count_val,
                                   const void* start_ptr, int start_bytes,
                                   long long start_val, void* out, int K,
                                   int rows, int lanes, void* stream) {
  if (K <= 0) return 0;
  const DevInt count = {count_ptr, count_bytes, count_val};
  const DevInt start = {start_ptr, start_bytes, start_val};
  orientation_hist_kernel<<<K, ORI_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)slab, hs, ws, (const int*)ys0, (const int*)xs0,
      (const float*)par, npar, count, start, (float*)out, K, rows, lanes);
  return (int)cudaGetLastError();
}
