// Descriptor kernel: per live keypoint, the rotated 4x4 spatial x 8
// orientation trilinear histogram of Gaussian-weighted gradient
// magnitudes over its raw pyramid window (raw [128], cell-major r, c, o).
//
// Replaces the TPU kernel sift_tpu/kernels/fused_stages.py
// (descriptor_fused / _desc_kernel / _desc_group).
//
// Bound on the H100: operations.  A keypoint of radius r covers up to
// (2r+1)^2 pixels (r up to 38: ~5900).  The function needs ~22 float
// operations to place a pixel in the rotated grid and ~106 more for one
// inside it (gradient 6, polynomial atan2 32, weights 9, orientation bin
// 6, three floors, 2+2+2 hat functions 30, 4 row x column products, 8
// products and 8 accumulations), all read from an L2-resident slab,
// against 512 bytes written: hundreds of operations per byte of
// device-memory traffic.  What the design does
// about it: work follows the frame's live keypoints and their actual
// radii.  One 128-thread block per keypoint slot; blocks outside
// [start, start + count) (read from device memory, no host sync) return
// at once; threads stride over the keypoint's own bounding square only
// and drop pixels outside the rotated 4x4 grid before any transcendental;
// of the 128 hat-function products the TPU kernel evaluates per pixel
// only the <= 8 non-zero ones (2 rows x 2 cols x 2 orientation bins) are
// formed, with the TPU kernel's own expressions; bins are per-warp
// private in shared memory (shared atomicAdd) and reduced in a fixed
// order.  f32 accumulation throughout.  One launch covers every radius:
// the TPU kernel's radius classes exist for its lane packing only.
//
// Window contract: as in orientation_hist.cu.
#include "common.cuh"

#define DESC_D 4
#define DESC_NB 8
#define DESC_LEN (DESC_D * DESC_D * DESC_NB)
#define DESC_THREADS 128
#define DESC_WARPS (DESC_THREADS / 32)

__global__ void __launch_bounds__(DESC_THREADS)
descriptor_hist_kernel(const float* __restrict__ slab, int ws,
                       const int* __restrict__ ys0,
                       const int* __restrict__ xs0,
                       const float* __restrict__ par, int npar,
                       const int* __restrict__ cnt,
                       float* __restrict__ out, int rows, int lanes) {
  const int k = blockIdx.x;
  const int count = cnt[0], start = cnt[1];
  if (k < start || k >= start + count) return;  // count gating

  __shared__ float bins[DESC_WARPS][DESC_LEN];
  const int tid = threadIdx.x;
  const float* pk = par + (size_t)k * npar;
  const KpWindow kw = load_window(pk, rows, lanes);
  float* orow = out + (size_t)k * DESC_LEN;
  if (!(kw.vld > 0.0f)) {
    orow[tid] = 0.0f;
    return;
  }
  const float cos_t = pk[9], sin_t = pk[10], ang = pk[11];
  for (int b = tid; b < DESC_WARPS * DESC_LEN; b += DESC_THREADS)
    (&bins[0][0])[b] = 0.0f;
  __syncthreads();

  const int nrow = kw.i_hi - kw.i_lo + 1;
  const int ncol = kw.p_hi - kw.p_lo + 1;
  if (nrow > 0 && ncol > 0) {
    const float* base = slab + (size_t)ys0[k] * ws + xs0[k];
    float* wbins = bins[tid >> 5];
    const int total = nrow * ncol;
    for (int t = tid; t < total; t += DESC_THREADS) {
      const int i = kw.i_lo + t / ncol;
      const int p = kw.p_lo + t % ncol;
      const float offy = kw.dy0 + (float)i;
      const float offx = kw.dx0 + (float)p;
      const bool my = (offy >= kw.ylo) && (offy <= kw.yhi) &&
                      (fabsf(offy) <= kw.rad);
      const bool mx = (offx >= kw.xlo) && (offx <= kw.xhi) &&
                      (fabsf(offx) <= kw.rad);
      if (!(my && mx)) continue;
      const float c_rot = offx * cos_t - offy * sin_t;
      const float r_rot = offx * sin_t + offy * cos_t;
      const float rbin = r_rot + F(DESC_D / 2.0 - 0.5);
      const float cbin = c_rot + F(DESC_D / 2.0 - 0.5);
      if (!((rbin > -1.0f) && (rbin < (float)DESC_D) && (cbin > -1.0f) &&
            (cbin < (float)DESC_D)))
        continue;

      const float* v = base + (size_t)i * ws + p;
      const float dx = v[1] - v[-1];
      const float dy = v[-ws] - v[ws];
      const float mag = sqrtf(dx * dx + dy * dy);
      const float ori = atan2_deg(dy, dx);  // [-180, 180]
      const float wy = expf(offy * offy * kw.es);
      const float wx = expf(offx * offx * kw.es) * kw.vld;
      const float mag_w = mag * (wy * wx);

      // Orientation bin in [0, 8]: the subtraction can round up to 8.0,
      // which the circular hat below folds onto bin 0.
      float ob = (ori - ang) * F(DESC_NB / 360.0);
      ob = ob - floorf(ob * F(1.0 / DESC_NB)) * (float)DESC_NB;

      const int r0 = (int)floorf(rbin);
      const int c0 = (int)floorf(cbin);
      const int o0 = (int)floorf(ob);
#pragma unroll
      for (int dr = 0; dr < 2; ++dr) {
        const int r = r0 + dr;
        if (r < 0 || r >= DESC_D) continue;
        const float hr = fmaxf(0.0f, 1.0f - fabsf(rbin - (float)r));
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) {
          const int c = c0 + dc;
          if (c < 0 || c >= DESC_D) continue;
          const float hc = fmaxf(0.0f, 1.0f - fabsf(cbin - (float)c));
          const float hrc = hr * hc;
#pragma unroll
          for (int dd = 0; dd < 2; ++dd) {
            const int o = ((o0 + dd) % DESC_NB + DESC_NB) % DESC_NB;
            const float od = fabsf(ob - (float)o);
            const float vo =
                fmaxf(0.0f, 1.0f - fminf(od, (float)DESC_NB - od)) * mag_w;
            atomicAdd(&wbins[(r * DESC_D + c) * DESC_NB + o], hrc * vo);
          }
        }
      }
    }
  }
  __syncthreads();
  float s = bins[0][tid];
#pragma unroll
  for (int wi = 1; wi < DESC_WARPS; ++wi) s += bins[wi][tid];
  orow[tid] = s;
}

// Arguments as sift_orientation_hist (par additionally carries cos_t,
// sin_t, ang in columns 9..11); out: [K, 128] f32.
SIFT_API int sift_descriptor_hist(const void* slab, int ws,
                                  const void* ys0, const void* xs0,
                                  const void* par, int npar,
                                  const void* cnt, void* out, int K,
                                  int rows, int lanes, void* stream) {
  if (K <= 0) return 0;
  descriptor_hist_kernel<<<K, DESC_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)slab, ws, (const int*)ys0, (const int*)xs0,
      (const float*)par, npar, (const int*)cnt, (float*)out, rows, lanes);
  return (int)cudaGetLastError();
}
