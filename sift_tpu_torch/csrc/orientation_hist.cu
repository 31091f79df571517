// Orientation kernel: per live keypoint, the 36-bin Gaussian-weighted
// gradient-orientation histogram of its raw pyramid window.
//
// Replaces the TPU kernel sift_tpu/kernels/fused_stages.py
// (orientation_hist_fused / _ori_kernel / _ori_group).
//
// Bound on the H100: bytes and operations are both tiny - a live keypoint
// reads its (nrow+2) x (ncol+2) patch (at most 35 x 35 at the default
// radius bound of 16) of a slab that sits in L2 and spends ~60 float
// operations per pixel (square root, polynomial atan2, a division), so a
// frame's ~900 keypoints are some 3 * 10^7 operations: far too little work
// to fill the card.  What decides the time is the longest block's chain of
// keypoints, and inside it the pixel loop's ~110 instructions per pixel
// (IEEE square root and division with their slow-path branches, which also
// keep the compiler from interleaving two pixels) plus each keypoint's
// fixed costs: staging its patch, zeroing and reducing its bins.
//
// What the design does about it:
//  * A persistent grid (the blocks the card holds at once, at most K) walks
//    the live rows start + blockIdx.x + j * gridDim.x; the same blocks
//    write zeros to every row outside [start, start + count).  count and
//    start are read from device memory, so nothing synchronises with the
//    host, and window origins are clamped as they are loaded.  The next
//    keypoint's parameter row and origin are loaded one keypoint ahead.
//  * Each keypoint's patch (its masked pixels plus the 1-px gradient halo)
//    is staged in shared memory once, with 4-byte cp.async, so every slab
//    value is read from L2 once instead of four times and the gradient taps
//    come from shared memory.  One buffer: the next patch loads while this
//    keypoint's bins are reduced (a second buffer, loading during the
//    pixel loop, costs the SM four blocks and was slower).  A patch larger
//    than the buffer (only out of contract: radius above the window's) is
//    staged in chunks of rows, each with its own halo.
//  * No atomics.  Each of the 64 threads accumulates into its OWN column of
//    the 36 bins (bins[b][t]: thread t always hits bank t % 32, whatever
//    bins its pixels choose), and a fixed-order reduction (per warp, skewed
//    so the 32 readers hit 32 banks; then the warps in order) makes the
//    output bit-reproducible from run to run.  64 threads per keypoint
//    keep the per-keypoint zeroing and reduction small against its pixels
//    and let 14 blocks share an SM.
//  * No transcendental in the pixel loop: per patch the block fills a row
//    table wy[i] = expf(offy^2 * es) and a column table wx[p] =
//    expf(offx^2 * es) * valid (the same expressions as before, so the
//    weights are bit-identical), -1 where the image-bounds / radius masks
//    drop the row or column; contrib = mag * wy * wx keeps its order.
//  * The block's threads stride over the patch's pixels in row-major order,
//    so every lane works however narrow the patch; the pixel's row comes
//    from a float reciprocal (exact for these sizes), not an integer
//    division.
// f32 accumulation; built with -fmad=false.
//
// Window contract (same as the TPU kernel's, so both can be fed the same
// arrays): pixel (i, p) of keypoint k is slab[ys0[k]+i, xs0[k]+p],
// offy = par[k,0]+i, offx = par[k,1]+p.  Origins need no alignment.
#include "common.cuh"

#define ORI_BINS 36
#define ORI_NT 64
#define ORI_WARPS (ORI_NT / 32)
// Floats of the patch buffer: a 35 x 35 patch (radius 16 plus halo) fits.
#define ORI_PATCH_CAP 1296
static_assert(ORI_NT % 32 == 0 && ORI_NT >= ORI_BINS, "block size");

// Dynamic shared memory: bins [36][NT], the patch [CAP], the row table
// [rows], the column table [lanes], warp partials [WARPS][36] - all f32.
// kernels/fused_stages.orientation_smem_bytes is the same formula.
static size_t ori_smem_bytes(int rows, int lanes) {
  return 4 * ((size_t)ORI_BINS * ORI_NT + ORI_PATCH_CAP + rows + lanes +
              ORI_WARPS * ORI_BINS);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floor(t / n) for 0 <= t < 2^22, n >= 1 from n's float reciprocal:
// (t + 0.5) / n is at least 0.5 / n away from an integer, more than the two
// roundings' relative error of 2^-23 can move it.
__device__ __forceinline__ int div_small(int t, float inv_n) {
  return (int)(((float)t + 0.5f) * inv_n);
}

// A keypoint's parameter-row head and window origin, loaded one keypoint
// ahead so that their latency hides behind the current patch.
struct KpRaw {
  float p[9];
  int y, x;
};

__device__ __forceinline__ KpRaw load_raw(const float* par, int npar,
                                          const int* ys0, const int* xs0,
                                          int k) {
  KpRaw r;
  const float* pk = par + (size_t)k * npar;
#pragma unroll
  for (int j = 0; j < 9; ++j) r.p[j] = pk[j];
  r.y = ys0[k];
  r.x = xs0[k];
  return r;
}

// One unit of a block's work: a chunk of interior rows [r0, r0 + nr) of
// keypoint k's window (nr = 0: nothing to count, the row comes out zero).
struct OriItem {
  int k;  // < 0: past the block's last keypoint
  KpWindow kw;
  int y0, x0;  // the window origin, clamped into the slab
  int r0, nr, ncol;
  int chunk, nchunks;
};

__device__ __forceinline__ void ori_chunk(OriItem* it, int chunk) {
  it->chunk = chunk;
  const int nrow = it->kw.i_hi - it->kw.i_lo + 1;
  it->ncol = it->kw.p_hi - it->kw.p_lo + 1;
  if (!(it->kw.vld > 0.0f) || nrow <= 0 || it->ncol <= 0) {
    it->r0 = 0;
    it->nr = it->ncol = 0;
    it->nchunks = 1;
    return;
  }
  const int per = ORI_PATCH_CAP / (it->ncol + 2) - 2;  // >= 1: lanes <= 432
  it->nchunks = (nrow + per - 1) / per;
  it->r0 = it->kw.i_lo + chunk * per;
  it->nr = min(per, it->kw.i_hi - it->r0 + 1);
}

__device__ __forceinline__ OriItem ori_item(const KpRaw& raw, int k, int hs,
                                            int ws, int rows, int lanes) {
  OriItem it;
  it.k = k;
  it.kw = load_window(raw.p, rows, lanes);
  // Origins clamped into the slab, so no read can leave it.
  it.y0 = min(max(raw.y, 0), hs - rows);
  it.x0 = min(max(raw.x, 0), ws - lanes);
  ori_chunk(&it, 0);
  return it;
}

// Pixel t of the current chunk: false where a mask drops it, else its
// weighted magnitude and its bin.
__device__ __forceinline__ bool ori_pixel(const float* pt, const float* wy,
                                          const float* wx, int t, float inv,
                                          int ncol, float* contrib,
                                          int* bin) {
  const int r = div_small(t, inv), c = t - r * ncol;
  const float wyv = wy[r], wxv = wx[c];
  if (wyv < 0.0f || wxv < 0.0f) return false;  // masked row or column
  const int pcol = ncol + 2;
  const float* v = pt + (r + 1) * pcol + (c + 1);
  const float dx = v[1] - v[-1];
  const float dy = v[-pcol] - v[pcol];
  const float mag = sqrtf(dx * dx + dy * dy);
  const float ori = atan2_deg(dy, dx);
  *contrib = mag * wyv * wxv;
  // bin = round-half-even(ori * 36/360), wrapped into [0, 36).
  float b = rintf(ori * F(36.0 / 360.0));
  b = b >= (float)ORI_BINS ? b - (float)ORI_BINS : b;
  b = b < 0.0f ? b + (float)ORI_BINS : b;
  *bin = (int)b;
  return true;
}

__global__ void __launch_bounds__(ORI_NT)
orientation_hist_kernel(const float* __restrict__ slab, int hs, int ws,
                        const int* __restrict__ ys0,
                        const int* __restrict__ xs0,
                        const float* __restrict__ par, int npar,
                        const DevInt count, const DevInt start,
                        float* __restrict__ out, int K, int rows,
                        int lanes) {
  extern __shared__ float smem[];
  float* bins = smem;                             // [36][NT]
  float* patch = bins + ORI_BINS * ORI_NT;        // [CAP]
  float* wy = patch + ORI_PATCH_CAP;              // [rows]
  float* wx = wy + rows;                          // [lanes]
  float* part = wx + lanes;                       // [WARPS][36]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo, hi;
  live_rows(count, start, K, &lo, &hi);

  // Rows outside [lo, hi) are zero: spread over the whole grid.
  {
    const size_t step = (size_t)gridDim.x * ORI_NT;
    const size_t a = (size_t)lo * ORI_BINS, b = (size_t)hi * ORI_BINS;
    const size_t n = (size_t)K * ORI_BINS;
    for (size_t e = (size_t)blockIdx.x * ORI_NT + tid; e < a; e += step)
      out[e] = 0.0f;
    for (size_t e = b + (size_t)blockIdx.x * ORI_NT + tid; e < n; e += step)
      out[e] = 0.0f;
  }

  // Queue item ``it``'s patch and fill its weight tables.
  auto stage = [&](const OriItem& it) {
    if (it.k < 0 || it.nr == 0) return;
    const KpWindow& kw = it.kw;
    const float* src = slab + (size_t)(it.y0 + it.r0 - 1) * ws +
                       (it.x0 + kw.p_lo - 1);
    const int pcol = it.ncol + 2, n = (it.nr + 2) * pcol;
    const float inv = 1.0f / (float)pcol;
    for (int e = tid; e < n; e += ORI_NT) {
      const int a = div_small(e, inv);
      cp_async4(patch + e, src + (size_t)a * ws + (e - a * pcol));
    }
    for (int r = tid; r < it.nr; r += ORI_NT) {
      const float offy = kw.dy0 + (float)(it.r0 + r);
      const bool my = (offy >= kw.ylo) && (offy <= kw.yhi) &&
                      (fabsf(offy) <= kw.rad);
      wy[r] = my ? expf(offy * offy * kw.es) : -1.0f;
    }
    for (int c = tid; c < it.ncol; c += ORI_NT) {
      const float offx = kw.dx0 + (float)(kw.p_lo + c);
      const bool mx = (offx >= kw.xlo) && (offx <= kw.xhi) &&
                      (fabsf(offx) <= kw.rad);
      wx[c] = mx ? expf(offx * offx * kw.es) * kw.vld : -1.0f;
    }
  };

  const int g = gridDim.x;
  int k = lo + blockIdx.x;
  OriItem cur;
  cur.k = -1;
  if (k < hi) cur = ori_item(load_raw(par, npar, ys0, xs0, k), k, hs, ws,
                             rows, lanes);
  KpRaw ahead;  // the block's next keypoint's, while k + g < hi
  if (k + g < hi) ahead = load_raw(par, npar, ys0, xs0, k + g);
  stage(cur);
  cp_async_commit();
  float* col = bins + tid;  // this thread's bins: bin b at col[b * NT]
  while (cur.k >= 0) {
    OriItem nx = cur;
    if (cur.chunk + 1 < cur.nchunks) {
      ori_chunk(&nx, cur.chunk + 1);
    } else if (cur.k + g < hi) {
      nx = ori_item(ahead, cur.k + g, hs, ws, rows, lanes);
      if (cur.k + 2 * g < hi)
        ahead = load_raw(par, npar, ys0, xs0, cur.k + 2 * g);
    } else {
      nx.k = -1;
    }
    cp_async_wait_all();  // this item's patch has landed (this thread's part)
    __syncthreads();      // ... and every thread's, tables included
    if (cur.chunk == 0) {
#pragma unroll
      for (int b = 0; b < ORI_BINS; ++b) col[b * ORI_NT] = 0.0f;
    }
    const int n = cur.nr * cur.ncol;
    const float inv = 1.0f / (float)(cur.ncol > 0 ? cur.ncol : 1);
    for (int t = tid; t < n; t += ORI_NT) {
      float contrib;
      int b;
      if (ori_pixel(patch, wy, wx, t, inv, cur.ncol, &contrib, &b))
        col[b * ORI_NT] += contrib;
    }
    __syncthreads();  // the patch is free, every bin column written
    stage(nx);  // the next patch loads while this keypoint's bins are reduced
    cp_async_commit();
    if (cur.chunk + 1 == cur.nchunks) {
      // Lane l of warp w sums bins l and (l < 4) 32 + l over the warp's 32
      // columns, starting at column l so the 32 lanes hit 32 banks; then
      // bin b is the warps' sums in warp order.
      const float* seg = bins + warp * 32;
      const bool two = lane < ORI_BINS - 32;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        s0 += seg[lane * ORI_NT + c];
        if (two) s1 += seg[(32 + lane) * ORI_NT + c];
      }
      part[warp * ORI_BINS + lane] = s0;
      if (two) part[warp * ORI_BINS + 32 + lane] = s1;
      __syncthreads();
      if (tid < ORI_BINS) {
        float sum = part[tid];
#pragma unroll
        for (int w = 1; w < ORI_WARPS; ++w) sum += part[w * ORI_BINS + tid];
        out[(size_t)cur.k * ORI_BINS + tid] = sum;
      }
    }
    cur = nx;
  }
}

// Shared memory (bytes) and grid of a launch at this window shape: the
// blocks the card holds at once, at most K.  Launch geometry per device,
// kept for the last shared-memory size.  Returns a cudaError_t.
static int ori_geometry(int rows, int lanes, int K, size_t* smem,
                        int* grid) {
  static size_t cached_smem[64];
  static int cached_grid[64];
  *smem = ori_smem_bytes(rows, lanes);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (*smem != cached_smem[dev]) {
    e = cudaFuncSetAttribute(orientation_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, orientation_hist_kernel, ORI_NT, *smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_smem[dev] = *smem;
    cached_grid[dev] = sms * per_sm;
  }
  *grid = cached_grid[dev] < K ? cached_grid[dev] : K;
  return 0;
}

// The launch geometry sift_orientation_hist would use on the current
// device: shared memory per block (bytes) and the grid.
SIFT_API int sift_orientation_hist_geometry(int rows, int lanes, int K,
                                            long long* smem, int* grid) {
  size_t s = 0;
  const int e = ori_geometry(rows, lanes, K, &s, grid);
  *smem = (long long)s;
  return e;
}

// slab: [hs, ws] f32; ys0/xs0: [K] i32 window origins, clamped here to
// [0, hs - rows] x [0, ws - lanes]; par: [K, npar] f32; count / start:
// each a value (bytes 0) or an int32 / int64 on the card (bytes 4 / 8 at
// ptr); out: [K, 36] f32, rows outside [start, start + count) written 0.
// lanes <= 432 (a patch chunk holds at least one row).  Launches on
// ``stream``, does not synchronise; returns cudaGetLastError().
SIFT_API int sift_orientation_hist(const void* slab, int hs, int ws,
                                   const void* ys0, const void* xs0,
                                   const void* par, int npar,
                                   const void* count_ptr, int count_bytes,
                                   long long count_val,
                                   const void* start_ptr, int start_bytes,
                                   long long start_val, void* out, int K,
                                   int rows, int lanes, void* stream) {
  if (K <= 0) return 0;
  if (3 * lanes > ORI_PATCH_CAP) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int grid = 0;
  const int e = ori_geometry(rows, lanes, K, &smem, &grid);
  if (e) return e;
  const DevInt count = {count_ptr, count_bytes, count_val};
  const DevInt start = {start_ptr, start_bytes, start_val};
  orientation_hist_kernel<<<grid, ORI_NT, smem, (cudaStream_t)stream>>>(
      (const float*)slab, hs, ws, (const int*)ys0, (const int*)xs0,
      (const float*)par, npar, count, start, (float*)out, K, rows, lanes);
  return (int)cudaGetLastError();
}
