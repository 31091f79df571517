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
// device-memory traffic.  At a frame's ~1000 live keypoints that is far
// too little work to fill the card, so what decides the time is how long
// the largest keypoints take and what each pixel waits on.
//
// What the design does about it:
//  * No atomics.  Each thread accumulates into its OWN column of the 128
//    bins in shared memory, laid out bin-major, thread-fastest
//    (bins[b][t]), so thread t always hits bank t % 32 whatever bins its
//    pixels choose: no conflicts and no serialised adds.  A 129th row is a
//    sink for the hat taps that fall outside the 4x4 grid, so a pixel's 8
//    read-modify-writes go to 8 distinct addresses and are issued as 8
//    loads, then 8 stores.
//  * Deterministic: thread b sums bin b over the threads in a fixed order
//    (skewed by b so the 32 readers of a warp hit 32 banks), so the output
//    is bit-reproducible from run to run.
//  * No transcendental or division in the pixel loop: per keypoint the
//    block fills a row table wy[i] and a column table wx[p] * valid (zero
//    where the image-bounds / radius masks drop the row or column; the
//    same expf arguments as the TPU kernel, so bit-identical weights), and
//    per row the range of columns that can fall inside the rotated 4x4
//    grid (+-1 px, the exact test stays in the loop).  Rows are strided
//    by warp, columns by lane: coalesced loads, and lanes do not idle on
//    the half of the bounding square outside the grid.  Each lane issues
//    the four neighbour loads of its next pixel before it works on the
//    current one: with 12 warps per SM (the bins' shared memory caps it)
//    the pixel loop waits on latency, L2 latency above all.
//  * A persistent grid (blocks resident on every SM) walks the live rows
//    start + blockIdx.x + j * gridDim.x; count and start are read from
//    device memory, so nothing synchronises with the host.  The same
//    blocks write zeros to every row outside [start, start + count), and
//    clamp window origins as they load them.
//  * f32 accumulation; built with -fmad=false.  No TF32 or tensor cores:
//    the sparse form forms at most 8 products per pixel, where the dense
//    [16, P] x [P, 8] product of the plain version needs 128, and TF32
//    would need a 3-pass split to keep f32 results.
// Of the 128 hat-function products the TPU kernel evaluates per pixel
// only the <= 8 non-zero ones (2 rows x 2 cols x 2 orientation bins) are
// formed, with the TPU kernel's own expressions.  One launch covers every
// radius: the TPU kernel's radius classes exist for its lane packing only.
//
// Window contract: as in orientation_hist.cu.
#include "common.cuh"

#define DESC_D 4
#define DESC_NB 8
#define DESC_LEN (DESC_D * DESC_D * DESC_NB)
#define DESC_NT 128
#define DESC_WARPS (DESC_NT / 32)

// Dynamic shared memory: bins [DESC_LEN + 1][DESC_NT] f32 (the last row is
// the sink), wy [rows] f32, wx [lanes] f32, column ranges [rows] int2.
static size_t desc_smem_bytes(int rows, int lanes) {
  size_t f = (size_t)(DESC_LEN + 1) * DESC_NT + rows + lanes;
  f += f & 1;  // int2 alignment
  return f * 4 + (size_t)rows * 8;
}

__global__ void __launch_bounds__(DESC_NT)
descriptor_hist_kernel(const float* __restrict__ slab, int hs, int ws,
                       const int* __restrict__ ys0,
                       const int* __restrict__ xs0,
                       const float* __restrict__ par, int npar,
                       const DevInt count, const DevInt start,
                       float* __restrict__ out, int K, int rows, int lanes) {
  extern __shared__ float smem[];
  float* bins = smem;
  float* wyt = bins + (DESC_LEN + 1) * DESC_NT;
  float* wxt = wyt + rows;
  const size_t nf = (size_t)(DESC_LEN + 1) * DESC_NT + rows + lanes;
  int2* crng = (int2*)(smem + nf + (nf & 1));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo, hi;
  live_rows(count, start, K, &lo, &hi);

  // Rows outside [lo, hi) are zero: spread over the whole grid.
  {
    const size_t step = (size_t)gridDim.x * DESC_NT;
    const size_t a = (size_t)lo * DESC_LEN, b = (size_t)hi * DESC_LEN;
    const size_t n = (size_t)K * DESC_LEN;
    for (size_t e = (size_t)blockIdx.x * DESC_NT + tid; e < a; e += step)
      out[e] = 0.0f;
    for (size_t e = b + (size_t)blockIdx.x * DESC_NT + tid; e < n; e += step)
      out[e] = 0.0f;
  }

  float* col = bins + tid;  // this thread's bins: bin b at col[b * DESC_NT]
  for (int k = lo + blockIdx.x; k < hi; k += gridDim.x) {
    const float* pk = par + (size_t)k * npar;
    const KpWindow kw = load_window(pk, rows, lanes);
    float* orow = out + (size_t)k * DESC_LEN;
    if (!(kw.vld > 0.0f)) {  // the same for the whole block
      for (int b = tid; b < DESC_LEN; b += DESC_NT) orow[b] = 0.0f;
      continue;
    }
    const float cos_t = pk[9], sin_t = pk[10], ang = pk[11];

#pragma unroll 8
    for (int b = 0; b < DESC_LEN; ++b) col[b * DESC_NT] = 0.0f;
    for (int i = tid; i < rows; i += DESC_NT) {
      const float offy = kw.dy0 + (float)i;
      const bool my = (offy >= kw.ylo) && (offy <= kw.yhi) &&
                      (fabsf(offy) <= kw.rad);
      wyt[i] = my ? expf(offy * offy * kw.es) : 0.0f;
      // Columns whose pixel can land inside the rotated grid:
      // |offx*cos_t - offy*sin_t| < 2.5 and |offx*sin_t + offy*cos_t| <
      // 2.5, solved for offx with a pixel of margin on each side.
      float ulo = -INFINITY, uhi = INFINITY;
      const float half = F(DESC_D / 2.0 + 0.5);
      if (fabsf(cos_t) > F(1e-6)) {
        const float u0 = (offy * sin_t - half) / cos_t;
        const float u1 = (offy * sin_t + half) / cos_t;
        ulo = fmaxf(ulo, fminf(u0, u1));
        uhi = fminf(uhi, fmaxf(u0, u1));
      }
      if (fabsf(sin_t) > F(1e-6)) {
        const float u0 = (-offy * cos_t - half) / sin_t;
        const float u1 = (-offy * cos_t + half) / sin_t;
        ulo = fmaxf(ulo, fminf(u0, u1));
        uhi = fminf(uhi, fmaxf(u0, u1));
      }
      const float plo = fminf(fmaxf(floorf(ulo - kw.dx0) - 1.0f,
                                    (float)kw.p_lo), (float)lanes);
      const float phi = fmaxf(fminf(ceilf(uhi - kw.dx0) + 1.0f,
                                    (float)kw.p_hi), -1.0f);
      crng[i] = make_int2((int)plo, (int)phi);
    }
    for (int p = tid; p < lanes; p += DESC_NT) {
      const float offx = kw.dx0 + (float)p;
      const bool mx = (offx >= kw.xlo) && (offx <= kw.xhi) &&
                      (fabsf(offx) <= kw.rad);
      wxt[p] = mx ? expf(offx * offx * kw.es) * kw.vld : 0.0f;
    }
    __syncthreads();

    const int y0 = min(max(ys0[k], 0), hs - rows);
    const int x0 = min(max(xs0[k], 0), ws - lanes);
    const float* base = slab + (size_t)y0 * ws + x0;
    // Each lane walks its own pixel sequence: the warp's rows (strided by
    // warp), in each row the columns lane, lane + 32, ... of the row's
    // range.  The four neighbour loads of the next pixel are issued before
    // the current one is worked on, so their latency overlaps a pixel's
    // arithmetic.
    int i = kw.i_lo + warp - DESC_WARPS, p = 0, pend = -1;
    auto advance = [&]() {  // to this lane's next pixel; false past the end
      p += 32;
      while (p > pend) {
        i += DESC_WARPS;
        if (i > kw.i_hi) return false;
        if (wyt[i] == 0.0f) {  // masked row
          p = 0;
          pend = -1;
          continue;
        }
        const int2 cr = crng[i];
        p = cr.x + lane;
        pend = cr.y;
      }
      return true;
    };
    float nl = 0.0f, nr = 0.0f, nu = 0.0f, nd = 0.0f;
    auto prefetch = [&]() {
      const float* v = base + (size_t)i * ws + p;
      nl = v[-1];
      nr = v[1];
      nu = v[-ws];
      nd = v[ws];
    };
    bool more = advance();
    if (more) prefetch();
    while (more) {
      const int prow = i, pcol = p;
      const float vl = nl, vr = nr, vu = nu, vd = nd;
      more = advance();
      if (more) prefetch();
      const float wx = wxt[pcol];
      if (wx == 0.0f) continue;  // masked column
      const float wy = wyt[prow];
      const float offy = kw.dy0 + (float)prow;
      const float offx = kw.dx0 + (float)pcol;
      const float c_rot = offx * cos_t - offy * sin_t;
      const float r_rot = offx * sin_t + offy * cos_t;
      const float rbin = r_rot + F(DESC_D / 2.0 - 0.5);
      const float cbin = c_rot + F(DESC_D / 2.0 - 0.5);
      if (!((rbin > -1.0f) && (rbin < (float)DESC_D) && (cbin > -1.0f) &&
            (cbin < (float)DESC_D)))
        continue;

      const float dx = vr - vl;
      const float dy = vu - vd;
      const float mag = sqrtf(dx * dx + dy * dy);
      const float ori = atan2_deg(dy, dx);  // [-180, 180]
      const float mag_w = mag * (wy * wx);

      // Orientation bin in [0, 8]: the subtraction can round up to 8.0,
      // which the circular hat below folds onto bin 0.
      float ob = (ori - ang) * F(DESC_NB / 360.0);
      ob = ob - floorf(ob * F(1.0 / DESC_NB)) * (float)DESC_NB;

      const int r0 = (int)floorf(rbin);
      const int c0 = (int)floorf(cbin);
      const int o0 = (int)floorf(ob);
      float hr[2], hc[2], vo[2];
      int ri[2], ci[2], oi[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int r = r0 + d, c = c0 + d;
        hr[d] = fmaxf(0.0f, 1.0f - fabsf(rbin - (float)r));
        hc[d] = fmaxf(0.0f, 1.0f - fabsf(cbin - (float)c));
        ri[d] = (r >= 0 && r < DESC_D) ? r : -1;
        ci[d] = (c >= 0 && c < DESC_D) ? c : -1;
        const int o = ((o0 + d) % DESC_NB + DESC_NB) % DESC_NB;
        const float od = fabsf(ob - (float)o);
        vo[d] = fmaxf(0.0f, 1.0f - fminf(od, (float)DESC_NB - od)) * mag_w;
        oi[d] = o;
      }
      // The 8 taps: distinct bins, or the sink row for a tap outside
      // the grid.  Loads first, then stores.
      int idx[8];
      float val[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int dr = j >> 2, dc = (j >> 1) & 1, dd = j & 1;
        const bool in = ri[dr] >= 0 && ci[dc] >= 0;
        idx[j] = (in ? (ri[dr] * DESC_D + ci[dc]) * DESC_NB + oi[dd]
                     : DESC_LEN) * DESC_NT;
        val[j] = col[idx[j]];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int dr = j >> 2, dc = (j >> 1) & 1, dd = j & 1;
        col[idx[j]] = val[j] + (hr[dr] * hc[dc]) * vo[dd];
      }
    }
    __syncthreads();
    // Bin b: the sum over the threads' columns in a fixed order, starting
    // at column b so the warp's 32 reads hit 32 banks.
    for (int b = tid; b < DESC_LEN; b += DESC_NT) {
      const float* row = bins + b * DESC_NT;
      float s = 0.0f;
#pragma unroll 8
      for (int j = 0; j < DESC_NT; ++j) s += row[(j + b) & (DESC_NT - 1)];
      orow[b] = s;
    }
    __syncthreads();  // the next keypoint rewrites columns and tables
  }
}

// Arguments as sift_orientation_hist (par additionally carries cos_t,
// sin_t, ang in columns 9..11); out: [K, 128] f32, rows outside
// [start, start + count) written 0.  The grid is the number of blocks the
// card holds at once (at most K); the dynamic shared memory grows with
// rows + lanes.
SIFT_API int sift_descriptor_hist(const void* slab, int hs, int ws,
                                  const void* ys0, const void* xs0,
                                  const void* par, int npar,
                                  const void* count_ptr, int count_bytes,
                                  long long count_val,
                                  const void* start_ptr, int start_bytes,
                                  long long start_val, void* out, int K,
                                  int rows, int lanes, void* stream) {
  if (K <= 0) return 0;
  const size_t smem = desc_smem_bytes(rows, lanes);
  // Launch geometry per device, kept for the last shared-memory size.
  static size_t cached_smem[64];
  static int cached_grid[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem != cached_smem[dev]) {
    e = cudaFuncSetAttribute(descriptor_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, descriptor_hist_kernel, DESC_NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_smem[dev] = smem;
    cached_grid[dev] = sms * per_sm;
  }
  const int grid = cached_grid[dev] < K ? cached_grid[dev] : K;
  const DevInt count = {count_ptr, count_bytes, count_val};
  const DevInt start = {start_ptr, start_bytes, start_val};
  descriptor_hist_kernel<<<grid, DESC_NT, smem, (cudaStream_t)stream>>>(
      (const float*)slab, hs, ws, (const int*)ys0, (const int*)xs0,
      (const float*)par, npar, count, start, (float*)out, K, rows, lanes);
  return (int)cudaGetLastError();
}
