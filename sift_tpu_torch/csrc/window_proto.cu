// Three schemes for loading per-keypoint windows, head to head on a toy
// column sum:  out[k, :] = sum_i slab[ys0[k]+i, xs0[k] : xs0[k]+128]  for
// k < count, zeros for count <= k < K.
//
// Replaces the TPU experiment kernels of scripts/dma_proto.py: p0 (static
// grid over capacity, 2-slot double buffer), p0b (p0 plus a blocked
// parameter tile) and p1 (one program that loops over the LIVE blocks only,
// nbuf-slot ring, one wait per slot).
//
// Bound on the H100: bytes — count*rows*512 bytes of window reads (at most
// the slab once) against one add per element.  What matters on this card is
// how many 16-byte loads each SM keeps in flight, so the three kernels are
// the three ways a CUDA block can get a window, not copies of the TPU's
// DMA-and-semaphore code:
//   static  one warp per window, blocks past the live count only write
//           their zeros; 32 lanes x float4 = one 512-byte row per step,
//           loaded straight from global memory into registers, the row
//           loop unrolled so that several loads are in flight per lane;
//   par     the same, after the block has staged its [block_k, 16]
//           parameter tile in shared memory (what the orientation and
//           descriptor kernels do with their parameter rows);
//   ring    a persistent grid (a fixed number of blocks per SM) whose warps
//           walk the live windows only; each warp streams its windows in
//           bands of RING_ROWS rows through an nbuf-slot ring in shared
//           memory with cp.async (16 bytes per lane and row), one
//           commit group per slot and ONE wait per slot; the ring runs
//           across window boundaries, so the next window's first bands are
//           already in flight while the last bands of this one are summed.
//           Each lane reads back only what it copied itself, so the ring
//           needs no barrier.
//
// Origins are clamped into the slab and xs0 aligned down to 4 floats, so an
// out-of-contract origin can never fault (the plain version does the same).
#include "common.cuh"

#define WP_LANES 128
#define RING_ROWS 2

__device__ __forceinline__ void clamp_origin(const int* ys0, const int* xs0,
                                             int k, int h, int w, int rows,
                                             int* y0, int* x0) {
  int y = ys0[k], x = xs0[k];
  y = y < 0 ? 0 : (y > h - rows ? h - rows : y);
  x = x < 0 ? 0 : (x > w - WP_LANES ? w - WP_LANES : x);
  *y0 = y;
  *x0 = x & ~3;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One warp per window: direct global loads, summed in registers.
__device__ __forceinline__ float4 colsum_direct(const float* slab, int y0,
                                                int x0, int w, int rows,
                                                int lane) {
  const float4* p = reinterpret_cast<const float4*>(
      slab + (size_t)y0 * w + x0) + lane;
  const size_t step = (size_t)(w >> 2);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int i = 0; i < rows; ++i) acc = add4(acc, p[i * step]);
  return acc;
}

// grid = ceil(K / block_k) blocks of block_k warps.
__global__ void __launch_bounds__(1024)
colsum_static_kernel(const float* __restrict__ slab,
                     const int* __restrict__ ys0,
                     const int* __restrict__ xs0,
                     const int* __restrict__ count, float4* __restrict__ out,
                     int k_cap, int h, int w, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= k_cap) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < min(*count, k_cap)) {
    int y0, x0;
    clamp_origin(ys0, xs0, k, h, w, rows, &y0, &x0);
    acc = colsum_direct(slab, y0, x0, w, rows, lane);
  }
  out[(size_t)k * 32 + lane] = acc;
}

// The same with the block's parameter tile staged in shared memory first;
// par[first row of the block, 0] is added to the block's first output row.
__global__ void __launch_bounds__(1024)
colsum_par_kernel(const float* __restrict__ slab,
                  const int* __restrict__ ys0, const int* __restrict__ xs0,
                  const float* __restrict__ par,
                  const int* __restrict__ count, float4* __restrict__ out,
                  int k_cap, int h, int w, int rows) {
  extern __shared__ float spar[];  // [block_k, 16]
  const int block_k = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_first = blockIdx.x * block_k;
  for (int t = threadIdx.x; t < block_k * 16; t += blockDim.x) {
    const int kk = k_first + (t >> 4);
    spar[t] = kk < k_cap ? par[(size_t)kk * 16 + (t & 15)] : 0.f;
  }
  __syncthreads();
  const int k = k_first + warp;
  if (k >= k_cap) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < min(*count, k_cap)) {
    int y0, x0;
    clamp_origin(ys0, xs0, k, h, w, rows, &y0, &x0);
    acc = colsum_direct(slab, y0, x0, w, rows, lane);
    if (warp == 0) {
      const float p0 = spar[0];
      acc = add4(acc, make_float4(p0, p0, p0, p0));
    }
  }
  out[(size_t)k * 32 + lane] = acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const size_t g = __cvta_generic_to_global(gmem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Persistent grid; warp w of block b owns windows b + (w + m*block_k) *
// gridDim.x, m = 0, 1, ... below the live count: neighbouring windows go to
// different blocks, so a short live prefix still spreads over every SM.
// Its work is the flat sequence of (window, band) items; item n sits in
// ring slot n % NBUF.
template <int NBUF>
__global__ void __launch_bounds__(1024)
colsum_ring_kernel(const float* __restrict__ slab,
                   const int* __restrict__ ys0, const int* __restrict__ xs0,
                   const int* __restrict__ count, float4* __restrict__ out,
                   int k_cap, int h, int w, int rows) {
  extern __shared__ float4 ring[];  // [block_k][NBUF][RING_ROWS][32]
  const int block_k = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int live = min(*count, k_cap);
  // Rows at or past the live count are zero.
  for (int k = live + blockIdx.x * block_k + warp; k < k_cap;
       k += gridDim.x * block_k)
    out[(size_t)k * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int first = warp * gridDim.x + blockIdx.x;
  const int stride = gridDim.x * block_k;
  const int n_win = first < live ? (live - first + stride - 1) / stride : 0;
  const int bands = rows / RING_ROWS;
  const int total = n_win * bands;
  float4* my = ring + (size_t)warp * NBUF * RING_ROWS * 32 + lane;
  const size_t step = (size_t)(w >> 2);

  auto issue = [&](int n) {
    const int k = first + (n / bands) * stride;
    const int band = n % bands;
    int y0, x0;
    clamp_origin(ys0, xs0, k, h, w, rows, &y0, &x0);
    const float4* src = reinterpret_cast<const float4*>(
        slab + (size_t)(y0 + band * RING_ROWS) * w + x0) + lane;
    float4* dst = my + (n % NBUF) * RING_ROWS * 32;
#pragma unroll
    for (int r = 0; r < RING_ROWS; ++r) cp_async16(dst + r * 32, src + r * step);
  };

  // Every step commits exactly one group (possibly empty), so that
  // "all but the newest NBUF-1 groups are complete" always means "item n
  // has landed".
  for (int n = 0; n < NBUF - 1; ++n) {
    if (n < total) issue(n);
    cp_async_commit();
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int band = 0, k = first;
  for (int n = 0; n < total; ++n) {
    if (n + NBUF - 1 < total) issue(n + NBUF - 1);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();
    const float4* slot = my + (n % NBUF) * RING_ROWS * 32;
#pragma unroll
    for (int r = 0; r < RING_ROWS; ++r) acc = add4(acc, slot[r * 32]);
    if (++band == bands) {
      out[(size_t)k * 32 + lane] = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      band = 0;
      k += stride;
    }
  }
  cp_async_wait<0>();
}

// slab: [h, w] f32 (w % 4 == 0, h >= rows, w >= 128, 16-byte aligned);
// ys0/xs0: [k_cap] i32; count: 1 i32 ON THE DEVICE; out: [k_cap, 128] f32.
// block_k warps per block (1..32).  Each launches on ``stream``, does not
// synchronise, and returns cudaGetLastError().
SIFT_API int sift_window_colsum_static(const void* slab, const void* ys0,
                                       const void* xs0, const void* count,
                                       void* out, int k_cap, int h, int w,
                                       int rows, int block_k, void* stream) {
  if (k_cap <= 0) return 0;
  const int grid = (k_cap + block_k - 1) / block_k;
  colsum_static_kernel<<<grid, 32 * block_k, 0, (cudaStream_t)stream>>>(
      (const float*)slab, (const int*)ys0, (const int*)xs0,
      (const int*)count, (float4*)out, k_cap, h, w, rows);
  return (int)cudaGetLastError();
}

// par: [k_cap, 16] f32.
SIFT_API int sift_window_colsum_par(const void* slab, const void* ys0,
                                    const void* xs0, const void* par,
                                    const void* count, void* out, int k_cap,
                                    int h, int w, int rows, int block_k,
                                    void* stream) {
  if (k_cap <= 0) return 0;
  const int grid = (k_cap + block_k - 1) / block_k;
  colsum_par_kernel<<<grid, 32 * block_k, block_k * 16 * sizeof(float),
                      (cudaStream_t)stream>>>(
      (const float*)slab, (const int*)ys0, (const int*)xs0,
      (const float*)par, (const int*)count, (float4*)out, k_cap, h, w, rows);
  return (int)cudaGetLastError();
}

template <int NBUF>
static int launch_ring(const void* slab, const void* ys0, const void* xs0,
                       const void* count, void* out, int k_cap, int h, int w,
                       int rows, int block_k, int grid, cudaStream_t stream) {
  const int smem = block_k * NBUF * RING_ROWS * 32 * (int)sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      colsum_ring_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  colsum_ring_kernel<NBUF><<<grid, 32 * block_k, smem, stream>>>(
      (const float*)slab, (const int*)ys0, (const int*)xs0,
      (const int*)count, (float4*)out, k_cap, h, w, rows);
  return (int)cudaGetLastError();
}

// nbuf in {2, 4, 8}; rows % RING_ROWS == 0; grid: number of persistent
// blocks.  Returns -1 for an nbuf it was not built for.
SIFT_API int sift_window_colsum_ring(const void* slab, const void* ys0,
                                     const void* xs0, const void* count,
                                     void* out, int k_cap, int h, int w,
                                     int rows, int block_k, int nbuf,
                                     int grid, void* stream) {
  if (k_cap <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (nbuf) {
    case 2:
      return launch_ring<2>(slab, ys0, xs0, count, out, k_cap, h, w, rows,
                            block_k, grid, s);
    case 4:
      return launch_ring<4>(slab, ys0, xs0, count, out, k_cap, h, w, rows,
                            block_k, grid, s);
    case 8:
      return launch_ring<8>(slab, ys0, xs0, count, out, k_cap, h, w, rows,
                            block_k, grid, s);
    default:
      return -1;
  }
}
