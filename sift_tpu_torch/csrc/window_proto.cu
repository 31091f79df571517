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
//   ring    Hopper's counterpart of the TPU's DMA ring: a persistent grid
//           (as many blocks as the card holds at once) whose blocks walk
//           the live windows only, interleaved (block b takes windows b,
//           b + grid, ...).  Thread 0 copies each window in bands of
//           band_rows x 128 f32 with the Tensor Memory Accelerator
//           (cp.async.bulk.tensor.2d, one instruction per band, a tensor
//           map over the slab) into an nbuf-slot ring in shared memory;
//           each slot has a "full" mbarrier that the copy completes by its
//           byte count and an "empty" one that every warp arrives on once
//           it has summed the slot.  The ring runs across window
//           boundaries.  The warps split a window's rows, read the slot
//           with float4 loads and combine their sums in a fixed order.
//           A whole 72-row window is one 36,864-byte tile.
//
// Origins are clamped into the slab and xs0 aligned down to 4 floats, so an
// out-of-contract origin can never fault (the plain version does the same).
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda

#include "common.cuh"

#define WP_LANES 128
#define RING_ROW_BYTES (WP_LANES * 4)

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

// --- the ring: TMA tiles into an mbarrier-guarded ring ---------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// One arrival that also raises the phase's expected transaction bytes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Returns once the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// The [box rows x 128] f32 tile at column x, row y of the slab into shared
// memory; completion is counted in bytes on ``bar``.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Dynamic shared memory of the ring kernel, in this order: nbuf slots of
// band x 128 f32 (each a multiple of 512 bytes, so 128-byte aligned as TMA
// wants), the per-warp window sums [2][block_k][32] float4 (double-buffered
// by window parity), then full[nbuf] and empty[nbuf] mbarriers; plus 128
// bytes of slack to align the base.  perf/window_proto.ring_smem_bytes is
// the same formula.
static int ring_smem_bytes(int block_k, int nbuf, int band) {
  return nbuf * band * RING_ROW_BYTES + 2 * block_k * RING_ROW_BYTES +
         2 * nbuf * 8 + 128;
}

// Persistent grid; block b owns windows b, b + gridDim.x, ... below the
// live count, so a short live prefix still spreads over every SM.  Its work
// is the flat sequence of (window, band) items; item n lands in slot
// n % nbuf.  Thread 0 is the producer: it arms the slot's full barrier with
// the tile's bytes and starts the TMA copy, and refills a slot once every
// warp has arrived on its empty barrier.  Every warp consumes every item:
// warp c sums the window rows r with r % block_k == c (float4 per lane), and
// at a window's last band the block adds the warps' sums in warp order, so
// the result does not depend on timing.
__global__ void __launch_bounds__(1024)
colsum_ring_kernel(const __grid_constant__ CUtensorMap map,
                   const int* __restrict__ ys0, const int* __restrict__ xs0,
                   const int* __restrict__ count, float4* __restrict__ out,
                   int k_cap, int h, int w, int rows, int band, int nbuf) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int block_k = blockDim.x >> 5;
  float* ring = reinterpret_cast<float*>(base);
  float4* part = reinterpret_cast<float4*>(base + nbuf * band * RING_ROW_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 2 * block_k * 32);
  uint64_t* empty = full + nbuf;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int live = min(*count, k_cap);
  if (tid == 0) {
    for (int s = 0; s < nbuf; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, block_k);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int first = blockIdx.x, stride = gridDim.x;
  const int n_win = first < live ? (live - first + stride - 1) / stride : 0;
  const int bands = rows / band;
  const int total = n_win * bands;
  const unsigned slot_bytes = (unsigned)band * RING_ROW_BYTES;
  auto load = [&](int n) {
    const int k = first + (n / bands) * stride;
    int y0, x0;
    clamp_origin(ys0, xs0, k, h, w, rows, &y0, &x0);
    const int s = n % nbuf;
    mbar_expect_tx(full + s, slot_bytes);
    tma_load_tile(ring + (size_t)s * band * WP_LANES, &map, x0,
                  y0 + (n % bands) * band, full + s);
  };
  if (tid == 0)
    for (int n = 0; n < nbuf && n < total; ++n) load(n);

  // Rows at or past the live count are zero, while the first tiles land.
  for (int k = live + blockIdx.x * block_k + warp; k < k_cap;
       k += gridDim.x * block_k)
    out[(size_t)k * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < total; ++n) {
    // Refill the slot item n - 1 used with item n - 1 + nbuf, once every
    // warp has released it.
    if (tid == 0 && n > 0 && n - 1 + nbuf < total) {
      mbar_wait(empty + (n - 1) % nbuf, ((n - 1) / nbuf) & 1);
      load(n - 1 + nbuf);
    }
    __syncwarp();
    const int s = n % nbuf;
    mbar_wait(full + s, (n / nbuf) & 1);
    const int b = n % bands;
    const float4* slot =
        reinterpret_cast<const float4*>(ring + (size_t)s * band * WP_LANES) +
        lane;
    // This warp's rows of the window that fall in this band.
    int j = (warp - (b * band) % block_k + block_k) % block_k;
    for (; j < band; j += block_k) acc = add4(acc, slot[j * 32]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (b == bands - 1) {
      const int m = n / bands;
      float4* p = part + (m & 1) * block_k * 32;
      p[warp * 32 + lane] = acc;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      if (warp == 0) {
        float4 t = p[lane];
        for (int c = 1; c < block_k; ++c) t = add4(t, p[c * 32 + lane]);
        out[(size_t)(first + m * stride) * 32 + lane] = t;
      }
    }
  }
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

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &q);
#endif
  if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
    fn = (EncodeTiledFn)p;
  return fn;
}

// Shared memory (bytes) of one ring block and how many such blocks one SM
// of the current device holds at once (registers, threads and shared
// memory all counted).  Returns a cudaError_t, -1 for a ring that does not
// fit a block.
SIFT_API int sift_window_colsum_ring_geometry(int block_k, int nbuf,
                                              int band_rows, long long* smem,
                                              int* blocks_per_sm) {
  const int bytes = ring_smem_bytes(block_k, nbuf, band_rows);
  *smem = bytes;
  *blocks_per_sm = 0;
  if (bytes > 227 * 1024 || block_k < 1 || block_k > 32) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      colsum_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, colsum_ring_kernel, 32 * block_k, bytes);
}

// nbuf slots of band_rows x 128 f32 (1 <= band_rows <= 256, rows %
// band_rows == 0); block_k consumer warps; grid: number of persistent
// blocks.  The tensor map spans the whole slab: dims {w, h}, row stride
// w * 4 bytes, box {128, band_rows}, no swizzle (perf/window_proto.
// ring_tensor_map gives the same arguments).  Returns -1 for arguments the
// kernel cannot take, -2 without cuTensorMapEncodeTiled, the
// CUresult + 1000 if encoding fails, else cudaGetLastError().
SIFT_API int sift_window_colsum_ring(const void* slab, const void* ys0,
                                     const void* xs0, const void* count,
                                     void* out, int k_cap, int h, int w,
                                     int rows, int block_k, int nbuf,
                                     int band_rows, int grid, void* stream) {
  if (k_cap <= 0) return 0;
  if (band_rows < 1 || band_rows > 256 || rows % band_rows || nbuf < 1 ||
      block_k < 1 || block_k > 32 || grid < 1 || w % 4 || w < WP_LANES ||
      h < rows)
    return -1;
  const int smem = ring_smem_bytes(block_k, nbuf, band_rows);
  if (smem > 227 * 1024) return -1;
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h};
  const cuuint64_t strides[1] = {(cuuint64_t)w * sizeof(float)};
  const cuuint32_t box[2] = {WP_LANES, (cuuint32_t)band_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<void*>(slab), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  cudaError_t e = cudaFuncSetAttribute(
      colsum_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  colsum_ring_kernel<<<grid, 32 * block_k, smem, (cudaStream_t)stream>>>(
      map, (const int*)ys0, (const int*)xs0, (const int*)count, (float4*)out,
      k_cap, h, w, rows, band_rows, nbuf);
  return (int)cudaGetLastError();
}
