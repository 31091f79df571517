// Batched window copy: out[k, i, j] = values[lidx[k], ys0[k]+i, xs0[k]+j]
// for 0 <= i < rows, 0 <= j < lanes; one [rows, lanes] window per keypoint
// out of a [L, hp, wp] slab stack.
//
// Replaces the TPU kernel sift_tpu/kernels/window_gather.py
// (gather_windows_pallas / _gather_kernel).
//
// Bound on the H100: bytes.  Pure data movement: K*rows*lanes*4 bytes are
// read and as many written, no arithmetic.  What the design does about it:
// one thread block per window, each thread moves 16 bytes (one float4) per
// step, neighbouring threads on neighbouring addresses, so a warp reads and
// writes 512 contiguous bytes of one window row at a time.  The callers'
// origins are multiples of 128 columns on a slab whose width is a multiple
// of 128, so every float4 is aligned; a window whose origin or slab width is
// not a multiple of 4 floats takes scalar loads instead (same result).  The
// TPU kernel's scheme (one DMA per window into the output block, one
// semaphore each, block_k windows per grid step) is not carried over: a
// block loads from any address and 132 SMs keep thousands of loads in
// flight without any staging.
//
// Elements that fall outside the slab (a slab smaller than one window, or
// an origin past its edge) read as 0: the same values as a gather from the
// slab zero-padded to hold the window.  lidx is clamped to [0, L-1].
// Offsets are 64-bit: a 4-copy padded pyramid at 3840x2160 has 1.8e9
// elements.
#include "common.cuh"

#define GW_THREADS 256

__global__ void __launch_bounds__(GW_THREADS)
gather_windows_kernel(const float* __restrict__ values,
                      const int* __restrict__ lidx,
                      const int* __restrict__ ys0,
                      const int* __restrict__ xs0, float* __restrict__ out,
                      int nl, int hp, int wp, int rows, int lanes) {
  const size_t k = blockIdx.x;
  int l = lidx[k];
  l = l < 0 ? 0 : (l >= nl ? nl - 1 : l);
  const int y0 = ys0[k];
  const int x0 = xs0[k];
  const float* src = values + (size_t)l * hp * wp;
  float* dst = out + k * rows * (size_t)lanes;
  const int lanes4 = lanes >> 2;
  const int n4 = rows * lanes4;
  const bool vec = ((x0 & 3) == 0) && ((wp & 3) == 0);
  for (int t = threadIdx.x; t < n4; t += GW_THREADS) {
    const int i = t / lanes4;
    const int j = (t - i * lanes4) << 2;
    const int y = y0 + i;
    const int x = x0 + j;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (y >= 0 && y < hp) {
      const float* row = src + (size_t)y * wp;
      if (vec && x >= 0 && x + 3 < wp) {
        v = *reinterpret_cast<const float4*>(row + x);
      } else {
        if (x >= 0 && x < wp) v.x = row[x];
        if (x + 1 >= 0 && x + 1 < wp) v.y = row[x + 1];
        if (x + 2 >= 0 && x + 2 < wp) v.z = row[x + 2];
        if (x + 3 >= 0 && x + 3 < wp) v.w = row[x + 3];
      }
    }
    reinterpret_cast<float4*>(dst)[t] = v;
  }
}

// values: [nl, hp, wp] f32; lidx/ys0/xs0: [k] i32; out: [k, rows, lanes]
// f32, lanes % 4 == 0, both base pointers 16-byte aligned.  Launches on
// ``stream``, does not synchronise; returns cudaGetLastError().
SIFT_API int sift_gather_windows(const void* values, const void* lidx,
                                 const void* ys0, const void* xs0, void* out,
                                 int nl, int hp, int wp, int k, int rows,
                                 int lanes, void* stream) {
  if (k <= 0 || rows <= 0 || lanes <= 0) return 0;
  gather_windows_kernel<<<k, GW_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)lidx, (const int*)ys0,
      (const int*)xs0, (float*)out, nl, hp, wp, rows, lanes);
  return (int)cudaGetLastError();
}
