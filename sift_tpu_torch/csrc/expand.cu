// Slab copy expansion: [hs, ws] -> [copies*hs, ws], copy c shifted LEFT
// by c * 128/copies columns with a zeroed tail, all copies in one pass.
//
// Replaces the TPU kernel sift_tpu/kernels/expand.py
// (expand_lane_copies / _expand_kernel).
//
// Bound on the H100: bytes.  Pure data movement: the base is read once
// and `copies` times as much is written; no arithmetic at all.  What the
// design does about it: one thread per 16 bytes of the BASE row loads its
// float4 once and stores it into every copy in which that column
// survives the shift (ws, the shift step and both base pointers are
// multiples of 4 floats, so every access is an aligned float4 and
// coalesced along the row); the threads of the last c*step columns of
// copy c store zeros.  The concatenation of shifted pads that the plain
// version does reads the base once per copy and passes through
// intermediates; here each byte moves once.
#include "common.cuh"

#define EXP_THREADS 256

__global__ void __launch_bounds__(EXP_THREADS)
expand_lane_copies_kernel(const float4* __restrict__ base,
                          float4* __restrict__ out, int hs, int ws4,
                          int copies, int step4) {
  const int x = blockIdx.x * EXP_THREADS + threadIdx.x;  // float4 column
  const int r = blockIdx.y;
  if (x >= ws4) return;
  const size_t row = (size_t)r * ws4;
  const float4 v = base[row + x];
  const size_t copy = (size_t)hs * ws4;
  for (int c = 0; c < copies; ++c) {
    const int s = c * step4;
    // base column x lands at column x - s of copy c ...
    if (x >= s) out[c * copy + row + (x - s)] = v;
    // ... and the tail [ws - s, ws) of copy c is zero.
    if (x >= ws4 - s) out[c * copy + row + x] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// base: [hs, ws] f32, ws % 4 == 0, 16-byte aligned; out: [copies*hs, ws]
// f32; step = 128/copies columns (a multiple of 4).  Launches on
// ``stream``, does not synchronise; returns cudaGetLastError().
SIFT_API int sift_expand_lane_copies(const void* base, void* out, int hs,
                                     int ws, int copies, int step,
                                     void* stream) {
  if (hs <= 0 || ws <= 0) return 0;
  const int ws4 = ws / 4;
  dim3 grid((ws4 + EXP_THREADS - 1) / EXP_THREADS, hs);
  expand_lane_copies_kernel<<<grid, EXP_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)base, (float4*)out, hs, ws4, copies, step / 4);
  return (int)cudaGetLastError();
}
