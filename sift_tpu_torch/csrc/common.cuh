// Shared device helpers of the hand-written Hopper kernels.
//
// All sources are compiled with -fmad=false and without fast-math so that
// each kernel rounds like its plain PyTorch version (one IEEE operation
// per arithmetic step): the decision bits of the record field and the
// histogram-bin choices sit right behind heavily cancelling expressions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SIFT_API extern "C" __attribute__((visibility("default")))

// Python-side constants are doubles rounded to float at their first use
// with a float operand; (float)<double literal> reproduces that rounding.
#define F(x) ((float)(x))

// clip that propagates NaN like torch.clamp (fminf/fmaxf would drop it).
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Polynomial atan2 in degrees, [-180, 180]: octant reduction + odd
// degree-15 minimax polynomial for atan on [0, 1] (|err| <= 3.8e-8 rad).
// Same expression, coefficient for coefficient, as the plain version
// (kernels/fused_stages._atan2_deg) and the JAX package's kernel, so
// histogram-bin decisions agree.  atan2(0, 0) -> 0, never NaN.
__device__ __forceinline__ float atan2_deg(float dy, float dx) {
  const float ax = fabsf(dx);
  const float ay = fabsf(dy);
  const float mx = fmaxf(ax, ay);
  const float z = fminf(ax, ay) / fmaxf(mx, F(1e-30));
  const float z2 = z * z;
  float p = F(-0.004054926663980925);
  p = F(0.02186422353328521) + z2 * p;
  p = F(-0.05591409699715592) + z2 * p;
  p = F(0.09642322342441606) + z2 * p;
  p = F(-0.13908676324191868) + z2 * p;
  p = F(0.19946574511230034) + z2 * p;
  p = F(-0.3332986151078535) + z2 * p;
  p = F(0.9999993357463199) + z2 * p;
  p = z * p;
  float r = ay > ax ? F(1.5707963267948966) - p : p;
  r = dx < 0.0f ? F(3.141592653589793) - r : r;
  return (dy < 0.0f ? -r : r) * F(57.29577951308232);
}

// An integer argument that is either a value or a 0-d tensor on the card
// (read in the kernel, so the host never synchronises): ``bytes`` is 4 or
// 8 for an int32 / int64 tensor at ``ptr``, 0 for the value ``val``.
struct DevInt {
  const void* ptr;
  int bytes;
  long long val;
};

__device__ __forceinline__ long long read_int(const DevInt a) {
  if (a.bytes == 4) return *(const int*)a.ptr;
  if (a.bytes == 8) return *(const long long*)a.ptr;
  return a.val;
}

// Rows [lo, hi) of a K-row output that a per-keypoint kernel computes:
// [start, start + min(count, K)) cut to [0, K).
__device__ __forceinline__ void live_rows(const DevInt count,
                                          const DevInt start, int K,
                                          int* lo, int* hi) {
  long long c = read_int(count), s = read_int(start);
  c = c < K ? c : K;
  long long a = s > 0 ? s : 0, b = s + c;
  b = b < K ? b : K;
  *lo = (int)(a < K ? a : K);
  *hi = (int)(b > *lo ? b : *lo);
}

// Per-keypoint parameter row shared by the orientation and descriptor
// kernels (the JAX package's layout, kernels/fused_stages.py):
//  0 dy0 (window row 0 - cy)   1 dx0 (window col 0 - cx)
//  2 ylo (1-py)  3 yhi (h-2-py)  4 xlo (1-px)  5 xhi (w-2-px)
//  6 es (Gaussian exponent scale)  7 radius (uncapped)  8 valid
//  9 cos_t  10 sin_t  11 ang      (descriptor only)
//  12 TPU lane offset: ignored here.
struct KpWindow {
  float dy0, dx0, ylo, yhi, xlo, xhi, es, rad, vld;
  int i_lo, i_hi, p_lo, p_hi;  // inclusive pixel range inside the window
};

// Loop bounds: pixels whose offsets pass every mask (image bounds and the
// keypoint's OWN radius), cut to the window's interior [1, rows-2] x
// [1, lanes-2] so that the gradient taps at +-1 never leave rows x lanes.
__device__ __forceinline__ KpWindow load_window(const float* p, int rows,
                                                int lanes) {
  KpWindow k;
  k.dy0 = p[0]; k.dx0 = p[1]; k.ylo = p[2]; k.yhi = p[3];
  k.xlo = p[4]; k.xhi = p[5]; k.es = p[6]; k.rad = p[7]; k.vld = p[8];
  const float ylo = fmaxf(k.ylo, -k.rad), yhi = fminf(k.yhi, k.rad);
  const float xlo = fmaxf(k.xlo, -k.rad), xhi = fminf(k.xhi, k.rad);
  // Clamp in float before the int cast (a huge radius must not overflow).
  k.i_lo = (int)fminf(fmaxf(ceilf(ylo - k.dy0), 1.0f), (float)rows);
  k.i_hi = (int)fmaxf(fminf(floorf(yhi - k.dy0), (float)(rows - 2)), 0.0f);
  k.p_lo = (int)fminf(fmaxf(ceilf(xlo - k.dx0), 1.0f), (float)lanes);
  k.p_hi = (int)fmaxf(fminf(floorf(xhi - k.dx0), (float)(lanes - 2)), 0.0f);
  return k;
}
