// Record-field kernel: Gaussian octave -> DoG -> 3x3x3 extrema mask ->
// per-pixel Newton records, one pass, packed into the A/B/C planes.  ONE
// launch covers every octave of a pyramid.
//
// Replaces the TPU kernel sift_tpu/kernels/fused_detect.py
// (detect_records_pallas / _detect_kernel).
//
// Bound on the H100: bytes.  Each pixel reads NL Gaussian values and
// writes 3*(NL-3) record values (15 floats = 60 B at NL = 6) against
// roughly 250 float operations - about 4 flop/byte, far below the card's
// ~20 flop/byte float32 ridge.  What the design does about it:
//  * Each Gaussian value is read from device memory once per tile: a
//    block stages its 32x8 output tile plus a 1-px halo, (32+2) x (8+2)
//    f32 per layer, in shared memory with cp.async.  All NL layers are
//    requested at once (NL x 1.3 KB), each layer its own commit group, so
//    later layers stream in while the records of earlier ones compute.
//    Every thread then reads its 3x3 neighbourhood from the tile and
//    slides a 3-layer DoG window in registers; the DoG volume is never
//    written, and the three planes are stored coalesced along x.
//  * One launch per pyramid: a table of up to 16 octaves (in/out
//    pointers, h, w, first block, tiles per row) in a __grid_constant__
//    parameter; one 1-D grid covers every octave's tiles, largest octave
//    first, so the small octaves (a few blocks each) fill the tail of the
//    large one instead of paying a launch each.  A block finds its octave
//    by scanning the table's first-block column.
//
// Bit-exact against the plain version (ops/refine_dense.record_fields,
// ops/peaks.peak_mask): -fmad=false, IEEE divisions, rintf, the same
// expression order.  The kernel takes each octave at its natural shape
// [NL, h, w] with any h, w >= 1: halo coordinates are clamped to the
// image, so the 1-px rim holds defined (by contract unused) values, and
// the peak bit is masked to [border, size - border).
#include "common.cuh"

#define IMG_SCALE (1.0 / 255.0)
#define DERIV_SCALE F(IMG_SCALE * 0.5)
#define SECOND_DERIV_SCALE F(IMG_SCALE)
#define CROSS_DERIV_SCALE F(IMG_SCALE * 0.25)

#define BX 32
#define BY 8
#define TW (BX + 2)
#define TH (BY + 2)
#define TILE (TW * TH)
#define MAX_OCTAVES 16

struct OctaveEntry {
  const float* g;  // [nl, h, w]
  float* out;      // [3, nl - 3, h, w]
  int h, w, first, tiles_x;
};

struct DetectParams {
  OctaveEntry oct[MAX_OCTAVES];  // in block order
  int n, nl, border;
  float threshold, et, et1sq, cthr, flayers;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ``n`` commit groups are pending (n capped at 6, which
// only waits longer than asked).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 6 ? (n < 0 ? 0 : n) : 6) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

__global__ void __launch_bounds__(BX * BY)
detect_records_kernel(const __grid_constant__ DetectParams P) {
  extern __shared__ float tile[];  // [nl][TILE]
  int e = 0;
  while (e + 1 < P.n && (int)blockIdx.x >= P.oct[e + 1].first) ++e;
  const OctaveEntry& O = P.oct[e];
  const int h = O.h, w = O.w, nl = P.nl;
  const int local = (int)blockIdx.x - O.first;
  const int x0 = (local % O.tiles_x) * BX, y0 = (local / O.tiles_x) * BY;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const size_t plane = (size_t)h * w;

  // Stage every layer's halo tile; coordinates clamped to the image.
  int src[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = tid + q * BX * BY;
    const int gy = min(max(y0 - 1 + t / TW, 0), h - 1);
    const int gx = min(max(x0 - 1 + t % TW, 0), w - 1);
    src[q] = gy * w + gx;
  }
  for (int l = 0; l < nl; ++l) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int t = tid + q * BX * BY;
      if (t < TILE)
        cp_async4(&tile[l * TILE + t], O.g + (size_t)l * plane + src[q]);
    }
    cp_async_commit();
  }

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const bool active = (x < w) && (y < h);
  const bool inb = (y >= P.border) && (y < h - P.border) &&
                   (x >= P.border) && (x < w - P.border);
  // Tile offset of neighbour j = (dr+1)*3 + (dc+1).
  const int t0 = threadIdx.y * TW + threadIdx.x;
#define TAP(l, j) tile[(l) * TILE + t0 + ((j) / 3) * TW + (j) % 3]

  float gprev[9], lo[9], c[9], hi[9];
  // Prime the sliding window with DoG layers 0 and 1 (into c and hi).
  cp_async_wait(nl - 3);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float g0 = TAP(0, j), g1 = TAP(1, j), g2 = TAP(2, j);
    c[j] = g1 - g0;
    hi[j] = g2 - g1;
    gprev[j] = g2;
    lo[j] = 0.0f;
  }

  const int nrec = nl - 3;
  for (int lr = 1; lr <= nrec; ++lr) {
    cp_async_wait(nl - 3 - lr);
    __syncthreads();
    // Slide: lo <- c <- hi <- DoG layer lr+1 = G[lr+2] - G[lr+1].
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float gn = TAP(lr + 2, j);
      lo[j] = c[j];
      c[j] = hi[j];
      hi[j] = gn - gprev[j];
      gprev[j] = gn;
    }
    if (!active) continue;
    const float cc = c[4];

    // 26-neighbour extremum: c equals the 27-window max / min.
    float mx = cc, mn = cc;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      mx = fmaxf(mx, fmaxf(fmaxf(lo[j], c[j]), hi[j]));
      mn = fminf(mn, fminf(fminf(lo[j], c[j]), hi[j]));
    }
    const bool peak = (fabsf(cc) > P.threshold) &&
                      (((cc > 0.0f) && (cc >= mx)) ||
                       ((cc < 0.0f) && (cc <= mn))) && inb;

    // Dense Newton record (expression for expression the plain version,
    // ops/refine_dense.record_fields).
    const float dx = (c[5] - c[3]) * DERIV_SCALE;
    const float dy = (c[7] - c[1]) * DERIV_SCALE;
    const float ds = (hi[4] - lo[4]) * DERIV_SCALE;
    const float v2 = cc * 2.0f;
    const float dxx = (c[5] + c[3] - v2) * SECOND_DERIV_SCALE;
    const float dyy = (c[7] + c[1] - v2) * SECOND_DERIV_SCALE;
    const float dss = (hi[4] + lo[4] - v2) * SECOND_DERIV_SCALE;
    const float dxy = (c[8] - c[6] - c[2] + c[0]) * CROSS_DERIV_SCALE;
    const float dxs = (hi[5] - hi[3] - lo[5] + lo[3]) * CROSS_DERIV_SCALE;
    const float dys = (hi[7] - hi[1] - lo[7] + lo[1]) * CROSS_DERIV_SCALE;

    const float det = (dxx * (dyy * dss - dys * dys)
                       - dxy * (dxy * dss - dys * dxs)
                       + dxs * (dxy * dys - dyy * dxs));
    const bool ok = fabsf(det) > F(1e-30);
    const float safe = ok ? det : 1.0f;
    const float x0r = (dx * (dyy * dss - dys * dys)
                       - dxy * (dy * dss - dys * ds)
                       + dxs * (dy * dys - dyy * ds)) / safe;
    const float x1r = (dxx * (dy * dss - dys * ds)
                       - dx * (dxy * dss - dys * dxs)
                       + dxs * (dxy * ds - dy * dxs)) / safe;
    const float x2r = (dxx * (dyy * ds - dy * dys)
                       - dxy * (dxy * ds - dy * dxs)
                       + dx * (dxy * dys - dyy * dxs)) / safe;

    const bool conv = (fabsf(x0r) < 0.5f) && (fabsf(x1r) < 0.5f) &&
                      (fabsf(x2r) < 0.5f) && ok;
    const bool div = (fabsf(x0r) > (float)w) || (fabsf(x1r) > (float)h) ||
                     (fabsf(x2r) > 100.0f) || !ok;

    const float contrast =
        fabsf(cc * F(IMG_SCALE) - (dx * x0r + dy * x1r + ds * x2r) * 0.5f);
    const float tr = dxx + dyy;
    const float det2 = dxx * dyy - dxy * dxy;
    const bool edge_ok = (det2 > 0.0f) && (tr * tr * P.et < P.et1sq * det2);
    const bool cok = contrast * P.flayers >= P.cthr;

    // Packing (ops/records.pack_record_channels); rintf rounds half to
    // even like torch.round / jnp.round.  Every term is an exact integer
    // in f32 and A < 2^24.
    const float a = (conv ? 1.0f : 0.0f) + (div ? 2.0f : 0.0f)
                  + (edge_ok ? 4.0f : 0.0f) + (peak ? 8.0f : 0.0f)
                  + (cok ? 16.0f : 0.0f)
                  + 32.0f * (clipf(rintf(x0r), -32.0f, 31.0f) + 32.0f)
                  + 2048.0f * (clipf(rintf(x1r), -32.0f, 31.0f) + 32.0f)
                  + 131072.0f * (clipf(rintf(x2r), -8.0f, 7.0f) + 8.0f);
    const float qx0 = clipf(rintf((x0r + 0.5f) * 2000.0f), 0.0f, 2047.0f);
    const float qx1 = clipf(rintf((x1r + 0.5f) * 2000.0f), 0.0f, 2047.0f);
    const float qx2 = clipf(rintf((x2r + 0.5f) * 1000.0f), 0.0f, 1023.0f);
    const float qc = clipf(rintf(contrast * 8191.0f), 0.0f, 8191.0f);

    float* out = O.out + (size_t)(lr - 1) * plane + (size_t)y * w + x;
    out[0] = a;
    out[(size_t)nrec * plane] = qx0 + 2048.0f * qx1;
    out[2 * (size_t)nrec * plane] = qx2 + 1024.0f * qc;
  }
#undef TAP
}

// table: n rows of 6 int64 in block order (largest octave first):
// g [nl, h, w] f32 device pointer, out [3, nl-3, h, w] f32 device pointer,
// h, w, first block, tiles per row (32-px wide, 8-px tall tiles);
// ``blocks`` the total.  Launches on ``stream``, does not synchronise,
// allocates nothing; returns cudaGetLastError().
SIFT_API int sift_detect_records(const long long* table, int n, int blocks,
                                 int nl, float threshold, int border,
                                 float et, float et1sq, float cthr,
                                 float flayers, void* stream) {
  if (n < 1 || n > MAX_OCTAVES || nl < 4) return (int)cudaErrorInvalidValue;
  if (blocks <= 0) return 0;
  DetectParams P;
  for (int i = 0; i < n; ++i) {
    const long long* r = table + 6 * i;
    P.oct[i].g = (const float*)(uintptr_t)r[0];
    P.oct[i].out = (float*)(uintptr_t)r[1];
    P.oct[i].h = (int)r[2];
    P.oct[i].w = (int)r[3];
    P.oct[i].first = (int)r[4];
    P.oct[i].tiles_x = (int)r[5];
  }
  P.n = n;
  P.nl = nl;
  P.border = border;
  P.threshold = threshold;
  P.et = et;
  P.et1sq = et1sq;
  P.cthr = cthr;
  P.flayers = flayers;
  const size_t smem = (size_t)nl * TILE * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  detect_records_kernel<<<blocks, dim3(BX, BY), smem, (cudaStream_t)stream>>>(
      P);
  return (int)cudaGetLastError();
}
