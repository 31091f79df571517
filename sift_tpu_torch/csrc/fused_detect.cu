// Record-field kernel: Gaussian octave -> DoG -> 3x3x3 extrema mask ->
// per-pixel Newton records, one pass, packed into the A/B/C planes.
//
// Replaces the TPU kernel sift_tpu/kernels/fused_detect.py
// (detect_records_pallas / _detect_kernel).
//
// Bound on the H100: bytes.  Each pixel reads NL Gaussian values and
// writes 3*(NL-3) record values (15 floats = 60 B at NL = 6) against
// roughly 250 float operations - about 4 flop/byte, far below the card's
// ~20 flop/byte float32 ridge.  The design therefore moves each byte
// once: one thread per pixel walks the layers with a sliding 3-layer DoG
// window in registers, so every Gaussian value is loaded from device
// memory once per 3x3 neighbourhood (the 9x re-reads hit L1/L2), the DoG
// volume is never written, and the three planes are stored coalesced
// along x.  No shared-memory tile yet: the stencil's re-reads are cached,
// and a later pass can add one if the L1 hit rate turns out to bind.
//
// Unlike the TPU kernel this one takes the octave at its natural shape
// [NL, h, w] with any h, w >= 1: reads at x+-1 / y+-1 are clamped to the
// image, so the 1-px rim holds defined (by contract unused) values, and
// the peak bit is masked to [border, size - border).
#include "common.cuh"

#define IMG_SCALE (1.0 / 255.0)
#define DERIV_SCALE F(IMG_SCALE * 0.5)
#define SECOND_DERIV_SCALE F(IMG_SCALE)
#define CROSS_DERIV_SCALE F(IMG_SCALE * 0.25)

#define BX 32
#define BY 8

__global__ void __launch_bounds__(BX * BY)
detect_records_kernel(const float* __restrict__ g, float* __restrict__ out,
                      int nl, int h, int w, float threshold, int border,
                      float et, float et1sq, float cthr, float flayers) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = (size_t)h * w;
  const int nrec = nl - 3;

  // Clamped 3x3 neighbourhood addresses; j = (dr+1)*3 + (dc+1).
  int off[9];
  {
    const int xs[3] = {max(x - 1, 0), x, min(x + 1, w - 1)};
    const int ys[3] = {max(y - 1, 0), y, min(y + 1, h - 1)};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) off[r * 3 + c] = ys[r] * w + xs[c];
  }
  const bool inb = (y >= border) && (y < h - border) && (x >= border) &&
                   (x < w - border);

  float gprev[9], lo[9], c[9], hi[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) gprev[j] = g[off[j]];
  // Prime the sliding window with DoG layers 0 and 1 (into c and hi).
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float g1 = g[plane + off[j]];
    const float g2 = g[2 * plane + off[j]];
    c[j] = g1 - gprev[j];
    hi[j] = g2 - g1;
    gprev[j] = g2;
    lo[j] = 0.0f;
  }

  for (int lr = 1; lr <= nrec; ++lr) {
    // Slide: lo <- c <- hi <- DoG layer lr+1 = G[lr+2] - G[lr+1].
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float gn = g[(size_t)(lr + 2) * plane + off[j]];
      lo[j] = c[j];
      c[j] = hi[j];
      hi[j] = gn - gprev[j];
      gprev[j] = gn;
    }
    const float cc = c[4];

    // 26-neighbour extremum: c equals the 27-window max / min.
    float mx = cc, mn = cc;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      mx = fmaxf(mx, fmaxf(fmaxf(lo[j], c[j]), hi[j]));
      mn = fminf(mn, fminf(fminf(lo[j], c[j]), hi[j]));
    }
    const bool peak = (fabsf(cc) > threshold) &&
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
    const float x0 = (dx * (dyy * dss - dys * dys)
                      - dxy * (dy * dss - dys * ds)
                      + dxs * (dy * dys - dyy * ds)) / safe;
    const float x1 = (dxx * (dy * dss - dys * ds)
                      - dx * (dxy * dss - dys * dxs)
                      + dxs * (dxy * ds - dy * dxs)) / safe;
    const float x2 = (dxx * (dyy * ds - dy * dys)
                      - dxy * (dxy * ds - dy * dxs)
                      + dx * (dxy * dys - dyy * dxs)) / safe;

    const bool conv = (fabsf(x0) < 0.5f) && (fabsf(x1) < 0.5f) &&
                      (fabsf(x2) < 0.5f) && ok;
    const bool div = (fabsf(x0) > (float)w) || (fabsf(x1) > (float)h) ||
                     (fabsf(x2) > 100.0f) || !ok;

    const float contrast =
        fabsf(cc * F(IMG_SCALE) - (dx * x0 + dy * x1 + ds * x2) * 0.5f);
    const float tr = dxx + dyy;
    const float det2 = dxx * dyy - dxy * dxy;
    const bool edge_ok = (det2 > 0.0f) && (tr * tr * et < et1sq * det2);
    const bool cok = contrast * flayers >= cthr;

    // Packing (ops/records.pack_record_channels); rintf rounds half to
    // even like torch.round / jnp.round.  Every term is an exact integer
    // in f32 and A < 2^24.
    const float a = (conv ? 1.0f : 0.0f) + (div ? 2.0f : 0.0f)
                  + (edge_ok ? 4.0f : 0.0f) + (peak ? 8.0f : 0.0f)
                  + (cok ? 16.0f : 0.0f)
                  + 32.0f * (clipf(rintf(x0), -32.0f, 31.0f) + 32.0f)
                  + 2048.0f * (clipf(rintf(x1), -32.0f, 31.0f) + 32.0f)
                  + 131072.0f * (clipf(rintf(x2), -8.0f, 7.0f) + 8.0f);
    const float qx0 = clipf(rintf((x0 + 0.5f) * 2000.0f), 0.0f, 2047.0f);
    const float qx1 = clipf(rintf((x1 + 0.5f) * 2000.0f), 0.0f, 2047.0f);
    const float qx2 = clipf(rintf((x2 + 0.5f) * 1000.0f), 0.0f, 1023.0f);
    const float qc = clipf(rintf(contrast * 8191.0f), 0.0f, 8191.0f);

    const size_t o = (size_t)(lr - 1) * plane + (size_t)y * w + x;
    out[o] = a;
    out[(size_t)nrec * plane + o] = qx0 + 2048.0f * qx1;
    out[2 * (size_t)nrec * plane + o] = qx2 + 1024.0f * qc;
  }
}

// g: [nl, h, w] f32; out: [3, nl-3, h, w] f32.  Launches on ``stream``,
// does not synchronise, allocates nothing; returns cudaGetLastError().
SIFT_API int sift_detect_records(const void* g, void* out, int nl, int h,
                                 int w, float threshold, int border,
                                 float et, float et1sq, float cthr,
                                 float flayers, void* stream) {
  dim3 block(BX, BY);
  dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY);
  detect_records_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)g, (float*)out, nl, h, w, threshold, border, et, et1sq,
      cthr, flayers);
  return (int)cudaGetLastError();
}
