"""128-D SIFT descriptor extraction.

Counterpart of ``sift_tpu/ops/descriptor.py``: rotated 4x4 spatial x 8
orientation grid, trilinear interpolation, L2-normalise -> clip at
0.2*norm -> renormalise -> scale (the capability of the reference's
``genDescriptorMultiThread``, SiftOps.cu:453-623).  The histogram has two
forms.  ``compute_descriptors_fused`` is one kernel launch over keypoints
of ALL octaves and ALL radii (kernels/fused_stages.descriptor_hist): the
JAX package's three radius classes exist for the TPU's lane packing and
have no counterpart here.  ``compute_descriptors_flat`` is the non-fused
form on a packed dense-gradient pyramid (one aligned window copy per
keypoint, then the trilinear scatter-with-fold as hat-function products

    desc[k, R, C, o] = sum_p mag_p * hat(rbin_p + 1 - R) * hat(cbin_p + 1 - C)
                             * circular_hat_8(obin_p - o),

hat(t) = max(0, 1 - |t|), contracted over pixels by batched matrix
products); the golden replay stages and large patch radii use it.

Output quantisations:
* "opencv"    — saturate_cast<uchar>(v * 512/norm): rounded, clamped to 255
                (what cv2.SIFT produces; the parity-gate mode);
* "reference" — clamp(v/norm, 0, 1) * 512 unrounded (SiftOps.cu:606-622).
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import (SIFT_DESCR_HIST_BINS, SIFT_DESCR_SCL_FCTR,
                                   SIFT_DESCR_WIDTH, SIFT_INT_DESCR_FCTR,
                                   SiftConfig)
from sift_tpu_torch.kernels.fused_stages import descriptor_hist
from sift_tpu_torch.kernels.window_gather import window_rows
from sift_tpu_torch.ops.flatpyr import (PaddedPyramid, StackedPyramid,
                                         dense_gradients_packed,
                                         keypoint_window_packed, pad_pyramid,
                                         stacked_origins, window_lanes)

_D = SIFT_DESCR_WIDTH        # 4 spatial cells per side
_NB = SIFT_DESCR_HIST_BINS   # 8 orientation bins


def max_descr_radius(cfg: SiftConfig) -> int:
    """Static window-radius bound: hist_width = 3 * scl_octv with
    scl_octv <= sigma * 2^((L+0.5)/L); radius = round(hw * sqrt2 * 2.5)."""
    scl_max = cfg.sigma * 2.0 ** ((cfg.num_octave_layers + 0.5)
                                  / cfg.num_octave_layers)
    hw = SIFT_DESCR_SCL_FCTR * scl_max
    return int(round(hw * math.sqrt(2.0) * (_D + 1) * 0.5))


def _hat(t):
    return torch.clamp(1.0 - t.abs(), min=0.0)


def compute_descriptors_flat(grad: PaddedPyramid, octave, x, y, layer, size,
                             angle, valid, cfg: SiftConfig,
                             chunk: int = 512):
    """One global pass over keypoints of every octave.

    grad: PACKED dense gradient pyramid; octave [K] int32; x/y/size in
    base-image space; angle in degrees.

    Returns (desc [K, 128] float32 pre-quantisation, nrm2 [K, 1]); invalid
    slots are zero.  Keypoints are processed ``chunk`` at a time to bound
    the [chunk, rows*lanes, 8] operands."""
    inv = torch.exp2(-octave.to(torch.float32))
    px = torch.round(x * inv).to(torch.int32)
    py = torch.round(y * inv).to(torch.int32)
    scl = size * 0.5 * inv
    ang = 360.0 - angle
    ang = torch.where((ang - 360.0).abs() < 1e-6, torch.zeros_like(ang),
                      ang)

    rmax = max_descr_radius(cfg)
    k = x.shape[0]
    hists = [_descriptor_hist(grad, *(a[s:s + chunk] for a in
                                      (octave, px, py, layer, scl, ang,
                                       valid)),
                              rmax, cfg.kernel_impl)
             for s in range(0, k, chunk)]
    hist = torch.cat(hists, dim=0) if hists else torch.zeros(
        (0, _D, _D, _NB), dtype=torch.float32, device=x.device)
    return finalize_descriptor(hist)


def _descriptor_hist(grad, octave, px, py, layer, scl, ang, valid, rmax,
                     impl):
    """[Kc, D, D, NB] histogram via hat-function products contracted over
    the window's pixels."""
    hist_width = SIFT_DESCR_SCL_FCTR * scl
    arad = ang * (math.pi / 180.0)
    inv_hw = 1.0 / torch.clamp(hist_width, min=1e-12)
    cos_t = torch.cos(arad) * inv_hw
    sin_t = torch.sin(arad) * inv_hw

    h, w = grad.octave_geometry(octave)
    diag = torch.sqrt((h * h + w * w).to(torch.float32))
    radius = torch.minimum(
        torch.round(hist_width * math.sqrt(2.0) * (_D + 1) * 0.5), diag)

    m_p, o_p, offy, offx = keypoint_window_packed(
        grad, octave, layer, py, px, rmax, impl)
    offyf = offy.to(torch.float32)                       # [Kc, rows]
    offxf = offx.to(torch.float32)                       # [Kc, lanes]
    ii = offyf[:, :, None]                               # rows
    jj = offxf[:, None, :]                               # cols

    c_rot = jj * cos_t[:, None, None] - ii * sin_t[:, None, None]
    r_rot = jj * sin_t[:, None, None] + ii * cos_t[:, None, None]
    rbin = r_rot + (_D / 2 - 0.5)
    cbin = c_rot + (_D / 2 - 0.5)

    # Separable window: image-bounds/radius masks per axis, and the
    # Gaussian weight exp(-(c_rot^2 + r_rot^2)/(0.5 D^2)) equals
    # exp(-(i^2 + j^2) inv_hw^2 / (0.5 D^2)) — rotation preserves norm.
    pyy = py[:, None] + offy
    pxx = px[:, None] + offx
    in_y = (pyy > 0) & (pyy < (h - 1)[:, None])
    in_x = (pxx > 0) & (pxx < (w - 1)[:, None])
    rad = radius[:, None]
    es = (inv_hw * inv_hw * (-1.0 / (_D * _D * 0.5)))[:, None]
    wy = torch.exp(offyf ** 2 * es) \
        * (in_y & (offyf.abs() <= rad)).to(torch.float32)
    wx = torch.exp(offxf ** 2 * es) \
        * (in_x & (offxf.abs() <= rad)).to(torch.float32)
    wgt = wy[:, :, None] * wx[:, None, :] \
        * valid.to(torch.float32)[:, None, None]

    m = (rbin > -1) & (rbin < _D) & (cbin > -1) & (cbin < _D)
    mag_w = torch.where(m, m_p * wgt, torch.zeros_like(m_p))  # [Kc, S, S]

    obin = (o_p - ang[:, None, None]) * (_NB / 360.0)
    ob = torch.remainder(obin, float(_NB))                # [0, 8)

    # Separable hat tensors, contracted over pixels.  The row cell is
    # taken one at a time, so the largest operand is [Kc, P, 8], not the
    # [Kc, P, 16] row x column product.
    kc = px.shape[0]
    p = m_p.shape[1] * m_p.shape[2]
    dev = m_p.device
    cells = torch.arange(1, _D + 1, dtype=torch.float32, device=dev)
    hr = _hat(rbin.reshape(kc, p)[:, :, None] + 1.0 - cells)   # [Kc, P, 4]
    hc = _hat(cbin.reshape(kc, p)[:, :, None] + 1.0 - cells)   # [Kc, P, 4]
    od = (ob.reshape(kc, p)[:, :, None]
          - torch.arange(_NB, dtype=torch.float32, device=dev)).abs()
    wo = torch.clamp(1.0 - torch.minimum(od, float(_NB) - od), min=0.0)
    wo = wo * mag_w.reshape(kc, p)[:, :, None]                 # [Kc, P, 8]
    hct = hc.transpose(1, 2)                                   # [Kc, 4, P]
    return torch.stack(
        [torch.bmm(hct, wo * hr[:, :, r, None]) for r in range(_D)],
        dim=1)                                                 # [Kc,D,D,NB]


def compute_descriptors(block: torch.Tensor, x, y, layer, size, angle, valid,
                        octave: int, cfg: SiftConfig, chunk: int = 512):
    """Single-octave wrapper (the golden-replay stage): block [D, H, W]
    Gaussian stack of this octave; x/y/size in base-image space."""
    grad = dense_gradients_packed(pad_pyramid([block]))
    oct_arr = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    inv = 1.0 / float(1 << octave)
    return compute_descriptors_flat(grad, oct_arr, x * inv, y * inv, layer,
                                    size * inv, angle, valid, cfg, chunk)


def descriptor_params(slab: StackedPyramid, octave, x, y, layer, size,
                      angle, valid, cfg: SiftConfig):
    """Window origins and the per-keypoint parameter rows of the
    descriptor kernel.  Returns (ys0, xs0, par [K, 13], rows, lanes)."""
    inv = torch.exp2(-octave.to(torch.float32))
    px = torch.round(x * inv).to(torch.int32)
    py = torch.round(y * inv).to(torch.int32)
    scl = size * 0.5 * inv
    ang = 360.0 - angle
    ang = torch.where((ang - 360.0).abs() < 1e-6, torch.zeros_like(ang),
                      ang)

    hist_width = SIFT_DESCR_SCL_FCTR * scl
    arad = ang * (math.pi / 180.0)
    inv_hw = 1.0 / torch.clamp(hist_width, min=1e-12)
    cos_t = torch.cos(arad) * inv_hw
    sin_t = torch.sin(arad) * inv_hw
    es = inv_hw * inv_hw * (-1.0 / (_D * _D * 0.5))

    rmax = max_descr_radius(cfg)
    rows = window_rows(rmax)
    h, w = slab.octave_geometry(octave)
    diag = torch.sqrt((h * h + w * w).to(torch.float32))
    radius = torch.minimum(
        torch.round(hist_width * math.sqrt(2.0) * (_D + 1) * 0.5), diag)
    ys0, xs0, off, dy0, dx0 = stacked_origins(
        slab, octave, layer, py, px, torch.clamp(radius, max=float(rmax)))
    hf = h.to(torch.float32)
    wf = w.to(torch.float32)
    pyf = py.to(torch.float32)
    pxf = px.to(torch.float32)

    par = torch.stack([
        dy0.to(torch.float32), dx0.to(torch.float32),
        1.0 - pyf, hf - 2.0 - pyf, 1.0 - pxf, wf - 2.0 - pxf,
        es, radius, valid.to(torch.float32),
        cos_t, sin_t, ang, off.to(torch.float32)], dim=1)
    return ys0, xs0, par, rows, window_lanes(slab.copies, rmax)


def compute_descriptors_fused(slab: StackedPyramid, octave, x, y, layer,
                              size, angle, valid, cfg: SiftConfig,
                              count=None, impl: str = "auto"):
    """Descriptors of keypoints from every octave in ONE kernel launch.
    ``slab``: row-stacked RAW Gaussian pyramid; octave [K] int32; x/y/size
    in base-image space; angle in degrees; ``count``: live keypoint count
    (valid-first order), a device scalar.

    Returns (desc [K, 128] float32 pre-quantisation, nrm2 [K, 1]); invalid
    slots are zero."""
    ys0, xs0, par, rows, lanes = descriptor_params(
        slab, octave, x, y, layer, size, angle, valid, cfg)
    hist = descriptor_hist(slab.values, ys0, xs0, par, rows, lanes,
                           count=count, impl=impl)
    hist = torch.where(valid[:, None], hist, torch.zeros_like(hist))
    return finalize_descriptor(hist)


def finalize_descriptor(hist: torch.Tensor):
    """hist [K, 128] (or [K, D, D, NB]) -> (desc [K, 128], nrm2 [K, 1])
    (SiftOps.cu:606-616): L2-norm, clip at 0.2*norm, renorm factor."""
    k = hist.shape[0]
    desc = hist.reshape(k, _D * _D * _NB)
    nrm = torch.sqrt(torch.sum(desc * desc, -1, keepdim=True))
    desc = torch.minimum(desc, nrm * 0.2)
    nrm2 = torch.sqrt(torch.sum(desc * desc, -1, keepdim=True))
    return desc, nrm2


def quantize_descriptor(desc, nrm2, mode: str = "opencv"):
    if mode == "opencv":
        # saturate_cast<uchar>(v * 512 / max(norm, FLT_EPSILON))
        scale = SIFT_INT_DESCR_FCTR / torch.clamp(nrm2, min=1.192092896e-07)
        return torch.clamp(torch.round(desc * scale), 0.0, 255.0)
    # reference: __saturatef(v / max(norm, 1e-7)) * 512 (SiftOps.cu:617-622)
    scale = 1.0 / torch.clamp(nrm2, min=1e-7)
    return torch.clamp(desc * scale, 0.0, 1.0) * SIFT_INT_DESCR_FCTR
