"""Orientation assignment — 36-bin gradient histograms + peak expansion.

Counterpart of ``sift_tpu/ops/orientation.py``: Gaussian-weighted
gradient-orientation histogram over a square window, (6,4,1)/16 circular
smoothing, and one emitted keypoint per local max >= 0.8 * peak (the
capability of the reference's ``calOriHistMultiThread``,
SiftOps.cu:237-376).  The histogram has two forms: the per-keypoint kernel
on the raw slab (``orientation_histograms_fused``,
kernels/fused_stages.orientation_hist) and the non-fused one on dense
precomputed gradients (``orientation_histograms_flat``: one aligned window
copy per keypoint, separable Gaussian weights, the bin scatter as a one-hot
batched matrix product — deterministic, no atomics), which the golden
replay stages and large patch radii use.

As in the JAX package (both gated on OpenCV): gradients default to the
Gaussian block, histogram bin = round(ori * 36/360), and peaks are
parabolically interpolated when ``config.interpolate_orientation``.
"""

from __future__ import annotations

import torch

from sift_tpu_torch.config import (SIFT_ORI_HIST_BINS, SIFT_ORI_PEAK_RATIO,
                                   SIFT_ORI_RADIUS, SIFT_ORI_SIG_FCTR,
                                   SiftConfig)
from sift_tpu_torch.kernels.fused_stages import orientation_hist
from sift_tpu_torch.kernels.window_gather import window_rows
from sift_tpu_torch.ops.flatpyr import (PaddedPyramid, StackedPyramid,
                                         dense_gradients_padded,
                                         keypoint_window_pair, pad_pyramid,
                                         stacked_origins, window_lanes)

_NB = SIFT_ORI_HIST_BINS
_ONEHOT_ROWS = 256   # keypoints per one-hot contraction (memory bound)


def max_ori_radius(cfg: SiftConfig) -> int:
    """Static bound on the orientation window radius: scl_octv <=
    sigma * 2^((L + 0.5)/L) (layer <= L, |xi| <= 0.5)."""
    scl_max = cfg.sigma * 2.0 ** ((cfg.num_octave_layers + 0.5)
                                  / cfg.num_octave_layers)
    return int(round(SIFT_ORI_RADIUS * scl_max))


def orientation_histograms_flat(mag: PaddedPyramid, ori: PaddedPyramid,
                                octave, x, y, layer, size, valid,
                                cfg: SiftConfig,
                                chunk: int = 1024) -> torch.Tensor:
    """One global pass over keypoints of every octave.

    mag/ori: FULL-PRECISION dense gradient pyramids (the 1-degree angle
    parity gate is sensitive to histogram perturbations; the packed slab
    is reserved for the descriptor stage).  octave: [K] int32 per
    keypoint; x/y/size in base-image space.  Returns raw histograms
    [K, 36].  Keypoints are processed ``chunk`` at a time to bound the
    one-hot operand ([chunk, rows*lanes, 36] float32)."""
    inv = torch.exp2(-octave.to(torch.float32))
    px = torch.round(x * inv).to(torch.int32)
    py = torch.round(y * inv).to(torch.int32)
    scl_octv = size * 0.5 * inv
    sigma_ori = SIFT_ORI_SIG_FCTR * scl_octv
    radius = torch.round(SIFT_ORI_RADIUS * scl_octv)

    rmax = max_ori_radius(cfg)
    k = x.shape[0]
    hists = [_hist_chunk(mag, ori, *(a[s:s + chunk] for a in
                                     (octave, px, py, layer, sigma_ori,
                                      radius, valid)),
                         rmax, cfg.kernel_impl)
             for s in range(0, k, chunk)]
    if not hists:
        return torch.zeros((0, _NB), dtype=torch.float32, device=x.device)
    return torch.cat(hists, dim=0)


def _hist_chunk(mag, ori, octave, px, py, layer, sigma_ori, radius, valid,
                rmax, impl):
    m_p, o_p, offy, offx = keypoint_window_pair(
        mag, ori, octave, layer, py, px, rmax, impl)
    offyf = offy.to(torch.float32)                      # [K, rows]
    offxf = offx.to(torch.float32)                      # [K, lanes]

    h, w = mag.octave_geometry(octave)
    pyy = py[:, None] + offy
    pxx = px[:, None] + offx
    in_y = (pyy >= 1) & (pyy <= (h - 2)[:, None])
    in_x = (pxx >= 1) & (pxx <= (w - 2)[:, None])
    rad = radius[:, None]
    # Separable Gaussian weights: exp(-(i^2 + j^2) es) = wy_i * wx_j.
    es = (-0.5 / torch.clamp(sigma_ori * sigma_ori, min=1e-12))[:, None]
    wy = torch.exp(offyf ** 2 * es) \
        * (in_y & (offyf.abs() <= rad)).to(torch.float32)
    wx = torch.exp(offxf ** 2 * es) \
        * (in_x & (offxf.abs() <= rad)).to(torch.float32)
    wgt = wy[:, :, None] * wx[:, None, :] \
        * valid.to(torch.float32)[:, None, None]

    contrib = wgt * m_p                                 # [K, rows, lanes]
    b = torch.round(o_p * (_NB / 360.0)).to(torch.int32)
    b = torch.where(b >= _NB, b - _NB, b)
    b = torch.where(b < 0, b + _NB, b)

    # One-hot contraction as a batched matrix product instead of a
    # scatter: the sum order is fixed, so the result is deterministic.
    # _ONEHOT_ROWS keypoints at a time: the [rows, P, 36] operand is the
    # stage's largest temporary.
    kc = px.shape[0]
    p = m_p.shape[1] * m_p.shape[2]
    bins = torch.arange(_NB, dtype=torch.int32, device=b.device)
    b = b.reshape(kc, p)
    contrib = contrib.reshape(kc, 1, p)
    return torch.cat([
        torch.bmm(contrib[s:s + _ONEHOT_ROWS],
                  (b[s:s + _ONEHOT_ROWS, :, None] == bins)
                  .to(torch.float32))[:, 0, :]
        for s in range(0, kc, _ONEHOT_ROWS)])                  # [Kc, 36]


def orientation_histograms(block: torch.Tensor, x, y, layer, size, valid,
                           octave: int, cfg: SiftConfig) -> torch.Tensor:
    """Single-octave wrapper (the golden-replay stage): block [D, H, W]
    source stack; octave is this block's pyramid octave index."""
    mag, ori = dense_gradients_padded(pad_pyramid([block]))
    # base-image -> this octave's scale uses 2^octave, but the padded
    # pyramid has a single block at index 0; pre-scale coordinates.
    oct_arr = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    inv = 1.0 / float(1 << octave)
    return orientation_histograms_flat(
        mag, ori, oct_arr, x * inv, y * inv, layer, size * inv, valid, cfg)


def orientation_params(slab: StackedPyramid, octave, x, y, layer, size,
                       valid, cfg: SiftConfig):
    """Window origins and the per-keypoint parameter rows of the
    orientation kernel.  Returns (ys0, xs0, par [K, 13], rows, lanes)."""
    inv = torch.exp2(-octave.to(torch.float32))
    px = torch.round(x * inv).to(torch.int32)
    py = torch.round(y * inv).to(torch.int32)
    scl_octv = size * 0.5 * inv
    sigma_ori = SIFT_ORI_SIG_FCTR * scl_octv
    radius = torch.round(SIFT_ORI_RADIUS * scl_octv)

    rmax = max_ori_radius(cfg)
    rows = window_rows(rmax)
    ys0, xs0, off, dy0, dx0 = stacked_origins(
        slab, octave, layer, py, px, torch.clamp(radius, max=float(rmax)))
    h, w = slab.octave_geometry(octave)
    hf = h.to(torch.float32)
    wf = w.to(torch.float32)
    pyf = py.to(torch.float32)
    pxf = px.to(torch.float32)
    es = -0.5 / torch.clamp(sigma_ori * sigma_ori, min=1e-12)

    zero = torch.zeros_like(es)
    par = torch.stack([
        dy0.to(torch.float32), dx0.to(torch.float32),
        1.0 - pyf, hf - 2.0 - pyf, 1.0 - pxf, wf - 2.0 - pxf,
        es, radius, valid.to(torch.float32),
        zero, zero, zero, off.to(torch.float32)], dim=1)
    return ys0, xs0, par, rows, window_lanes(slab.copies, rmax)


def orientation_histograms_fused(slab: StackedPyramid, octave, x, y, layer,
                                 size, valid, cfg: SiftConfig, count=None,
                                 impl: str = "auto") -> torch.Tensor:
    """Raw [K, 36] histograms of keypoints from every octave in ONE kernel
    launch.  ``slab``: row-stacked RAW pyramid (ops/flatpyr.stack_pyramid,
    extra_rows >= this stage's window rows) — Gaussian by default, the DoG
    stack for orientation_source="dog".  octave: [K] int32; x/y/size in
    base-image space.  ``count``: live keypoint count (valid-first order),
    a device scalar; rows past it are zero."""
    ys0, xs0, par, rows, lanes = orientation_params(
        slab, octave, x, y, layer, size, valid, cfg)
    return orientation_hist(slab.values, ys0, xs0, par, rows, lanes,
                            count=count, impl=impl)


def smooth_histogram(hist: torch.Tensor) -> torch.Tensor:
    """(6 h[i] + 4 (h[i-1] + h[i+1]) + h[i-2] + h[i+2]) / 16, circular
    (SiftOps.cu:329-336)."""
    r1 = torch.roll(hist, 1, -1)
    l1 = torch.roll(hist, -1, -1)
    r2 = torch.roll(hist, 2, -1)
    l2 = torch.roll(hist, -2, -1)
    return (6.0 * hist + 4.0 * (r1 + l1) + r2 + l2) / 16.0


def orientation_peaks(hist: torch.Tensor, valid, cfg: SiftConfig):
    """Returns (angles [K, 36], peak_mask [K, 36]): one candidate orientation
    per histogram bin that is a strict local max >= 0.8 * global max
    (SiftOps.cu:338-373)."""
    sm = smooth_histogram(hist)
    left = torch.roll(sm, 1, -1)
    right = torch.roll(sm, -1, -1)
    peak = (sm > left) & (sm > right) \
        & (sm >= SIFT_ORI_PEAK_RATIO * sm.max(-1, keepdim=True).values) \
        & valid[:, None]

    bins = torch.arange(_NB, dtype=torch.float32, device=hist.device)[None, :]
    if cfg.interpolate_orientation:
        denom = left - 2.0 * sm + right
        denom = torch.where(denom.abs() < 1e-20,
                            torch.full_like(denom, 1e-20), denom)
        fb = bins + 0.5 * (left - right) / denom
        fb = torch.where(fb < 0, fb + _NB,
                         torch.where(fb >= _NB, fb - _NB, fb))
    else:
        fb = bins.expand_as(sm)
    angle = 360.0 - fb * (360.0 / _NB)
    angle = torch.where((angle - 360.0).abs() < 1.192092896e-07,
                        torch.zeros_like(angle), angle)
    return angle, peak
