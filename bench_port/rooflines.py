"""Operations, bytes and peaks behind the benchmark's roofline shares.

A roofline share is the least time the card could take for a call (the
larger of its bytes over the memory bandwidth and its operations over the
peak rate) divided by the device time the call took.  Bytes count each
input byte read once and each output byte written once; operations count
what the function needs for these inputs (live keypoints, their actual
window extents), not what one implementation happens to recompute.

The detector kernels' counts are those of the port's proof script
(``chip_smoke.py``: ``check_detect``, ``check_expand``, ``window_work``,
``grid_pixels``, ``stage_bytes`` and the per-pixel operation counts),
copied here so that the yardstick does not move with the program.  The
matcher's operations are taken at the int8 tensor-core peak: the Gram
product of uint8 descriptors is exact in int8 with int32 accumulation
(128 * 255^2 < 2^31), so no exact implementation can beat that rate.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, 700 W).
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12         # int8 tensor cores, dense

DETECT_OPS_PER_RECORD = 250     # per pixel and record layer
DESC_OPS_PER_MASKED_PIXEL = 22  # offsets, masks, rotation, 4x4-grid test
DESC_OPS_PER_GRID_PIXEL = 106   # gradient, atan2, weights, bins, hats, sums
DESCRIPTOR_DIM = 128


def bound_s(bytes_: float, ops: float, peak_ops: float) -> float:
    """The least time in seconds: bytes at the bandwidth or operations at
    ``peak_ops``, whichever is larger."""
    return max(bytes_ / PEAK_BYTES_PER_S, ops / peak_ops)


def detect_records_bytes(octave_shapes, layers: int) -> int:
    """K1 over a whole pyramid: each octave's ``layers`` Gaussian layers
    read once and its three record planes of ``layers - 3`` DoG layers
    written once, float32.  ``octave_shapes``: the content (h, w) of each
    octave."""
    pix = sum(h * w for h, w in octave_shapes)
    return (layers + 3 * (layers - 3)) * pix * 4


def detect_records_ops(octave_shapes, layers: int) -> int:
    pix = sum(h * w for h, w in octave_shapes)
    return DETECT_OPS_PER_RECORD * (layers - 3) * pix


def expand_bytes(base_numel: int, copies: int) -> int:
    """K5: the base slab read once and ``copies`` shifted copies written."""
    return (1 + copies) * base_numel * 4


def window_work(par, rows, lanes, count):
    """Per-axis pixel counts of the live keypoints' masked windows,
    exactly as the kernels bound their loops."""
    p = par[:count]
    ylo = torch.maximum(p[:, 2], -p[:, 7])
    yhi = torch.minimum(p[:, 3], p[:, 7])
    xlo = torch.maximum(p[:, 4], -p[:, 7])
    xhi = torch.minimum(p[:, 5], p[:, 7])
    i_lo = torch.clamp(torch.ceil(ylo - p[:, 0]), min=1)
    i_hi = torch.clamp(torch.floor(yhi - p[:, 0]), max=rows - 2)
    p_lo = torch.clamp(torch.ceil(xlo - p[:, 1]), min=1)
    p_hi = torch.clamp(torch.floor(xhi - p[:, 1]), max=lanes - 2)
    live = p[:, 8] > 0
    nrow = torch.clamp(i_hi - i_lo + 1, min=0) * live
    ncol = torch.clamp(p_hi - p_lo + 1, min=0) * live
    return nrow, ncol, (i_lo, i_hi, p_lo, p_hi)


def grid_pixels(par, rows, lanes, count, chunk=512):
    """Pixels of the live keypoints that fall inside the rotated 4x4
    descriptor grid (the ones that reach the histogram)."""
    dev = par.device
    ri = torch.arange(rows, device=dev, dtype=torch.float32)
    li = torch.arange(lanes, device=dev, dtype=torch.float32)
    _, _, (i_lo, i_hi, p_lo, p_hi) = window_work(par, rows, lanes, count)
    total = 0
    for s in range(0, count, chunk):
        p = par[s:min(s + chunk, count)]
        sl = slice(s, min(s + chunk, count))
        oy = (p[:, 0:1] + ri)[:, :, None]
        ox = (p[:, 1:2] + li)[:, None, :]
        my = ((ri >= i_lo[sl, None]) & (ri <= i_hi[sl, None]))[:, :, None]
        mx = ((li >= p_lo[sl, None]) & (li <= p_hi[sl, None]))[:, None, :]
        c, sn = p[:, 9, None, None], p[:, 10, None, None]
        rbin = ox * sn + oy * c + 1.5
        cbin = ox * c - oy * sn + 1.5
        inb = (rbin > -1) & (rbin < 4) & (cbin > -1) & (cbin < 4)
        total += int((inb & my & mx & (p[:, 8] > 0)[:, None, None]).sum())
    return total


def stage_bytes(values_numel, par, nrow, ncol, count, nbins):
    """Bytes the live keypoints need: their windows (with the 1-px
    gradient halo, at most the ``values_numel`` pixels they are read
    from), their parameter rows and origins, and their output rows."""
    win = float(((nrow + 2) * (ncol + 2)).sum()) * 4
    return (min(win, values_numel * 4)
            + count * (par.shape[1] + 2) * 4 + count * nbins * 4 + 8)


def descriptor_rows(x, y, octave, size, angle, valid, shapes):
    """Parameter rows of the live keypoints' descriptor windows in the
    layout ``window_work`` and ``grid_pixels`` read (the proof script's):
    window origin offsets, the interior bounds of the keypoint's octave,
    the Gaussian weight's exponent, the radius, liveness, the rotation
    over the cell width, the angle; from the keypoints alone (x, y, size
    in image pixels, angle in degrees, octave; ``shapes`` the octaves'
    (h, w)), as SIFT's descriptor defines its window.  Returns (par [n,
    13], rows = lanes of a window that holds every patch, n)."""
    live = valid.to(torch.bool)
    o = octave[live].to(torch.int64)
    inv = torch.exp2(-o.to(torch.float32))
    px = torch.round(x[live] * inv)
    py = torch.round(y[live] * inv)
    hw = 3.0 * size[live] * 0.5 * inv
    ang = 360.0 - angle[live]
    ang = torch.where((ang - 360.0).abs() < 1e-6, torch.zeros_like(ang), ang)
    hwf = torch.as_tensor(shapes, dtype=torch.float32, device=x.device)[o]
    h, w = hwf[:, 0], hwf[:, 1]
    radius = torch.minimum(torch.round(hw * (2.0 ** 0.5) * 2.5),
                           torch.sqrt(h * h + w * w))
    n = int(live.sum())
    rmax = int(radius.max()) if n else 0
    org = torch.full_like(px, -(rmax + 1.0))
    a = torch.deg2rad(ang)
    par = torch.stack([
        org, org, 1.0 - py, h - 2.0 - py, 1.0 - px, w - 2.0 - px,
        -1.0 / (hw * hw * 8.0), radius, torch.ones_like(px),
        torch.cos(a) / hw, torch.sin(a) / hw, ang, torch.zeros_like(px)],
        dim=1)
    return par, 2 * rmax + 3, n


def descriptor_hist_work(values_numel, par, rows, lanes, count):
    """(bytes, operations) of K3 for one frame's live keypoints."""
    nrow, ncol, _ = window_work(par, rows, lanes, count)
    masked = int((nrow * ncol).sum())
    in_grid = grid_pixels(par, rows, lanes, count)
    return (stage_bytes(values_numel, par, nrow, ncol, count,
                        DESCRIPTOR_DIM),
            DESC_OPS_PER_MASKED_PIXEL * masked
            + DESC_OPS_PER_GRID_PIXEL * in_grid)


def match_work(pairs: int, queries: int, train: int, query_sets=None):
    """(bytes, operations) of one matcher call over ``pairs`` pairs of
    ``queries`` uint8 descriptors against ``train`` ones, at capacity (the
    matcher's contract computes every row): ``query_sets`` query sets
    (default one a pair; one where a frame is matched against a window),
    ``pairs`` train sets and their masks read once, the int32 indices
    written once; two operations per multiply-add of the Gram product."""
    qsets = pairs if query_sets is None else query_sets
    row = DESCRIPTOR_DIM + 1                     # a descriptor and its mask
    bytes_ = (qsets * queries + pairs * train) * row + pairs * queries * 4
    ops = pairs * 2 * queries * train * DESCRIPTOR_DIM
    return bytes_, ops
