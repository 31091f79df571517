"""Dense Newton records: the 3-D quadratic solve for every DoG pixel, and
the walk of candidates over a stacked record field.

Counterpart of ``sift_tpu/ops/refine_dense.py``: the capability of the
reference's ``adjustExtrema`` (SiftOps.cu:63-208) — 1/255-scaled
derivatives, a vectorised Cramer solve of the 3x3 system, convergence /
divergence flags, contrast, and the Hessian edge test — for the whole
volume at once.  ``record_fields`` is the arithmetic of the plain version
of the record-field kernel (kernels/fused_detect.py), written expression
for expression like the kernel so the two decide alike.

``refine_keypoints_dense`` (one octave: the golden-replay stage) and
``refine_keypoints_dense_all`` (all octaves in one walk) stack the five
channels channel-last, ``[D-2, H, W, 5]``, optionally in bfloat16
(``SiftConfig.refine_record_dtype``: flags are small integers and stay
exact, sub-pixel offsets carry <= 2^-9 relative error), and walk the
candidates over it: up to 5 Newton steps, one record row gathered per
candidate and step, then the contrast and edge tests at the final
position.  The detector's default path walks the packed plane-layout
field instead (ops/records.py); both clamp steps alike and agree bit for
bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sift_tpu_torch.config import (SIFT_IMG_BORDER, SIFT_MAX_INTERP_STEPS,
                                   SiftConfig)
from sift_tpu_torch.ops.peaks import clamp_pad

_IMG_SCALE = 1.0 / 255.0
_DERIV_SCALE = _IMG_SCALE * 0.5
_SECOND_DERIV_SCALE = _IMG_SCALE
_CROSS_DERIV_SCALE = _IMG_SCALE * 0.25


class RefinedKeypoints(NamedTuple):
    x: torch.Tensor         # base-image-space x (float)
    y: torch.Tensor
    layer: torch.Tensor     # final integer layer (1..L)
    xi: torch.Tensor        # sub-pixel layer offset (OpenCV's xi)
    size: torch.Tensor      # base-image-space diameter
    response: torch.Tensor  # |contrast|
    valid: torch.Tensor


def record_fields(dog: torch.Tensor, edge_threshold: float,
                  dogp: torch.Tensor = None):
    """dog [D, H, W] -> five [D-2, H, W] record channels
    (x0, x1, x2, |contrast|, flags) for layers 1..D-2, flags =
    conv | div<<1 | edge_ok<<2.  Neighbours outside the image are the
    nearest edge pixel (rim records are garbage by contract either way:
    the walk never consults them for live candidates)."""
    d, h, w = dog.shape
    if dogp is None:
        dogp = clamp_pad(dog)

    def sh(dl, dr, dc):
        return dogp[1 + dl:d - 1 + dl, 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    v = dog[1:d - 1]
    dx = (sh(0, 0, 1) - sh(0, 0, -1)) * _DERIV_SCALE
    dy = (sh(0, 1, 0) - sh(0, -1, 0)) * _DERIV_SCALE
    ds = (sh(1, 0, 0) - sh(-1, 0, 0)) * _DERIV_SCALE
    v2 = v * 2.0
    dxx = (sh(0, 0, 1) + sh(0, 0, -1) - v2) * _SECOND_DERIV_SCALE
    dyy = (sh(0, 1, 0) + sh(0, -1, 0) - v2) * _SECOND_DERIV_SCALE
    dss = (sh(1, 0, 0) + sh(-1, 0, 0) - v2) * _SECOND_DERIV_SCALE
    dxy = (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1)) \
        * _CROSS_DERIV_SCALE
    dxs = (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1)) \
        * _CROSS_DERIV_SCALE
    dys = (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0)) \
        * _CROSS_DERIV_SCALE

    # Cramer solve of A x = dD (A = Hessian), vectorised per pixel.
    det = (dxx * (dyy * dss - dys * dys)
           - dxy * (dxy * dss - dys * dxs)
           + dxs * (dxy * dys - dyy * dxs))
    ok = det.abs() > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    x0 = (dx * (dyy * dss - dys * dys)
          - dxy * (dy * dss - dys * ds)
          + dxs * (dy * dys - dyy * ds)) / safe
    x1 = (dxx * (dy * dss - dys * ds)
          - dx * (dxy * dss - dys * dxs)
          + dxs * (dxy * ds - dy * dxs)) / safe
    x2 = (dxx * (dyy * ds - dy * dys)
          - dxy * (dxy * ds - dy * dxs)
          + dx * (dxy * dys - dyy * dxs)) / safe

    conv = (x0.abs() < 0.5) & (x1.abs() < 0.5) & (x2.abs() < 0.5) & ok
    div = (x0.abs() > w) | (x1.abs() > h) | (x2.abs() > 100.0) | ~ok

    contrast = v * _IMG_SCALE - (dx * x0 + dy * x1 + ds * x2) * 0.5
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    et = float(edge_threshold)
    edge_ok = (det2 > 0) & (tr * tr * et < (et + 1.0) * (et + 1.0) * det2)

    flags = (conv.to(torch.float32) + 2.0 * div.to(torch.float32)
             + 4.0 * edge_ok.to(torch.float32))
    return x0, x1, x2, contrast.abs(), flags


def record_dtype(cfg: SiftConfig) -> torch.dtype:
    """Resolve ``cfg.refine_record_dtype``.  "auto" keeps float32 records
    below 1 MP and switches to bfloat16 at/above (the record field is the
    largest buffer of a large frame)."""
    mode = cfg.refine_record_dtype
    if mode == "auto":
        mode = ("bfloat16"
                if cfg.base_width * cfg.base_height >= (1 << 20)
                else "float32")
    return torch.bfloat16 if mode == "bfloat16" else torch.float32


def _dense_records(dog: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """record_fields stacked channel-last: [D-2, H, W, 5]."""
    return torch.stack(record_fields(dog, cfg.edge_threshold),
                       dim=-1).to(record_dtype(cfg))


def refine_keypoints_dense_all(dogs, cands, cfg: SiftConfig):
    """ALL octaves' candidates walked in ONE pass over one concatenated
    record slab, so the gather count does not depend on the octave count.

    dogs: per-octave [D, H_o, W_o] DoG stacks (same D).  cands: list of
    (cx, cy, clayer, cvalid) per octave.  Returns (RefinedKeypoints
    concatenated octave-major, octave indices [K])."""
    d = dogs[0].shape[0]
    dev = dogs[0].device
    recs, bases, hs, ws = [], [], [], []
    row = 0
    for dog in dogs:
        _, h, w = dog.shape
        recs.append(_dense_records(dog, cfg).reshape(-1, 5))
        bases.append(row)
        hs.append(h)
        ws.append(w)
        row += recs[-1].shape[0]
    rec = torch.cat(recs)

    octv = torch.cat([
        torch.full(c[0].shape, o, dtype=torch.int32, device=dev)
        for o, c in enumerate(cands)])
    cat = lambda i: torch.cat([torch.as_tensor(c[i], device=dev)
                               for c in cands])
    cx, cy, clayer, cvalid = cat(0), cat(1), cat(2), cat(3)
    o64 = octv.to(torch.int64)
    table = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)[o64]
    base, h, w = table(bases), table(hs), table(ws)

    def fetch(l, r, c):
        idx = base + ((torch.clamp(l, 1, d - 2) - 1) * h
                      + torch.minimum(torch.clamp(r, min=0), h - 1)) * w \
            + torch.minimum(torch.clamp(c, min=0), w - 1)
        return rec[idx].to(torch.float32)                       # [K, 5]

    scale = torch.exp2(octv.to(torch.float32))
    ref = _newton_walk(fetch, cx, cy, clayer, cvalid, d, h, w, scale, cfg)
    return ref, octv


def refine_keypoints_dense(dog: torch.Tensor, cx, cy, clayer, cvalid,
                           octave: int, cfg: SiftConfig) -> RefinedKeypoints:
    """Single-octave entry (the per-stage replay contract,
    perf/replay.py run_adjust_pts)."""
    d, h, w = dog.shape
    rec = _dense_records(dog, cfg).reshape(-1, 5)

    def fetch(l, r, c):
        idx = ((torch.clamp(l, 1, d - 2) - 1) * h
               + torch.clamp(r, 0, h - 1)) * w + torch.clamp(c, 0, w - 1)
        return rec[idx].to(torch.float32)                       # [K, 5]

    return _newton_walk(fetch, cx, cy, clayer, cvalid, d, h, w,
                        float(1 << octave), cfg)


def _newton_walk(fetch, cx, cy, clayer, cvalid, d, h, w, scale,
                 cfg: SiftConfig) -> RefinedKeypoints:
    """The 5-step walk + accept tests over a record fetcher.  ``h``,
    ``w``, ``scale`` may be scalars (one octave) or per-candidate tensors
    (the all-octave walk)."""
    border = SIFT_IMG_BORDER
    c = cx.to(torch.int64)
    r = cy.to(torch.int64)
    l = clayer.to(torch.int64)
    alive = cvalid.to(torch.bool)
    converged = torch.zeros_like(alive)
    x0 = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    x1 = torch.zeros_like(x0)
    x2 = torch.zeros_like(x0)
    top = lambda v, hi: torch.minimum(torch.clamp(v, min=0), hi - 1) \
        if torch.is_tensor(hi) else torch.clamp(v, 0, hi - 1)

    for _ in range(int(SIFT_MAX_INTERP_STEPS)):
        active = alive & ~converged
        rc = fetch(l, r, c)
        nx0, nx1, nx2 = rc[:, 0], rc[:, 1], rc[:, 2]
        flags = rc[:, 4]
        conv_now = torch.remainder(flags, 2.0) > 0.5
        diverged = torch.remainder(torch.floor(flags * 0.5), 2.0) > 0.5
        step = active & ~conv_now & ~diverged
        # Step clamps match the packed-record walk (ops/records.py
        # STEP_CLIP_*): spatial steps to [-32, 31], layer to [-8, 7].
        # Layer clamping is exactly equivalent (any |step| > 2 exits
        # [1, d-2] either way); spatial clamping deviates only for
        # |round(x)| > 31 — quadratic-fit steps that large are
        # divergence chases, and both walk paths must agree bit-for-bit.
        nl = l - torch.clamp(torch.round(nx2), -8, 7).to(torch.int64)
        nr = r - torch.clamp(torch.round(nx1), -32, 31).to(torch.int64)
        nc = c - torch.clamp(torch.round(nx0), -32, 31).to(torch.int64)
        oob = ((nl < 1) | (nl > d - 2)
               | (nr < border) | (nr >= h - border)
               | (nc < border) | (nc >= w - border))
        l = torch.where(step, torch.clamp(nl, 0, d - 1), l)
        r = torch.where(step, top(nr, h), r)
        c = torch.where(step, top(nc, w), c)
        x0 = torch.where(active & conv_now, nx0, x0)
        x1 = torch.where(active & conv_now, nx1, x1)
        x2 = torch.where(active & conv_now, nx2, x2)
        alive = alive & ~(active & (diverged | (step & oob)))
        converged = converged | (active & conv_now)

    ok = alive & converged
    final = fetch(l, r, c)
    contrast = final[:, 3]
    ok = ok & (contrast * cfg.num_octave_layers >= cfg.contrast_threshold)
    # edge_ok bit (bit 2), by bit arithmetic like the packed-record walk.
    ok = ok & (torch.remainder(torch.floor(final[:, 4] * 0.25), 2.0) > 0.5)

    if cfg.subpixel:
        fx = (c.to(torch.float32) - x0) * scale
        fy = (r.to(torch.float32) - x1) * scale
    else:
        fx = c.to(torch.float32) * scale
        fy = r.to(torch.float32) * scale
    xi = -x2
    size = (cfg.sigma * torch.pow(2.0, (l.to(torch.float32) + xi)
                                  / cfg.num_octave_layers) * scale * 2.0)
    return RefinedKeypoints(x=fx, y=fy, layer=l.to(torch.int32), xi=xi,
                            size=size, response=contrast, valid=ok)
