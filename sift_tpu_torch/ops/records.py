"""Plane-layout Newton record fields: the dense detection stages (DoG,
extrema, per-pixel quadratic records) as ONE field per octave, with
candidate compaction and the Newton walk reading it.

Counterpart of ``sift_tpu/ops/records.py``: equivalent capability to the
reference's ``findPeaks3D`` + ``adjustExtrema`` + ``collectKpts`` chain
(MatOps.cu:92-181, SiftOps.cu:63-235), restructured so the whole dense part
is a single kernel pass over all octaves (kernels/fused_detect.py) and the
only dense buffer written to device memory is the record field itself.

Record packing.  Three f32 planes per record layer; integer payloads, exact
in f32:

    A = flags + 32*(sx+32) + 2048*(sy+32) + 131072*(sl+8)
        flags = conv | div<<1 | edge_ok<<2 | peak<<3 | contrast_ok<<4
        sx/sy = round(x0/x1) clamped to [-32, 31], sl = round(x2)
        clamped to [-8, 7] — everything a walk STEP consumes, one
        element per candidate per step.
    B = round((x0+0.5)*2000) + 2048*round((x1+0.5)*2000)
    C = round((x2+0.5)*1000) + 1024*round(min(|contrast|,1)*8191)
        — sub-pixel offsets and the response value, consumed ONCE at
        the final (converged) position, where |x_i| < 0.5 by the
        convergence test.  contrast_ok is decided at FULL f32 precision
        (bit 4 of A), so quantisation never moves an accept decision.

The extrema mask rides flags bit 3, so candidates are one compaction over
the A plane, and the DoG volume is never materialised by the kernel.

Layout: the port stores the field at the octave's NATURAL shape
``[3, L, h, w]`` (the JAX package pads rows and lanes to the TPU tiling);
positions are addressed through the strides, and candidate order is
(layer, y, x) either way.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from sift_tpu_torch.config import (SIFT_IMG_BORDER, SIFT_MAX_INTERP_STEPS,
                                   SiftConfig)
from sift_tpu_torch.ops.compact import stream_compact
from sift_tpu_torch.ops.refine_dense import RefinedKeypoints

# Step clamps (see module docstring).
STEP_CLIP_XY = 31
STEP_CLIP_L = 7
_XSCALE = 2000.0     # sub-pixel x0/x1 resolution (1/2000 px)
_SSCALE = 1000.0     # x2 resolution
_CSCALE = 8191.0     # |contrast| resolution


def pack_record_channels(x0, x1, x2, contrast, flags, peak, cok):
    """(x0, x1, x2, |contrast|, flags<=7) + peak/contrast_ok bits ->
    (A, B, C) f32 planes.  ``torch.round`` rounds half to even, like the
    kernel's ``rintf``."""
    def clip_step(x, c):
        return torch.clamp(torch.round(x), -(c + 1), c)

    a = (flags + 8.0 * peak.to(torch.float32)
         + 16.0 * cok.to(torch.float32)
         + 32.0 * (clip_step(x0, STEP_CLIP_XY) + 32.0)
         + 2048.0 * (clip_step(x1, STEP_CLIP_XY) + 32.0)
         + 131072.0 * (clip_step(x2, STEP_CLIP_L) + 8.0))
    qx0 = torch.clamp(torch.round((x0 + 0.5) * _XSCALE), 0.0, 2047.0)
    qx1 = torch.clamp(torch.round((x1 + 0.5) * _XSCALE), 0.0, 2047.0)
    b = qx0 + 2048.0 * qx1
    qx2 = torch.clamp(torch.round((x2 + 0.5) * _SSCALE), 0.0, 1023.0)
    qc = torch.clamp(torch.round(contrast * _CSCALE), 0.0, _CSCALE)
    c = qx2 + 1024.0 * qc
    return a, b, c


def _bit(a, k):
    return torch.remainder(torch.floor(a * (1.0 / (1 << k))), 2.0) > 0.5


def decode_steps(a):
    """A plane -> (conv, div, (sx, sy, sl)): everything a walk step needs."""
    conv = _bit(a, 0)
    div = _bit(a, 1)
    sx = torch.remainder(torch.floor(a * (1.0 / 32.0)), 64.0) - 32.0
    sy = torch.remainder(torch.floor(a * (1.0 / 2048.0)), 64.0) - 32.0
    sl = torch.remainder(torch.floor(a * (1.0 / 131072.0)), 16.0) - 8.0
    return conv, div, (sx.to(torch.int32), sy.to(torch.int32),
                       sl.to(torch.int32))


def decode_final(a, b, c):
    """(A, B, C) at the final position -> (edge_ok, contrast_ok,
    x0, x1, x2, response)."""
    edge = _bit(a, 2)
    cok = _bit(a, 4)
    x0 = torch.remainder(b, 2048.0) * (1.0 / _XSCALE) - 0.5
    x1 = torch.floor(b * (1.0 / 2048.0)) * (1.0 / _XSCALE) - 0.5
    x2 = torch.remainder(c, 1024.0) * (1.0 / _SSCALE) - 0.5
    resp = torch.floor(c * (1.0 / 1024.0)) * (1.0 / _CSCALE)
    return edge, cok, x0, x1, x2, resp


class OctaveRecords(NamedTuple):
    """One octave's packed record field.

    values: [3, L, Hq, Wp] f32, PLANE-major (channels A/B/C, then record
    layers 1..L of the DoG stack).  The port's own fields have Hq == h and
    Wp == w; a padded field (Hq >= h, Wp >= w, e.g. one converted from the
    JAX package) is addressed correctly through its strides.
    """

    values: torch.Tensor
    h: int
    w: int


def resolve_kernel_impl(impl: str, device) -> str:
    """"auto" -> "cuda" on a CUDA device, "torch" on a CPU device.
    "cuda" on a CPU device is an error: nothing falls back silently."""
    dev = torch.device(device)
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"kernel_impl='cuda' needs a CUDA device, got "
                         f"{dev}")
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown kernel_impl {impl!r}")
    return impl


def detect_records_pyramid(gauss: List[torch.Tensor], cfg: SiftConfig,
                           impl: str = "auto") -> List[OctaveRecords]:
    """Record fields of all natural-shape octaves [NL, h_o, w_o] at once:
    ONE launch of the CUDA kernel (CUDA tensors, impl "auto"/"cuda") or
    one call of its plain version (CPU tensors, or impl "torch")."""
    from sift_tpu_torch.kernels import fused_detect
    recs = fused_detect.detect_records(
        gauss, float(cfg.peak_threshold), SIFT_IMG_BORDER,
        float(cfg.edge_threshold), float(cfg.contrast_threshold),
        cfg.num_octave_layers, impl=impl)
    return [OctaveRecords(values=r, h=g.shape[1], w=g.shape[2])
            for g, r in zip(gauss, recs)]


def detect_records_padded_pyramid(plan, gp: List[torch.Tensor],
                                  impl: str = "auto") -> List[OctaveRecords]:
    """Record fields of a whole padded pyramid (ops/pyramid.
    gaussian_pyramid_padded of ``plan``) in ONE launch: the kernel reads
    each octave's content in place through its strides."""
    from sift_tpu_torch.ops.pyramid import padded_content_views
    return detect_records_pyramid(padded_content_views(plan, gp),
                                  plan.config, impl)


def detect_records_padded(gp: torch.Tensor, h: int, w: int,
                          cfg: SiftConfig,
                          impl: str = "auto") -> OctaveRecords:
    """Record field of ONE padded-layout octave ``[NL, Hv, Wp]`` (content
    rows [HALO, HALO + h), columns [0, w)): the kernel reads the content
    in place, the plain version takes the same view (the JAX package's
    ``detect_records_padded``)."""
    from sift_tpu_torch.core.types import HALO
    return detect_records_pyramid([gp[:, HALO:HALO + h, :w]], cfg,
                                  impl)[0]


def detect_records(gauss_oct: torch.Tensor, cfg: SiftConfig,
                   impl: str = "auto") -> OctaveRecords:
    """Record field of one natural-shape octave [NL, h, w]: the
    one-element case of ``detect_records_pyramid``."""
    return detect_records_pyramid([gauss_oct], cfg, impl)[0]


def records_torch(gauss_oct: torch.Tensor, cfg: SiftConfig) -> OctaveRecords:
    """Plain-PyTorch record field of one octave (the counterpart of
    ``records_jnp``; natural layout), on whatever device it lies."""
    return detect_records(gauss_oct, cfg, "torch")


def candidates_from_records(rec: OctaveRecords, cap: int):
    """Extrema candidates from the A plane's peak bit (first ``cap`` set
    bits in layer-major index order).  Returns (x, y, layer, valid), layer
    in 1..L (DoG layer index)."""
    _, nrec, hq, wp = rec.values.shape
    mask = _bit(rec.values[0], 3).reshape(-1)
    idx, valid = stream_compact(mask, cap)
    lyr = idx // (hq * wp) + 1
    rem = idx % (hq * wp)
    y = rem // wp
    x = rem % wp
    return (x.to(torch.int32), y.to(torch.int32), lyr.to(torch.int32),
            valid)


@functools.lru_cache(maxsize=256)
def _table(vals: tuple, device: str) -> torch.Tensor:
    """Small static int64 lookup table on ``device``, uploaded once (the
    per-frame path then issues no host-to-device copy for it)."""
    return torch.tensor(vals, dtype=torch.int64, device=device)


class WalkState(NamedTuple):
    """Per-candidate outcome of the positions-only Newton walk.

    Everything the global compaction needs (``ok``) plus everything the
    post-compaction finalize needs to build keypoints for the SURVIVORS
    only: the B/C planes (sub-pixel offsets + response) are deliberately
    NOT gathered here.  The accept bits (edge, contrast) ride the A value
    the walk already gathered at the convergence step, so ``ok`` is exact
    without touching B/C."""

    l: torch.Tensor       # [K] i32 final DoG layer
    r: torch.Tensor       # [K] i32 final row (octave coords)
    c: torch.Tensor       # [K] i32 final col
    ok: torch.Tensor      # [K] bool: converged & edge_ok & contrast_ok
    octv: torch.Tensor    # [K] i32 octave index
    fi: torch.Tensor      # [K] i64 plane-local flat index of the final
    #                       position (addresses A/B/C per-plane flats)


def walk_records_positions(recs: List[OctaveRecords], cands,
                           cfg: SiftConfig
                           ) -> Tuple[WalkState, tuple]:
    """ALL octaves' candidates in ONE Newton walk over the concatenated
    packed record fields.  Each of the 5 steps gathers ONE element per
    candidate (the A plane).  cands: per-octave (cx, cy, clayer, cvalid).
    Returns (WalkState, (flat_b, flat_c)) — feed survivors to
    ``finalize_walk``.

    When the summed per-octave candidate capacity exceeds 2 * num_features,
    candidates are first globally compacted to that bound, so walk cost
    scales with the configured feature budget, not the frame area.
    Truncation drops trailing (highest-octave) candidates only on frames
    whose RAW extrema count exceeds twice the requested feature count."""
    d = recs[0].values.shape[1] + 2          # DoG layer count
    border = SIFT_IMG_BORDER
    dev = recs[0].values.device
    bases, hs, ws, hqwps, wps = [], [], [], [], []
    row = 0
    for rr in recs:
        _, nrec, hq, wp = rr.values.shape
        bases.append(row)
        hs.append(rr.h)
        ws.append(rr.w)
        hqwps.append(hq * wp)
        wps.append(wp)
        row += nrec * hq * wp                # per-PLANE octave stride
    flat_a = torch.cat([rr.values[0].reshape(-1) for rr in recs])
    flat_b = torch.cat([rr.values[1].reshape(-1) for rr in recs])
    flat_c = torch.cat([rr.values[2].reshape(-1) for rr in recs])

    octv = torch.cat([
        torch.full(cc[0].shape, o, dtype=torch.int32, device=dev)
        for o, cc in enumerate(cands)])
    cat = lambda i: torch.cat([cc[i] for cc in cands])
    cx, cy, clayer, cvalid = cat(0), cat(1), cat(2), cat(3)

    gcap = 2 * cfg.num_features
    if octv.shape[0] > gcap:
        # Global candidate compaction (octave-major order preserved).
        gidx, gval = stream_compact(cvalid, gcap)
        gi = gidx.to(torch.int64)
        cx, cy, clayer, octv = cx[gi], cy[gi], clayer[gi], octv[gi]
        cvalid = cvalid[gi] & gval

    octv64 = octv.to(torch.int64)

    def sel(vals):
        """Per-candidate int64 from a per-octave table."""
        return _table(tuple(vals), str(dev))[octv64]

    base, h, w = sel(bases), sel(hs), sel(ws)
    hqwp, wp = sel(hqwps), sel(wps)

    def pos_idx(l, r, c):
        """PLANE-LOCAL index (the same position addresses A, B or C in
        their per-plane flats)."""
        return (base + (torch.clamp(l, 1, d - 2) - 1) * hqwp
                + torch.minimum(torch.clamp(r, min=0), h - 1) * wp
                + torch.minimum(torch.clamp(c, min=0), w - 1))

    c = cx.to(torch.int64)
    r = cy.to(torch.int64)
    l = clayer.to(torch.int64)
    alive = cvalid
    converged = torch.zeros_like(alive)
    edge = torch.zeros_like(alive)
    cok = torch.zeros_like(alive)

    for _ in range(int(SIFT_MAX_INTERP_STEPS)):
        active = alive & ~converged
        a = flat_a[pos_idx(l, r, c)]
        conv_now, diverged, (sx, sy, sl) = decode_steps(a)
        # A converged candidate's position never changes again, so the A
        # value at the convergence step IS the final-position A: capture
        # its accept bits here and the finalize never re-reads A.
        first = active & conv_now
        edge = torch.where(first, _bit(a, 2), edge)
        cok = torch.where(first, _bit(a, 4), cok)
        step = active & ~conv_now & ~diverged
        nl = l - sl
        nr = r - sy
        nc = c - sx
        oob = ((nl < 1) | (nl > d - 2)
               | (nr < border) | (nr >= h - border)
               | (nc < border) | (nc >= w - border))
        l = torch.where(step, torch.clamp(nl, 0, d - 1), l)
        r = torch.where(step, torch.minimum(torch.clamp(nr, min=0), h - 1),
                        r)
        c = torch.where(step, torch.minimum(torch.clamp(nc, min=0), w - 1),
                        c)
        alive = alive & ~(active & (diverged | (step & oob)))
        converged = converged | (active & conv_now)

    ok = alive & converged & edge & cok
    return WalkState(l=l.to(torch.int32), r=r.to(torch.int32),
                     c=c.to(torch.int32), ok=ok, octv=octv,
                     fi=pos_idx(l, r, c)), (flat_b, flat_c)


def finalize_walk(flat, st: WalkState, valid: torch.Tensor,
                  cfg: SiftConfig
                  ) -> Tuple[RefinedKeypoints, torch.Tensor]:
    """Keypoints from walk survivors.  ``st``: WalkState rows already
    gathered down to the surviving set; ``valid``: the compaction's
    validity mask for those rows; ``flat``: the (flat_b, flat_c) pair from
    walk_records_positions.  Gathers B/C (2 elements per survivor) and
    builds coordinates/size/response.  Returns (RefinedKeypoints,
    octave [K'])."""
    flat_b, flat_c = flat
    safe = torch.where(valid, st.fi.to(torch.int64), 0)
    b = flat_b[safe]
    cc = flat_c[safe]
    x0 = torch.remainder(b, 2048.0) * (1.0 / _XSCALE) - 0.5
    x1 = torch.floor(b * (1.0 / 2048.0)) * (1.0 / _XSCALE) - 0.5
    x2 = torch.remainder(cc, 1024.0) * (1.0 / _SSCALE) - 0.5
    resp = torch.floor(cc * (1.0 / 1024.0)) * (1.0 / _CSCALE)

    scale = torch.exp2(st.octv.to(torch.float32))
    if cfg.subpixel:
        fx = (st.c.to(torch.float32) - x0) * scale
        fy = (st.r.to(torch.float32) - x1) * scale
    else:
        fx = st.c.to(torch.float32) * scale
        fy = st.r.to(torch.float32) * scale
    xi = -x2
    size = (cfg.sigma * torch.pow(
        2.0, (st.l.to(torch.float32) + xi) / cfg.num_octave_layers)
        * scale * 2.0)
    ref = RefinedKeypoints(x=fx, y=fy, layer=st.l, xi=xi, size=size,
                           response=resp, valid=valid & st.ok)
    return ref, st.octv


def walk_records_all(recs: List[OctaveRecords], cands, cfg: SiftConfig
                     ) -> Tuple[RefinedKeypoints, torch.Tensor]:
    """Un-compacted walk (parity entry): positions walk + finalize over
    ALL candidates."""
    st, flat = walk_records_positions(recs, cands, cfg)
    return finalize_walk(flat, st, st.ok, cfg)
