"""Per-keypoint kernels: orientation histograms and descriptor histograms
read straight from the raw pyramid slab.

Counterpart of ``sift_tpu/kernels/fused_stages.py``
(``orientation_hist_fused``, ``descriptor_fused``).  The CUDA kernels are
``csrc/orientation_hist.cu`` and ``csrc/descriptor_hist.cu``; beside each
wrapper stands the same function in plain PyTorch
(``orientation_hist_plain``, ``descriptor_hist_plain``), batched over
keypoints in chunks so memory stays bounded.

Contract (the JAX kernels', so both can be fed the same arrays).  For
keypoint k the window pixel (i, p), 0 <= i < rows, 0 <= p < lanes, is
``slab[ys0[k]+i, xs0[k]+p]``; ``offy = par[k,0]+i``, ``offx = par[k,1]+p``;
a pixel counts where ``par[k,2] <= offy <= par[k,3]``,
``par[k,4] <= offx <= par[k,5]`` and ``|off| <= par[k,7]`` (the UNCAPPED
radius) on both axes; weight ``exp(off^2 * par[k,6])`` per axis; valid
``par[k,8]``; the descriptor also reads ``cos_t, sin_t, ang =
par[k,9:12]``.  Column 12 (a TPU lane offset) is ignored.  Gradients are
central differences inside the window, so only its interior
``[1, rows-2] x [1, lanes-2]`` can count: a keypoint whose radius exceeds
the window (out of contract; the pipeline never emits one) is truncated
there and stays finite.  Origins need no alignment; they are clamped into
the slab (by the kernels as they load them, by the plain versions in
PyTorch) so that no read can leave it.

Only rows ``[start, start + count)`` are computed (``count``/``start`` may
be ints, None or 0-d integer tensors on the device, which the kernels read
themselves: nothing here synchronises with the host); all other rows of
the output are zero.  The plain versions skip the other rows where
``count`` and ``start`` are known on the host (ints, None or CPU tensors),
and otherwise compute every row and mask.
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.config import (SIFT_DESCR_HIST_BINS, SIFT_DESCR_WIDTH,
                                   SIFT_ORI_HIST_BINS)
from sift_tpu_torch.kernels import build

LANES = 128
_D = SIFT_DESCR_WIDTH
_NBD = SIFT_DESCR_HIST_BINS
_NBO = SIFT_ORI_HIST_BINS
_RAD2DEG = 180.0 / math.pi
NPAR = 13

# The orientation kernel's block (csrc/orientation_hist.cu): threads, and
# floats of its patch buffer (a 35 x 35 patch: radius 16 plus the gradient
# halo; larger patches are staged in chunks of rows).
ORI_THREADS = 64
ORI_PATCH_CAP = 1296

# Launch counts: ``launches[name]`` rises by one where a wrapper launches
# its CUDA kernel and nowhere else; ``plain_calls`` counts plain versions.
launches = {"orientation_hist": 0, "descriptor_hist": 0}
plain_calls = {"orientation_hist": 0, "descriptor_hist": 0}


def _atan2_deg(dy, dx):
    """Polynomial atan2 in degrees, [-180, 180]: octant reduction + odd
    degree-15 minimax polynomial for atan on [0, 1] (|err| <= 3.8e-8
    rad).  The same polynomial as the CUDA kernels and the JAX package's
    kernels, so histogram-bin decisions agree.  atan2(0, 0) -> 0."""
    ax = dx.abs()
    ay = dy.abs()
    mx = torch.maximum(ax, ay)
    z = torch.minimum(ax, ay) / torch.clamp(mx, min=1e-30)
    z2 = z * z
    p = z * (0.9999993357463199
             + z2 * (-0.3332986151078535
                     + z2 * (0.19946574511230034
                             + z2 * (-0.13908676324191868
                                     + z2 * (0.09642322342441606
                                             + z2 * (-0.05591409699715592
                                                     + z2 * (0.02186422353328521
                                                             + z2 * -0.004054926663980925)))))))
    r = torch.where(ay > ax, (math.pi / 2) - p, p)
    r = torch.where(dx < 0, math.pi - r, r)
    return torch.where(dy < 0, -r, r) * _RAD2DEG


def _check_args(values, ys0, xs0, par, rows, lanes):
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError("slab must be [Hs, Ws] float32")
    k = ys0.shape[0]
    if ys0.shape != (k,) or xs0.shape != (k,) or par.dim() != 2 \
            or par.shape[0] != k or par.shape[1] < 12:
        raise ValueError("ys0/xs0 must be [K], par [K, >=12]")
    if ys0.dtype != torch.int32 or xs0.dtype != torch.int32 \
            or par.dtype != torch.float32:
        raise ValueError("ys0/xs0 must be int32, par float32")
    for t in (ys0, xs0, par):
        if t.device != values.device:
            raise ValueError("all arguments must be on the slab's device")
    hs, ws = values.shape
    # The margin the windows need: any origin clamped to
    # [0, hs - rows] x [0, ws - lanes] keeps every tap inside the slab.
    if rows < 3 or lanes < 3 or hs < rows or ws < lanes:
        raise ValueError(f"slab {hs}x{ws} cannot hold a {rows}x{lanes} "
                         "window")


def orientation_smem_bytes(rows: int, lanes: int) -> int:
    """Dynamic shared memory of one orientation block, as
    csrc/orientation_hist.cu lays it out (f32): lane-private bins [36,
    threads], the patch buffer, a row table [rows], a column table
    [lanes], the warps' partial sums [warps, 36].  Raises for a window the
    kernel cannot take: a patch chunk of at least one row plus its halo
    must fit one buffer, so ``lanes <= ORI_PATCH_CAP // 3``."""
    if rows < 3 or not 3 <= lanes <= ORI_PATCH_CAP // 3:
        raise ValueError(f"the orientation kernel takes 3 <= lanes <= "
                         f"{ORI_PATCH_CAP // 3} and rows >= 3, got "
                         f"{rows}x{lanes}")
    return 4 * (_NBO * ORI_THREADS + ORI_PATCH_CAP + rows + lanes
                + (ORI_THREADS // 32) * _NBO)


def orientation_geometry(rows: int, lanes: int, k: int) -> dict:
    """The orientation kernel's launch on the current CUDA device: shared
    memory per block and the persistent grid, as the C entry point
    computes them, beside this module's formula."""
    import ctypes
    lib = build.load_library()
    smem, grid = ctypes.c_longlong(0), ctypes.c_int(0)
    build.check(lib.sift_orientation_hist_geometry(
        rows, lanes, k, ctypes.byref(smem), ctypes.byref(grid)),
        "sift_orientation_hist_geometry")
    return dict(threads=ORI_THREADS, smem_bytes=smem.value, grid=grid.value,
                smem_bytes_formula=orientation_smem_bytes(rows, lanes),
                patch_cap_floats=ORI_PATCH_CAP)


def _clamp_origins(ys0, xs0, values, rows, lanes):
    """Clamp origins into the slab.  A live keypoint's origin is inside
    already (ops/flatpyr.stack_pyramid leaves ``extra_rows`` below and
    ``lanes`` of slack to the right); dead entries may carry garbage."""
    hs, ws = values.shape
    return (torch.clamp(ys0, 0, hs - rows), torch.clamp(xs0, 0, ws - lanes))


def _count_start(count, start, k, device):
    """[2] int32 device tensor (live count, start) — no host sync."""
    def scalar(v, default):
        if v is None:
            v = default
        if torch.is_tensor(v):
            return v.to(device=device, dtype=torch.int32).reshape(())
        # torch.full fills on the device: no host-to-device copy.
        return torch.full((), int(v), dtype=torch.int32, device=device)
    cnt = torch.clamp(scalar(count, k), max=k)
    return torch.stack([cnt, scalar(start, 0)])


def int_arg(v, default: int, device):
    """An integer argument of the kernels' C entry points as ``(pointer,
    bytes, value)``: a one-element int32 / int64 tensor on ``device`` goes
    by pointer (the kernel reads it, so nothing synchronises with the
    host); an int, a CPU tensor or None (meaning ``default``) by value."""
    if v is None:
        return None, 0, int(default)
    if not torch.is_tensor(v):
        return None, 0, int(v)
    if v.numel() != 1:
        raise ValueError(f"count/start must hold one integer, got shape "
                         f"{tuple(v.shape)}")
    if v.device.type == "cpu":
        return None, 0, int(v)
    if v.device != torch.device(device):
        raise ValueError(f"count/start lies on {v.device}, the slab on "
                         f"{device}")
    if v.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"count/start must be int32 or int64, got "
                         f"{v.dtype}")
    return v.data_ptr(), v.element_size(), 0


def _launch(name, fn_name, nbins, values, ys0, xs0, par, rows, lanes,
            count, start):
    """One launch: origins are clamped and count/start read by the kernel
    itself, so the frame path queues the output allocation and the kernel
    only.  Every output row outside [start, start + count) is written 0."""
    if not values.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                         f"got {values.device}")
    _check_args(values, ys0, xs0, par, rows, lanes)
    values, par = values.contiguous(), par.contiguous()
    ys0, xs0 = ys0.contiguous(), xs0.contiguous()
    k = ys0.shape[0]
    cnt = int_arg(count, k, values.device)
    st = int_arg(start, 0, values.device)
    out = torch.empty((k, nbins), dtype=torch.float32, device=values.device)
    lib = build.load_library()
    with torch.cuda.device(values.device):
        rc = getattr(lib, fn_name)(
            values.data_ptr(), values.shape[0], values.shape[1],
            ys0.data_ptr(), xs0.data_ptr(), par.data_ptr(), par.shape[1],
            *cnt, *st, out.data_ptr(), k, rows, lanes,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, fn_name)
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _window_terms(values, ys0, xs0, par, rows, lanes):
    """Shared front half of both plain versions for one chunk: gradient
    magnitude / orientation of every window pixel and the separable
    masked Gaussian weights.  Returns (mag, ori [Kc, rows, lanes],
    offy [Kc, rows], offx [Kc, lanes], wy, wx)."""
    dev = values.device
    ws = values.shape[1]
    ri = torch.arange(rows, device=dev)
    li = torch.arange(lanes, device=dev)
    idx = ((ys0.to(torch.int64)[:, None, None] + ri[None, :, None]) * ws
           + xs0.to(torch.int64)[:, None, None] + li[None, None, :])
    vld = par[:, 8]
    win = values.reshape(-1)[idx]
    # A dead entry's window holds unrelated pixels: zero it.
    win = torch.where((vld > 0)[:, None, None], win, torch.zeros_like(win))
    dx = torch.roll(win, -1, 2) - torch.roll(win, 1, 2)
    dy = torch.roll(win, 1, 1) - torch.roll(win, -1, 1)
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = _atan2_deg(dy, dx)

    offy = par[:, 0:1] + ri.to(torch.float32)[None, :]
    offx = par[:, 1:2] + li.to(torch.float32)[None, :]
    es = par[:, 6:7]
    rad = par[:, 7:8]
    # The rolls wrap at the window edge: only interior pixels can count.
    my = ((offy >= par[:, 2:3]) & (offy <= par[:, 3:4])
          & (offy.abs() <= rad) & ((ri >= 1) & (ri <= rows - 2))[None, :])
    mx = ((offx >= par[:, 4:5]) & (offx <= par[:, 5:6])
          & (offx.abs() <= rad) & ((li >= 1) & (li <= lanes - 2))[None, :])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    wy = torch.where(my, torch.exp(offy * offy * es), zero)
    wx = torch.where(mx, torch.exp(offx * offx * es) * vld[:, None], zero)
    return mag, ori, offy, offx, wy, wx


def _host_span(k, count, start):
    """``[lo, hi)``, the live rows, where ``count`` and ``start`` are known
    on the host (None, ints or CPU tensors: reading them waits for
    nothing); all ``k`` rows where either lies on a device."""
    vals = []
    for v, default in ((count, k), (start, 0)):
        if v is None:
            v = default
        elif torch.is_tensor(v) and v.device.type != "cpu":
            return 0, k
        vals.append(int(v))
    cnt, st = vals
    lo = min(max(st, 0), k)
    return lo, max(lo, min(st + min(cnt, k), k))


def _live_rows(k, count, start, device):
    cs = _count_start(count, start, k, device)
    j = torch.arange(k, dtype=torch.int32, device=device)
    return (j >= cs[1]) & (j < cs[1] + cs[0])


def orientation_hist_plain(values, ys0, xs0, par, rows: int,
                           lanes: int = LANES, count=None, start=None,
                           chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version of the orientation kernel: [K, 36] f32."""
    plain_calls["orientation_hist"] += 1
    _check_args(values, ys0, xs0, par, rows, lanes)
    k = ys0.shape[0]
    ys0, xs0 = _clamp_origins(ys0, xs0, values, rows, lanes)
    hist = torch.zeros((k, _NBO), dtype=torch.float32, device=values.device)
    lo, hi = _host_span(k, count, start)
    for s in range(lo, hi, chunk):
        sl = slice(s, min(s + chunk, hi))
        mag, ori, _, _, wy, wx = _window_terms(
            values, ys0[sl], xs0[sl], par[sl], rows, lanes)
        contrib = mag * wy[:, :, None] * wx[:, None, :]
        # bin = round-half-even(ori * 36/360), wrapped into [0, 36).
        b = torch.round(ori * (_NBO / 360.0))
        b = torch.where(b >= _NBO, b - _NBO, b)
        b = torch.where(b < 0, b + _NBO, b)
        kc = contrib.shape[0]
        hist[sl].scatter_add_(1, b.reshape(kc, -1).to(torch.int64),
                              contrib.reshape(kc, -1))
    live = _live_rows(k, count, start, values.device)
    return torch.where(live[:, None], hist, torch.zeros_like(hist))


def descriptor_hist_plain(values, ys0, xs0, par, rows: int,
                          lanes: int = LANES, count=None, start=None,
                          chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the descriptor kernel: [K, 128] f32 raw
    histograms, cell-major (r, c, o)."""
    plain_calls["descriptor_hist"] += 1
    _check_args(values, ys0, xs0, par, rows, lanes)
    dev = values.device
    k = ys0.shape[0]
    ys0, xs0 = _clamp_origins(ys0, xs0, values, rows, lanes)
    cells = torch.arange(_D, dtype=torch.float32, device=dev)
    obins = torch.arange(_NBD, dtype=torch.float32, device=dev)
    hist = torch.zeros((k, _D * _D * _NBD), dtype=torch.float32, device=dev)
    lo, hi = _host_span(k, count, start)
    for s in range(lo, hi, chunk):
        sl = slice(s, min(s + chunk, hi))
        pc = par[sl]
        mag, ori, offy, offx, wy, wx = _window_terms(
            values, ys0[sl], xs0[sl], pc, rows, lanes)
        kc = mag.shape[0]
        cos_t = pc[:, 9, None, None]
        sin_t = pc[:, 10, None, None]
        ang = pc[:, 11, None, None]
        oy = offy[:, :, None]
        ox = offx[:, None, :]
        c_rot = ox * cos_t - oy * sin_t
        r_rot = ox * sin_t + oy * cos_t
        rbin = r_rot + (_D / 2 - 0.5)
        cbin = c_rot + (_D / 2 - 0.5)
        inb = (rbin > -1.0) & (rbin < float(_D)) \
            & (cbin > -1.0) & (cbin < float(_D))
        mag_w = torch.where(inb, mag * (wy[:, :, None] * wx[:, None, :]),
                            torch.zeros_like(mag))

        # ori in [-180, 180]; the mod folds it into [0, 8].
        ob = (ori - ang) * (_NBD / 360.0)
        ob = ob - torch.floor(ob * (1.0 / _NBD)) * _NBD

        p = rows * lanes
        od = (ob.reshape(kc, p, 1) - obins).abs()
        wo = torch.clamp(1.0 - torch.minimum(od, _NBD - od), min=0.0) \
            * mag_w.reshape(kc, p, 1)                       # [Kc, P, 8]
        hr = torch.clamp(1.0 - (rbin.reshape(kc, p, 1) - cells).abs(),
                         min=0.0)                           # [Kc, P, 4]
        hc = torch.clamp(1.0 - (cbin.reshape(kc, p, 1) - cells).abs(),
                         min=0.0)
        hrc = (hr[:, :, :, None] * hc[:, :, None, :]).reshape(kc, p,
                                                              _D * _D)
        hist[sl] = torch.bmm(hrc.transpose(1, 2), wo).reshape(
            kc, _D * _D * _NBD)
    live = _live_rows(k, count, start, dev)
    return torch.where(live[:, None], hist, torch.zeros_like(hist))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def orientation_hist_cuda(values, ys0, xs0, par, rows: int,
                          lanes: int = LANES, count=None, start=None):
    """Launch the CUDA orientation kernel; raises rather than fall back."""
    orientation_smem_bytes(rows, lanes)
    return _launch("orientation_hist", "sift_orientation_hist", _NBO,
                   values, ys0, xs0, par, rows, lanes, count, start)


def descriptor_hist_cuda(values, ys0, xs0, par, rows: int,
                         lanes: int = LANES, count=None, start=None):
    """Launch the CUDA descriptor kernel; raises rather than fall back."""
    return _launch("descriptor_hist", "sift_descriptor_hist",
                   _D * _D * _NBD, values, ys0, xs0, par, rows, lanes,
                   count, start)


def orientation_hist(values, ys0, xs0, par, rows: int, lanes: int = LANES,
                     count=None, start=None, impl: str = "auto"):
    """values: [Hs, Ws] f32 raw pyramid slab; ys0/xs0: [K] i32 window
    origins; par: [K, NPAR] f32.  Returns [K, 36] f32 raw histograms.
    A CUDA slab launches the kernel (or raises); the plain version is
    taken for a CPU slab, or on explicit ``impl="torch"``."""
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    fn = orientation_hist_cuda \
        if resolve_kernel_impl(impl, values.device) == "cuda" \
        else orientation_hist_plain
    return fn(values, ys0, xs0, par, rows, lanes, count, start)


def descriptor_hist(values, ys0, xs0, par, rows: int, lanes: int = LANES,
                    count=None, start=None, impl: str = "auto"):
    """As ``orientation_hist``; returns [K, 128] f32 raw descriptor
    histograms (pre-normalisation, finalize_descriptor order)."""
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    fn = descriptor_hist_cuda \
        if resolve_kernel_impl(impl, values.device) == "cuda" \
        else descriptor_hist_plain
    return fn(values, ys0, xs0, par, rows, lanes, count, start)
