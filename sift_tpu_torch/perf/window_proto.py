"""Experiment: three schemes for loading per-keypoint windows, head to head.

    python -m sift_tpu_torch.perf.window_proto [--out FILE.json]
    python -m sift_tpu_torch.perf.window_proto --parent TREE [--out FILE]

Counterpart of ``scripts/dma_proto.py`` (``p0``, ``p0b``, ``p1``).  The toy
function is a column sum over one ``[rows, 128]`` float32 window per
keypoint, read from a slab at scattered aligned origins:

    out[k, :] = sum_i slab[ys0[k] + i, xs0[k] : xs0[k] + 128]   for k < count

Rows at or past ``count`` are zero (the JAX script leaves them unspecified
and compares live rows only).  The CUDA kernels (``csrc/window_proto.cu``):

* ``window_colsum_static`` — strip owners: a one-block bucket pass
  (``colsum_bucket``) keys every live window by (strip of ``strip_rows``
  rows, 128-column tile) and cuts the keys into items of at most ``chunk``
  windows; a grid fixed by the capacity (``colsum_strip``) stages each
  item's bounding box once in shared memory and sums its windows from there,
  row by row, ``warps`` warps per block; the other blocks write the zero
  rows.  ``strip_plan`` is the bucket pass's host twin;
* ``window_colsum_par`` — the same, each block also gathering its windows'
  ``par[k, 0]``, added to every live row ``k`` with ``k % block_k == 0``;
* ``window_colsum_ring`` — a persistent grid that walks the LIVE windows
  only; one thread per block copies each window in ``band_rows``-row tiles
  with the Tensor Memory Accelerator into an ``nbuf``-slot shared-memory
  ring guarded by mbarriers, and ``block_k`` warps sum the slots.

``window_colsum_plain`` is the same function in plain PyTorch (with the
``par`` variant), summing each window row by row in float32 as the strip
kernels do, so they equal it bit for bit; the ring sums in another order.
The ``*_cuda`` wrappers launch or raise.  ``main`` runs the JAX script's
workload (slab 1536x1024, rows 72, capacity 5000, 1080 live) and a
clustered set (every live window in one strip of one column tile), sweeps
the strip geometry and the ring, each point with its layout, checks every
result against the plain version, and prints each time: ``ms`` from CUDA
events around back-to-back calls of the wrapper, ``device_ms`` the
kernels' own duration from ``torch.profiler`` (both strip launches
summed).  ``--parent TREE`` times the static and par kernels of another
checkout and of this one on both sets, in turns (parent, this, this,
parent), one subprocess each.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from sift_tpu_torch.kernels import build

LANES = 128
NPAR = 16
ROW_BYTES = LANES * 4              # one window row, f32
# Ring sweep points (block_k consumer warps, nbuf slots, band_rows per slot):
# bands of 8, 24, 36 and 72 rows (a whole window is one 36,864-byte tile).
SWEEP = ((8, 4, 8), (8, 8, 8), (8, 4, 24), (16, 4, 24), (8, 4, 36),
         (4, 6, 36), (4, 2, 72), (8, 2, 72), (16, 2, 72))
# The ring's defaults (block_k, nbuf, band_rows): two whole-window slots;
# band_rows None means one tile per window (rows <= 256).
RING_DEFAULT = (8, 2, None)
# Strip sweep points (strip_rows, chunk, warps): two windows per warp at
# every (strip_rows, chunk) of 32 / 64 / 128 x 4 / 8 / 16, then one window
# per warp and items of 32 windows.
STRIP_SWEEP = (tuple((t, c, c // 2) for t in (32, 64, 128) for c in (4, 8, 16))
               + ((64, 8, 8), (64, 16, 16), (64, 32, 16), (128, 32, 16)))
# The strip kernels' defaults (strip_rows, chunk, warps).
STRIP_DEFAULT = (64, 16, 8)
# Shared memory of a strip block per window of an item (index, origin,
# parameter, rank; besides 16 bytes for the item's box), and the most
# windows one warp sums.
STRIP_META = 20
STRIP_MAXM = 2
# Warps of a bucket block.
BUCKET_WARPS = 8
# The most dynamic shared memory one block may have on the H100 (bytes).
BLOCK_SMEM_MAX = 227 * 1024

_NAMES = ("window_colsum_static", "window_colsum_par", "window_colsum_ring")
# Launch counts: ``launches[name]`` rises by one where a wrapper launches
# its CUDA kernel(s) and nowhere else; ``plain_calls`` counts plain versions.
launches = {n: 0 for n in _NAMES}
plain_calls = {n: 0 for n in _NAMES}


def _check_args(slab, ys0, xs0, rows: int, block_k: int, par=None) -> None:
    if slab.dim() != 2 or slab.dtype != torch.float32:
        raise ValueError("slab must be [H, W] float32, got "
                         f"{tuple(slab.shape)} {slab.dtype}")
    h, w = slab.shape
    if w % 4 or w < LANES or rows <= 0 or h < rows:
        raise ValueError(f"slab {h}x{w} cannot hold a {rows}x{LANES} window "
                         "(width % 4 == 0)")
    k = ys0.shape[0]
    for name, t in (("ys0", ys0), ("xs0", xs0)):
        if t.shape != (k,) or t.dtype != torch.int32 \
                or t.device != slab.device:
            raise ValueError(f"{name} must be [K] int32 on the slab's device")
    if not 1 <= block_k <= 32:
        raise ValueError(f"block_k must be in 1..32, got {block_k}")
    if par is not None and (tuple(par.shape) != (k, NPAR)
                            or par.dtype != torch.float32
                            or par.device != slab.device):
        raise ValueError(f"par must be [K, {NPAR}] float32 on the slab's "
                         "device")


def _count_tensor(count, k: int, device) -> torch.Tensor:
    """[1] int32 on ``device``, clamped to the capacity — no host sync."""
    if torch.is_tensor(count):
        c = count.to(device=device, dtype=torch.int32).reshape(1)
    else:
        c = torch.full((1,), int(count), dtype=torch.int32, device=device)
    return torch.clamp(c, 0, k)


def clamp_origins(ys0, xs0, h: int, w: int, rows: int):
    """Origins clamped into an [h, w] slab, columns aligned down to 4, as
    int64 — what every kernel reads."""
    y0 = torch.clamp(ys0.to(torch.int64), 0, h - rows)
    x0 = torch.div(torch.clamp(xs0.to(torch.int64), 0, w - LANES), 4,
                   rounding_mode="floor") * 4
    return y0, x0


def window_colsum_plain(slab: torch.Tensor, ys0, xs0, rows: int, count,
                        par: Optional[torch.Tensor] = None,
                        block_k: int = 8,
                        name: str = "window_colsum_static") -> torch.Tensor:
    """Plain PyTorch version of all three kernels (any device): each window
    summed row by row in float32, ``0 + row 0 + row 1 + ...``; with ``par``
    the variant that then adds ``par[k, 0]`` to every row ``k`` with
    ``k % block_k == 0``.  Rows at or past ``count`` are zero.  ``name``:
    which kernel's ``plain_calls`` counter this call counts under.  Origins
    are clamped into the slab and ``xs0`` aligned down to 4 columns, as the
    kernels do."""
    plain_calls[name] += 1
    _check_args(slab, ys0, xs0, rows, block_k, par)
    h, w = slab.shape
    k = ys0.shape[0]
    dev = slab.device
    y0, x0 = clamp_origins(ys0, xs0, h, w, rows)
    x = x0[:, None] + torch.arange(LANES, device=dev)
    out = torch.zeros((k, LANES), dtype=torch.float32, device=dev)
    for i in range(rows):
        out = out + slab[(y0 + i)[:, None], x]
    if par is not None:
        first = (torch.arange(k, device=dev) % block_k) == 0
        out = torch.where(first[:, None], out + par[:, :1], out)
    live = torch.arange(k, device=dev) < _count_tensor(count, k, dev)
    return torch.where(live[:, None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# The strip design's host side
# ---------------------------------------------------------------------------


def strip_geometry(k: int, h: int, w: int, rows: int, strip_rows: int,
                   chunk: int, warps: int) -> dict:
    """Sizes of one strip launch, the arithmetic of csrc/window_proto.cu
    (``strip_geometry``, ``strip_buf_rows``, ``bucket_layout``): keys are
    strips of ``strip_rows`` rows x 128-column tiles of the origins' range;
    at most ``ceil(k / chunk) + keys`` items, one strip block each (the
    grid); a strip block holds ``buf_rows`` staged rows of 512 bytes
    (``strip_rows + rows - 1``, the box of 128-aligned origins, at least 2,
    at most what fits beside ``STRIP_META`` bytes per window and 16 for
    the box) and each of
    its ``warps`` warps sums at most ``STRIP_MAXM`` windows; each bucket
    block (one per key, ``BUCKET_WARPS`` warps) holds 32 scan slots of 8
    bytes, three words per window, one per key and 34 more.
    The plan in the scratch tensor: ``plan_views``.  Raises on arguments
    the kernels do not take."""
    if w % 4 or w < LANES or not 1 <= rows <= h or k < 0:
        raise ValueError(f"a {h}x{w} slab cannot hold {rows}x{LANES} windows")
    if strip_rows < 1 or not 1 <= warps <= 32 \
            or not 1 <= chunk <= min(32, STRIP_MAXM * warps):
        raise ValueError(f"strip_rows >= 1, warps in 1..32, chunk in 1.."
                         f"min(32, {STRIP_MAXM} x warps); got {strip_rows}, "
                         f"{chunk}, {warps}")
    tiles_x = (w - LANES) // LANES + 1
    n_buckets = ((h - rows) // strip_rows + 1) * tiles_x
    max_items = -(-k // chunk) + n_buckets
    fit = (BLOCK_SMEM_MAX - STRIP_META * chunk - 16) // ROW_BYTES
    buf_rows = min(max(strip_rows + rows - 1, 2), fit)
    bucket_smem = 4 * (64 + 3 * k + n_buckets + 2 + 32)
    if bucket_smem > BLOCK_SMEM_MAX:
        raise ValueError(f"{n_buckets} keys and {k} windows do not fit the "
                         "bucket block's shared memory")
    return dict(design="strip_owner", strip_rows=strip_rows, chunk=chunk,
                warps=warps, tiles_x=tiles_x, n_buckets=n_buckets,
                max_items=max_items, grid=max_items, buf_rows=buf_rows,
                smem_bytes=buf_rows * ROW_BYTES + STRIP_META * chunk + 16,
                bucket_grid=n_buckets, bucket_threads=32 * BUCKET_WARPS,
                bucket_smem_bytes=bucket_smem,
                scratch_words=4 * max_items + 4 + 2 * n_buckets + 3 * k)


def plan_views(scratch: torch.Tensor, geom: dict, k: int) -> dict:
    """The plan ``colsum_bucket`` writes into the int32 scratch tensor
    (``StripPlan``): items ``[max_items, 4]`` ({key, first, n, 0}), the
    item count, per-key counts and starts, and by position in key order
    the windows' clamped origins ``[k, 2]`` (row, column) and indices."""
    mi, nb = geom["max_items"], geom["n_buckets"]
    o = 4 * mi + 4
    return dict(items=scratch[:4 * mi].view(mi, 4), n_items=scratch[4 * mi],
                bucket_count=scratch[o:o + nb],
                bucket_start=scratch[o + nb:o + 2 * nb],
                origin=scratch[o + 2 * nb:o + 2 * nb + 2 * k].view(k, 2),
                order=scratch[o + 2 * nb + 2 * k:o + 2 * nb + 3 * k])


def strip_plan(ys0, xs0, count, h: int, w: int, rows: int, strip_rows: int,
               chunk: int, warps: Optional[int] = None) -> dict:
    """On the CPU, what ``colsum_bucket`` writes for these origins: the
    live windows' keys, per-key counts and starts, the windows in key order
    (index order inside a key) with their clamped origins, the items (key,
    first position in the
    order, windows) in key order, and what each item's block stages: its
    bounding box (first row and column, rows, columns) and the buffer loads
    it takes (1 unless the box outgrows the buffer).  ``geometry``: the
    launch's ``strip_geometry``."""
    k = ys0.shape[0]
    geom = strip_geometry(k, h, w, rows, strip_rows, chunk, warps or chunk)
    live = int(_count_tensor(count, k, "cpu"))
    y0, x0 = clamp_origins(ys0.cpu()[:live], xs0.cpu()[:live], h, w, rows)
    nb = geom["n_buckets"]
    key = (y0 // strip_rows) * geom["tiles_x"] + x0 // LANES
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=nb)
    starts = torch.cumsum(counts, 0) - counts
    per = -(-counts // chunk)
    base = torch.cumsum(per, 0) - per
    n_items = int(per.sum())
    ikey = torch.repeat_interleave(torch.arange(nb), per)
    i = torch.arange(n_items) - base[ikey]
    first = starts[ikey] + i * chunk
    n = torch.clamp(counts[ikey] - i * chunk, max=chunk)
    # Item of each position of the order, and the boxes by segment.
    skey = key[order]
    pos = torch.arange(live)
    item_of = base[skey] + torch.div(pos - starts[skey], chunk,
                                     rounding_mode="floor")
    ys, xs = y0[order], x0[order]

    def seg(v, how, fill):
        return torch.full((n_items,), fill, dtype=torch.int64).scatter_reduce(
            0, item_of, v, how, include_self=False)

    ymin, ymax = seg(ys, "amin", 0), seg(ys, "amax", 0)
    xmin, xmax = seg(xs, "amin", 0), seg(xs, "amax", 0)
    box_rows = ymax - ymin + rows
    box_cols = xmax - xmin + LANES
    load_rows = torch.minimum(box_rows,
                              geom["buf_rows"] * LANES // box_cols)
    i32 = lambda t: t.to(torch.int32)
    return dict(geometry=geom, live=live, n_items=n_items,
                bucket_count=i32(counts), bucket_start=i32(starts),
                order=i32(order), origin=i32(torch.stack([ys, xs], 1)),
                items=i32(torch.stack([ikey, first, n], 1)),
                box=i32(torch.stack([ymin, xmin, box_rows, box_cols], 1)),
                loads=i32(-(-box_rows // load_rows)))


def plan_matches(device_plan: dict, host_plan: dict) -> bool:
    """The device's plan (``plan_views`` of a launch) equals ``strip_plan``:
    the same items, each with the same windows, in the same order."""
    n, live = host_plan["n_items"], host_plan["live"]
    d = {key: v.cpu() for key, v in device_plan.items()
         if torch.is_tensor(v)}
    return (int(d["n_items"]) == n
            and torch.equal(d["items"][:n, :3], host_plan["items"])
            and torch.equal(d["bucket_count"], host_plan["bucket_count"])
            and torch.equal(d["bucket_start"], host_plan["bucket_start"])
            and torch.equal(d["order"][:live], host_plan["order"])
            and torch.equal(d["origin"][:live], host_plan["origin"]))


@functools.lru_cache(maxsize=None)
def _strip_occupancy(device_index: int, k: int, h: int, w: int, rows: int,
                     strip_rows: int, chunk: int, warps: int,
                     par: bool) -> int:
    import ctypes
    lib = build.load_library()
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device_index):
        build.check(lib.sift_window_colsum_strip_geometry(
            k, h, w, rows, strip_rows, chunk, warps, int(par), out),
            "sift_window_colsum_strip_geometry")
    g = strip_geometry(k, h, w, rows, strip_rows, chunk, warps)
    got = list(out)
    want = [g["smem_bytes"], got[1], g["n_buckets"], g["bucket_smem_bytes"],
            g["bucket_threads"], g["buf_rows"], g["grid"], g["tiles_x"]]
    if got != want:
        raise RuntimeError("strip_geometry disagrees with the kernel's: "
                           f"{got} against {want}")
    if out[1] < 1:
        raise RuntimeError(f"a strip block of {warps} warps and {out[0]} "
                           "bytes does not fit an SM")
    return out[1]


def strip_design(device, k: int, h: int, w: int, rows: int,
                 strip_rows: int, chunk: int, warps: int,
                 par: bool = False) -> dict:
    """What one strip launch looks like: ``strip_geometry`` and the strip
    blocks one SM holds (CUDA occupancy calculator)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return dict(**strip_geometry(k, h, w, rows, strip_rows, chunk, warps),
                blocks_per_sm=_strip_occupancy(index, k, h, w, rows,
                                               strip_rows, chunk, warps,
                                               par))


def ring_smem_bytes(block_k: int, nbuf: int, band_rows: int) -> int:
    """Dynamic shared memory of one ring block, as csrc/window_proto.cu lays
    it out: ``nbuf`` slots of ``band_rows`` window rows, the warps' window
    sums double-buffered ([2, block_k] rows), two mbarriers per slot and
    128 bytes to align the base."""
    return (nbuf * band_rows * ROW_BYTES + 2 * block_k * ROW_BYTES
            + 2 * nbuf * 8 + 128)


def ring_band(rows: int, band_rows: Optional[int]) -> int:
    """Rows of one ring slot: ``band_rows``, or the whole window."""
    return rows if band_rows is None else band_rows


def check_ring(rows: int, block_k: int, nbuf: int,
               band_rows: Optional[int]) -> None:
    """Raise on ring arguments the kernel cannot take: a slot is one TMA
    tile of ``band_rows`` x 128 (a box side is at most 256), the bands tile
    the window exactly, and the block's shared memory fits the SM."""
    band_rows = ring_band(rows, band_rows)
    if not 1 <= band_rows <= 256 or rows % band_rows:
        raise ValueError(f"band_rows must divide rows={rows} and lie in "
                         f"1..256, got {band_rows}")
    if nbuf < 1:
        raise ValueError(f"nbuf must be >= 1, got {nbuf}")
    if not 1 <= block_k <= 32:
        raise ValueError(f"block_k must be in 1..32, got {block_k}")
    smem = ring_smem_bytes(block_k, nbuf, band_rows)
    if smem > BLOCK_SMEM_MAX:
        raise ValueError(f"a ring of {nbuf} x {band_rows} rows needs {smem} "
                         f"bytes of shared memory (at most {BLOCK_SMEM_MAX})")


@functools.lru_cache(maxsize=None)
def _ring_occupancy(device_index: int, block_k: int, nbuf: int,
                    band_rows: int) -> int:
    import ctypes
    lib = build.load_library()
    smem, per_sm = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(lib.sift_window_colsum_ring_geometry(
            block_k, nbuf, band_rows, ctypes.byref(smem),
            ctypes.byref(per_sm)), "sift_window_colsum_ring_geometry")
    if smem.value != ring_smem_bytes(block_k, nbuf, band_rows):
        raise RuntimeError("ring_smem_bytes disagrees with the kernel's "
                           f"layout: {smem.value} bytes")
    if per_sm.value < 1:
        raise RuntimeError(f"a ring block of {block_k} warps and "
                           f"{smem.value} bytes does not fit an SM")
    return per_sm.value


def ring_grid(device, block_k: int, nbuf: int, band_rows: int) -> int:
    """Blocks of the ring kernel's persistent grid: one wave on the card
    (SMs x the blocks one SM holds, from the CUDA occupancy calculator),
    fixed by the card, never by the data."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * _ring_occupancy(index, block_k, nbuf, band_rows)


def ring_tensor_map(h: int, w: int, band_rows: int) -> dict:
    """The arguments csrc/window_proto.cu gives cuTensorMapEncodeTiled for
    an [h, w] float32 slab (innermost dimension first): the whole slab,
    rows ``w * 4`` bytes apart, a box of one band.  Raises where TMA
    cannot take them (row stride a multiple of 16 bytes, box sides <= 256,
    dimensions below 2**32)."""
    if w % 4 or w < LANES or not 0 < h < 2 ** 32 or w >= 2 ** 32:
        raise ValueError(f"a {h}x{w} slab has no TMA map (width % 4 == 0, "
                         f">= {LANES})")
    if not 1 <= band_rows <= min(256, h):
        raise ValueError(f"box of {band_rows} rows (1..256, <= {h})")
    return dict(global_dim=(w, h), global_stride_bytes=(w * 4,),
                box_dim=(LANES, band_rows), element_strides=(1, 1),
                box_bytes=band_rows * ROW_BYTES)


def ring_design(device, rows: int, block_k: int, nbuf: int,
                band_rows: Optional[int]) -> dict:
    """What one ring launch looks like: stages, band, slot and block bytes
    and grid."""
    band_rows = ring_band(rows, band_rows)
    return dict(design="tma_2d_mbarrier_ring", block_k=block_k, nbuf=nbuf,
                band_rows=band_rows, bands_per_window=rows // band_rows,
                slot_bytes=band_rows * ROW_BYTES,
                smem_bytes=ring_smem_bytes(block_k, nbuf, band_rows),
                grid=ring_grid(device, block_k, nbuf, band_rows))


def _launch(name: str, slab, ys0, xs0, rows, count, block_k, par=None,
            nbuf: int = 0, band_rows: Optional[int] = None,
            strip=STRIP_DEFAULT, plan: Optional[dict] = None):
    if not slab.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{slab.device}")
    _check_args(slab, ys0, xs0, rows, block_k, par)
    if not slab.is_contiguous() or slab.data_ptr() % 16:
        raise ValueError("slab must be contiguous and 16-byte aligned")
    h, w = slab.shape
    k = ys0.shape[0]
    ys0, xs0 = ys0.contiguous(), xs0.contiguous()
    cnt = _count_tensor(count, k, slab.device)
    out = torch.empty((k, LANES), dtype=torch.float32, device=slab.device)
    lib = build.load_library()
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (slab.data_ptr(), ys0.data_ptr(), xs0.data_ptr())
        if name == "window_colsum_ring":
            check_ring(rows, block_k, nbuf, band_rows)
            band_rows = ring_band(rows, band_rows)
            ring_tensor_map(h, w, band_rows)
            grid = ring_grid(slab.device, block_k, nbuf, band_rows)
            rc = lib.sift_window_colsum_ring(
                *head, cnt.data_ptr(), out.data_ptr(), k, h, w, rows,
                block_k, nbuf, band_rows, grid, stream)
        else:
            geom = strip_geometry(k, h, w, rows, *strip)
            scratch = torch.empty(geom["scratch_words"], dtype=torch.int32,
                                  device=slab.device)
            tail = (out.data_ptr(), scratch.data_ptr(), k, h, w, rows)
            if name == "window_colsum_static":
                rc = lib.sift_window_colsum_static(
                    *head, cnt.data_ptr(), *tail, *strip, stream)
            else:
                par = par.contiguous()
                rc = lib.sift_window_colsum_par(
                    *head, par.data_ptr(), cnt.data_ptr(), *tail, block_k,
                    *strip, stream)
            if plan is not None:
                plan.update(plan_views(scratch, geom, k), geometry=geom)
    build.check(rc, f"sift_{name}")
    launches[name] += 1
    return out


def window_colsum_static_cuda(slab, ys0, xs0, rows: int, count,
                              block_k: int = 8, *,
                              strip_rows: int = STRIP_DEFAULT[0],
                              chunk: int = STRIP_DEFAULT[1],
                              warps: int = STRIP_DEFAULT[2],
                              plan: Optional[dict] = None) -> torch.Tensor:
    """Launch the bucket pass and the strip kernel; raises on anything they
    do not take.  ``block_k`` (the JAX script's block) does not change the
    sum; ``strip_rows``, ``chunk`` and ``warps`` set the strip geometry.
    A ``plan`` dict receives the launch's plan (``plan_views``) and
    ``geometry``."""
    return _launch("window_colsum_static", slab, ys0, xs0, rows, count,
                   block_k, strip=(strip_rows, chunk, warps), plan=plan)


def window_colsum_par_cuda(slab, ys0, xs0, par, rows: int, count,
                           block_k: int = 8, *,
                           strip_rows: int = STRIP_DEFAULT[0],
                           chunk: int = STRIP_DEFAULT[1],
                           warps: int = STRIP_DEFAULT[2],
                           plan: Optional[dict] = None) -> torch.Tensor:
    """The same with ``par[k, 0]`` added to every live row ``k`` with
    ``k % block_k == 0``, each block gathering its windows' values."""
    if par is None:
        raise ValueError("window_colsum_par needs par [K, 16]")
    return _launch("window_colsum_par", slab, ys0, xs0, rows, count, block_k,
                   par=par, strip=(strip_rows, chunk, warps), plan=plan)


def window_colsum_ring_cuda(slab, ys0, xs0, rows: int, count,
                            block_k: int = RING_DEFAULT[0],
                            nbuf: int = RING_DEFAULT[1],
                            band_rows: Optional[int] = RING_DEFAULT[2]
                            ) -> torch.Tensor:
    """Launch the persistent TMA ring kernel (``block_k`` consumer warps
    per block, an ``nbuf``-slot ring of ``band_rows``-row tiles, whole
    windows by default)."""
    return _launch("window_colsum_ring", slab, ys0, xs0, rows, count,
                   block_k, nbuf=nbuf, band_rows=band_rows)


def _dispatch(impl: str, device) -> bool:
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    return resolve_kernel_impl(impl, device) == "cuda"


def window_colsum_static(slab, ys0, xs0, rows: int, count, block_k: int = 8,
                         impl: str = "auto") -> torch.Tensor:
    """[K, 128] column sums.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor, or ``impl="torch"``, takes the plain version."""
    if _dispatch(impl, slab.device):
        return window_colsum_static_cuda(slab, ys0, xs0, rows, count,
                                         block_k)
    return window_colsum_plain(slab, ys0, xs0, rows, count, block_k=block_k)


def window_colsum_par(slab, ys0, xs0, par, rows: int, count,
                      block_k: int = 8, impl: str = "auto") -> torch.Tensor:
    if _dispatch(impl, slab.device):
        return window_colsum_par_cuda(slab, ys0, xs0, par, rows, count,
                                      block_k)
    return window_colsum_plain(slab, ys0, xs0, rows, count, par, block_k,
                               name="window_colsum_par")


def window_colsum_ring(slab, ys0, xs0, rows: int, count,
                       block_k: int = RING_DEFAULT[0],
                       nbuf: int = RING_DEFAULT[1],
                       band_rows: Optional[int] = RING_DEFAULT[2],
                       impl: str = "auto") -> torch.Tensor:
    check_ring(rows, block_k, nbuf, band_rows)
    if _dispatch(impl, slab.device):
        return window_colsum_ring_cuda(slab, ys0, xs0, rows, count, block_k,
                                       nbuf, band_rows)
    return window_colsum_plain(slab, ys0, xs0, rows, count,
                               name="window_colsum_ring")


# ---------------------------------------------------------------------------
# The experiment
# ---------------------------------------------------------------------------

H, W, ROWS, CAPACITY, LIVE = 1536, 1024, 72, 5000, 1080
# Out of contract: windows taller than a strip buffer holds beside a strip,
# at unaligned and out-of-range origins.
OOC_ROWS = 440


def workload(device, seed: int = 0):
    """The JAX script's workload: a [1536, 1024] normal slab, 5000 aligned
    origins (rows to 8, columns to 128), 1080 of them live, and a
    [5000, 16] parameter array."""
    rng = np.random.default_rng(seed)
    slab = rng.normal(size=(H, W)).astype(np.float32)
    ys0 = (rng.integers(0, (H - ROWS) // 8, CAPACITY) * 8).astype(np.int32)
    xs0 = (rng.integers(0, (W - LANES) // 128, CAPACITY) * 128
           ).astype(np.int32)
    par = rng.normal(size=(CAPACITY, NPAR)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return dict(slab=t(slab), ys0=t(ys0), xs0=t(xs0), par=t(par), rows=ROWS,
                count=torch.full((1,), LIVE, dtype=torch.int32,
                                 device=device))


def clustered_workload(device, seed: int = 0):
    """The workload's slab, parameters and count with every origin in one
    128-row strip of one column tile (rows 8 * [0, 16), column 256): what a
    textured patch of a frame does to the per-keypoint kernels."""
    wl = workload(device, seed)
    rng = np.random.default_rng(seed + 1)
    ys0 = (rng.integers(0, 16, CAPACITY) * 8).astype(np.int32)
    wl["ys0"] = torch.as_tensor(ys0, device=device)
    wl["xs0"] = torch.full((CAPACITY,), 256, dtype=torch.int32, device=device)
    return wl


def out_of_contract_workload(device, seed: int = 0):
    """The workload's slab with ``OOC_ROWS``-row windows at origins
    anywhere in and around the slab (columns not aligned): the strip
    kernels stage such boxes in several buffer loads."""
    wl = workload(device, seed)
    rng = np.random.default_rng(seed + 2)
    t = lambda a: torch.as_tensor(a.astype(np.int32), device=device)
    wl["ys0"] = t(rng.integers(-100, H + 100, CAPACITY))
    wl["xs0"] = t(rng.integers(-100, W + 100, CAPACITY))
    wl["rows"] = OOC_ROWS
    return wl


def time_ms(fn, reps: int = 50, warm: int = 5) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def run_experiment(device="cuda") -> dict:
    """Check and time the three schemes on the workload, the strip sweep
    and the clustered set.  Returns a dict with ``ok`` and one entry per
    scheme, set and sweep point."""
    from sift_tpu_torch.perf.profile import device_ms

    sets = dict(uniform=workload(device), clustered=clustered_workload(device))
    refs = {label: (window_colsum_plain(s["slab"], s["ys0"], s["xs0"],
                                        s["rows"], s["count"]),
                    window_colsum_plain(s["slab"], s["ys0"], s["xs0"],
                                        s["rows"], s["count"], s["par"], 8,
                                        name="window_colsum_par"))
            for label, s in sets.items()}
    close = lambda a, b: bool(torch.allclose(a, b, rtol=1e-5, atol=1e-4))
    rows = ROWS
    # Each input byte the live windows need read once (they overlap: at
    # most the whole slab), each output byte written once, plus origins.
    bytes_ = (min(LIVE * rows * LANES * 4, H * W * 4)
              + CAPACITY * LANES * 4 + CAPACITY * 8)
    entries = []

    def entry(scheme, label, fn, want, exact, **kw):
        out = fn()
        again = fn()
        torch.cuda.synchronize()
        e = dict(scheme=scheme, set=label, **kw,
                 matches_plain=bool(torch.equal(out, want)) if exact
                 else close(out, want),
                 bit_exact=bool(torch.equal(out, want)),
                 bit_reproducible=bool(torch.equal(out, again)),
                 max_abs_err=float((out - want).abs().max()),
                 rows_past_count_zero=bool((out[LIVE:] == 0).all()),
                 ms=time_ms(fn), device_ms=device_ms(fn, name="colsum_"))
        entries.append(e)
        return out

    for label, s in sets.items():
        a = (s["slab"], s["ys0"], s["xs0"])
        ref, ref_par = refs[label]
        for scheme, fn, want, par in (
                ("static", lambda **g: window_colsum_static_cuda(
                    *a, rows, s["count"], **g), ref, False),
                ("par", lambda **g: window_colsum_par_cuda(
                    *a, s["par"], rows, s["count"], 8, **g), ref_par, True)):
            points = STRIP_SWEEP if (label, scheme) == ("uniform", "static") \
                else (STRIP_DEFAULT,)
            for t, c, nw in points:
                g = dict(strip_rows=t, chunk=c, warps=nw)
                plan = {}
                fn(plan=plan, **g)
                torch.cuda.synchronize()
                host = strip_plan(s["ys0"], s["xs0"], s["count"], H, W, rows,
                                  t, c, nw)
                call = functools.partial(fn, **g)
                entry(scheme, label, call, want, True,
                      default=(t, c, nw) == STRIP_DEFAULT,
                      bucket_device_ms=device_ms(call, name="colsum_bucket"),
                      strip_device_ms=device_ms(call, name="colsum_strip"),
                      n_items=int(plan["n_items"]),
                      plan_matches=plan_matches(plan, host),
                      staged_rows=int(host["box"][:, 2].sum()),
                      **strip_design(s["slab"].device, CAPACITY, H, W, rows,
                                     t, c, nw, par))
    s = sets["uniform"]
    a = (s["slab"], s["ys0"], s["xs0"])
    static = window_colsum_static_cuda(*a, rows, s["count"])
    for bk, nbuf, band in SWEEP:
        out = entry("ring", "uniform", lambda bk=bk, nbuf=nbuf, band=band:
                    window_colsum_ring_cuda(*a, rows, s["count"], bk, nbuf,
                                            band), refs["uniform"][0], False,
                    **ring_design(s["slab"].device, rows, bk, nbuf, band))
        entries[-1]["matches_static"] = close(out, static)
    plain_ms = time_ms(lambda: window_colsum_plain(*a, rows, s["count"]),
                       reps=10, warm=2)
    ok = all(e["matches_plain"] and e["rows_past_count_zero"]
             and e["bit_reproducible"] and e.get("plan_matches", True)
             and e.get("matches_static", True) for e in entries)
    return dict(ok=ok, slab=[H, W], rows=rows, capacity=CAPACITY, live=LIVE,
                bytes=bytes_, window_bytes=LIVE * rows * LANES * 4,
                bound_ms=bytes_ / 3.35e12 * 1e3, plain_ms=plain_ms,
                tolerance=("strip kernels torch.equal (bit for bit, the "
                           "plain version's row order); ring allclose rtol "
                           "1e-5 atol 1e-4"),
                entries=entries)


# One tree's static and par kernels on the sets saved by compare_trees, run
# with that tree's package (only calls both trees have).
_TREE_TIMES = r"""
import json, sys
import torch
from sift_tpu_torch.perf import window_proto as WP
from sift_tpu_torch.perf.profile import device_ms
res = {}
for label, s in torch.load(sys.argv[1]).items():
    g = {key: v.cuda() if torch.is_tensor(v) else v for key, v in s.items()}
    a = (g["slab"], g["ys0"], g["xs0"])
    for scheme, fn in (
            ("static", lambda: WP.window_colsum_static_cuda(
                *a, g["rows"], g["count"])),
            ("par", lambda: WP.window_colsum_par_cuda(
                *a, g["par"], g["rows"], g["count"]))):
        out = fn()
        want = g["ref_" + scheme]
        torch.cuda.synchronize()
        res[label + "_" + scheme] = dict(
            device_ms=device_ms(fn, name="colsum_"), ms=WP.time_ms(fn),
            bit_exact=bool(torch.equal(out, want)),
            max_abs_err=float((out - want).abs().max()))
print(json.dumps(res))
"""


def compare_trees(parent: str) -> dict:
    """K6/K7 of the checkout ``parent`` and of this one on the uniform and
    clustered sets, in turns parent, this, this, parent: each run a
    subprocess with the tree's own package (and its own build), the
    kernels held against this tree's plain version (computed on the CPU)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sets = {}
    for label, wl in (("uniform", workload("cpu")),
                      ("clustered", clustered_workload("cpu"))):
        a = (wl["slab"], wl["ys0"], wl["xs0"], wl["rows"], wl["count"])
        wl["ref_static"] = window_colsum_plain(*a)
        wl["ref_par"] = window_colsum_plain(*a, wl["par"], 8,
                                            name="window_colsum_par")
        sets[label] = wl
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sets.pt")
        torch.save(sets, path)
        for name, tree in (("parent", parent), ("this", here),
                           ("this", here), ("parent", parent)):
            tree = os.path.abspath(tree)
            p = subprocess.run([sys.executable, "-c", _TREE_TIMES, path],
                               cwd=tree, env=dict(os.environ,
                                                  PYTHONPATH=tree),
                               capture_output=True, text=True)
            if p.returncode:
                raise RuntimeError(f"{name} tree {tree} failed:\n"
                                   f"{p.stderr[-4000:]}")
            runs.append(dict(tree=name, path=tree,
                             **json.loads(p.stdout.strip().splitlines()[-1])))
    ok = all(v["bit_exact"] for r in runs if r["tree"] == "this"
             for key, v in r.items() if isinstance(v, dict))
    return dict(ok=ok, runs=runs,
                tolerance="this tree: torch.equal to the row-ordered plain "
                          "version; the parent's is reported")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", default=None,
                    help="another checkout whose static and par kernels "
                         "are timed beside this tree's")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_proto: needs a CUDA device", file=sys.stderr)
        return 1
    res = compare_trees(args.parent) if args.parent \
        else run_experiment("cuda")
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
