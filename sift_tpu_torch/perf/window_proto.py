"""Experiment: three schemes for loading per-keypoint windows, head to head.

    python -m sift_tpu_torch.perf.window_proto [--out FILE.json]

Counterpart of ``scripts/dma_proto.py`` (``p0``, ``p0b``, ``p1``).  The toy
function is a column sum over one ``[rows, 128]`` float32 window per
keypoint, read from a slab at scattered aligned origins:

    out[k, :] = sum_i slab[ys0[k] + i, xs0[k] : xs0[k] + 128]   for k < count

Rows at or past ``count`` are zero (the JAX script leaves them unspecified
and compares live rows only).  The three CUDA kernels (``csrc/window_proto.cu``)
compute it by three loading schemes:

* ``window_colsum_static`` — a static grid over the capacity, one warp per
  window, direct coalesced global loads summed in registers;
* ``window_colsum_par`` — the same, with the block's ``[block_k, 16]``
  parameter tile staged in shared memory first; ``par[first row of the
  block, 0]`` is added to the block's first output row;
* ``window_colsum_ring`` — a persistent grid that walks the LIVE windows
  only; one thread per block copies each window in ``band_rows``-row tiles
  with the Tensor Memory Accelerator into an ``nbuf``-slot shared-memory
  ring guarded by mbarriers, and ``block_k`` warps sum the slots.

``window_colsum_plain`` is the same function in plain PyTorch (with the
``par`` variant); the ``*_cuda`` wrappers launch or raise.  ``main`` runs
the JAX script's workload (slab 1536x1024, rows 72, capacity 5000, 1080
live; the ring swept over consumer warps, ring depth and band rows, each
point with its layout), checks the schemes against each other and against
the plain version, and prints each time: ``ms`` from CUDA
events around back-to-back calls of the wrapper, ``device_ms`` the kernel's
own duration from ``torch.profiler``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
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
# The most dynamic shared memory one block may have on the H100 (bytes).
BLOCK_SMEM_MAX = 227 * 1024

_NAMES = ("window_colsum_static", "window_colsum_par", "window_colsum_ring")
# Launch counts: ``launches[name]`` rises by one where a wrapper launches
# its CUDA kernel and nowhere else; ``plain_calls`` counts plain versions.
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


def window_colsum_plain(slab: torch.Tensor, ys0, xs0, rows: int, count,
                        par: Optional[torch.Tensor] = None,
                        block_k: int = 8,
                        name: str = "window_colsum_static") -> torch.Tensor:
    """Plain PyTorch version of all three kernels (any device); with
    ``par`` the variant that adds ``par[b * block_k, 0]`` to output row
    ``b * block_k`` of every live block.  ``name``: which kernel's
    ``plain_calls`` counter this call counts under.  Origins are clamped
    into the slab and ``xs0`` aligned down to 4 columns, as the kernels do."""
    plain_calls[name] += 1
    _check_args(slab, ys0, xs0, rows, block_k, par)
    h, w = slab.shape
    k = ys0.shape[0]
    dev = slab.device
    y0 = torch.clamp(ys0.to(torch.int64), 0, h - rows)
    x0 = torch.div(torch.clamp(xs0.to(torch.int64), 0, w - LANES), 4,
                   rounding_mode="floor") * 4
    y = y0[:, None] + torch.arange(rows, device=dev)
    x = x0[:, None] + torch.arange(LANES, device=dev)
    out = slab[y[:, :, None], x[:, None, :]].sum(1)
    live = torch.arange(k, device=dev) < _count_tensor(count, k, dev)
    if par is not None:
        first = (torch.arange(k, device=dev) % block_k) == 0
        out = out + torch.where(first, par[:, 0],
                                torch.zeros_like(par[:, 0]))[:, None]
    return torch.where(live[:, None], out, torch.zeros_like(out))


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
            nbuf: int = 0, band_rows: Optional[int] = None):
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
        tail = (cnt.data_ptr(), out.data_ptr(), k, h, w, rows, block_k)
        if name == "window_colsum_static":
            rc = lib.sift_window_colsum_static(*head, *tail, stream)
        elif name == "window_colsum_par":
            par = par.contiguous()
            rc = lib.sift_window_colsum_par(*head, par.data_ptr(), *tail,
                                            stream)
        else:
            check_ring(rows, block_k, nbuf, band_rows)
            band_rows = ring_band(rows, band_rows)
            ring_tensor_map(h, w, band_rows)
            grid = ring_grid(slab.device, block_k, nbuf, band_rows)
            rc = lib.sift_window_colsum_ring(*head, *tail, nbuf, band_rows,
                                             grid, stream)
    build.check(rc, f"sift_{name}")
    launches[name] += 1
    return out


def window_colsum_static_cuda(slab, ys0, xs0, rows: int, count,
                              block_k: int = 8) -> torch.Tensor:
    """Launch the static-grid kernel; raises on anything it does not take."""
    return _launch("window_colsum_static", slab, ys0, xs0, rows, count,
                   block_k)


def window_colsum_par_cuda(slab, ys0, xs0, par, rows: int, count,
                           block_k: int = 8) -> torch.Tensor:
    """Launch the kernel that stages the parameter tile first."""
    if par is None:
        raise ValueError("window_colsum_par needs par [K, 16]")
    return _launch("window_colsum_par", slab, ys0, xs0, rows, count, block_k,
                   par=par)


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
    return window_colsum_plain(slab, ys0, xs0, rows, count)


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
    """Check and time the three schemes on the workload.  Returns a dict
    with ``ok`` and one entry per scheme and sweep point."""
    from sift_tpu_torch.perf.profile import device_ms

    wl = workload(device)
    slab, ys0, xs0, par = wl["slab"], wl["ys0"], wl["xs0"], wl["par"]
    rows, count = wl["rows"], wl["count"]
    ref = window_colsum_plain(slab, ys0, xs0, rows, count)
    ref_par = window_colsum_plain(slab, ys0, xs0, rows, count, par, 8,
                                  name="window_colsum_par")
    close = lambda a, b: bool(torch.allclose(a, b, rtol=1e-5, atol=1e-4))
    # Each input byte the live windows need read once (they overlap: at
    # most the whole slab), each output byte written once, plus origins.
    bytes_ = (min(LIVE * rows * LANES * 4, slab.numel() * 4)
              + CAPACITY * LANES * 4 + CAPACITY * 8)
    entries = []

    def entry(scheme, fn, want, **kw):
        out = fn()
        torch.cuda.synchronize()
        e = dict(scheme=scheme, **kw, matches_plain=close(out, want),
                 max_abs_err=float((out - want).abs().max()),
                 rows_past_count_zero=bool((out[LIVE:] == 0).all()),
                 ms=time_ms(fn), device_ms=device_ms(fn, name="colsum_"))
        entries.append(e)
        return out

    a = entry("static", lambda: window_colsum_static_cuda(
        slab, ys0, xs0, rows, count, 8), ref, block_k=8)
    entry("par", lambda: window_colsum_par_cuda(
        slab, ys0, xs0, par, rows, count, 8), ref_par, block_k=8)
    for bk, nbuf, band in SWEEP:
        b = entry("ring", lambda bk=bk, nbuf=nbuf, band=band:
                  window_colsum_ring_cuda(slab, ys0, xs0, rows, count, bk,
                                          nbuf, band), ref,
                  **ring_design(slab.device, rows, bk, nbuf, band))
        entries[-1]["matches_static"] = close(a, b)
    plain_ms = time_ms(lambda: window_colsum_plain(slab, ys0, xs0, rows,
                                                   count), reps=10, warm=2)
    ok = all(e["matches_plain"] and e["rows_past_count_zero"]
             and e.get("matches_static", True) for e in entries)
    return dict(ok=ok, slab=[H, W], rows=rows, capacity=CAPACITY, live=LIVE,
                bytes=bytes_, window_bytes=LIVE * rows * LANES * 4,
                bound_ms=bytes_ / 3.35e12 * 1e3,
                plain_ms=plain_ms, tolerance="allclose rtol 1e-5 atol 1e-4",
                entries=entries)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_proto: needs a CUDA device", file=sys.stderr)
        return 1
    res = run_experiment("cuda")
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
