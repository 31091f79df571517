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
  only and streams them through an ``nbuf``-slot shared-memory ring with
  ``cp.async``, one wait per slot.

``window_colsum_plain`` is the same function in plain PyTorch (with the
``par`` variant); the ``*_cuda`` wrappers launch or raise.  ``main`` runs
the JAX script's workload (slab 1536x1024, rows 72, capacity 5000, 1080
live, the same ``block_k``/``nbuf`` sweep), checks the schemes against each
other and against the plain version, and prints each time: ``ms`` from CUDA
events around back-to-back calls of the wrapper, ``device_ms`` the kernel's
own duration from ``torch.profiler``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from sift_tpu_torch.kernels import build

LANES = 128
NPAR = 16
RING_ROWS = 2                      # rows per ring slot (csrc/window_proto.cu)
RING_NBUF = (2, 4, 8)              # ring depths the kernel is built for
SWEEP = ((8, 2), (8, 4), (8, 8), (16, 4), (32, 2), (32, 4))  # (block_k, nbuf)

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
    if w % 4 or w < LANES or rows <= 0 or rows % RING_ROWS or h < rows:
        raise ValueError(f"slab {h}x{w} cannot hold a {rows}x{LANES} window "
                         f"(width % 4 == 0, rows % {RING_ROWS} == 0)")
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


def _launch(name: str, slab, ys0, xs0, rows, count, block_k, par=None,
            nbuf: int = 0):
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
            if nbuf not in RING_NBUF:
                raise ValueError(f"nbuf must be one of {RING_NBUF}, got "
                                 f"{nbuf}")
            grid = ring_grid(slab.device, block_k, nbuf)
            rc = lib.sift_window_colsum_ring(*head, *tail, nbuf, grid,
                                             stream)
    build.check(rc, f"sift_{name}")
    launches[name] += 1
    return out


def ring_grid(device, block_k: int, nbuf: int) -> int:
    """Blocks of the ring kernel's persistent grid: per SM as many blocks
    as give it 32 warps (``32 // block_k``), fewer where their rings would
    not fit 200 KB of shared memory; fixed by the card, never by the data."""
    smem = block_k * nbuf * RING_ROWS * 32 * 16
    blocks_per_sm = max(1, min(32 // block_k, (200 * 1024) // smem))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * blocks_per_sm


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
                            block_k: int = 8, nbuf: int = 4) -> torch.Tensor:
    """Launch the persistent ring kernel (``block_k`` warps per block, each
    with an ``nbuf``-slot ring)."""
    return _launch("window_colsum_ring", slab, ys0, xs0, rows, count,
                   block_k, nbuf=nbuf)


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


def window_colsum_ring(slab, ys0, xs0, rows: int, count, block_k: int = 8,
                       nbuf: int = 4, impl: str = "auto") -> torch.Tensor:
    if _dispatch(impl, slab.device):
        return window_colsum_ring_cuda(slab, ys0, xs0, rows, count, block_k,
                                       nbuf)
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
    for bk, nbuf in SWEEP:
        b = entry("ring", lambda bk=bk, nbuf=nbuf: window_colsum_ring_cuda(
            slab, ys0, xs0, rows, count, bk, nbuf), ref, block_k=bk,
            nbuf=nbuf, grid=ring_grid(slab.device, bk, nbuf))
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
