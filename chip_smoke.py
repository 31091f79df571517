#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sift_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``SiftDetector.detect_and_compute`` on two
752x480 frames with ``num_features=5000``, then ``match_brute_force`` — and
its further paths: the golden capture + per-stage replay at the same size
(``perf/checkpoint.capture_golden``, ``perf/replay.Replayer``), one frame
each through the detector's non-fused branch (``sigma=2.0``: 256-column
windows; ``sigma=1.97``: 4 shifted copies), and the window-loading
experiment (``perf/window_proto``).  Every hand-written CUDA kernel is held
against its plain PyTorch version on the card, at the shapes its path gives
it, and each path's launch counters are set to 0 just before it runs and
read just after.  Phases (one JSON line each): ``device``, ``build``,
``main_path``, ``replay``, ``flat_frame``, ``window_proto``, then the
``kernels`` line; any failure exits non-zero.  Needs one CUDA device and
``nvcc``; imports ``sift_tpu_torch``, ``torch`` and ``numpy`` only.  The
last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Roofline figures: ``bound_ms`` is the larger of bytes / 3.35 TB/s (each
input byte the run's data needs read once, each output byte written once)
and float32 operations / 67 TFLOP/s (H100 SXM data sheet), both counted
from this run's inputs — live keypoints and their actual radii.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12          # H100 SXM float32, outside tensor cores

# Arithmetic operations per pixel that each FUNCTION needs (one per
# add/mul/compare/select; sqrt, exp, floor and divide as one each), not
# what a particular kernel happens to recompute.
DETECT_OPS_PER_RECORD = 250     # per pixel and record layer
ORI_OPS_PER_PIXEL = 57
DESC_OPS_PER_MASKED_PIXEL = 22  # offsets, masks, rotation, 4x4-grid test:
#                                 every pixel inside the radius/bounds mask
# Further operations of a pixel inside the grid: gradient and magnitude 6,
# polynomial atan2 32, Gaussian weights 9, orientation bin 6, three floors
# 3, two row hats 8, two column hats 8, two orientation hats 14, four
# row x column products 4, eight products and eight accumulations 16.
DESC_OPS_PER_GRID_PIXEL = 106


def say(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median over ``reps`` single calls, CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def warp_image(img: np.ndarray) -> np.ndarray:
    """A copy of ``img`` under a small affine map (2 degrees, 1.02x, a
    few pixels of shift), bilinear, reflected border — torch only."""
    h, w = img.shape
    th = math.radians(2.0)
    s = 1.0 / 1.02
    a = torch.tensor([[s * math.cos(th), -s * math.sin(th), 0.01],
                      [s * math.sin(th), s * math.cos(th), -0.008]],
                     dtype=torch.float32)[None]
    t = torch.from_numpy(img)[None, None]
    grid = torch.nn.functional.affine_grid(a, t.shape, align_corners=False)
    out = torch.nn.functional.grid_sample(
        t, grid, mode="bilinear", padding_mode="reflection",
        align_corners=False)
    return out[0, 0].numpy()


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------


def check_detect(gauss, cfg):
    """K1: ONE launch over every octave of the main path's pyramid, held
    octave by octave against one call of the plain version."""
    from sift_tpu_torch.config import SIFT_IMG_BORDER
    from sift_tpu_torch.kernels import fused_detect as FD
    from sift_tpu_torch.perf.profile import device_ms

    args = (float(cfg.peak_threshold), SIFT_IMG_BORDER,
            float(cfg.edge_threshold), float(cfg.contrast_threshold),
            cfg.num_octave_layers)
    tot = dict(n=0, flags=0, a=0, b=0, c=0, bad_conv=0)
    max_err = 0.0
    kers = FD.detect_records_cuda(gauss, *args)
    plas = FD.detect_records_plain(gauss, *args)
    torch.cuda.synchronize()
    exact = []
    for g, ker, pla in zip(gauss, kers, plas):
        if ker.shape != pla.shape or not torch.isfinite(ker).all():
            fail(f"detect_records: bad output for octave {tuple(g.shape)}")
        exact.append(bool(torch.equal(ker, pla)))
        h, w = g.shape[1:]
        if h < 3 or w < 3:
            continue
        ki = ker[:, :, 1:h - 1, 1:w - 1].to(torch.int64)
        pi = pla[:, :, 1:h - 1, 1:w - 1].to(torch.int64)
        tot["n"] += ki[0].numel()
        tot["flags"] += int(((ki[0] % 32) != (pi[0] % 32)).sum())
        tot["a"] += int((ki[0] != pi[0]).sum())
        tot["b"] += int((ki[1] != pi[1]).sum())
        tot["c"] += int((ki[2] != pi[2]).sum())
        conv = (pi[0] % 2).bool()
        for ch, quanta in ((1, (1, 2047, 2048, 2049)),
                           (2, (1, 1023, 1024, 1025))):
            d = ((ki[ch] - pi[ch]).abs())[conv]
            d = d[d > 0]
            if d.numel():
                ok = torch.isin(d, torch.tensor(quanta, device=d.device))
                tot["bad_conv"] += int((~ok).sum())
        # Largest difference of the decoded sub-pixel offsets on
        # converged pixels, in pixels (B holds x0/x1 at 1/2000 px).
        dx0 = ((ki[1] % 2048) - (pi[1] % 2048)).abs()[conv]
        if dx0.numel():
            max_err = max(max_err, float(dx0.max()) / 2000.0)
    n = tot["n"]
    passed = (all(exact)
              and tot["flags"] <= max(3, n // 100_000)
              and tot["a"] <= max(3, n // 100_000)
              and tot["b"] <= max(30, n // 5_000)
              and tot["c"] <= max(80, n // 2_000)
              and tot["bad_conv"] == 0)

    def run_kernel():
        FD.detect_records_cuda(gauss, *args)

    def run_octave0():
        FD.detect_records_cuda(gauss[:1], *args)

    ms = time_ms(run_kernel)
    ms0 = time_ms(run_octave0)
    plain_ms = time_ms(lambda: FD.detect_records_plain(gauss, *args),
                       reps=20, warm=2)
    nl = gauss[0].shape[0]
    pix = sum(g.shape[1] * g.shape[2] for g in gauss)
    bytes_ = (nl + 3 * (nl - 3)) * pix * 4
    ops = DETECT_OPS_PER_RECORD * (nl - 3) * pix
    return finish_entry(
        name="detect_records", source="sift_tpu_torch/csrc/fused_detect.cu",
        replaces="sift_tpu/kernels/fused_detect.py:205",
        shapes=[list(g.shape) for g in gauss], max_abs_err=max_err,
        tolerance=("bit-exact on every octave, rim included (the JAX "
                   "package's limits, reported beside: flag bits differ on "
                   "<= max(3, n/100000) interior pixels; A/B/C on <= "
                   "max(3, n/1e5) / max(30, n/5000) / max(80, n/2000); "
                   "single-quantum on converged pixels)"),
        passed=passed, ms=ms, plain_ms=plain_ms, bytes_=bytes_, ops=ops,
        extra=dict(interior_pixels=n, flag_mismatch=tot["flags"],
                   a_mismatch=tot["a"], b_mismatch=tot["b"],
                   c_mismatch=tot["c"], bit_exact_incl_rim=all(exact),
                   bit_exact_per_octave=exact, ms_octave0=ms0,
                   device_ms=device_ms(run_kernel,
                                       name="detect_records_kernel"),
                   device_ms_octave0=device_ms(
                       run_octave0, name="detect_records_kernel")))


def check_expand(base, copies):
    """K5 at the main path's slab shape: pure data movement, so exact."""
    from sift_tpu_torch.kernels import expand as EX
    from sift_tpu_torch.perf.profile import device_ms

    ker = EX.expand_lane_copies_cuda(base, copies)
    pla = EX.expand_lane_copies_plain(base, copies)
    torch.cuda.synchronize()
    exact = ker.shape == pla.shape and bool(torch.equal(ker, pla))
    err = float((ker - pla).abs().max()) if ker.shape == pla.shape \
        else float("inf")
    ms = time_ms(lambda: EX.expand_lane_copies_cuda(base, copies))
    plain_ms = time_ms(lambda: EX.expand_lane_copies_plain(base, copies))
    dev_ms = device_ms(lambda: EX.expand_lane_copies_cuda(base, copies),
                       name="expand_lane_copies_kernel")
    return finish_entry(
        name="expand_lane_copies", source="sift_tpu_torch/csrc/expand.cu",
        replaces="sift_tpu/kernels/expand.py:39",
        shapes=dict(base=list(base.shape), copies=copies),
        max_abs_err=err, tolerance="bit-exact", passed=exact, ms=ms,
        plain_ms=plain_ms, bytes_=(1 + copies) * base.numel() * 4, ops=0,
        extra=dict(bit_exact=exact, device_ms=dev_ms))


def finish_entry(*, name, source, replaces, shapes, max_abs_err, tolerance,
                 passed, ms, plain_ms, bytes_, ops, extra, library_ms=None):
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    e = dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=None, max_abs_err=max_abs_err, ms=ms,
             plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             library_ms=library_ms, launches_per_frame=None, shapes=shapes,
             tolerance=tolerance,
             passed=bool(passed), bytes=int(bytes_), operations=int(ops))
    e.update(extra)
    return e


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


def stage_bytes(values, par, nrow, ncol, count, nbins):
    """Bytes the live keypoints need: their windows (with the 1-px
    gradient halo, at most the whole slab), their parameter rows and
    origins, and their output rows."""
    win = float(((nrow + 2) * (ncol + 2)).sum()) * 4
    return (min(win, values.numel() * 4)
            + count * (par.shape[1] + 2) * 4 + count * nbins * 4 + 8)


def check_orientation(tap, label):
    """K2 against its plain version; two launches must give the same bits
    (no atomics), and a [start, start + count) sub-range the full run's
    rows with zeros outside."""
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.perf.profile import device_ms

    a = (tap["values"], tap["ys0"], tap["xs0"], tap["par"], tap["rows"],
         tap["lanes"])
    count = int(tap["count"])
    k = tap["ys0"].shape[0]
    ker = FS.orientation_hist_cuda(*a, count=tap["count"])
    again = FS.orientation_hist_cuda(*a, count=tap["count"])
    pla = FS.orientation_hist_plain(*a, count=tap["count"])
    st, cn = count // 3, count // 2
    sub = FS.orientation_hist_cuda(*a, count=cn, start=st)
    torch.cuda.synchronize()
    if not torch.isfinite(ker).all():
        fail(f"orientation_hist[{label}]: non-finite output")
    rel = ((ker - pla).abs() / (pla.abs() + 1e-3)).max().item() \
        if k else 0.0
    reproducible = bool(torch.equal(ker, again))
    tail_untouched = bool((ker[count:] == 0).all())
    subrange = (bool(torch.equal(sub[st:st + cn], ker[st:st + cn]))
                and bool((sub[:st] == 0).all())
                and bool((sub[st + cn:] == 0).all()))
    geom = FS.orientation_geometry(tap["rows"], tap["lanes"], k)
    # Out of contract: a radius beyond the window truncates the patch at the
    # window's interior, which the kernel stages in chunks of rows.
    big = tap["par"].clone()
    big[:64, 7] = 4.0 * tap["rows"]
    b = (tap["values"], tap["ys0"], tap["xs0"], big, tap["rows"],
         tap["lanes"])
    kb = FS.orientation_hist_cuda(*b, count=tap["count"])
    pb = FS.orientation_hist_plain(*b, count=tap["count"])
    torch.cuda.synchronize()
    rel_big = ((kb - pb).abs() / (pb.abs() + 1e-3)).max().item() \
        if k else 0.0
    passed = (rel < 1e-4 and tail_untouched and reproducible and subrange
              and rel_big < 1e-4
              and geom["smem_bytes"] == geom["smem_bytes_formula"])
    ms = time_ms(lambda: FS.orientation_hist_cuda(*a, count=tap["count"]))
    dev_ms = device_ms(lambda: FS.orientation_hist_cuda(
        *a, count=tap["count"]), name="orientation_hist_kernel")
    plain_ms = time_ms(
        lambda: FS.orientation_hist_plain(*a, count=tap["count"]),
        reps=20, warm=2)
    nrow, ncol, _ = window_work(tap["par"], tap["rows"], tap["lanes"], count)
    pixels = int((nrow * ncol).sum())
    return finish_entry(
        name="orientation_hist",
        source="sift_tpu_torch/csrc/orientation_hist.cu",
        replaces="sift_tpu/kernels/fused_stages.py:401",
        shapes=dict(slab=list(tap["values"].shape), capacity=k, live=count,
                    rows=tap["rows"], lanes=tap["lanes"]),
        max_abs_err=float((ker - pla).abs().max()) if k else 0.0,
        tolerance=("max |k-p| / (|p| + 1e-3) < 1e-4; rows outside "
                   "[start, start+count) zero; two launches bit-equal"),
        passed=passed, ms=ms, plain_ms=plain_ms,
        bytes_=stage_bytes(tap["values"], tap["par"], nrow, ncol, count, 36),
        ops=ORI_OPS_PER_PIXEL * pixels,
        extra=dict(inputs=label, max_rel_err=rel, pixels=pixels,
                   rows_past_count_zero=tail_untouched,
                   bit_reproducible=reproducible,
                   start_count_subrange_ok=subrange,
                   max_rel_err_beyond_window=rel_big, geometry=geom,
                   device_ms=dev_ms))


def check_descriptor(tap, label, radius_classes=False):
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.perf.profile import device_ms
    from sift_tpu_torch.ops.descriptor import (finalize_descriptor,
                                               quantize_descriptor)

    a = (tap["values"], tap["ys0"], tap["xs0"], tap["par"], tap["rows"],
         tap["lanes"])
    count = int(tap["count"])
    k = tap["ys0"].shape[0]
    ker = FS.descriptor_hist_cuda(*a, count=tap["count"])
    again = FS.descriptor_hist_cuda(*a, count=tap["count"])
    pla = FS.descriptor_hist_plain(*a, count=tap["count"])
    torch.cuda.synchronize()
    if not torch.isfinite(ker).all():
        fail(f"descriptor_hist[{label}]: non-finite output")
    # Two launches on the same inputs: the same bits (no atomics).
    reproducible = bool(torch.equal(ker, again))
    qk = quantize_descriptor(*finalize_descriptor(ker), "opencv")
    qp = quantize_descriptor(*finalize_descriptor(pla), "opencv")
    dq = (qk - qp).abs()
    tail_untouched = bool((ker[count:] == 0).all())
    extra = dict(inputs=label, max_u8_diff=float(dq.max()) if k else 0.0,
                 frac_u8_entries_differing=float((dq > 0).float().mean())
                 if k else 0.0,
                 rows_past_count_zero=tail_untouched,
                 bit_reproducible=reproducible)
    passed = ((not k or float(dq.max()) <= 1.0) and tail_untouched
              and reproducible)
    if radius_classes:
        rad = tap["par"][:count, 7]
        for name, lo, hi in (("r_le_26", 0, 26), ("r_27_30", 27, 30),
                             ("r_31_38", 31, 38)):
            m = (rad >= lo) & (rad <= hi)
            extra[f"n_{name}"] = int(m.sum())
            extra[f"max_u8_diff_{name}"] = float(dq[:count][m].max()) \
                if int(m.sum()) else None
            passed = passed and int(m.sum()) > 0
        # A [start, start + count) sub-range: rows outside stay zero and
        # rows inside equal the full run's.
        st, cn = count // 3, count // 2
        sub = FS.descriptor_hist_cuda(*a, count=cn, start=st)
        torch.cuda.synchronize()
        inside = torch.allclose(sub[st:st + cn], ker[st:st + cn],
                                rtol=1e-5, atol=1e-4)
        outside = bool((sub[:st] == 0).all()
                       and (sub[st + cn:] == 0).all())
        extra["start_count_subrange_ok"] = bool(inside and outside)
        passed = passed and inside and outside
    ms = time_ms(lambda: FS.descriptor_hist_cuda(*a, count=tap["count"]))
    extra["device_ms"] = device_ms(lambda: FS.descriptor_hist_cuda(
        *a, count=tap["count"]), name="descriptor_hist_kernel")
    plain_ms = time_ms(
        lambda: FS.descriptor_hist_plain(*a, count=tap["count"]),
        reps=20, warm=2)
    nrow, ncol, _ = window_work(tap["par"], tap["rows"], tap["lanes"], count)
    masked = int((nrow * ncol).sum())
    in_grid = grid_pixels(tap["par"], tap["rows"], tap["lanes"], count)
    extra.update(pixels_masked=masked, pixels_in_grid=in_grid)
    return finish_entry(
        name="descriptor_hist",
        source="sift_tpu_torch/csrc/descriptor_hist.cu",
        replaces="sift_tpu/kernels/fused_stages.py:585",
        shapes=dict(slab=list(tap["values"].shape), capacity=k, live=count,
                    rows=tap["rows"], lanes=tap["lanes"]),
        max_abs_err=float((ker - pla).abs().max()) if k else 0.0,
        tolerance=("uint8 after finalize + quantize('opencv'): |diff| <= 1;"
                   " rows outside [start, start+count) zero"),
        passed=passed, ms=ms, plain_ms=plain_ms,
        bytes_=stage_bytes(tap["values"], tap["par"], nrow, ncol, count,
                           128),
        ops=(DESC_OPS_PER_MASKED_PIXEL * masked
             + DESC_OPS_PER_GRID_PIXEL * in_grid),
        extra=extra)


def check_gather(gauss0, cfg, seed=2):
    """K4 at the shapes its paths give it: the replay's orientation stage
    ([1024, 48, 256] windows from the [6, 480, 768] gradient block), its
    descriptor stage ([512, 88, 256] from the packed block) and the flat
    detector branch's 4-copy / 128-column windows.  Pure data movement, so
    exactly equal to the plain version; origins come from the ops the
    stages themselves call, at random keypoint places."""
    from sift_tpu_torch.kernels import window_gather as WG
    from sift_tpu_torch.ops import flatpyr as FP
    from sift_tpu_torch.ops.descriptor import max_descr_radius
    from sift_tpu_torch.ops.orientation import max_ori_radius
    from sift_tpu_torch.perf.profile import device_ms

    dev = gauss0.device
    rng = np.random.default_rng(seed)
    d, h, w = gauss0.shape
    padded = FP.pad_pyramid([gauss0])
    mag, _ = FP.dense_gradients_padded(padded)
    packed = FP.dense_gradients_packed(padded)
    cases = (("replay_orientation", mag, 1024, max_ori_radius(cfg)),
             ("replay_descriptor", packed, 512, max_descr_radius(cfg)),
             ("flat_branch_4_copies", FP.shift_copies(mag), 1024,
              max_ori_radius(cfg)))
    out = []
    for label, src, k, radius in cases:
        t = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
        cy, cx = t(rng.integers(0, h, k)), t(rng.integers(0, w, k))
        layer = t(rng.integers(1, d - 2, k))
        li, ys0, xs0, _, rows, lanes = FP.keypoint_window_origins(
            src, torch.zeros_like(layer), layer, cy, cx, radius)
        a = (src.values, li, ys0, xs0, rows, lanes)
        ker = WG.gather_windows_cuda(*a)
        pla = WG.gather_windows_plain(*a)
        torch.cuda.synchronize()
        exact = ker.shape == pla.shape and bool(torch.equal(ker, pla))
        # The one PyTorch call that computes the same function.
        yy = (ys0.to(torch.int64)[:, None]
              + torch.arange(rows, device=dev))[:, :, None]
        xx = (xs0.to(torch.int64)[:, None]
              + torch.arange(lanes, device=dev))[:, None, :]
        ll = li.to(torch.int64)[:, None, None]
        lib = src.values[ll, yy, xx]
        exact = exact and bool(torch.equal(lib, ker))
        win_bytes = k * rows * lanes * 4
        # Each input element read once (at most the slab), each output
        # element written once, plus the origins.
        bytes_ = min(win_bytes, src.values.numel() * 4) + win_bytes + 12 * k
        out.append(dict(
            label=label, values=list(src.values.shape),
            windows=[k, rows, lanes], bit_exact=exact,
            max_abs_err=float((ker - pla).abs().max()),
            ms=time_ms(lambda: WG.gather_windows_cuda(*a)),
            device_ms=device_ms(lambda: WG.gather_windows_cuda(*a),
                                name="gather_windows_kernel"),
            plain_ms=time_ms(lambda: WG.gather_windows_plain(*a)),
            library_ms=time_ms(lambda: src.values[ll, yy, xx]),
            bytes=bytes_, bytes_copied=2 * win_bytes,
            bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3,
            bound_ms_no_reuse=2 * win_bytes / PEAK_BYTES_PER_S * 1e3))
    first = out[0]
    return finish_entry(
        name="gather_windows", source="sift_tpu_torch/csrc/window_gather.cu",
        replaces="sift_tpu/kernels/window_gather.py:53",
        shapes=dict(values=first["values"], windows=first["windows"]),
        max_abs_err=max(c["max_abs_err"] for c in out),
        tolerance="bit-exact (against the plain version and the indexing "
                  "call), all three shapes",
        passed=all(c["bit_exact"] for c in out), ms=first["ms"],
        plain_ms=first["plain_ms"], bytes_=first["bytes"], ops=0,
        library_ms=first["library_ms"],
        extra=dict(device_ms=first["device_ms"], cases=out,
                   bit_exact=all(c["bit_exact"] for c in out)))


def check_window_proto():
    """K6-K8 on the experiment's workload against the plain version; the
    ring at every sweep point, its default design timed."""
    from sift_tpu_torch.perf import window_proto as WP
    from sift_tpu_torch.perf.profile import device_ms

    wl = WP.workload("cuda")
    slab, ys0, xs0, par = wl["slab"], wl["ys0"], wl["xs0"], wl["par"]
    rows, count = wl["rows"], wl["count"]
    k = ys0.shape[0]
    bytes_ = (min(WP.LIVE * rows * WP.LANES * 4, slab.numel() * 4)
              + k * WP.LANES * 4 + 8 * k + 4)
    ref = WP.window_colsum_plain(slab, ys0, xs0, rows, count,
                                 name="window_colsum_ring")

    def agrees(out, want):
        return (bool(torch.allclose(out, want, rtol=1e-5, atol=1e-4))
                and bool((out[WP.LIVE:] == 0).all()))

    sweep = []
    for bk, nbuf, band in WP.SWEEP:
        out = WP.window_colsum_ring_cuda(slab, ys0, xs0, rows, count, bk,
                                         nbuf, band)
        torch.cuda.synchronize()
        sweep.append(dict(**WP.ring_design(slab.device, rows, bk, nbuf,
                                           band),
                          matches_plain=agrees(out, ref),
                          max_abs_err=float((out - ref).abs().max())))
    runs = (
        ("window_colsum_static", "scripts/dma_proto.py:86",
         lambda: WP.window_colsum_static_cuda(slab, ys0, xs0, rows, count),
         lambda: WP.window_colsum_plain(slab, ys0, xs0, rows, count), 0, {}),
        ("window_colsum_par", "scripts/dma_proto.py:123",
         lambda: WP.window_colsum_par_cuda(slab, ys0, xs0, par, rows,
                                           count),
         lambda: WP.window_colsum_plain(slab, ys0, xs0, rows, count, par, 8,
                                        name="window_colsum_par"),
         WP.NPAR * 4 * k, {}),
        ("window_colsum_ring", "scripts/dma_proto.py:196",
         lambda: WP.window_colsum_ring_cuda(slab, ys0, xs0, rows, count),
         lambda: WP.window_colsum_plain(slab, ys0, xs0, rows, count,
                                        name="window_colsum_ring"), 0,
         dict(design=WP.ring_design(slab.device, rows, *WP.RING_DEFAULT),
              sweep=sweep)))
    entries = []
    for name, replaces, fn, plain, more_bytes, extra in runs:
        ker, pla = fn(), plain()
        torch.cuda.synchronize()
        ok = agrees(ker, pla) and all(e["matches_plain"]
                                      for e in extra.get("sweep", ()))
        entries.append(finish_entry(
            name=name, source="sift_tpu_torch/csrc/window_proto.cu",
            replaces=replaces,
            shapes=dict(slab=list(slab.shape), capacity=k, live=WP.LIVE,
                        rows=rows, lanes=WP.LANES),
            max_abs_err=float((ker - pla).abs().max()),
            tolerance="allclose rtol 1e-5 atol 1e-4 (sums of 72 rows in "
                      "another order); rows past count zero",
            passed=ok, ms=time_ms(fn), plain_ms=time_ms(plain, reps=10,
                                                        warm=2),
            bytes_=bytes_ + more_bytes, ops=WP.LIVE * rows * WP.LANES,
            extra=dict(device_ms=device_ms(fn, name="colsum_"), **extra)))
    return entries


def ptxas_kernels(log: str) -> list:
    """Per kernel in ``ptxas -v`` output: its (mangled) name, registers,
    spill stores and loads, shared memory."""
    import re
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(kernel=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def zero_counters(*modules) -> None:
    for m in modules:
        for d in (m.launches, m.plain_calls):
            for key in d:
                d[key] = 0


def events_ms(fn):
    """One call of ``fn`` between CUDA events; returns (result, ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def run_replay(cfg, img, WG):
    """Golden capture on the card, then the seven replay stages on the
    loaded triple.  Returns the phase line and K4's launch count."""
    from sift_tpu_torch.perf.checkpoint import capture_golden, load_golden
    from sift_tpu_torch.perf.replay import Replayer

    zero_counters(WG)
    with tempfile.TemporaryDirectory() as path:
        _, capture_ms = events_ms(lambda: capture_golden(cfg, img, path))
        n_capture = WG.launches["gather_windows"]
        params, inputs, expected = load_golden(path)
    rep = Replayer(params, inputs, expected)
    results = rep.run_all()
    torch.cuda.synchronize()
    n_replay = WG.launches["gather_windows"] - n_capture
    plain = WG.plain_calls["gather_windows"]
    # Stage times: a second pass, after the verifying one warmed it up.
    stage_ms = {name: events_ms(getattr(rep, f"run_{name}"))[1]
                for name in rep.ALL}
    failed = [name for name, (ok, _) in results.items() if not ok]
    kcap = rep.plan.octaves[0].kpt_cap
    per_pass = 2 * -(-kcap // 1024) + -(-kcap // 512)
    line = {"phase": "replay", "width": cfg.width, "height": cfg.height,
            "num_features": cfg.num_features, "octave0_kpt_cap": kcap,
            "stages": {name: {"passed": ok, **info}
                       for name, (ok, info) in results.items()},
            "stages_passed": len(results) - len(failed),
            "gather_windows_launches": {"capture": n_capture,
                                        "replay": n_replay,
                                        "expected_each": per_pass},
            "plain_calls": plain, "capture_ms": capture_ms,
            "stage_ms": stage_ms}
    say(line)
    if failed:
        fail(f"replay stages failed: {failed}")
    if n_capture != per_pass or n_replay != per_pass or plain:
        fail(f"replay: gather_windows launched {n_capture} + {n_replay} "
             f"times (expected {per_pass} each), plain version {plain}")
    return n_capture + n_replay


def run_flat_frames(cfg, frame, FD, WG):
    """One frame through the detector's non-fused branch at two patch
    radii, each against the same frame under kernel_impl="torch"."""
    import dataclasses

    from sift_tpu_torch import SiftDetector
    from sift_tpu_torch.core.convert import result_to_numpy
    from sift_tpu_torch.perf.compare import pair_keypoints

    out = []
    for sigma, copies in ((2.0, 1), (1.97, 4)):
        c = dataclasses.replace(cfg, sigma=sigma)
        det = SiftDetector(c)
        det.detect_and_compute(frame)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(FD, WG)
        res = det.detect_and_compute(frame)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        k1, k4 = FD.launches["detect_records"], WG.launches["gather_windows"]
        plain = FD.plain_calls["detect_records"] \
            + WG.plain_calls["gather_windows"]
        frame_ms = time_ms(lambda: det.detect_and_compute(frame), reps=5,
                           warm=0)
        rp = SiftDetector(dataclasses.replace(c, kernel_impl="torch")) \
            .detect_and_compute(frame)
        torch.cuda.synchronize()
        a, b = result_to_numpy(res), result_to_numpy(rp)
        ia, ib = pair_keypoints(a, b)
        paired = len(ia) / max(a["count"], b["count"], 1)
        dd = np.abs(a["descriptors"][ia].astype(np.int32)
                    - b["descriptors"][ib].astype(np.int32)).max(1) \
            if len(ia) else np.zeros(0)
        planes = cfg.num_octaves * (cfg.num_octave_layers + 3)
        hp, wp = -(-cfg.height // 8) * 8, -(-cfg.width // 128) * 128
        out.append(dict(
            sigma=sigma, slab_copies=copies, keypoints=a["count"],
            raw_keypoints=a["raw_count"], detect_records_launches=k1,
            gather_windows_launches=k4, plain_calls=plain,
            paired_with_plain_path=paired,
            max_descriptor_diff_vs_plain_path=float(dd.max())
            if len(dd) else None,
            frame_ms=frame_ms, peak_memory_mib=peak,
            gradient_slabs_mib=3 * copies * planes * hp * wp * 4 / 2 ** 20))
        if k1 != 1 or k4 <= 0 or plain:
            fail(f"flat frame sigma={sigma}: launches K1 {k1}, K4 {k4}, "
                 f"plain {plain}")
        if a["count"] <= 100 or paired < 0.99 or (len(dd) and dd.max() > 1):
            fail(f"flat frame sigma={sigma}: {a['count']} keypoints, "
                 f"{paired:.2%} paired with the plain path, max descriptor "
                 f"diff {dd.max() if len(dd) else None}")
    say({"phase": "flat_frame", "width": cfg.width, "height": cfg.height,
         "num_features": cfg.num_features, "frames": out})
    return out


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU")
    from sift_tpu_torch import SiftConfig, SiftDetector, match_brute_force
    from sift_tpu_torch.core.convert import result_to_numpy
    from sift_tpu_torch.kernels import build
    from sift_tpu_torch.kernels import expand as EX
    from sift_tpu_torch.kernels import fused_detect as FD
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.kernels import window_gather as WG
    from sift_tpu_torch.perf.benchimg import (FLAGSHIP_FEATURES as
                                              NUM_FEATURES,
                                              FLAGSHIP_HEIGHT as HEIGHT,
                                              FLAGSHIP_WIDTH as WIDTH,
                                              bench_image)
    from sift_tpu_torch.perf import window_proto as WP
    from sift_tpu_torch.perf.compare import pair_keypoints
    from sift_tpu_torch.perf.stage_inputs import (frame_inputs, frame_slab,
                                                  synthetic_inputs)
    from sift_tpu_torch.pipeline.detector import full_precision_matmul

    full_precision_matmul()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say({"phase": "device", "kind": kind, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- build ------------------------------------------------------------
    build.load_library()
    ptxas = [ln for ln in build.build_log.splitlines()
             if "registers" in ln or "error" in ln.lower()]
    per_kernel = ptxas_kernels(build.build_log)
    say({"phase": "build", "seconds": build.build_seconds,
         "library_dir": str(build.build_dir()), "ptxas": ptxas,
         "kernels": per_kernel})
    spills = [e["kernel"] for e in per_kernel
              if e.get("spill_stores") or e.get("spill_loads")]
    if spills:
        fail(f"kernels spill registers: {spills}")

    # -- set-up: detector, frames, the main path's own kernel inputs --------
    cfg = SiftConfig(width=WIDTH, height=HEIGHT, num_features=NUM_FEATURES)
    det = SiftDetector(cfg)
    img1 = bench_image(HEIGHT, WIDTH, seed=0)
    img2 = warp_image(img1)
    f1 = torch.as_tensor(img1, device=det.device)
    f2 = torch.as_tensor(img2, device=det.device)
    det.warm_up()
    r0 = det.detect_and_compute(f1)
    torch.cuda.synchronize()

    # -- kernels: each at the inputs the main path gave it on frame 1,
    # rebuilt here by the ops the detector itself calls -------------------
    gauss, base, slab = frame_slab(det, f1)
    frm_ori, frm_desc = frame_inputs(slab, r0, cfg)
    syn_ori, syn_desc = synthetic_inputs(det, slab)
    k1 = check_detect(gauss, cfg)
    k5 = check_expand(base, slab.copies)
    k2 = check_orientation(frm_ori, "frame")
    k2s = check_orientation(syn_ori, "synthetic_full")
    k3 = check_descriptor(frm_desc, "frame")
    k3s = check_descriptor(syn_desc, "synthetic_full", radius_classes=True)
    for main_e, syn_e in ((k2, k2s), (k3, k3s)):
        main_e["synthetic_full"] = {
            key: syn_e[key] for key in syn_e
            if key not in ("name", "route", "source", "replaces",
                           "launches", "launches_per_frame", "library_ms",
                           "tolerance")}
        main_e["passed"] = main_e["passed"] and syn_e["passed"]
    k4 = check_gather(gauss[0], cfg)
    kernels = [k1, k5, k2, k3, k4] + check_window_proto()

    # -- main path --------------------------------------------------------
    torch.cuda.synchronize()
    zero_counters(FD, EX, FS)
    frames = (f1, f2)
    r1, r2 = [det.detect_and_compute(f) for f in frames]
    matches = match_brute_force(r2.descriptors, r1.descriptors,
                                r2.keypoints.valid, r1.keypoints.valid)
    torch.cuda.synchronize()
    counts = {**FD.launches, **EX.launches, **FS.launches}
    plain = {**FD.plain_calls, **EX.plain_calls, **FS.plain_calls}
    for e in kernels[:4]:
        e["launches"] = counts[e["name"]]
        e["launches_per_frame"] = counts[e["name"]] / len(frames)
    expect = {"detect_records": len(frames),
              "expand_lane_copies": len(frames),
              "orientation_hist": len(frames),
              "descriptor_hist": len(frames)}
    if counts != expect:
        fail(f"launch counts {counts} != expected {expect}")
    if any(plain.values()):
        fail(f"plain versions ran on the main path: {plain}")
    n1, n2 = int(r1.count), int(r2.count)
    for r, n in ((r1, n1), (r2, n2)):
        if not (r.descriptors.is_cuda and r.keypoints.x.is_cuda):
            fail("results are not CUDA tensors")
        if r.descriptors.dtype != torch.uint8 \
                or tuple(r.descriptors.shape) != (NUM_FEATURES, 128):
            fail("descriptors are not [num_features, 128] uint8")
        if n <= 300:
            fail(f"only {n} keypoints on a 752x480 textured frame")
        if not bool((r.descriptors[:n].sum(1) > 0).all()):
            fail("a valid keypoint has an all-zero descriptor")
        if bool(r.descriptors[n:].any()) or bool(r.keypoints.valid[n:].any()):
            fail("rows past the count are not empty")
        for f in ("x", "y", "size", "angle", "response"):
            if not bool(torch.isfinite(getattr(r.keypoints, f)).all()):
                fail(f"non-finite keypoint field {f}")
    n_match = int((matches >= 0).sum())
    rate = n_match / n2
    if rate < 0.30:
        fail(f"only {rate:.1%} of frame-2 keypoints matched")

    # The same frame through the plain versions ON THE CARD.
    import dataclasses
    det_plain = SiftDetector(dataclasses.replace(cfg, kernel_impl="torch"))
    rp = det_plain.detect_and_compute(f1)
    torch.cuda.synchronize()
    if not all({**FD.plain_calls, **EX.plain_calls,
                **FS.plain_calls}.values()) \
            or {**FD.launches, **EX.launches, **FS.launches} != counts:
        fail("kernel_impl='torch' did not run the plain versions")
    a, b = result_to_numpy(r1), result_to_numpy(rp)
    ia, ib = pair_keypoints(a, b)
    paired = len(ia) / max(a["count"], b["count"], 1)
    dd = np.abs(a["descriptors"][ia].astype(np.int32)
                - b["descriptors"][ib].astype(np.int32)).max(1) \
        if len(ia) else np.zeros(0)
    if paired < 0.99 or (len(dd) and dd.max() > 1):
        fail(f"kernel path vs plain path on the card: {paired:.2%} paired,"
             f" max descriptor diff {dd.max() if len(dd) else None}")

    frame_ms = time_ms(lambda: det.detect_and_compute(f1))
    plain_frame_ms = time_ms(lambda: det_plain.detect_and_compute(f1),
                             reps=20, warm=1)
    match_ms = time_ms(lambda: match_brute_force(
        r2.descriptors, r1.descriptors, r2.keypoints.valid,
        r1.keypoints.valid))
    t0 = time.perf_counter()
    for _ in range(20):
        det.detect_and_compute(f1)
    torch.cuda.synchronize()
    frame_wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    say({"phase": "main_path", "width": WIDTH, "height": HEIGHT,
         "num_features": NUM_FEATURES, "keypoints": [n1, n2],
         "raw_keypoints": [int(r1.raw_count), int(r2.raw_count)],
         "matched": n_match, "match_rate": rate, "launches": counts,
         "plain_calls": plain, "paired_with_plain_path": paired,
         "max_descriptor_diff_vs_plain_path": float(dd.max())
         if len(dd) else None,
         "frame_ms": frame_ms, "frame_wall_ms": frame_wall_ms,
         "plain_path_frame_ms": plain_frame_ms, "match_ms": match_ms,
         "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
         "card": smi})

    # -- the further paths, each with its counters set to 0 just before ----
    k4["launches"] = run_replay(cfg, img1, WG)
    k4["launches_flat_frames"] = [
        f["gather_windows_launches"] for f in run_flat_frames(cfg, f1, FD,
                                                              WG)]
    zero_counters(WP)
    proto = WP.run_experiment("cuda")
    torch.cuda.synchronize()
    say({"phase": "window_proto", **proto, "launches": dict(WP.launches)})
    if not proto["ok"]:
        fail("window_proto: a loading scheme disagrees with the plain "
             "version or with another scheme")
    for e in kernels[5:]:
        e["launches"] = WP.launches[e["name"]]
    say({"kernels": kernels})
    bad = [e["name"] for e in kernels if not e["passed"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    idle = [e["name"] for e in kernels if not e["launches"]]
    if idle:
        fail(f"kernels never launched on their path: {idle}")
    print(smi, flush=True)
    say({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
