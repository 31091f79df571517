#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sift_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — ``SiftDetector.detect_and_compute`` on two
752x480 frames with ``num_features=5000``, then ``match_brute_force`` — and
its further paths: the golden capture + per-stage replay at the same size
(``perf/checkpoint.capture_golden``, ``perf/replay.Replayer``), one frame
each through the detector's non-fused branch (``sigma=2.0``: 256-column
windows; ``sigma=1.97``: 4 shifted copies), the window-loading experiment
(``perf/window_proto``), and the visual-odometry and reconstruction slice
on rendered 752x480 scenes (``geometry/odometry.MonocularOdometry``, its
checkpoint resume, loop closure, ``tools/reconstruct.py`` and
``tools/odometry.py`` on PGM frames, float64 bundle adjustment), and the
detector's remaining configurations and CLIs: OpenCV parity at
``upscale=True`` on the committed cv2 oracle's three scenes, capacity
tiers, the conv pyramid (``blur_impl="conv"``), ``tools/detect.py`` with
its golden replayed by ``tools/perf.py``, and ``tools/extract_and_match.py
--tiers``, and the multi-device layer: the keyframe-sharded pipeline
over four virtual shards of the one card, ``tools/scale_bench.py``,
distributed bundle adjustment, ``reconstruct --distributed``, and worker
processes sharing the card against one process (with the elastic
kill-and-resume), and the detector's band-blocked padded pyramid at the
reference's three frame sizes against the dense one, with the port's
measuring tools (``tools/benchmark.py``, ``perf/stage_bench.py``,
``perf/kernel_bench.py``, ``perf/mem_analysis.py``) run at their
defaults.  Every hand-written CUDA kernel is held against its
plain PyTorch version on the card, at the shapes its path gives it, and
each path's launch counters are set to 0 just before it runs and read
just after.  Phases (one JSON line each): ``device``, ``build``,
``main_path``, ``matcher_exact``, ``replay``, ``flat_frame``,
``window_proto``, ``vo``, ``vo_capacity``, ``vo_resume``,
``loop_closure``, ``reconstruct``, ``odometry_cli``, ``ba_float64``,
``cv2_parity``, ``tiers``, ``conv_pyramid``, ``detect_cli``,
``extract_and_match_cli``, ``sharded``, ``scale_bench``,
``distributed_ba``, ``reconstruct_distributed``, ``multihost``,
``banded_pyramid``, ``tools``, then the ``kernels`` line; any failure
exits non-zero.
Needs one CUDA device, ``nvcc``, a C++ compiler (the native PGM loader)
and the checkout's ``tests/data/cv2_parity_oracle.npz``; imports
``sift_tpu_torch``, ``torch`` and ``numpy`` only.  The
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
import os
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


def check_window_proto(per_kernel):
    """K6-K8 on the experiment's workload against the plain version.  K6
    and K7 (strip owners) bit for bit on the uniform, clustered and
    out-of-contract sets, two launches equal, their device plan equal to
    the host twin ``strip_plan``; the ring at every sweep point, its
    default design timed."""
    from sift_tpu_torch.perf import window_proto as WP
    from sift_tpu_torch.perf.profile import device_ms

    wl = WP.workload("cuda")
    slab, ys0, xs0, par = wl["slab"], wl["ys0"], wl["xs0"], wl["par"]
    rows, count = wl["rows"], wl["count"]
    k = ys0.shape[0]
    bytes_ = (min(WP.LIVE * rows * WP.LANES * 4, slab.numel() * 4)
              + k * WP.LANES * 4 + 8 * k + 4)
    sets = dict(uniform=wl, clustered=WP.clustered_workload("cuda"),
                out_of_contract=WP.out_of_contract_workload("cuda"))
    ref = WP.window_colsum_plain(slab, ys0, xs0, rows, count,
                                 name="window_colsum_ring")

    def agrees(out, want):
        return (bool(torch.allclose(out, want, rtol=1e-5, atol=1e-4))
                and bool((out[WP.LIVE:] == 0).all()))

    def strip_checks(call, plain, par):
        """One strip kernel on every set; each set's checks and, for the
        clustered set, its device time."""
        res = {}
        for label, s in sets.items():
            plan = {}
            ker, again = call(s, plan), call(s, None)
            pla = plain(s)
            torch.cuda.synchronize()
            host = WP.strip_plan(s["ys0"], s["xs0"], s["count"], WP.H, WP.W,
                                 s["rows"], *WP.STRIP_DEFAULT)
            res[label] = dict(
                rows=s["rows"], bit_exact=bool(torch.equal(ker, pla)),
                bit_reproducible=bool(torch.equal(ker, again)),
                rows_past_count_zero=bool((ker[WP.LIVE:] == 0).all()),
                plan_matches=WP.plan_matches(plan, host),
                n_items=host["n_items"], max_loads=int(host["loads"].max()),
                max_abs_err=float((ker - pla).abs().max()))
        res["clustered"]["device_ms"] = device_ms(
            lambda: call(sets["clustered"], None), name="colsum_")
        res["passed"] = all(v["bit_exact"] and v["bit_reproducible"]
                            and v["rows_past_count_zero"]
                            and v["plan_matches"]
                            for v in res.values() if isinstance(v, dict))
        res["design"] = WP.strip_design(slab.device, k, WP.H, WP.W, rows,
                                        *WP.STRIP_DEFAULT, par=par)
        res["ptxas"] = [e for e in per_kernel if "colsum_bucket" in e["kernel"]
                        or "colsum_strip" in e["kernel"]]
        return res

    sweep = []
    for bk, nbuf, band in WP.SWEEP:
        out = WP.window_colsum_ring_cuda(slab, ys0, xs0, rows, count, bk,
                                         nbuf, band)
        torch.cuda.synchronize()
        sweep.append(dict(**WP.ring_design(slab.device, rows, bk, nbuf,
                                           band),
                          matches_plain=agrees(out, ref),
                          max_abs_err=float((out - ref).abs().max())))
    static = lambda s, plan: WP.window_colsum_static_cuda(
        s["slab"], s["ys0"], s["xs0"], s["rows"], s["count"], plan=plan)
    static_plain = lambda s: WP.window_colsum_plain(
        s["slab"], s["ys0"], s["xs0"], s["rows"], s["count"])
    par_k = lambda s, plan: WP.window_colsum_par_cuda(
        s["slab"], s["ys0"], s["xs0"], s["par"], s["rows"], s["count"], 8,
        plan=plan)
    par_plain = lambda s: WP.window_colsum_plain(
        s["slab"], s["ys0"], s["xs0"], s["rows"], s["count"], s["par"], 8,
        name="window_colsum_par")
    strip_tol = ("torch.equal to the plain version (float32 rows summed in "
                 "order) on the uniform, clustered and out-of-contract sets;"
                 " two launches equal; rows past count zero; device plan == "
                 "strip_plan")
    runs = (
        ("window_colsum_static", "scripts/dma_proto.py:86",
         lambda: static(wl, None), lambda: static_plain(wl), 0,
         strip_checks(static, static_plain, False), strip_tol),
        ("window_colsum_par", "scripts/dma_proto.py:123",
         lambda: par_k(wl, None), lambda: par_plain(wl), WP.NPAR * 4 * k,
         strip_checks(par_k, par_plain, True), strip_tol),
        ("window_colsum_ring", "scripts/dma_proto.py:196",
         lambda: WP.window_colsum_ring_cuda(slab, ys0, xs0, rows, count),
         lambda: WP.window_colsum_plain(slab, ys0, xs0, rows, count,
                                        name="window_colsum_ring"), 0,
         dict(design=WP.ring_design(slab.device, rows, *WP.RING_DEFAULT),
              sweep=sweep),
         "allclose rtol 1e-5 atol 1e-4 (sums of 72 rows in another order); "
         "rows past count zero"))
    entries = []
    for name, replaces, fn, plain, more_bytes, extra, tol in runs:
        ker, pla = fn(), plain()
        torch.cuda.synchronize()
        if "sweep" in extra:
            ok = agrees(ker, pla) and all(e["matches_plain"]
                                          for e in extra["sweep"])
        else:
            ok = extra.pop("passed")
        entries.append(finish_entry(
            name=name, source="sift_tpu_torch/csrc/window_proto.cu",
            replaces=replaces,
            shapes=dict(slab=list(slab.shape), capacity=k, live=WP.LIVE,
                        rows=rows, lanes=WP.LANES),
            max_abs_err=float((ker - pla).abs().max()), tolerance=tol,
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
        paired, dd, _ = plain_path_pairing(det, frame, res,
                                           f"flat frame sigma={sigma}")
        n = int(res.count)
        planes = cfg.num_octaves * (cfg.num_octave_layers + 3)
        hp, wp = -(-cfg.height // 8) * 8, -(-cfg.width // 128) * 128
        out.append(dict(
            sigma=sigma, slab_copies=copies, keypoints=n,
            raw_keypoints=int(res.raw_count), detect_records_launches=k1,
            gather_windows_launches=k4, plain_calls=plain,
            paired_with_plain_path=paired,
            max_descriptor_diff_vs_plain_path=dd,
            frame_ms=frame_ms, peak_memory_mib=peak,
            gradient_slabs_mib=3 * copies * planes * hp * wp * 4 / 2 ** 20))
        if k1 != 1 or k4 <= 0 or plain:
            fail(f"flat frame sigma={sigma}: launches K1 {k1}, K4 {k4}, "
                 f"plain {plain}")
        if n <= 100:
            fail(f"flat frame sigma={sigma}: {n} keypoints")
    say({"phase": "flat_frame", "width": cfg.width, "height": cfg.height,
         "num_features": cfg.num_features, "frames": out})
    return out


# ---------------------------------------------------------------------------
# The visual-odometry and reconstruction paths (geometry/, tools/)
# ---------------------------------------------------------------------------

VO_SPLIT = 5                # vo_resume: checkpoint after this many frames
# Sim(3)-aligned ATE gates.  The JAX tests' gates are 0.15 for the textured
# sequence without window BA (tests/test_odometry.py:108) and 0.2 for the
# loop with a closure (tests/test_loop_closure.py).  At 752x480 the ATE of
# both sequences depends on which of two bootstrap solutions of near-equal
# RANSAC consensus the draws keep, in the JAX package as in the port
# (tests/test_torch_vo_witness.py, run on the CPU; PERF.md section 6):
#   * textured with window BA every 3rd frame: the JAX package ends at
#     0.2165 with its default key (0.015-0.037 with keys 1-7); held at
#     0.25, and 0.15 reported;
#   * loop: JAX keys 1 and 2 end at 0.382 and 0.373 (key 0 at 0.012);
#     held at 0.5 (the JAX test's bound without a closure), 0.2 reported;
#   * textured without window BA (the CLI's run): 0.15 held.
# On the JAX package's draws the port ends where the JAX package does,
# seed by seed, on the same keypoints.
VO_ATE_GATE = 0.25
LOOP_ATE_GATE = 0.5
CLI_ATE_GATE = 0.15


def frame_launches(FD, EX, FS, n_frames, label):
    """The four frame kernels' counts since they were set to 0: each must
    have launched once per frame, and no plain version may have run."""
    counts = {**FD.launches, **EX.launches, **FS.launches}
    plain = {**FD.plain_calls, **EX.plain_calls, **FS.plain_calls}
    want = {k: n_frames for k in counts}
    if counts != want or any(plain.values()):
        fail(f"{label}: launches {counts} (expected {n_frames} each), "
             f"plain versions {plain}")
    return counts


def plain_path_pairing(det, frame, res, label):
    """``res``, the kernels' result on ``frame``, against the same frame
    through the plain versions on the card (``kernel_impl="torch"``): at
    least 99 % of the keypoints paired (octave, layer, position, angle
    within 0.5 degrees) and descriptors within 1.  Returns (the paired
    share, the largest descriptor difference, the plain detector)."""
    import dataclasses

    from sift_tpu_torch import SiftDetector
    from sift_tpu_torch.core.convert import result_to_numpy
    from sift_tpu_torch.perf.compare import pair_keypoints

    det_plain = SiftDetector(dataclasses.replace(det.config,
                                                 kernel_impl="torch"))
    rp = det_plain.detect_and_compute(frame)
    torch.cuda.synchronize()
    a, b = result_to_numpy(res), result_to_numpy(rp)
    ia, ib = pair_keypoints(a, b)
    paired = len(ia) / max(a["count"], b["count"], 1)
    dd = int(np.abs(a["descriptors"][ia].astype(np.int32)
                    - b["descriptors"][ib].astype(np.int32)).max()) \
        if len(ia) else None
    if paired < 0.99 or (dd is not None and dd > 1):
        fail(f"{label}: kernel path vs plain path on the card: "
             f"{paired:.2%} paired, max descriptor diff {dd}")
    return paired, dd, det_plain


def check_matcher_exact(r1, r2, match_brute_force):
    """C1: the CUDA matcher's indices on the smoke pair equal the exact
    float32 ones — the same tensors matched on the CPU — and both routes
    of its Gram product (f32 operands; bf16 operands on the tensor cores
    with an f32 result) equal the float64 product.  Reports how many rows
    the pre-repair route (a bf16 RESULT) gets wrong on the same pair."""
    from sift_tpu_torch.pipeline import matcher as M

    args = (r2.descriptors, r1.descriptors, r2.keypoints.valid,
            r1.keypoints.valid)
    cuda = match_brute_force(*args)
    cpu = match_brute_force(*[a.cpu() for a in args])
    q, t = r2.descriptors, r1.descriptors
    exact = torch.matmul(q.double(), t.double().T)        # < 2^53: exact
    gram_f32 = M.gram_u8(q, t)
    gram_tc = M.gram_u8(q, t, "tensor_cores")
    old_gram = lambda a, b, route="f32": torch.matmul(
        a.to(torch.bfloat16), b.to(torch.bfloat16).transpose(-1, -2)
    ).to(torch.float32)
    saved = M.gram_u8
    M.gram_u8 = old_gram
    try:
        old = match_brute_force(*args)
    finally:
        M.gram_u8 = saved
    torch.cuda.synchronize()
    line = {
        "phase": "matcher_exact",
        "queries": int(q.shape[0]),
        "matched": int((cuda >= 0).sum()),
        "equal_to_cpu": bool(torch.equal(cuda.cpu(), cpu)),
        "gram_f32_exact": bool(torch.equal(gram_f32.double(), exact)),
        "gram_tensor_cores_exact": bool(torch.equal(gram_tc.double(),
                                                    exact)),
        "rows_differing_before_repair": int((old != cuda).sum()),
        "matched_before_repair": int((old >= 0).sum()),
        "max_gram_err_before_repair": float(
            (old_gram(q, t).double() - exact).abs().max()),
        "match_ms": time_ms(lambda: match_brute_force(*args)),
    }
    say(line)
    if not (line["equal_to_cpu"] and line["gram_f32_exact"]
            and line["gram_tensor_cores_exact"]):
        fail("matcher_exact: the CUDA matcher is not exact")
    return line


def _vo_odometry(width, height, scene, **kw):
    """The port's MonocularOdometry on the card with ``scene``'s settings
    (``perf/scenes.ODOMETRY_KW``), ``fx = 0.9 * width``."""
    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.geometry.odometry import MonocularOdometry
    from sift_tpu_torch.perf import scenes as S

    fx = 0.9 * width
    cfg = SiftConfig(width=width, height=height, num_features=S.VO_FEATURES)
    return MonocularOdometry(cfg, fx=fx, fy=fx, cx=width / 2,
                             cy=height / 2, **S.ODOMETRY_KW[scene], **kw)


def check_vo_capacity(det, frame, FD, EX, FS):
    """The four frame kernels at the VO path's own shapes (``VO_FEATURES``
    rows, a rendered frame), which the main path's checks do not reach:
    the frame through the kernels and through the plain versions, paired
    as on the main path, and K2 / K3 held against their plain versions on
    that frame's own inputs.  Sets the counters to 0 again after."""
    from sift_tpu_torch.perf.stage_inputs import frame_inputs, frame_slab

    f = torch.as_tensor(frame, device=det.device)
    res = det.detect_and_compute(f)
    paired, dd, _ = plain_path_pairing(det, f, res, "vo_capacity")
    _, _, slab = frame_slab(det, f)
    ori, desc = frame_inputs(slab, res, det.config)
    k2 = check_orientation(ori, "vo_frame")
    k3 = check_descriptor(desc, "vo_frame")
    torch.cuda.synchronize()
    zero_counters(FD, EX, FS)
    say({"phase": "vo_capacity", "capacity": int(res.keypoints.x.shape[0]),
         "keypoints": int(res.count), "paired_with_plain_path": paired,
         "max_descriptor_diff_vs_plain_path": dd,
         "orientation_hist": {k: k2[k] for k in ("passed", "max_abs_err",
                                                  "max_rel_err")},
         "descriptor_hist": {k: k3[k] for k in ("passed", "max_abs_err",
                                                 "max_u8_diff")}})
    if not (k2["passed"] and k3["passed"]):
        fail("vo_capacity: K2 or K3 disagrees with its plain version")
    return k2, k3


def run_vo(FD, EX, FS, frames, gt):
    """MonocularOdometry over the textured sequence on the card, window
    BA every third frame.  Per-frame process() host ms and its split by
    stage (telemetry timers, the device synchronised at both ends of
    each), then the frame kernels checked at this path's shapes."""
    from sift_tpu_torch.geometry.trajectory import ate_rmse
    from sift_tpu_torch.perf import scenes as S
    from sift_tpu_torch.perf.telemetry import Telemetry

    h, w = frames[0].shape
    tel = Telemetry()
    odo = _vo_odometry(w, h, "textured", telemetry=tel)
    odo.detector.warm_up()
    torch.cuda.synchronize()
    zero_counters(FD, EX, FS)
    ms = []
    for f in frames:
        t0 = time.perf_counter()
        odo.process(f)
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    counts = frame_launches(FD, EX, FS, len(frames), "vo")
    res = odo.result
    ate = ate_rmse(res.positions(), gt, with_scale=True)
    total_s = sum(ms) / 1e3
    series = tel.summary()["series"]
    share = {k: sum(tel.series[k + "_s"]) / total_s
             for k in ("detect", "match", "ransac", "pnp", "window_ba")
             if k + "_s" in tel.series}
    n_ba = sum(1 for e in tel.events if e["kind"] == "window_ba")
    line = {"phase": "vo", "scene": "textured", "width": w, "height": h,
            "fx": 0.9 * w, "num_features": S.VO_FEATURES,
            "frames": len(frames), "settings": S.ODOMETRY_KW["textured"],
            "modes": res.modes, "n_matches": res.n_matches,
            "n_inliers": res.n_inliers, "landmarks": len(odo._points),
            "ate": ate, "ate_gate": VO_ATE_GATE,
            "meets_0_15": bool(ate < 0.15), "window_ba_runs": n_ba,
            "launches": counts,
            "process_ms_median": statistics.median(ms),
            "process_ms_max": max(ms), "process_ms": ms,
            "stage_share": share,
            "stage_ms_mean": {k: v["mean"] * 1e3 for k, v in series.items()}}
    say(line)
    bad = []
    if res.modes[1] != "bootstrap" or any(m != "pnp" for m in res.modes[2:]):
        bad.append(f"modes {res.modes}")
    if min(res.n_inliers[1:]) < 12:
        bad.append(f"inliers {res.n_inliers}")
    if not ate < VO_ATE_GATE:
        bad.append(f"ATE {ate} >= {VO_ATE_GATE}")
    if n_ba < 1:
        bad.append("window BA never ran")
    if bad:
        fail("vo: " + "; ".join(bad))
    return odo, line, check_vo_capacity(odo.detector, frames[1], FD, EX, FS)


def run_vo_resume(FD, EX, FS, frames, full):
    """Run VO_SPLIT frames, save_state, a FRESH instance load_state, the
    rest: the poses must equal the uninterrupted run's bit for bit — the
    deterministic segment sums of window BA, the generator state and the
    checkpoint on the card."""
    h, w = frames[0].shape
    zero_counters(FD, EX, FS)
    first = _vo_odometry(w, h, "textured")
    for f in frames[:VO_SPLIT]:
        first.process(f)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/state.npz"
        first.save_state(path)
        resumed = _vo_odometry(w, h, "textured")
        resumed.load_state(path)
    for f in frames[VO_SPLIT:]:
        resumed.process(f)
    torch.cuda.synchronize()
    counts = frame_launches(FD, EX, FS, len(frames), "vo_resume")
    a, b = full.result, resumed.result
    same = (np.array_equal(np.stack(a.rotations), np.stack(b.rotations))
            and np.array_equal(np.stack(a.translations),
                               np.stack(b.translations))
            and a.modes == b.modes and a.n_inliers == b.n_inliers)
    line = {"phase": "vo_resume", "split": VO_SPLIT, "frames": len(frames),
            "bit_identical": same, "launches": counts,
            "max_abs_translation_diff": float(np.abs(
                np.stack(a.translations) - np.stack(b.translations)).max())}
    say(line)
    if not same:
        fail("vo_resume: the resumed poses differ from the uninterrupted "
             "run's")
    return line


def run_loop_closure(FD, EX, FS, width, height):
    from sift_tpu_torch.geometry.trajectory import ate_rmse
    from sift_tpu_torch.perf.scenes import render_scene

    frames, gt = render_scene("loop", width, height)
    odo = _vo_odometry(width, height, "loop")
    zero_counters(FD, EX, FS)
    t0 = time.perf_counter()
    for f in frames:
        odo.process(f)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = frame_launches(FD, EX, FS, len(frames), "loop_closure")
    ate = ate_rmse(odo.result.positions(), gt, with_scale=True)
    good = [c for c in odo.closures if c[1] - c[0] >= 6 and c[2] >= 15]
    line = {"phase": "loop_closure", "frames": len(frames),
            "closures": odo.closures, "ate": ate,
            "ate_gate": LOOP_ATE_GATE, "meets_0_2": bool(ate < 0.2),
            "modes": odo.result.modes, "n_matches": odo.result.n_matches,
            "n_inliers": odo.result.n_inliers, "launches": counts,
            "seconds": wall}
    say(line)
    if not good or not ate < LOOP_ATE_GATE:
        fail(f"loop_closure: closures {odo.closures}, ATE {ate}")
    return line


def run_reconstruct(FD, EX, FS, width, height, distributed=False):
    """tools/reconstruct.py on three rendered frames written as PGM
    (``distributed``: with ``--distributed``, phase
    ``reconstruct_distributed``).  Returns the phase line and the CLI's
    final BAState."""
    import contextlib
    import io
    import re

    from sift_tpu_torch.perf import scenes as S
    from sift_tpu_torch.tools import reconstruct

    phase = "reconstruct_distributed" if distributed else "reconstruct"
    frames, _, _ = S.render_sequence(n_frames=3, n_pts=220, width=width,
                                     height=height)
    fx = 0.9 * width
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        files = []
        for i, f in enumerate(frames):
            files.append(f"{d}/f{i}.pgm")
            S.write_pgm(files[-1], f)
        zero_counters(FD, EX, FS)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = reconstruct.main(
                files + ["--fx", str(fx), "--num-features",
                         str(S.VO_FEATURES)]
                + (["--distributed"] if distributed else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = frame_launches(FD, EX, FS, len(frames), phase)
    out = buf.getvalue()
    m = re.search(r"mean sq reproj ([0-9.]+) -> ([0-9.]+) px\^2 over "
                  r"(\d+) observations, (\d+) points", out)
    if not m:
        fail(f"{phase}: no cost line in\n{out}")
    c0, c1 = float(m.group(1)), float(m.group(2))
    n_obs, n_pts = int(m.group(3)), int(m.group(4))
    line = {"phase": phase, "frames": len(frames), "c0": c0,
            "c1": c1, "cost": float(state.cost), "observations": n_obs,
            "points": n_pts, "launches": counts, "seconds": wall,
            "output": out.strip().splitlines()}
    if not distributed:
        say(line)
    if not (c1 <= c0 and c1 < 1.0 and n_pts > 50 and n_obs >= 2 * n_pts):
        fail(f"{phase}: cost {c0} -> {c1}, {n_obs} observations, "
             f"{n_pts} points")
    return line, state


def run_odometry_cli(FD, EX, FS, frames, gt_poses):
    """tools/odometry.py on a PGM directory of the textured sequence,
    without window BA (the CLI's default), through the native loader (the
    card has no cv2), TUM trajectory out and ground truth in."""
    import contextlib
    import io
    import re

    from sift_tpu_torch.geometry import trajectory as T
    from sift_tpu_torch.io import native
    from sift_tpu_torch.perf.scenes import ODOMETRY_KW, write_pgm
    from sift_tpu_torch.tools import odometry

    if not native.available():
        fail(f"odometry_cli: native loader unavailable: "
             f"{native.build_error()}")
    assert not ODOMETRY_KW["textured_no_ba"]        # the CLI's defaults
    h, w = frames[0].shape
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d:
        for i, f in enumerate(frames):
            write_pgm(f"{d}/frame_{i:04d}.pgm", f)
        T.write_tum_trajectory(f"{d}/gt.tum",
                               np.arange(len(frames), dtype=float),
                               gt_poses)
        zero_counters(FD, EX, FS)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            odometry.main([d, "--fx", str(0.9 * w), "--out",
                           f"{d}/est.tum", "--gt", f"{d}/gt.tum"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, est = T.read_tum_trajectory(f"{d}/est.tum")
    counts = frame_launches(FD, EX, FS, len(frames), "odometry_cli")
    out = buf.getvalue()
    m = re.search(r"ATE \(Sim3-aligned RMSE\): ([0-9.]+)", out)
    ate = float(m.group(1)) if m else None
    line = {"phase": "odometry_cli", "scene": "textured_no_ba",
            "frames": len(frames), "native_loader": True,
            "poses_written": len(est), "ate": ate, "ate_gate": CLI_ATE_GATE,
            "launches": counts, "seconds": wall,
            "output_tail": out.strip().splitlines()[-4:]}
    say(line)
    if ate is None or not ate < CLI_ATE_GATE or len(est) != len(frames):
        fail(f"odometry_cli: ATE {ate}, {len(est)} poses written")
    return line


def check_ba_float64():
    """Bundle adjustment in float64 on the card: lm_step (dense Schur) and
    solve_schur_cg equal the same calls on the CPU (atol 1e-8 / 1e-7,
    tests/test_ba.py's f64 tolerances), and a whole lm_optimize converges."""
    from sift_tpu_torch.geometry import ba, se3

    rng = np.random.default_rng(0)
    n_cams, n_pts = 5, 96
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
    w = np.stack([[0.0, 0.25 * (i / (n_cams - 1) - 0.5), 0.0]
                  for i in range(n_cams)])
    rots = se3.so3_exp(torch.from_numpy(w)).numpy()
    trs = np.stack([[-0.8 * i / (n_cams - 1) + 0.4, 0, 0]
                    for i in range(n_cams)])
    pc = np.einsum("cij,pj->cpi", rots, pts) + trs[:, None]
    uv = 500.0 * pc[..., :2] / pc[..., 2:] + np.array([320.0, 240.0])
    dw = rng.normal(0, 0.02, (n_cams, 3))
    dw[0] = 0
    rots_i = se3.so3_exp(torch.from_numpy(dw)).numpy() @ rots
    trs_i = trs + np.concatenate([np.zeros((1, 3)),
                                  rng.normal(0, 0.02, (n_cams - 1, 3))])

    rng_pts = rng.normal(0, 0.02, pts.shape)

    def problem(dev):
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        return ba.BAProblem(
            rotations=t(rots_i), translations=t(trs_i),
            points=t(pts + rng_pts), cam_idx=t(np.repeat(
                np.arange(n_cams), n_pts)),
            pt_idx=t(np.tile(np.arange(n_pts), n_cams)),
            uv=t(uv.reshape(-1, 2)), valid=t(np.ones(n_cams * n_pts, bool)),
            fx=500.0, fy=500.0, cx=320.0, cy=240.0)

    out = {}
    for dev in ("cuda", "cpu"):
        p = problem(dev)
        lam = torch.tensor(1e-4, dtype=torch.float64, device=dev)
        out[dev] = (ba.lm_step(p, lam), ba.solve_schur_cg(p, lam,
                                                          cg_iters=40),
                    ba.lm_optimize(p, iterations=15))
    (dc, dp), (cc, cp), opt = out["cuda"]
    (dc0, dp0), (cc0, cp0), opt0 = out["cpu"]
    err = lambda a, b: float((a.cpu() - b).abs().max())
    line = {"phase": "ba_float64", "dtype": str(dc.dtype),
            "lm_step_cam_err": err(dc, dc0), "lm_step_pt_err": err(dp, dp0),
            "cg_cam_err": err(cc, cc0), "cg_pt_err": err(cp, cp0),
            "cost": float(opt.cost), "cost_cpu": float(opt0.cost)}
    say(line)
    if not (dc.dtype == torch.float64 and line["lm_step_cam_err"] < 1e-8
            and line["cg_cam_err"] < 1e-8 and line["lm_step_pt_err"] < 1e-7
            and line["cg_pt_err"] < 1e-7 and line["cost"] < 1e-8):
        fail(f"ba_float64: {line}")
    return line


# A kernel entry's keys that its sub-entries (other inputs) leave out.
ENTRY_KEYS = ("name", "route", "source", "replaces", "launches",
              "launches_per_frame", "library_ms", "tolerance")


def run_slice(FD, EX, FS, width, height):
    """The sixth slice's phases, each with the frame kernels' counters set
    to 0 just before it: vo (then the frame kernels at its shapes),
    vo_resume, loop_closure, reconstruct, odometry_cli, ba_float64.
    Returns the frame kernels' launches on the vo run, the K2 / K3
    entries of the vo frame, the rendered frames and the reconstruct
    phase's line and final BAState."""
    from sift_tpu_torch.perf.scenes import VO_FRAMES, render_sequence

    frames, gt, gt_poses = render_sequence(n_frames=VO_FRAMES, textured=True,
                                           width=width, height=height)
    odo, vo, capacity = run_vo(FD, EX, FS, frames, gt)
    run_vo_resume(FD, EX, FS, frames, odo)
    run_loop_closure(FD, EX, FS, width, height)
    recon = run_reconstruct(FD, EX, FS, width, height)
    run_odometry_cli(FD, EX, FS, frames, gt_poses)
    check_ba_float64()
    return vo["launches"], capacity, frames, recon


# ---------------------------------------------------------------------------
# The detector's remaining configurations and CLIs
# ---------------------------------------------------------------------------

ORACLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "cv2_parity_oracle.npz")
PARITY_FEATURES = 2000      # tests/test_pipeline.py's parity config
TIERS = (1024, 2048)
FALLBACK_TIER = 64          # the smallest tier _pick_tier can choose
CLI_ITERS = 5
LARGE_FRAME = (1200, 1920)  # the JAX docs' second frame size
LARGE_FEATURES = 5000


def stdout_of(fn, *args):
    """``fn(*args)`` with its standard output captured; returns (the
    output, the return value, the SystemExit code or None)."""
    import contextlib
    import io

    buf = io.StringIO()
    code = ret = None
    with contextlib.redirect_stdout(buf):
        try:
            ret = fn(*args)
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), ret, code


def run_cv2_parity(FD, EX, FS):
    """The three parity scenes of the committed cv2 oracle through the
    port's detector on the card at tests/test_pipeline.py's config
    (``upscale=True``, ``num_features=2000``), held to that file's four
    gates (``perf/oracle.parity_gates``); each frame launches the four
    frame kernels once and no plain version.  Each frame (upscaled, so
    K1 / K5 run at octave shapes no other phase gives them) is then held
    against the same frame through the plain versions on the card, and
    K2 / K3 against their plain versions at the photo's own inputs."""
    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.core.convert import result_to_numpy
    from sift_tpu_torch.perf import oracle as OR

    orc = OR.load_parity_oracle(ORACLE_PATH)
    scenes, bad, photo, total = {}, [], None, {}
    for scene in OR.PARITY_SCENES:
        img = orc[scene]["image"].astype(np.float32)
        h, w = img.shape
        det = SiftDetector(SiftConfig(width=w, height=h,
                                      num_features=PARITY_FEATURES,
                                      upscale=True))
        det.warm_up()
        f = torch.as_tensor(img, device=det.device)
        zero_counters(FD, EX, FS)
        res = det.detect_and_compute(f)
        torch.cuda.synchronize()
        counts = frame_launches(FD, EX, FS, 1, f"cv2_parity[{scene}]")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        gates = OR.parity_gates(result_to_numpy(res), orc[scene])
        paired, dd, _ = plain_path_pairing(det, f, res,
                                           f"cv2_parity[{scene}]")
        scenes[scene] = dict(size=[w, h], keypoints=int(res.count),
                             cv2_keypoints=len(orc[scene]["x"]),
                             launches=counts, paired_with_plain_path=paired,
                             max_descriptor_diff_vs_plain=dd, **gates)
        if not gates["ok"]:
            bad.append(scene)
        if scene == "photo":
            photo = (det, f)
    zero_counters(FD, EX, FS)
    _, ori, desc = tap_stage_inputs(*photo)
    k2 = check_orientation(ori, "cv2_photo")
    k3 = check_descriptor(desc, "cv2_photo")
    say({"phase": "cv2_parity", "cv2_version": orc["cv2_version"],
         "num_features": PARITY_FEATURES, "upscale": True,
         "scenes": scenes,
         "orientation_hist": {k: k2[k] for k in ("passed", "max_abs_err",
                                                  "max_rel_err")},
         "descriptor_hist": {k: k3[k] for k in ("passed", "max_abs_err",
                                                 "max_u8_diff")}})
    if bad:
        fail(f"cv2_parity: gates failed on {bad}")
    if not (k2["passed"] and k3["passed"]):
        fail("cv2_parity: K2 or K3 disagrees with its plain version")
    return k2, k3, total


def tap_stage_inputs(det, frame):
    """One frame through ``det`` with the orientation and descriptor
    wrappers' arguments recorded as the detector passes them (the dicts
    check_orientation / check_descriptor take): the exact inputs of any
    configuration — upscaled frames, tiers — with nothing rebuilt."""
    from sift_tpu_torch.pipeline import detector as DT

    taps, saved = {}, (DT.orientation_hist, DT.descriptor_hist)

    def tap(name, fn):
        def call(values, ys0, xs0, par, rows, lanes, count, impl):
            taps[name] = dict(values=values, ys0=ys0, xs0=xs0, par=par,
                              rows=rows, lanes=lanes, count=count)
            return fn(values, ys0, xs0, par, rows, lanes, count=count,
                      impl=impl)
        return call

    DT.orientation_hist = tap("ori", saved[0])
    DT.descriptor_hist = tap("desc", saved[1])
    try:
        res = det.detect_and_compute(frame)
    finally:
        DT.orientation_hist, DT.descriptor_hist = saved
    torch.cuda.synchronize()
    return res, taps["ori"], taps["desc"]


def same_result(a, b):
    """Every keypoint field and the descriptors bit-equal up to the count,
    and the rows past the count empty in ``b``."""
    n = int(a.count)
    if n != int(b.count) or int(a.raw_count) != int(b.raw_count):
        return False
    eq = all(torch.equal(getattr(a.keypoints, k)[:n],
                         getattr(b.keypoints, k)[:n])
             for k in a.keypoints._fields)
    return bool(eq and torch.equal(a.descriptors[:n], b.descriptors[:n])
                and not bool(b.keypoints.valid[n:].any())
                and not bool(b.descriptors[n:].any()))


def run_tiers(det, f1, FD, EX, FS):
    """``SiftDetector(tiers=(1024, 2048))`` over the smoke frame twice:
    the first frame runs at full capacity, the second picks 2048 and must
    equal the full detector's result bit for bit.  The smallest tier a
    frame can pick (64 rows, ``_pick_tier``'s floor) forced on the frame
    must fill and fall back to the full result: the frame kernels run
    twice, at the tier and at full capacity.  K2 / K3 are held against
    their plain versions at the 2048-row inputs."""
    from sift_tpu_torch import SiftDetector

    cfg = det.config
    full = det.detect_and_compute(f1)
    tiered = SiftDetector(cfg, tiers=TIERS)
    tiered.warm_up()
    zero_counters(FD, EX, FS)
    r1 = tiered.detect_and_compute(f1)
    picked = tiered._pick_tier()
    r2 = tiered.detect_and_compute(f1)
    torch.cuda.synchronize()
    counts = frame_launches(FD, EX, FS, 2, "tiers")
    equal = same_result(full, r1) and same_result(full, r2)

    tiny = SiftDetector(cfg, tiers=(FALLBACK_TIER,))
    tiny.detect_and_compute(f1)
    tiny._last_count = 5                       # force the 64-row tier
    tiny_pick = tiny._pick_tier()
    zero_counters(FD, EX, FS)
    rf = tiny.detect_and_compute(f1)
    torch.cuda.synchronize()
    fallback_launches = dict(FS.launches)
    fallback_exact = same_result(full, rf)

    _, ori, desc = tap_stage_inputs(tiered, f1)
    k2 = check_orientation(ori, f"tier_{picked}")
    k3 = check_descriptor(desc, f"tier_{picked}")
    line = {"phase": "tiers", "width": cfg.width, "height": cfg.height,
            "num_features": cfg.num_features, "tiers": list(TIERS),
            "keypoints": int(full.count), "raw_keypoints":
            int(full.raw_count), "tier_picked": picked,
            "launches": counts, "bit_equal_to_full": equal,
            "fallback_tier": tiny_pick, "fallback_count": int(rf.count),
            "fallback_exact": fallback_exact,
            "fallback_launches": fallback_launches,
            "kernel_rows": [int(ori["ys0"].shape[0]),
                            int(desc["ys0"].shape[0])],
            "frame_ms_tiered": time_ms(
                lambda: tiered.detect_and_compute(f1)),
            "frame_ms_full": time_ms(lambda: det.detect_and_compute(f1)),
            "orientation_hist": {k: k2[k] for k in ("passed", "max_abs_err",
                                                     "max_rel_err")},
            "descriptor_hist": {k: k3[k] for k in ("passed", "max_abs_err",
                                                    "max_u8_diff")}}
    say(line)
    if picked != TIERS[1] or not equal:
        fail(f"tiers: picked {picked}, bit-equal {equal}")
    if tiny_pick != FALLBACK_TIER or not fallback_exact \
            or fallback_launches != {
            "orientation_hist": 2, "descriptor_hist": 2}:
        fail(f"tiers: fallback exact {fallback_exact}, launches "
             f"{fallback_launches}")
    if not (k2["passed"] and k3["passed"]):
        fail("tiers: K2 or K3 disagrees with its plain version")
    return k2, k3, counts


def frame_device_profile(fn, calls=5):
    """Per call of ``fn``, from torch.profiler after two warm-up calls:
    the device's busy ms, its kernels and copies, the host-to-device
    copies among them, the eight rows that take the most device time
    (name, ms, count) and the eight host operators that take the most
    host time of their own (name, ms, count; the profiler's own overhead
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sift_tpu_torch.perf.profile import device_rows

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof, calls)
    host = sorted(((e.key, e.self_cpu_time_total / calls / 1e3,
                    e.count / calls) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "device_ops": sum(r[2] for r in rows),
            "htod_copies": sum(r[2] for r in rows if "HtoD" in r[0]),
            "top": [[k[:90], ms, n] for k, ms, n in rows[:8]],
            "host_top": [[k[:60], ms, n] for k, ms, n in host[:8]]}


def run_conv_pyramid(det, f1, r_matmul, FD, EX, FS):
    """``blur_impl="conv"`` on the card: its pyramid against the matmul
    pyramid (atol 2e-2 on octaves 0-2, tests/test_pyramid.py:72-81) and
    against the conv pyramid on the CPU (atol 2e-4) — computed with
    cuDNN's TF32 switched ON for the process, which the conv blur must
    turn off for its own calls — then one whole conv-mode frame, profiled
    beside the matmul frame (it may copy no more to the device) and beside
    the conv frame that builds its pad indices on every blur."""
    import dataclasses

    from sift_tpu_torch import SiftDetector, build_detect_fn, build_plan
    from sift_tpu_torch.core.convert import result_to_numpy
    from sift_tpu_torch.ops.pyramid import gaussian_pyramid, plan_operators
    from sift_tpu_torch.perf.compare import pair_keypoints

    cfg = dataclasses.replace(det.config, blur_impl="conv",
                              downsample="nearest")
    plan = build_plan(cfg)
    ops = plan_operators(plan, f1.device)
    pm_ops = plan_operators(det.plan, f1.device, "dense")
    pm = gaussian_pyramid(det.plan, f1, pm_ops)
    torch.backends.cudnn.allow_tf32 = True
    try:
        pc = gaussian_pyramid(plan, f1, ops)
        torch.cuda.synchronize()
        restored = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    pcpu = gaussian_pyramid(plan, f1.cpu())
    err_mm = [float((a - b).abs().max()) for a, b in zip(pc[:3], pm[:3])]
    err_cpu = [float((a.cpu() - b).abs().max()) for a, b in zip(pc, pcpu)]
    dc = SiftDetector(cfg)
    dc.warm_up()
    # The conv frame as it was before plan_operators held the pad indices:
    # blur_conv builds and copies both indices to the card on every call.
    per_call = build_detect_fn(dc.plan, device=dc.device,
                               ops=ops._replace(pad_index=None))
    zero_counters(FD, EX, FS)
    rc = dc.detect_and_compute(f1)
    torch.cuda.synchronize()
    counts = frame_launches(FD, EX, FS, 1, "conv_pyramid")
    a, b = result_to_numpy(r_matmul), result_to_numpy(rc)
    ia, _ = pair_keypoints(a, b)
    paired = len(ia) / max(a["count"], b["count"], 1)
    line = {"phase": "conv_pyramid", "width": cfg.width,
            "height": cfg.height, "octaves": cfg.num_octaves,
            "max_abs_err_vs_matmul_octaves_0_2": err_mm,
            "max_abs_err_vs_cpu_conv": max(err_cpu),
            "max_abs_err_vs_cpu_conv_per_octave": err_cpu,
            "cudnn_tf32_on_outside": restored,
            "keypoints": int(rc.count), "keypoints_matmul": a["count"],
            "paired_with_matmul_frame": paired, "launches": counts,
            "frame_ms_conv": time_ms(lambda: dc.detect_and_compute(f1)),
            "frame_ms_matmul": time_ms(lambda: det.detect_and_compute(f1)),
            "pyramid_ms_conv": time_ms(lambda: gaussian_pyramid(plan, f1,
                                                                ops)),
            "pyramid_ms_matmul": time_ms(lambda: gaussian_pyramid(
                det.plan, f1, pm_ops)),
            "frame_ms_conv_index_per_call": time_ms(lambda: per_call(f1)),
            "profile_conv": frame_device_profile(
                lambda: dc.detect_and_compute(f1)),
            "profile_conv_index_per_call": frame_device_profile(
                lambda: per_call(f1)),
            "profile_matmul": frame_device_profile(
                lambda: det.detect_and_compute(f1))}
    say(line)
    if max(err_mm) > 2e-2 or max(err_cpu) > 2e-4 or not restored:
        fail(f"conv_pyramid: errors {err_mm} / {max(err_cpu)}, TF32 "
             f"setting kept {restored}")
    if int(rc.count) <= 300 or paired < 0.99:
        fail(f"conv_pyramid: {int(rc.count)} keypoints, {paired:.2%} "
             "paired with the matmul frame")
    copies = [line[k]["htod_copies"] for k in ("profile_conv",
                                               "profile_matmul")]
    if copies[0] > copies[1]:
        fail(f"conv_pyramid: {copies[0]} host-to-device copies a conv "
             f"frame, {copies[1]} a matmul frame")
    return line


def run_detect_cli(det, img1, FD, EX, FS, WG):
    """tools/detect.py on the smoke frame written as PGM (the native
    loader): its keypoint count equals the detector's on the same frame,
    and the golden it captures with --debug-path passes all seven stages
    of tools/perf.py, K4 launched per_pass times in each.  Then the CLI on
    a 1920x1200 frame, timed, its count equal to the detector's, and that
    frame (new octave and slab shapes for K1 / K5 / K2 / K3) held against
    the same frame through the plain versions on the card."""
    import re

    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.io.image import load_grayscale
    from sift_tpu_torch.perf.benchimg import bench_image
    from sift_tpu_torch.perf.scenes import write_pgm
    from sift_tpu_torch.tools import detect
    from sift_tpu_torch.tools import perf as perf_cli

    cfg = det.config
    kcap = det.plan.octaves[0].kpt_cap
    per_pass = 2 * -(-kcap // 1024) + -(-kcap // 512)
    with tempfile.TemporaryDirectory() as d:
        pgm, golden = f"{d}/frame.pgm", f"{d}/golden"
        write_pgm(pgm, img1)
        want = int(det.detect_and_compute(load_grayscale(pgm)).count)
        torch.cuda.synchronize()
        zero_counters(FD, EX, FS, WG)
        out, _, _ = stdout_of(detect.main, [pgm, "--iters", str(CLI_ITERS),
                                            "--debug-path", golden])
        torch.cuda.synchronize()
        frames = frame_launches(FD, EX, FS, 1 + CLI_ITERS, "detect_cli")
        n_capture = WG.launches["gather_windows"]
        zero_counters(WG)
        rep, _, code = stdout_of(perf_cli.main, [golden])
        torch.cuda.synchronize()
        n_replay = WG.launches["gather_windows"]
        plain = WG.plain_calls["gather_windows"]
        large = f"{d}/large.pgm"
        write_pgm(large, bench_image(*LARGE_FRAME, seed=0))
        zero_counters(FD, EX, FS)
        big, _, _ = stdout_of(detect.main, [large, "--iters", str(CLI_ITERS),
                                            "--num-features",
                                            str(LARGE_FEATURES)])
        torch.cuda.synchronize()
        big_launches = frame_launches(FD, EX, FS, 1 + CLI_ITERS,
                                      "detect_cli[1920x1200]")
        big_img = load_grayscale(large)
        det_big = SiftDetector(SiftConfig(
            width=big_img.shape[1], height=big_img.shape[0],
            num_features=LARGE_FEATURES))
        big_img = torch.as_tensor(big_img, device=det_big.device)
        r_big = det_big.detect_and_compute(big_img)
        big_plain = plain_path_pairing(det_big, big_img, r_big,
                                       "detect_cli[1920x1200]")[:2]
        zero_counters(FD, EX, FS)
    num = lambda pat, text: float(re.search(pat, text).group(1))
    n = int(num(r"keypoints: (\d+)", out))
    n_big = int(num(r"keypoints: (\d+)", big))
    passed = rep.count("PASS")
    line = {"phase": "detect_cli", "width": cfg.width, "height": cfg.height,
            "keypoints": n, "keypoints_detector": want,
            "median_ms": num(r"median ([0-9.]+) ms", out),
            "oracle_written": "cv2 oracle written" in out,
            "launches": frames, "replay_exit": code,
            "stages_passed": passed,
            "gather_windows_launches": {"capture": n_capture,
                                        "replay": n_replay,
                                        "expected_each": per_pass},
            "plain_calls": plain,
            "large": {"size": list(LARGE_FRAME[::-1]), "keypoints": n_big,
                      "keypoints_detector": int(r_big.count),
                      "paired_with_plain_path": big_plain[0],
                      "max_descriptor_diff_vs_plain": big_plain[1],
                      "median_ms": num(r"median ([0-9.]+) ms", big),
                      "min_ms": num(r"min ([0-9.]+) ms", big),
                      "launches": big_launches},
            "output": out.strip().splitlines(),
            "replay_output": rep.strip().splitlines()}
    say(line)
    if n != want or passed != 7 or code != 0:
        fail(f"detect_cli: {n} keypoints (detector {want}), {passed} "
             f"stages passed, exit {code}")
    if n_capture != per_pass or n_replay != per_pass or plain:
        fail(f"detect_cli: gather_windows launched {n_capture} + "
             f"{n_replay} (expected {per_pass} each), plain {plain}")
    if n_big <= 300 or n_big != int(r_big.count):
        fail(f"detect_cli: {n_big} keypoints at 1920x1200 (detector "
             f"{int(r_big.count)})")
    return n_capture + n_replay, frames, big_launches


def run_extract_and_match_cli(frames, FD, EX, FS):
    """tools/extract_and_match.py --tiers on the textured VO frames as a
    PGM directory: one line per frame, matches to the previous frame on
    every frame after the first, each count equal to a library run of the
    same frames (a tiered SiftDetector + match_brute_force), and the frame
    kernels launched as often as by that detector (its warm-up, then once
    per frame, twice where a tier saturates)."""
    import re

    from sift_tpu_torch import SiftConfig, SiftDetector, match_brute_force
    from sift_tpu_torch.io.image import load_image_directory
    from sift_tpu_torch.perf.scenes import VO_FEATURES, write_pgm
    from sift_tpu_torch.tools import extract_and_match

    tiers = tuple(t for t in (VO_FEATURES // 4, VO_FEATURES // 2)
                  if t >= 256)
    with tempfile.TemporaryDirectory() as d:
        for i, f in enumerate(frames):
            write_pgm(f"{d}/frame_{i:04d}.pgm", f)
        _, imgs = load_image_directory(d)
        zero_counters(FD, EX, FS)
        t0 = time.perf_counter()
        out, _, _ = stdout_of(extract_and_match.main, [d, "--tiers"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cli_counts = {**FD.launches, **EX.launches, **FS.launches}
    if any({**FD.plain_calls, **EX.plain_calls, **FS.plain_calls}.values()):
        fail("extract_and_match_cli: a plain version ran")
    lines = out.strip().splitlines()
    got = [re.match(r"\[(\d+)\] \S+: (\d+) kpts(?:, (\d+) matches to "
                    r"prev)? \(([0-9.]+) ms\)", ln) for ln in lines]
    h, w = imgs[0].shape
    cfg = SiftConfig(width=w, height=h, num_features=VO_FEATURES)
    lib = SiftDetector(cfg, tiers=tiers)
    zero_counters(FD, EX, FS)
    lib.warm_up()
    picked, per_frame, kpts, matched, prev = [], [], [], [], None
    for img in imgs:
        picked.append(lib._pick_tier())
        before = FS.launches["descriptor_hist"]
        res = lib.detect_and_compute(img)
        per_frame.append(FS.launches["descriptor_hist"] - before)
        kpts.append(int(res.count))
        matched.append(None if prev is None else int((match_brute_force(
            res.descriptors, prev.descriptors, res.keypoints.valid,
            prev.keypoints.valid) >= 0).sum()))
        prev = res
    torch.cuda.synchronize()
    lib_counts = {**FD.launches, **EX.launches, **FS.launches}
    cli_kpts = [int(g.group(2)) for g in got if g]
    cli_matched = [int(g.group(3)) if g and g.group(3) else None
                   for g in got]
    line = {"phase": "extract_and_match_cli", "frames": len(imgs),
            "width": w, "height": h, "num_features": VO_FEATURES,
            "tiers": list(tiers), "tiers_picked": picked,
            "kernel_runs_per_frame": per_frame,
            "keypoints": cli_kpts, "matches": cli_matched,
            "library_keypoints": kpts, "library_matches": matched,
            "launches": cli_counts, "library_launches": lib_counts,
            "seconds": wall,
            "frame_ms": [float(g.group(4)) for g in got if g]}
    say(line)
    if len(lines) != len(imgs) or not all(got):
        fail(f"extract_and_match_cli: output\n{out}")
    if cli_kpts != kpts or cli_matched != matched \
            or not all(m > 0 for m in matched[1:]):
        fail("extract_and_match_cli: counts differ from the library run")
    if cli_counts != lib_counts or any(r not in (1, 2) for r in per_frame):
        fail(f"extract_and_match_cli: launches {cli_counts}, library "
             f"{lib_counts}, per frame {per_frame}")
    return line


def run_detector_slice(det, f1, r1, img1, frames, FD, EX, FS, WG):
    """The seventh slice's phases, each with its counters set to 0 just
    before it: cv2_parity, tiers, conv_pyramid, detect_cli,
    extract_and_match_cli.  Returns the K2 / K3 entries of the parity
    photo and of the tier, the frame kernels' launches by phase and K4's
    launches in detect_cli."""
    *photo, parity = run_cv2_parity(FD, EX, FS)
    *tier, tiers = run_tiers(det, f1, FD, EX, FS)
    conv = run_conv_pyramid(det, f1, r1, FD, EX, FS)["launches"]
    k4, cli, cli_large = run_detect_cli(det, img1, FD, EX, FS, WG)
    em = run_extract_and_match_cli(frames, FD, EX, FS)["launches"]
    launches = {"cv2_parity": parity, "tiers": tiers, "conv_pyramid": conv,
                "detect_cli": cli, "detect_cli_1920x1200": cli_large,
                "extract_and_match_cli": em}
    return photo, tier, launches, k4


# ---------------------------------------------------------------------------
# The multi-device layer: parallel/, tools/scale_bench.py, reconstruct
# --distributed.  One card: several shards on it are virtual (they share
# its streams), so no figure here is a scaling figure.
# ---------------------------------------------------------------------------

SHARDED_FRAMES = 8
VIRTUAL_SHARDS = 4
MULTIHOST_FEATURES = 512    # tests/multihost_worker.py's config
CLUSTER_TIMEOUT = 300       # seconds, for each cluster of worker processes
CHAIN_CAMERAS = 2000        # tests/test_dba.py's map-block chain


def virtual_mesh(n):
    from sift_tpu_torch.parallel.batched import Mesh
    return Mesh(devices=(torch.device("cuda", 0),) * n)


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def host_syncs(fn):
    """``fn()`` with CUDA's sync debug mode on "warn": returns its result
    and how many synchronising torch calls it made (reading a device value
    on the host, a blocking copy)."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def run_sharded(FD, EX, FS, smi):
    """make_sharded_pipeline at the flagship config on 8 textured frames
    over 4 virtual shards of cuda:0, against batched_detect_fn +
    sequential_match on the one device: every field bit for bit."""
    from sift_tpu_torch import SiftConfig, build_plan
    from sift_tpu_torch.parallel.batched import (batched_detect_fn,
                                                 make_mesh,
                                                 make_sharded_pipeline,
                                                 sequential_match)
    from sift_tpu_torch.perf.benchimg import (FLAGSHIP_FEATURES,
                                              FLAGSHIP_HEIGHT,
                                              FLAGSHIP_WIDTH, bench_image)

    cfg = SiftConfig(width=FLAGSHIP_WIDTH, height=FLAGSHIP_HEIGHT,
                     num_features=FLAGSHIP_FEATURES)
    plan = build_plan(cfg)
    frames = np.stack([bench_image(cfg.height, cfg.width, seed=i)
                       for i in range(SHARDED_FRAMES)])
    dev = make_mesh(1).devices[0]
    batched = batched_detect_fn(plan, device=dev)
    ref = batched(torch.as_tensor(frames, device=dev))
    ref_m = sequential_match(ref.descriptors, ref.keypoints.valid,
                             cfg.match_ratio)
    fn, shard = make_sharded_pipeline(plan, virtual_mesh(VIRTUAL_SHARDS))
    blocks = shard(frames)
    torch.cuda.synchronize()
    zero_counters(FD, EX, FS)
    out, syncs = host_syncs(lambda: fn(blocks))
    torch.cuda.synchronize()
    counts = frame_launches(FD, EX, FS, SHARDED_FRAMES, "sharded")
    res, m = out.gather()
    equal = {"keypoints": same_bits(res.keypoints, ref.keypoints),
             "descriptors": torch.equal(res.descriptors, ref.descriptors),
             "count": torch.equal(res.count, ref.count),
             "matches": torch.equal(m, ref_m)}

    def fps(call, reps=3):
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
            torch.cuda.synchronize()
        return SHARDED_FRAMES * reps / (time.perf_counter() - t0)

    line = {"phase": "sharded", "width": cfg.width, "height": cfg.height,
            "num_features": cfg.num_features, "frames": SHARDED_FRAMES,
            "mesh": f"{VIRTUAL_SHARDS} virtual shards of cuda:0",
            "keypoints": res.count.tolist(),
            "matched": (m >= 0).sum(1).tolist(),
            "bit_equal_to_one_device": equal,
            "row0_unmatched": bool((m[0] == -1).all()), "launches": counts,
            "host_syncs": syncs,
            "frames_per_s_virtual_shards_one_card": fps(lambda: fn(blocks)),
            "frames_per_s_one_device_batch": fps(
                lambda: batched(torch.as_tensor(frames, device=dev))),
            "card": smi}
    say(line)
    if not all(equal.values()) or not line["row0_unmatched"] \
            or min(line["keypoints"]) < 300:
        fail(f"sharded: {line}")
    return counts


def run_scale_bench(FD, EX, FS, smi):
    """tools/scale_bench.py with its defaults (752x480, 512 features, 2
    frames per device, 4 timed iterations after one warm-up): one row on
    a one-GPU machine."""
    import contextlib
    import io

    from sift_tpu_torch.tools import scale_bench

    buf = io.StringIO()
    zero_counters(FD, EX, FS)
    with contextlib.redirect_stdout(buf):
        rows = scale_bench.main([])
    torch.cuda.synchronize()
    n = torch.cuda.device_count()
    points = sorted({1, 2, 4, 8, n} & set(range(1, n + 1)))
    # 2 frames per device, one warm-up call and 4 timed ones per point
    counts = frame_launches(FD, EX, FS, sum(2 * k * 5 for k in points),
                            "scale_bench")
    line = {"phase": "scale_bench", "rows": rows, "launches": counts,
            "output": buf.getvalue().strip().splitlines(), "card": smi}
    say(line)
    if [r["devices"] for r in rows] != points \
            or rows[0]["efficiency_vs_1"] != 1.0 \
            or not all(r["frames_per_s"] > 0 for r in rows):
        fail(f"scale_bench: {rows}")
    return counts


def run_distributed_ba(FD, EX, FS, smi):
    """parallel/dba.py on virtual shards of cuda:0 (tests/test_dba.py's
    cases and gates): dense 5 cameras / 96 points over 4 shards against
    lm_optimize; 148 observations over 8 shards; the 2000-camera chain
    with solver="cg" over 1 and 4 shards; the chunked resume through
    save_ba_state / load_ba_state, bit for bit."""
    from sift_tpu_torch.geometry import ba
    from sift_tpu_torch.parallel.dba import (make_distributed_lm,
                                             make_lm_stepper)
    from sift_tpu_torch.perf.checkpoint import load_ba_state, save_ba_state
    from sift_tpu_torch.perf.scenes import synthetic_ba, synthetic_ba_chain

    dev = torch.device("cuda", 0)
    zero_counters(FD, EX, FS)
    line = {"phase": "distributed_ba", "mesh": "virtual shards of cuda:0"}
    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96, device=dev)
    single = ba.lm_optimize(prob, iterations=10)
    fn, place = make_distributed_lm(virtual_mesh(4), iterations=10)
    dist = fn(place(prob))
    line["dense_4_shards"] = {
        "cost": float(dist.cost), "cost_single": float(single.cost),
        "rot_err": float((dist.rotations - single.rotations).abs().max())}
    ok = (line["dense_4_shards"]["cost"] < 1e-4
          and math.isclose(float(dist.cost), float(single.cost),
                           rel_tol=1e-2, abs_tol=1e-6)
          and line["dense_4_shards"]["rot_err"] <= 1e-4)

    prob, *_ = synthetic_ba(seed=1, n_cams=4, n_pts=37, device=dev)
    fn, place = make_distributed_lm(virtual_mesh(8), iterations=8)
    line["nondivisible_148_obs_8_shards"] = {"cost": float(fn(place(prob))
                                                          .cost)}
    ok &= line["nondivisible_148_obs_8_shards"]["cost"] < 1e-4

    chain = synthetic_ba_chain(n_cams=CHAIN_CAMERAS, device=dev)
    c0 = float(ba._mean_cost(chain, chain.rotations, chain.translations,
                             chain.points))
    line["chain"] = {"cameras": CHAIN_CAMERAS,
                     "points": int(chain.points.shape[0]),
                     "observations": int(chain.cam_idx.shape[0]),
                     "solver": "cg", "cg_iters": 30, "iterations": 6,
                     "c0": c0}
    for n in (1, 4):
        fn, place = make_distributed_lm(virtual_mesh(n), iterations=6,
                                        solver="cg", cg_iters=30)
        t0 = time.perf_counter()
        placed = place(chain)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        runs = []
        for _ in range(2):          # the first run pays first-use costs
            out, ms = events_ms(lambda: fn(placed))
            runs.append(ms / 6 / 1e3)
        _, syncs = host_syncs(lambda: fn(placed))
        line["chain"][f"shards_{n}"] = {
            "cost": float(out.cost), "place_s": place_s, "host_syncs": syncs,
            "s_per_lm_iteration": runs[-1],
            "s_per_lm_iteration_first_run": runs[0]}
        ok &= float(out.cost) < c0 / 10

    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96, device=dev)
    init, step, place = make_lm_stepper(virtual_mesh(4), chunk=5)
    placed = place(prob)
    straight = step(placed, step(placed, init(placed)))
    with tempfile.TemporaryDirectory() as d:
        save_ba_state(f"{d}/ba.npz", step(placed, init(placed)), 5)
        loaded, it = load_ba_state(f"{d}/ba.npz")
    resumed = step(placed, loaded)
    line["chunked_resume_bit_identical"] = it == 5 and same_bits(straight,
                                                                 resumed)
    ok &= line["chunked_resume_bit_identical"]
    counts = {**FD.launches, **EX.launches, **FS.launches}
    line["launches"] = counts
    line["card"] = smi
    say(line)
    if not ok or any(counts.values()):
        fail(f"distributed_ba: {line}")


def run_reconstruct_distributed(FD, EX, FS, width, height, single, smi):
    """reconstruct --distributed on the reconstruct phase's frames: one
    shard per GPU; the final cost equal to the single-device run's."""
    line, state = run_reconstruct(FD, EX, FS, width, height,
                                  distributed=True)
    ref_line, ref = single
    line["cost_single_device"] = ref_line["cost"]
    line["bit_equal_to_single_device"] = same_bits(state, ref)
    line["shards"] = torch.cuda.device_count()
    line["card"] = smi
    say(line)
    if not math.isclose(line["cost"], ref_line["cost"], rel_tol=1e-5) \
            or f"distributed over {line['shards']} devices" not in \
            "\n".join(line["output"]):
        fail(f"reconstruct_distributed: {line}")
    return line["launches"]


def run_multihost(FD, EX, FS, smi):
    """Two worker processes on the one card (gloo: NCCL refuses two ranks
    on one GPU), two cuda:0 shards each, against one process with four:
    the frame pipeline bit for bit, BA at rtol / atol 1e-5
    (tests/test_multihost.py's gates); one NCCL process with four shards
    (the NCCL staging; one rank, so bit for bit); then the elastic run —
    worker 1 lost after chunk 1, the survivor killed, a fresh pair
    resuming at iteration 10 — against the uninterrupted schedule."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_multihost_worker import det_frames, finish, spawn

    from sift_tpu_torch import SiftConfig, build_plan
    from sift_tpu_torch.parallel.batched import make_sharded_pipeline
    from sift_tpu_torch.parallel.dba import (make_distributed_lm,
                                             make_lm_stepper)
    from sift_tpu_torch.perf.benchimg import FLAGSHIP_HEIGHT, FLAGSHIP_WIDTH
    from sift_tpu_torch.perf.scenes import synthetic_ba

    w, h = FLAGSHIP_WIDTH, FLAGSHIP_HEIGHT
    size = ["--width", w, "--height", h, "--num-features",
            MULTIHOST_FEATURES, "--frames", SHARDED_FRAMES,
            "--device", "cuda:0"]
    line = {"phase": "multihost", "width": w, "height": h,
            "num_features": MULTIHOST_FEATURES, "frames": SHARDED_FRAMES}

    def start(d, nproc, shards, backend):
        return spawn("torch_multihost_worker.py", nproc, f"file://{d}/rv",
                     d, *size, "--shards", shards, "--backend", backend)

    def collect(d, procs, backend):
        logs = finish(procs, CLUSTER_TIMEOUT)
        if any(p.returncode != 0 for p in procs):
            fail(f"multihost: {backend} workers failed:\n"
                 + "\n".join(logs)[-6000:])
        launches = []
        for pid in range(len(procs)):
            with open(f"{d}/launches_{pid}.json") as fh:
                launches.append(json.load(fh))
        return dict(np.load(f"{d}/multihost_out.npz")), launches

    # The two clusters run side by side (the card is shared anyway).
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        procs_g = start(d1, 2, 2, "gloo")
        procs_n = start(d2, 1, 4, "nccl")
        try:
            gloo, gloo_launches = collect(d1, procs_g, "gloo")
            nccl, nccl_launches = collect(d2, procs_n, "nccl")
        finally:
            for p in procs_g + procs_n:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    clusters_s = time.perf_counter() - t0

    zero_counters(FD, EX, FS)
    mesh = virtual_mesh(4)
    fn, shard = make_sharded_pipeline(
        build_plan(SiftConfig(width=w, height=h,
                              num_features=MULTIHOST_FEATURES)), mesh)
    res, matches = fn(shard(det_frames(SHARDED_FRAMES, h, w))).gather()
    torch.cuda.synchronize()
    counts = frame_launches(FD, EX, FS, SHARDED_FRAMES, "multihost")
    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    lm, place = make_distributed_lm(mesh, iterations=10)
    state = lm(place(prob))
    want = {"count": res.count, "x": res.keypoints.x,
            "desc": res.descriptors, "matches": matches}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    cost, rot = float(state.cost), state.rotations.cpu().numpy()

    def held(got, bits):
        return {"count": np.array_equal(got["count"], want["count"]),
                "x": bool(np.allclose(got["x"], want["x"], rtol=0,
                                      atol=1e-5)),
                "descriptors": np.array_equal(got["desc"], want["desc"]),
                "matches": np.array_equal(got["matches"], want["matches"]),
                "ba_cost": (float(got["ba_cost"]) == cost) if bits
                else math.isclose(float(got["ba_cost"]), cost,
                                  rel_tol=1e-5, abs_tol=1e-8),
                "ba_rotations": (np.array_equal(got["ba_rot"], rot)
                                 if bits else bool(np.allclose(
                                     got["ba_rot"], rot, rtol=0,
                                     atol=1e-5)))}

    per_worker = SHARDED_FRAMES // 2
    line.update({
        "gloo_2x2": {"held": held(gloo, False),
                     "worker_launches": [x["launches"]
                                         for x in gloo_launches],
                     "ba_cost": float(gloo["ba_cost"])},
        "nccl_1x4": {"held": held(nccl, True),
                     "worker_launches": [x["launches"]
                                         for x in nccl_launches]},
        "clusters_seconds": clusters_s,
        "ba_cost_one_process": cost, "launches": counts,
        "keypoints": want["count"].tolist()})
    ok = all(line["gloo_2x2"]["held"].values()) \
        and all(line["nccl_1x4"]["held"].values()) \
        and all(set(x["launches"].values()) == {per_worker}
                and not any(x["plain_calls"].values())
                for x in gloo_launches) \
        and all(set(x["launches"].values()) == {SHARDED_FRAMES}
                for x in nccl_launches)

    # Elastic recovery.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        procs = spawn("torch_elastic_worker.py", 2, f"file://{d}/rv1", d, 1,
                      "--device", "cuda:0", "--shards", 2)
        try:
            out1, _ = procs[1].communicate(timeout=CLUSTER_TIMEOUT)
            died = procs[1].returncode
        finally:
            procs[0].kill()
            finish(procs, 60)
        ckpt_it = int(np.load(f"{d}/ba_ckpt.npz")["iteration"])
        final_before = os.path.exists(f"{d}/elastic_final.npz")
        procs = spawn("torch_elastic_worker.py", 2, f"file://{d}/rv2", d,
                      -1, "--device", "cuda:0", "--shards", 2)
        logs = finish(procs, CLUSTER_TIMEOUT)
        if any(p.returncode != 0 for p in procs):
            fail("multihost: elastic resume failed:\n"
                 + "\n".join(logs)[-6000:])
        got = dict(np.load(f"{d}/elastic_final.npz"))
    init, step, place = make_lm_stepper(mesh, chunk=5)
    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96)
    placed = place(prob)
    ref = init(placed)
    for _ in range(3):
        ref = step(placed, ref)
    line["elastic"] = {
        "worker1_exit": died, "checkpoint_iteration": ckpt_it,
        "final_before_resume": final_before,
        "resumed_at_10": "resuming at iteration 10" in logs[0],
        "cost": float(got["cost"]), "cost_uninterrupted": float(ref.cost),
        "cost_held": math.isclose(float(got["cost"]), float(ref.cost),
                                  rel_tol=1e-5, abs_tol=1e-8),
        "rotations_held": bool(np.allclose(
            got["rotations"], ref.rotations.cpu().numpy(), rtol=0,
            atol=1e-5)),
        "seconds": time.perf_counter() - t0}
    e = line["elastic"]
    ok &= (died == 17 and ckpt_it == 10 and not final_before
           and e["resumed_at_10"] and e["cost_held"] and e["rotations_held"])
    line["card"] = smi
    say(line)
    if not ok:
        fail(f"multihost: {line}" + (out1.decode(errors="replace")
                                     if died != 17 else ""))
    return counts


def run_parallel_slice(FD, EX, FS, width, height, recon, smi):
    """The eighth slice's phases, each with its counters set to 0 just
    before it: sharded, scale_bench, distributed_ba,
    reconstruct_distributed, multihost.  Returns the frame kernels'
    launches by phase."""
    launches = {"sharded": run_sharded(FD, EX, FS, smi),
                "scale_bench": run_scale_bench(FD, EX, FS, smi)}
    run_distributed_ba(FD, EX, FS, smi)
    launches["reconstruct_distributed"] = run_reconstruct_distributed(
        FD, EX, FS, width, height, recon, smi)
    launches["multihost"] = run_multihost(FD, EX, FS, smi)
    return launches



# ---------------------------------------------------------------------------
# The ninth slice: the band-blocked padded pyramid and the measuring tools
# ---------------------------------------------------------------------------

BENCH_SIZES = ((752, 480), (1600, 900), (1920, 1200))  # the reference's
BENCH_FEATURES = 5000
BENCH_TIERS = (1024, 2048)
BENCH_BATCH = 4
PYRAMID_ATOL = 2e-4         # tests/test_pyramid.py:106


def pyramid_gflop(plan):
    """float32 GFLOP of one pyramid (multiply + add each one operation)
    through the dense operators and through the band blocks, from the
    plan's shapes (init blur, carries, every octave's layer stack)."""
    dims = [(op.height, op.width) for op in plan.octaves]
    nl = plan.config.num_gauss_layers
    h0, w0 = dims[0]
    dense = 2 * (h0 * h0 * w0 + h0 * w0 * w0)
    for o, (h, w) in enumerate(dims):
        if o:
            ph, pw = dims[o - 1]
            dense += 2 * (h * ph * pw + h * pw * w)
        dense += 2 * nl * (h * h * w + h * w * w)

    def banded(pair, w_in):
        (vb, _), (hb, _) = pair
        nt, n, t, bv = vb.shape
        ntc, _, tc, bh = hb.shape
        return 2 * nt * n * t * bv * w_in + 2 * ntc * n * nt * t * bh * tc

    band = banded(plan.init_tiled, w0)
    for o, (h, w) in enumerate(dims):
        if o:
            band += banded(plan.carry_tiled[o], dims[o - 1][1])
        band += banded((plan.tiled_v[o], plan.tiled_h[o]), w)
    return dense / 1e9, band / 1e9


def run_banded_pyramid(FD, EX, FS, smi):
    """The detector's band-blocked padded pyramid at the reference's three
    frame sizes (``num_features=5000``, ``bench_image``): its content
    against the dense pyramid (atol 2e-4), its padding exactly 0, K1 on the
    padded octaves against its plain version bit for bit; each pyramid's
    time (CUDA events, median of 20) and device operations
    (torch.profiler); then one detector frame with the counters set to 0
    just before it (each frame kernel once) and ``frame_ms``.  Returns the
    keypoint count by size and the frame kernels' launches by size."""
    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.config import SIFT_IMG_BORDER
    from sift_tpu_torch.core.types import HALO
    from sift_tpu_torch.ops.pyramid import (gaussian_pyramid,
                                            gaussian_pyramid_padded,
                                            padded_content_views,
                                            plan_operators)
    from sift_tpu_torch.perf.benchimg import bench_image

    rows, counts, launches = [], {}, {}
    for w, h in BENCH_SIZES:
        cfg = SiftConfig(width=w, height=h, num_features=BENCH_FEATURES)
        det = SiftDetector(cfg)
        det.warm_up()
        plan = det.plan
        f = torch.as_tensor(bench_image(h, w), device=det.device)
        ops_p = plan_operators(plan, det.device)
        ops_d = plan_operators(plan, det.device, "dense")
        gp = gaussian_pyramid_padded(plan, f, ops_p)
        views = padded_content_views(plan, gp)
        dense = gaussian_pyramid(plan, f, ops_d)
        err = [float((v - d).abs().max()) for v, d in zip(views, dense)]
        pad_nonzero = 0
        for g, op in zip(gp, plan.octaves):
            z = g.clone()
            z[:, HALO:HALO + op.height, :op.width] = 0
            pad_nonzero += int((z != 0).sum())
        args = (float(cfg.peak_threshold), SIFT_IMG_BORDER,
                float(cfg.edge_threshold), float(cfg.contrast_threshold),
                cfg.num_octave_layers)
        ker = FD.detect_records_cuda(views, *args)
        pla = FD.detect_records_plain(views, *args)
        torch.cuda.synchronize()
        k1_exact = all(torch.equal(a, b) for a, b in zip(ker, pla))
        gflop_dense, gflop_banded = pyramid_gflop(plan)
        padded_fn = lambda: gaussian_pyramid_padded(plan, f, ops_p)
        dense_fn = lambda: gaussian_pyramid(plan, f, ops_d)
        prof_p = frame_device_profile(padded_fn)
        prof_d = frame_device_profile(dense_fn)
        torch.cuda.synchronize()
        zero_counters(FD, EX, FS)
        res = det.detect_and_compute(f)
        torch.cuda.synchronize()
        size = f"{w}x{h}"
        launches[size] = frame_launches(FD, EX, FS, 1,
                                        f"banded_pyramid {size}")
        counts[size] = int(res.count)
        row = {"size": size, "keypoints": counts[size],
               "padded_shapes": [list(g.shape) for g in gp],
               "max_abs_err_vs_dense": max(err),
               "max_abs_err_per_octave": err,
               "padding_nonzero": pad_nonzero,
               "k1_bit_exact_on_padded": k1_exact,
               "gflop_dense": gflop_dense, "gflop_banded": gflop_banded,
               "bound_ms_dense": gflop_dense * 1e9 / PEAK_F32_FLOPS * 1e3,
               "bound_ms_banded": gflop_banded * 1e9 / PEAK_F32_FLOPS * 1e3,
               "pyramid_ms_banded": time_ms(padded_fn),
               "pyramid_ms_dense": time_ms(dense_fn),
               "device_ms_banded": prof_p["device_ms"],
               "device_ms_dense": prof_d["device_ms"],
               "device_ops_banded": prof_p["device_ops"],
               "device_ops_dense": prof_d["device_ops"],
               "top_banded": prof_p["top"],
               "frame_ms": time_ms(lambda: det.detect_and_compute(f)),
               "launches": launches[size]}
        rows.append(row)
        if max(err) > PYRAMID_ATOL or pad_nonzero or not k1_exact:
            say({"phase": "banded_pyramid", "card": smi, "sizes": rows})
            fail(f"banded_pyramid {size}: error {max(err)} (atol "
                 f"{PYRAMID_ATOL}), {pad_nonzero} padding values not 0, "
                 f"K1 bit-exact {k1_exact}")
        del det, gp, views, dense, ops_p, ops_d
    say({"phase": "banded_pyramid", "card": smi, "sizes": rows})
    return counts, launches


def run_tools(counts, FD, EX, FS, smi):
    """The port's measuring tools on the card: ``tools.benchmark --batch 4
    --tiers 1024 2048`` as a subprocess at its default sizes, then
    ``perf.stage_bench``, ``perf.kernel_bench`` and ``perf.mem_analysis``
    at their defaults in this process.  Every value must be finite and
    positive (a stage's delta only finite), and every ``keypoints`` the
    detector's count at that size (``counts``, from banded_pyramid)."""
    import re

    from sift_tpu_torch.perf import kernel_bench, mem_analysis, stage_bench

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "sift_tpu_torch.tools.benchmark",
           "--batch", str(BENCH_BATCH), "--tiers",
           *[str(t) for t in BENCH_TIERS]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=600)
    seconds = {"benchmark": time.perf_counter() - t0}
    if proc.returncode != 0:
        fail(f"tools: benchmark exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    bench = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    line = {"phase": "tools", "card": smi, "benchmark_cmd": " ".join(cmd[1:]),
            "benchmark": bench}
    names = [b["metric"] for b in bench]
    want = []
    for w, h in BENCH_SIZES:
        want += [f"detect_compute_{w}x{h}"] + [
            f"detect_compute_{w}x{h}_tier{t}" for t in BENCH_TIERS] + [
            f"detect_compute_{w}x{h}_batch{BENCH_BATCH}"]
    bad = [] if names == want + ["match_2000x2000"] else [("names", names)]
    for b in bench:
        if not (math.isfinite(b["value"]) and b["value"] > 0):
            bad.append((b["metric"], b["value"]))
        if "keypoints" in b:
            size = re.match(r"detect_compute_(\d+x\d+)", b["metric"])[1]
            if b["keypoints"] != counts[size]:
                bad.append((b["metric"], b["keypoints"], counts[size]))
    for name, mod in (("stage_bench", stage_bench),
                      ("kernel_bench", kernel_bench),
                      ("mem_analysis", mem_analysis)):
        torch.cuda.synchronize()
        zero_counters(FD, EX, FS)
        t0 = time.perf_counter()
        out, ret, code = stdout_of(mod.main, [])
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        line[name] = {"lines": out.splitlines(), "result": ret,
                      "launches": {**FD.launches, **EX.launches,
                                   **FS.launches}}
        if code not in (None, 0):
            bad.append((name, "exit", code))
    for r in line["stage_bench"]["result"] or [None]:
        if not (r and math.isfinite(r["cum_ms"]) and r["cum_ms"] > 0
                and math.isfinite(r["delta_ms"])):
            bad.append(("stage_bench", r))
    if len(line["stage_bench"]["result"] or ()) != 8:
        bad.append(("stage_bench", "not 8 stages"))
    kb = line["kernel_bench"]["result"] or {}
    if set(kb) != {"detect_records", "expand_lane_copies",
                   "orientation_hist", "descriptor_hist"} or not all(
            math.isfinite(v) and v > 0 for v in kb.values()):
        bad.append(("kernel_bench", kb))
    for m in line["mem_analysis"]["result"] or [None]:
        keys = ("temp_mib", "args_mib", "output_mib", "total_mib")
        if not (m and all(math.isfinite(m[k]) and m[k] > 0 for k in keys)):
            bad.append(("mem_analysis", m))
    line["seconds"] = seconds
    say(line)
    if bad:
        fail(f"tools: {bad}")
    return line


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU")
    from sift_tpu_torch import SiftConfig, SiftDetector, match_brute_force
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
        main_e["synthetic_full"] = {key: syn_e[key] for key in syn_e
                                    if key not in ENTRY_KEYS}
        main_e["passed"] = main_e["passed"] and syn_e["passed"]
    k4 = check_gather(gauss[0], cfg)
    kernels = [k1, k5, k2, k3, k4] + check_window_proto(per_kernel)

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
    paired, dd, det_plain = plain_path_pairing(det, f1, r1, "main_path")
    if not all({**FD.plain_calls, **EX.plain_calls,
                **FS.plain_calls}.values()) \
            or {**FD.launches, **EX.launches, **FS.launches} != counts:
        fail("kernel_impl='torch' did not run the plain versions")

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
         "max_descriptor_diff_vs_plain_path": dd,
         "frame_ms": frame_ms, "frame_wall_ms": frame_wall_ms,
         "plain_path_frame_ms": plain_frame_ms, "match_ms": match_ms,
         "peak_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
         "card": smi})
    check_matcher_exact(r1, r2, match_brute_force)

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
    vo_launches, vo_entries, vo_frames, recon = run_slice(FD, EX, FS,
                                                          WIDTH, HEIGHT)
    for e in kernels[:4]:
        e["launches_vo"] = vo_launches[e["name"]]
    for main_e, vo_e in zip((k2, k3), vo_entries):
        main_e["vo_frame"] = {key: vo_e[key] for key in vo_e
                              if key not in ENTRY_KEYS}
    photo, tier, by_phase, k4_cli = run_detector_slice(
        det, f1, r1, img1, vo_frames, FD, EX, FS, WG)
    for e in kernels[:4]:
        e["launches_detector_slice"] = {p: c[e["name"]]
                                        for p, c in by_phase.items()}
    k4["launches_detect_cli"] = k4_cli
    by_phase = run_parallel_slice(FD, EX, FS, WIDTH, HEIGHT, recon, smi)
    for e in kernels[:4]:
        e["launches_parallel_slice"] = {p: c[e["name"]]
                                        for p, c in by_phase.items()}
    counts_by_size, by_size = run_banded_pyramid(FD, EX, FS, smi)
    for e in kernels[:4]:
        e["launches_banded_pyramid"] = {p: c[e["name"]]
                                        for p, c in by_size.items()}
    run_tools(counts_by_size, FD, EX, FS, smi)
    for main_e, *subs in ((k2, photo[0], tier[0]), (k3, photo[1], tier[1])):
        for sub in subs:
            main_e[sub["inputs"]] = {key: sub[key] for key in sub
                                     if key not in ENTRY_KEYS}
            main_e["passed"] = main_e["passed"] and sub["passed"]
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
