"""The per-keypoint kernels' inputs as the main path gives them.

``frame_slab`` rebuilds a frame's Gaussian pyramid and stacked slab with the
ops the detector itself calls; ``frame_inputs`` the orientation and
descriptor kernels' arguments for the keypoints of a detection result;
``synthetic_inputs`` the same for ~the whole capacity of random keypoints
whose radii span every class.  Shared by ``chip_smoke.py`` and
``perf/orientation_ablation.py``, so that both time the kernels on the same
inputs.  Each returns dicts of the wrappers' arguments (``values``, ``ys0``,
``xs0``, ``par``, ``rows``, ``lanes``, ``count``).
"""

from __future__ import annotations

import numpy as np
import torch


def frame_slab(det, frame):
    """(gauss, base, slab) of ``frame``: the Gaussian pyramid, the
    single-copy stacked slab and the slab with the detector's copy count,
    each window deep enough for the larger of the two stages' radii."""
    from sift_tpu_torch.kernels.window_gather import window_rows
    from sift_tpu_torch.ops.descriptor import max_descr_radius
    from sift_tpu_torch.ops.flatpyr import stack_pyramid
    from sift_tpu_torch.ops.orientation import max_ori_radius
    from sift_tpu_torch.ops.pyramid import gaussian_pyramid, plan_operators
    from sift_tpu_torch.pipeline.detector import slab_copies

    cfg = det.config
    gauss = gaussian_pyramid(det.plan, frame, plan_operators(det.plan,
                                                             det.device))
    rmax = max(max_descr_radius(cfg), max_ori_radius(cfg))
    layers = dict(extra_rows=window_rows(rmax), layer_lo=1,
                  layer_hi=cfg.num_octave_layers + 1)
    base = stack_pyramid(gauss, copies=1, **layers).values
    slab = stack_pyramid(gauss, copies=slab_copies(det.plan), **layers)
    return gauss, base, slab


def stage_inputs(slab, kp, count, cfg):
    """The orientation and descriptor wrappers' arguments for keypoints
    ``kp`` (a dict of fields), built by the ops the detector itself calls."""
    from sift_tpu_torch.ops import descriptor as D
    from sift_tpu_torch.ops import orientation as O

    ys0, xs0, par, rows, lanes = O.orientation_params(
        slab, kp["octave"], kp["x"], kp["y"], kp["layer"], kp["size"],
        kp["valid"], cfg)
    ori = dict(values=slab.values, ys0=ys0, xs0=xs0, par=par, rows=rows,
               lanes=lanes, count=count)
    if "angle" not in kp:
        return ori, None
    ys0, xs0, par, rows, lanes = D.descriptor_params(
        slab, kp["octave"], kp["x"], kp["y"], kp["layer"], kp["size"],
        kp["angle"], kp["valid"], cfg)
    desc = dict(values=slab.values, ys0=ys0, xs0=xs0, par=par, rows=rows,
                lanes=lanes, count=count)
    return ori, desc


def frame_inputs(slab, res, cfg):
    """The main path's own inputs of the orientation and descriptor
    kernels for the frame that gave ``res``.  The descriptor kernel ran on
    the result's keypoints.  The orientation kernel ran on the keypoints
    before their expansion into one copy per orientation peak: the copies
    of one keypoint are adjacent, so the first of each run, compacted in
    order, is that set (checked against ``res.raw_count``)."""
    from sift_tpu_torch.ops.compact import stream_compact

    k = res.keypoints
    full = {f: getattr(k, f) for f in ("octave", "x", "y", "layer", "size",
                                       "angle", "valid")}
    _, desc = stage_inputs(slab, full, res.count, cfg)
    same = torch.ones_like(k.valid)
    for f in ("octave", "x", "y", "layer", "size"):
        v = getattr(k, f)
        same[1:] &= v[1:] == v[:-1]
    same[0] = False
    idx, val = stream_compact(k.valid & ~same, k.valid.shape[0])
    idx = idx.to(torch.int64)
    raw = {f: full[f][idx] for f in ("octave", "x", "y", "layer", "size")}
    raw["valid"] = val
    if int(val.sum()) != int(res.raw_count):
        raise RuntimeError(f"rebuilt {int(val.sum())} pre-expansion "
                           f"keypoints, the frame had {int(res.raw_count)}")
    ori, _ = stage_inputs(slab, raw, res.raw_count, cfg)
    return ori, desc


def synthetic_inputs(det, slab, seed=1):
    """~all of the capacity live, radii spanning the three ranges the
    JAX package treats as classes (<= 26, 27-30, 31-38), random places
    in the three largest octaves of the real slab."""
    cfg, dev = det.config, det.device
    k = cfg.num_features
    rng = np.random.default_rng(seed)
    octv = rng.integers(0, 3, k).astype(np.int32)
    hs = np.array([op.height for op in det.plan.octaves])[octv]
    ws = np.array([op.width for op in det.plan.octaves])[octv]
    px = rng.uniform(2, ws - 3)
    py = rng.uniform(2, hs - 3)
    # descriptor radius = round(3 * scl * sqrt(2) * 2.5), scl = size/2 in
    # octave coordinates; scl <= sigma * 2^(3.5/3) keeps it <= 38.
    scl_max = cfg.sigma * 2.0 ** ((cfg.num_octave_layers + 0.5)
                                  / cfg.num_octave_layers)
    scl = rng.uniform(1.0, scl_max * 0.999, k)
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    kp = dict(
        octave=t(octv, torch.int32),
        x=t(px * 2.0 ** octv, torch.float32),
        y=t(py * 2.0 ** octv, torch.float32),
        layer=t(rng.integers(1, cfg.num_octave_layers + 1, k), torch.int32),
        size=t(2.0 * scl * 2.0 ** octv, torch.float32),
        angle=t(rng.uniform(0, 360, k), torch.float32),
        valid=t(np.arange(k) < k - 16, torch.bool))   # valid-first
    return stage_inputs(slab, kp, kp["valid"].to(torch.int32).sum(), cfg)
