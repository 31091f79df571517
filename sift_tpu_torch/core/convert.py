"""State carried across packages: the static plan, the keypoint trees and
the geometry layer's problems, as numpy.

There are no weights in this system; what a detector closes over is its
``SiftPlan`` (operators and capacities), what it hands on are keypoint
trees, and what the SfM layer works on are bundle-adjustment problems and
pose graphs.  These helpers build the port's objects from plain numpy arrays and
dicts — for example the JAX package's own plan operators — and turn results
back into numpy, so the two packages can be run on identical state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.core.types import (Keypoints, SiftPlan, SiftResult,
                                       octave_plans)

_TPU_ONLY = ("gather_impl",)   # config fields with no counterpart here


def config_from_dict(cfg: dict) -> SiftConfig:
    """SiftConfig from a plain dict of the JAX package's config fields
    (``dataclasses.asdict``); its TPU-only ``gather_impl`` is dropped."""
    kw = {k: v for k, v in cfg.items() if k not in _TPU_ONLY}
    return SiftConfig(**kw)


def plan_from_numpy(cfg: dict, arrays: Dict[str, object]) -> SiftPlan:
    """SiftPlan over GIVEN operators.  ``arrays``: ``blur_v``/``blur_h``/
    ``carry_v``/``carry_h`` as per-octave sequences of numpy arrays,
    ``init_v``/``init_h`` arrays, ``up_v``/``up_h`` arrays or None;
    optionally ``down_v``/``down_h``, ``kernels_1d``, ``init_kernel_1d``.
    Geometry and capacities are recomputed from the config."""
    config = config_from_dict(cfg)
    octs = octave_plans(config)

    def per_octave(name, required=True):
        if name not in arrays:
            if required:
                raise KeyError(name)
            return ()
        seq = tuple(np.asarray(a, np.float32) for a in arrays[name])
        if len(seq) != len(octs):
            raise ValueError(f"{name}: {len(seq)} octaves, plan has "
                             f"{len(octs)}")
        return seq

    def opt(name):
        a = arrays.get(name)
        return None if a is None else np.asarray(a, np.float32)

    plan = SiftPlan(
        config=config, octaves=octs,
        blur_v=per_octave("blur_v"), blur_h=per_octave("blur_h"),
        init_v=np.asarray(arrays["init_v"], np.float32),
        init_h=np.asarray(arrays["init_h"], np.float32),
        up_v=opt("up_v"), up_h=opt("up_h"),
        down_v=per_octave("down_v", False),
        down_h=per_octave("down_h", False),
        carry_v=per_octave("carry_v"), carry_h=per_octave("carry_h"),
        kernels_1d=tuple(np.asarray(k, np.float32)
                         for k in arrays.get("kernels_1d", ())),
        init_kernel_1d=opt("init_kernel_1d"))
    for o, op in enumerate(octs):
        if plan.blur_v[o].shape[-1] != op.height \
                or plan.blur_h[o].shape[-1] != op.width:
            raise ValueError(f"octave {o}: operator shapes do not match "
                             f"{op.height}x{op.width}")
    return plan


def padded_pyramid_from_numpy(values, height, width, layers: int,
                              copies: int = 1, device=None):
    """ops/flatpyr.PaddedPyramid from numpy: ``values`` [copies*O*D, Hp, Wp]
    float32, per-octave valid ``height``/``width`` [O], the static layer
    count D and the shifted-copy count — the fields of the JAX package's
    PaddedPyramid, so both packages' stages can be fed the same slab."""
    from sift_tpu_torch.ops.flatpyr import PaddedPyramid
    t = lambda a, dt: torch.as_tensor(np.array(a), device=device).to(dt)
    return PaddedPyramid(values=t(values, torch.float32),
                         height=t(height, torch.int32),
                         width=t(width, torch.int32),
                         layers=int(layers), copies=int(copies))


_KP_DTYPES = dict(x=torch.float32, y=torch.float32, layer=torch.int32,
                  octave=torch.int32, xi=torch.float32, size=torch.float32,
                  response=torch.float32, angle=torch.float32,
                  valid=torch.bool)


def keypoints_from_numpy(fields: Dict[str, np.ndarray],
                         device: Optional[object] = None) -> Keypoints:
    """Keypoints from a dict of numpy arrays (missing fields are zeros)."""
    n = len(next(iter(fields.values())))
    out = {}
    for name, dt in _KP_DTYPES.items():
        if name in fields:
            out[name] = torch.as_tensor(np.asarray(fields[name]),
                                        device=device).to(dt)
        else:
            out[name] = torch.zeros((n,), dtype=dt, device=device)
    return Keypoints(**out)


def result_to_numpy(res: SiftResult) -> dict:
    """SiftResult -> dict of numpy arrays (host copy; synchronises)."""
    out = {name: getattr(res.keypoints, name).detach().cpu().numpy()
           for name in Keypoints._fields}
    out["descriptors"] = res.descriptors.detach().cpu().numpy()
    out["count"] = int(res.count)
    out["raw_count"] = int(res.raw_count)
    return out


def _fields_as_numpy(obj, fields) -> Dict[str, np.ndarray]:
    """A dict or NamedTuple of arrays -> dict of numpy arrays."""
    get = obj.get if isinstance(obj, dict) else \
        (lambda k: getattr(obj, k))
    return {k: np.asarray(get(k)) for k in fields}


def ba_problem_from_numpy(fields, device=None):
    """geometry/ba.BAProblem from a dict or NamedTuple of arrays (e.g. the
    JAX package's own ``BAProblem``): floats keep their dtype (float64
    stays float64), indices become int64, ``valid`` bool, the intrinsics
    0-dim tensors of the points' dtype."""
    from sift_tpu_torch.geometry.ba import BAProblem

    a = _fields_as_numpy(fields, BAProblem._fields)
    t = lambda v: torch.as_tensor(np.array(v), device=device)
    dt = t(a["points"]).dtype
    return BAProblem(
        rotations=t(a["rotations"]), translations=t(a["translations"]),
        points=t(a["points"]),
        cam_idx=t(a["cam_idx"]).to(torch.int64),
        pt_idx=t(a["pt_idx"]).to(torch.int64),
        uv=t(a["uv"]), valid=t(a["valid"]).to(torch.bool),
        fx=t(a["fx"]).to(dt), fy=t(a["fy"]).to(dt), cx=t(a["cx"]).to(dt),
        cy=t(a["cy"]).to(dt))


def pose_graph_from_numpy(fields, device=None):
    """geometry/posegraph.PoseGraph from a dict or NamedTuple of arrays
    (e.g. the JAX package's own ``PoseGraph``)."""
    from sift_tpu_torch.geometry.posegraph import PoseGraph

    a = _fields_as_numpy(fields, PoseGraph._fields)
    t = lambda v: torch.as_tensor(np.array(v), device=device)
    return PoseGraph(
        rotations=t(a["rotations"]), translations=t(a["translations"]),
        pose_valid=t(a["pose_valid"]).to(torch.bool),
        edge_i=t(a["edge_i"]).to(torch.int32),
        edge_j=t(a["edge_j"]).to(torch.int32),
        rel_rot=t(a["rel_rot"]), rel_t=t(a["rel_t"]),
        edge_weight=t(a["edge_weight"]))


def sift_result_from_numpy(fields: Dict[str, np.ndarray],
                           device=None) -> SiftResult:
    """SiftResult from the dict ``result_to_numpy`` returns (keypoint
    fields, ``descriptors``, ``count``, ``raw_count``) — the inverse of
    ``result_to_numpy``, and the JAX package's result taken as numpy."""
    kp = keypoints_from_numpy({k: fields[k] for k in Keypoints._fields
                               if k in fields}, device)
    return SiftResult(
        keypoints=kp,
        descriptors=torch.as_tensor(np.array(fields["descriptors"]),
                                    device=device),
        count=torch.as_tensor(np.array(fields["count"]),
                              device=device).to(torch.int32),
        raw_count=torch.as_tensor(np.array(fields["raw_count"]),
                                  device=device).to(torch.int32))
