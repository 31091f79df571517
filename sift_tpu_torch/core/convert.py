"""State carried across packages: the static plan and the keypoint trees,
as numpy.

There are no weights in this system; what a detector closes over is its
``SiftPlan`` (operators and capacities) and what it hands on are keypoint
trees.  These helpers build the port's objects from plain numpy arrays and
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
