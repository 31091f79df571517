"""Gaussian and DoG pyramid construction, natural shapes.

Counterpart of ``sift_tpu/ops/pyramid.py`` (``gaussian_pyramid``,
``dog_pyramid``).  With the blur expressed as precomputed operators
(core/gaussian.py), each octave's layers come from the octave base via one
batched matmul pair, and each octave base comes from the previous base via
one composed (resize ∘ blur) matmul pair.  The padded/tiled layout of the
JAX package is a TPU layout and has no counterpart here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from sift_tpu_torch.core.types import SiftPlan
from sift_tpu_torch.ops.blur import blur_matmul
from sift_tpu_torch.ops.resize import resize_matmul


class PlanOperators(NamedTuple):
    """The plan's operators as tensors on one device (moved once)."""

    blur_v: Tuple[torch.Tensor, ...]
    blur_h: Tuple[torch.Tensor, ...]
    carry_v: Tuple[torch.Tensor, ...]
    carry_h: Tuple[torch.Tensor, ...]
    init_v: torch.Tensor
    init_h: torch.Tensor
    up_v: Optional[torch.Tensor]
    up_h: Optional[torch.Tensor]


def plan_operators(plan: SiftPlan, device) -> PlanOperators:
    t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    tt = lambda seq: tuple(t(a) for a in seq)
    return PlanOperators(blur_v=tt(plan.blur_v), blur_h=tt(plan.blur_h),
                         carry_v=tt(plan.carry_v), carry_h=tt(plan.carry_h),
                         init_v=t(plan.init_v), init_h=t(plan.init_h),
                         up_v=t(plan.up_v), up_h=t(plan.up_h))


def gaussian_pyramid(plan: SiftPlan, image: torch.Tensor,
                     ops: Optional[PlanOperators] = None
                     ) -> List[torch.Tensor]:
    """image: [H, W] float32 (0..255 range).  Returns per-octave stacks
    [L+3, H_o, W_o] on the image's device.  ``ops``: the plan's operators
    already on that device (else moved here)."""
    cfg = plan.config
    if cfg.blur_impl != "matmul":
        raise NotImplementedError(
            "blur_impl='conv' is not ported yet; use 'matmul'")
    if ops is None:
        ops = plan_operators(plan, image.device)
    base = resize_matmul(image, ops.up_v, ops.up_h) if cfg.upscale else image

    # Layer 0 of octave 0: base blur with sigma_diff.
    base = blur_matmul(base, ops.init_v, ops.init_h)
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            base = blur_matmul(base, ops.carry_v[o], ops.carry_h[o])
        octaves.append(blur_matmul(base, ops.blur_v[o], ops.blur_h[o]))
    return octaves


def dog_pyramid(gauss: List[torch.Tensor]) -> List[torch.Tensor]:
    """DoG[i] = gauss[i+1] - gauss[i] per octave."""
    return [g[1:] - g[:-1] for g in gauss]
