"""Gaussian and DoG pyramid construction, natural shapes.

Counterpart of ``sift_tpu/ops/pyramid.py`` (``gaussian_pyramid``,
``dog_pyramid``).  With the blur expressed as precomputed operators
(core/gaussian.py), each octave's layers come from the octave base via one
batched matmul pair, and each octave base comes from the previous base via
one composed (resize ∘ blur) matmul pair.  ``blur_impl="conv"`` builds the
pyramid sequentially instead, as the reference does: each layer is the
previous one blurred by 1-D convolutions, each octave base a resize of the
previous octave's layer L.  The padded/tiled layout of the JAX package is a
TPU layout and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from sift_tpu_torch.core.types import SiftPlan
from sift_tpu_torch.ops.blur import blur_conv, blur_matmul, reflect_pad_index
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
    # The conv pyramid's 1-D kernels, octave-base resize operators and
    # reflect-101 pad indices by (axis length, kernel half-width) (moved
    # only for blur_impl="conv", so that a frame copies nothing to the
    # device).
    kernels_1d: Tuple[torch.Tensor, ...] = ()
    init_kernel_1d: Optional[torch.Tensor] = None
    down_v: Tuple[torch.Tensor, ...] = ()
    down_h: Tuple[torch.Tensor, ...] = ()
    pad_index: Dict[Tuple[int, int], torch.Tensor] = {}


def plan_operators(plan: SiftPlan, device) -> PlanOperators:
    t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    tt = lambda seq: tuple(t(a) for a in seq)
    conv = {}
    if plan.config.blur_impl == "conv":
        _check_conv_plan(plan)
        halves = {k.shape[0] // 2
                  for k in (plan.init_kernel_1d, *plan.kernels_1d)}
        lengths = {n for oc in plan.octaves for n in (oc.height, oc.width)}
        conv = dict(kernels_1d=tt(plan.kernels_1d),
                    init_kernel_1d=t(plan.init_kernel_1d),
                    down_v=tt(plan.down_v), down_h=tt(plan.down_h),
                    pad_index={(n, h): reflect_pad_index(n, h, device)
                               for n in lengths for h in halves})
    return PlanOperators(blur_v=tt(plan.blur_v), blur_h=tt(plan.blur_h),
                         carry_v=tt(plan.carry_v), carry_h=tt(plan.carry_h),
                         init_v=t(plan.init_v), init_h=t(plan.init_h),
                         up_v=t(plan.up_v), up_h=t(plan.up_h), **conv)


def _check_conv_plan(plan: SiftPlan) -> None:
    """The conv pyramid needs the plan's 1-D kernels and per-octave resize
    operators; a plan built from matmul operators alone
    (core/convert.plan_from_numpy without them) has none."""
    cfg = plan.config
    if (plan.init_kernel_1d is None
            or len(plan.kernels_1d) < cfg.num_gauss_layers
            or len(plan.down_v) != cfg.num_octaves
            or len(plan.down_h) != cfg.num_octaves):
        raise ValueError(
            "blur_impl='conv' needs the plan's 1-D kernels (kernels_1d, "
            "init_kernel_1d) and octave resize operators (down_v, down_h); "
            "this plan has only the matmul operators")


def gaussian_pyramid(plan: SiftPlan, image: torch.Tensor,
                     ops: Optional[PlanOperators] = None
                     ) -> List[torch.Tensor]:
    """image: [H, W] float32 (0..255 range).  Returns per-octave stacks
    [L+3, H_o, W_o] on the image's device.  ``ops``: the plan's operators
    already on that device (else moved here)."""
    cfg = plan.config
    if ops is None:
        ops = plan_operators(plan, image.device)
    base = resize_matmul(image, ops.up_v, ops.up_h) if cfg.upscale else image
    if cfg.blur_impl == "conv":
        return _gaussian_pyramid_conv(plan, base, ops)

    # Layer 0 of octave 0: base blur with sigma_diff.
    base = blur_matmul(base, ops.init_v, ops.init_h)
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            base = blur_matmul(base, ops.carry_v[o], ops.carry_h[o])
        octaves.append(blur_matmul(base, ops.blur_v[o], ops.blur_h[o]))
    return octaves


def _gaussian_pyramid_conv(plan: SiftPlan, base: torch.Tensor,
                           ops: PlanOperators) -> List[torch.Tensor]:
    """Sequential conv path, the reference's per-layer chain
    (Detector.cu:292-303): layer i = blur(layer i-1, kernels_1d[i]);
    octave base = resize of the previous octave's layer L."""
    cfg = plan.config
    layer0 = blur_conv(base, ops.init_kernel_1d, ops.pad_index)
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            prev = octaves[o - 1][cfg.num_octave_layers]
            layer0 = resize_matmul(prev, ops.down_v[o], ops.down_h[o])
        layers = [layer0]
        for i in range(1, cfg.num_gauss_layers):
            layers.append(blur_conv(layers[-1], ops.kernels_1d[i],
                                     ops.pad_index))
        octaves.append(torch.stack(layers))
    return octaves


def dog_pyramid(gauss: List[torch.Tensor]) -> List[torch.Tensor]:
    """DoG[i] = gauss[i+1] - gauss[i] per octave."""
    return [g[1:] - g[:-1] for g in gauss]
