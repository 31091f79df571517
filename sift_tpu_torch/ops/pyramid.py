"""Gaussian and DoG pyramid construction.

Counterpart of ``sift_tpu/ops/pyramid.py``.  With the blur expressed as
precomputed operators (core/gaussian.py), each octave's layers come from the
octave base via one batched product pair, and each octave base comes from
the previous base via one composed (resize ∘ blur) product pair.

* ``gaussian_pyramid_padded`` — the detector's pyramid, as the JAX
  detector builds it: band-blocked operators (ops/blur.blur_tiled) write
  each octave straight into the padded layout ``[L+3, Hv_o, Wp_o]``
  (core/types.padded_shape: content rows at [HALO, HALO + h_o), columns
  [0, w_o), zeros elsewhere), which the record-field kernel reads in place;
  every other consumer takes ``padded_content_views``.  The band blocks
  cut the arithmetic from O(n^2 w) to O(n * band * w).
* ``gaussian_pyramid`` — natural shapes through the dense operators: the
  golden capture and replay (as in the JAX package, perf/checkpoint.py,
  perf/replay.py).

``blur_impl="conv"`` builds the pyramid sequentially instead, as the
reference does: each layer is the previous one blurred by 1-D convolutions,
each octave base a resize of the previous octave's layer L (padded into the
same layout by ``gaussian_pyramid_padded``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from sift_tpu_torch.core.types import HALO, SiftPlan, padded_shape
from sift_tpu_torch.ops.blur import (TiledOperator, blur_conv, blur_matmul,
                                     blur_tiled, reflect_pad_index,
                                     tiled_operator)
from sift_tpu_torch.ops.resize import resize_matmul


class PlanOperators(NamedTuple):
    """The plan's operators as tensors on one device (moved once): those
    of one pyramid (``plan_operators``)."""

    # The dense pyramid's operators (pyramid="dense", matmul route).
    blur_v: Tuple[torch.Tensor, ...] = ()
    blur_h: Tuple[torch.Tensor, ...] = ()
    carry_v: Tuple[torch.Tensor, ...] = ()
    carry_h: Tuple[torch.Tensor, ...] = ()
    init_v: Optional[torch.Tensor] = None
    init_h: Optional[torch.Tensor] = None
    up_v: Optional[torch.Tensor] = None
    up_h: Optional[torch.Tensor] = None
    # The conv pyramid's 1-D kernels, octave-base resize operators and
    # reflect-101 pad indices by (axis length, kernel half-width) (moved
    # only for blur_impl="conv", so that a frame copies nothing to the
    # device).
    kernels_1d: Tuple[torch.Tensor, ...] = ()
    init_kernel_1d: Optional[torch.Tensor] = None
    down_v: Tuple[torch.Tensor, ...] = ()
    down_h: Tuple[torch.Tensor, ...] = ()
    pad_index: Dict[Tuple[int, int], torch.Tensor] = {}
    # The padded pyramid's band-blocked operators (pyramid="padded",
    # matmul route): per octave, the init blur, per-octave carries (None
    # for octave 0).
    tiled: Tuple[TiledOperator, ...] = ()
    init_tiled: Optional[TiledOperator] = None
    carry_tiled: Tuple[Optional[TiledOperator], ...] = ()


def plan_operators(plan: SiftPlan, device,
                   pyramid: str = "padded") -> PlanOperators:
    """The operators of one pyramid on ``device``: ``"padded"`` the
    detector's (``gaussian_pyramid_padded``), ``"dense"`` the golden
    capture's and replay's (``gaussian_pyramid``).  The conv route needs
    the same ones for both."""
    if pyramid not in ("padded", "dense"):
        raise ValueError(f"pyramid must be 'padded' or 'dense', got "
                         f"{pyramid!r}")
    t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    tt = lambda seq: tuple(t(a) for a in seq)
    out = dict(up_v=t(plan.up_v), up_h=t(plan.up_h))
    if plan.config.blur_impl == "conv":
        _check_conv_plan(plan)
        halves = {k.shape[0] // 2
                  for k in (plan.init_kernel_1d, *plan.kernels_1d)}
        lengths = {n for oc in plan.octaves for n in (oc.height, oc.width)}
        out.update(kernels_1d=tt(plan.kernels_1d),
                   init_kernel_1d=t(plan.init_kernel_1d),
                   down_v=tt(plan.down_v), down_h=tt(plan.down_h),
                   pad_index={(n, h): reflect_pad_index(n, h, device)
                              for n in lengths for h in halves})
    elif pyramid == "dense":
        out.update(blur_v=tt(plan.blur_v), blur_h=tt(plan.blur_h),
                   carry_v=tt(plan.carry_v), carry_h=tt(plan.carry_h),
                   init_v=t(plan.init_v), init_h=t(plan.init_h))
    else:
        tiled = lambda p: None if p is None else tiled_operator(p, device)
        out.update(tiled=tuple(tiled(p) for p in zip(plan.tiled_v,
                                                      plan.tiled_h)),
                   init_tiled=tiled(plan.init_tiled),
                   carry_tiled=tuple(tiled(p) for p in plan.carry_tiled))
    return PlanOperators(**out)


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


def gaussian_pyramid_padded(plan: SiftPlan, image: torch.Tensor,
                            ops: Optional[PlanOperators] = None
                            ) -> List[torch.Tensor]:
    """The detector's pyramid: per-octave ``[L+3, Hv_o, Wp_o]`` stacks in
    the padded layout (core/types.padded_shape; content rows at [HALO,
    HALO + h_o), columns [0, w_o), exact zeros elsewhere).  The octave
    bases come through the band-blocked init and carry operators, the
    layers through the octave's band-blocked blur; each octave is a view
    of one ``[Hv_o, L+3, Wp_o]`` allocation (ops/blur.blur_tiled).
    ``ops``: ``plan_operators(plan, device)`` already on the image's
    device (else moved here).  The conv route builds the natural-shape
    conv pyramid and pads it (contiguous octaves)."""
    cfg = plan.config
    if ops is None:
        ops = plan_operators(plan, image.device)
    base = _init_base(plan, image, ops)
    if cfg.blur_impl == "conv":
        out = []
        for b, op in zip(_gaussian_pyramid_conv(plan, base, ops),
                         plan.octaves):
            hv, wp = padded_shape(op.height, op.width)
            out.append(torch.nn.functional.pad(
                b, (0, wp - op.width, HALO, hv - HALO - op.height)))
        return out

    # Octave bases stay in their padded [rows, columns] form (one layer:
    # contiguous); the next blur reads only their content.
    base = blur_tiled(base, ops.init_tiled)[0]
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            base = blur_tiled(base, ops.carry_tiled[o])[0]
        octaves.append(blur_tiled(base, ops.tiled[o]))
    return octaves


def padded_content_views(plan: SiftPlan,
                         gp: List[torch.Tensor]) -> List[torch.Tensor]:
    """Natural-shape views ``[L+3, h_o, w_o]`` of a padded pyramid (no
    copy: row pitch and layer stride stay the padded ones)."""
    return [g[:, HALO:HALO + op.height, :op.width]
            for g, op in zip(gp, plan.octaves)]


def _init_base(plan: SiftPlan, image: torch.Tensor,
               ops: PlanOperators) -> torch.Tensor:
    """Octave 0's source: the image, upscaled 2x when the config asks."""
    if plan.config.upscale:
        return resize_matmul(image, ops.up_v, ops.up_h)
    return image


def gaussian_pyramid(plan: SiftPlan, image: torch.Tensor,
                     ops: Optional[PlanOperators] = None
                     ) -> List[torch.Tensor]:
    """image: [H, W] float32 (0..255 range).  Returns per-octave stacks
    [L+3, H_o, W_o] on the image's device, through the dense operators.
    ``ops``: ``plan_operators(plan, device, "dense")`` already on that
    device (else moved here)."""
    cfg = plan.config
    if ops is None:
        ops = plan_operators(plan, image.device, "dense")
    base = _init_base(plan, image, ops)
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
