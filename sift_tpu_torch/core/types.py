"""Core data model: fixed-capacity masked keypoint SoA and the static plan.

Counterpart of ``sift_tpu/core/types.py``.  Every keypoint array has a
*static* capacity and a ``valid`` mask; counts live on the device as
``valid.sum()`` and never round-trip to the host mid-pipeline.  The plan is
built on the host in numpy (float64 operator composition) and keeps numpy
arrays; ``SiftDetector`` moves them to its device once.  The TPU tiling
fields of the JAX plan (band-blocked operators for the padded pyramid) have
no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.core import gaussian as g


class Keypoints(NamedTuple):
    """Fixed-capacity SoA keypoint store (cap = leading dim of every field).

      x, y      — coordinates in *original image* space (float32)
      layer     — integer DoG layer index within the octave (int32)
      octave    — octave index (>= 0; -1 is the upscaled base octave)
      xi        — sub-pixel layer offset from refinement
      size      — keypoint diameter in original-image pixels
      response  — |contrast|
      angle     — orientation in degrees, [0, 360)
      valid     — liveness mask (bool)
    """

    x: torch.Tensor
    y: torch.Tensor
    layer: torch.Tensor
    octave: torch.Tensor
    xi: torch.Tensor
    size: torch.Tensor
    response: torch.Tensor
    angle: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1)

    @staticmethod
    def empty(cap: int, device=None) -> "Keypoints":
        zf = torch.zeros((cap,), dtype=torch.float32, device=device)
        zi = torch.zeros((cap,), dtype=torch.int32, device=device)
        return Keypoints(x=zf, y=zf, layer=zi, octave=zi, xi=zf, size=zf,
                         response=zf, angle=zf,
                         valid=torch.zeros((cap,), dtype=torch.bool,
                                           device=device))

    def packed_octave(self) -> torch.Tensor:
        """Reference/OpenCV octave packing (SiftOps.cu:204):
        octave | (layer << 8) | (round((xi + 0.5) * 255) << 16).
        Negative octaves wrap into the low byte (two's complement & 255)."""
        oct_byte = torch.where(self.octave < 0, self.octave + 256,
                               self.octave)
        xi_byte = torch.clamp(torch.round((self.xi + 0.5) * 255.0), 0, 255)
        return (oct_byte.to(torch.int32)
                + (self.layer.to(torch.int32) << 8)
                + (xi_byte.to(torch.int32) << 16))


class SiftResult(NamedTuple):
    """Final per-frame output: keypoints + 128-D descriptors, capacity =
    ``num_features``."""

    keypoints: Keypoints
    descriptors: torch.Tensor  # [num_features, 128] uint8 or float32
    count: torch.Tensor        # scalar int32 (== keypoints.count())
    # Keypoint count before the orientation expansion (after the first
    # global compaction).
    raw_count: Any = 0


@dataclasses.dataclass(frozen=True)
class OctavePlan:
    """Static geometry + capacities for one octave."""

    index: int
    height: int
    width: int
    cand_cap: int   # capacity for raw extrema candidates
    kpt_cap: int    # capacity after refinement / orientation expansion


@dataclasses.dataclass(frozen=True)
class SiftPlan:
    """Everything static the pipeline closes over: octave shapes,
    per-layer blur operators, resize operators, capacities (numpy)."""

    config: SiftConfig
    octaves: Tuple[OctavePlan, ...]
    # Per-octave [L+3, H, H] / [L+3, W, W] composed blur operators mapping the
    # octave *base* (layer 0) to every layer directly (f32).
    blur_v: Tuple[np.ndarray, ...]
    blur_h: Tuple[np.ndarray, ...]
    # Base-image blur operators (initial sigma_diff) for base H/W.
    init_v: np.ndarray
    init_h: np.ndarray
    # Upscale (2x) operators, only when config.upscale.
    up_v: Any
    up_h: Any
    # Per-octave downsample operators: octave o base = Dv @ prev_layer_L @ Dh.T
    down_v: Tuple[np.ndarray, ...]
    down_h: Tuple[np.ndarray, ...]
    # Composed carry operators (resize ∘ blur-to-layer-L): octave o base
    # directly from octave o-1 base — one [h_o, h_{o-1}] matmul per side.
    carry_v: Tuple[np.ndarray, ...]
    carry_h: Tuple[np.ndarray, ...]
    # 1-D kernels kept for a "conv" blur implementation and for golden
    # checkpoints.
    kernels_1d: Tuple[np.ndarray, ...]
    init_kernel_1d: np.ndarray


def _octave_dims(cfg: SiftConfig) -> List[Tuple[int, int]]:
    """Per-octave (H, W).  "bilinear" mode round-halves from the base;
    "nearest" mode floor-halves (OpenCV buildGaussianPyramid: size/2)."""
    dims = []
    h, w = cfg.base_height, cfg.base_width
    for o in range(cfg.num_octaves):
        if o > 0:
            if cfg.downsample == "nearest":
                h, w = h // 2, w // 2
            else:
                h, w = int(round(h / 2.0)), int(round(w / 2.0))
        h, w = max(h, 1), max(w, 1)
        dims.append((h, w))
    return dims


def _candidate_capacity(cfg: SiftConfig, h: int, w: int, layers: int) -> int:
    """Per-octave raw-extrema capacity: real images produce far fewer raw
    extrema than pixels (heavy fractal texture at 752x480 yields 948
    octave-0 extrema; //384 gives ~3x headroom)."""
    if cfg.max_candidates_per_octave is not None:
        cap = cfg.max_candidates_per_octave
    else:
        cap = max(512, min(h * w * layers // 384, 2 * cfg.num_features))
    return int(min(cap, h * w * layers))


def octave_plans(cfg: SiftConfig) -> Tuple[OctavePlan, ...]:
    """Per-octave geometry and capacities alone (no operators)."""
    out = []
    for o, (h, w) in enumerate(_octave_dims(cfg)):
        cand = _candidate_capacity(cfg, h, w, cfg.num_dog_layers - 2)
        kpt = int(min(max(128, cand), cfg.num_features))
        out.append(OctavePlan(index=o, height=h, width=w,
                              cand_cap=cand, kpt_cap=kpt))
    return tuple(out)


def build_plan(cfg: SiftConfig) -> SiftPlan:
    sigmas = g.sigma_schedule(cfg.sigma, cfg.num_octave_layers)
    nL = cfg.num_gauss_layers
    dims = _octave_dims(cfg)

    blur_v, blur_h, down_v, down_h = [], [], [], []
    carry_v, carry_h = [], []
    acc64_v, acc64_h = [], []  # float64 composed blur chains for carry fold
    for o, (h, w) in enumerate(dims):
        # Composed operators: layer i = (B_i ... B_1) @ base.  Products are
        # taken in float64; the result applies the *exact* sequential
        # reflect-101 blur chain as a single matmul per layer.
        vs = np.empty((nL, h, h), np.float32)
        hs = np.empty((nL, w, w), np.float32)
        accv = np.eye(h, dtype=np.float64)
        acch = np.eye(w, dtype=np.float64)
        vs[0], hs[0] = accv.astype(np.float32), acch.astype(np.float32)
        accs_v, accs_h = [accv], [acch]
        for i in range(1, nL):
            k = g.gaussian_kernel_1d(float(sigmas[i]), cfg.kernel_truncate)
            accv = g.blur_operator(h, k, np.float64) @ accv
            acch = g.blur_operator(w, k, np.float64) @ acch
            vs[i], hs[i] = accv.astype(np.float32), acch.astype(np.float32)
            accs_v.append(accv)
            accs_h.append(acch)
        acc64_v.append(accs_v)
        acc64_h.append(accs_h)
        blur_v.append(vs)
        blur_h.append(hs)
        if o > 0:
            ph, pw = dims[o - 1]
            if cfg.downsample == "nearest":
                dv = g.decimation_operator(h, ph)
                dh = g.decimation_operator(w, pw)
            else:
                dv = g.resize_operator(h, ph)
                dh = g.resize_operator(w, pw)
            down_v.append(dv)
            down_h.append(dh)
            # carry: this octave's base from the previous octave's base,
            # folding resize and blur-to-layer-L into one operator per side.
            L = cfg.num_octave_layers
            cv64 = dv.astype(np.float64) @ acc64_v[o - 1][L]
            ch64 = dh.astype(np.float64) @ acc64_h[o - 1][L]
            carry_v.append(cv64.astype(np.float32))
            carry_h.append(ch64.astype(np.float32))
        else:
            down_v.append(np.eye(h, dtype=np.float32))
            down_h.append(np.eye(w, dtype=np.float32))
            carry_v.append(np.eye(h, dtype=np.float32))
            carry_h.append(np.eye(w, dtype=np.float32))

    sd = g.initial_sigma_diff(cfg.sigma, cfg.upscale)
    init_k = g.gaussian_kernel_1d(sd, cfg.kernel_truncate)
    bh, bw = dims[0]
    init_v = g.blur_operator(bh, init_k)
    init_h = g.blur_operator(bw, init_k)
    if cfg.upscale:
        up_v = g.resize_operator(bh, cfg.height)
        up_h = g.resize_operator(bw, cfg.width)
    else:
        up_v = up_h = None

    kernels_1d = tuple(
        g.gaussian_kernel_1d(float(s), cfg.kernel_truncate,
                             np.float32) for s in sigmas)

    return SiftPlan(config=cfg, octaves=octave_plans(cfg),
                    blur_v=tuple(blur_v), blur_h=tuple(blur_h),
                    init_v=init_v, init_h=init_h, up_v=up_v, up_h=up_h,
                    down_v=tuple(down_v), down_h=tuple(down_h),
                    carry_v=tuple(carry_v), carry_h=tuple(carry_h),
                    kernels_1d=kernels_1d,
                    init_kernel_1d=init_k.astype(np.float32))
