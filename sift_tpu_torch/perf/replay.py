"""Per-stage golden-checkpoint replay + verification.

Counterpart of ``sift_tpu/perf/replay.py``: the capability of the
reference's ``HostInterface`` seven ``run*`` functions
(sift_cuda/interface/HostInterface.{hh,cu}) and ``tool/perf.cu``.  Each
function re-executes exactly one pipeline stage on deserialized inputs and
compares against the golden output — simultaneously a regression test and
an isolated per-stage profiling target.  The checkpoint may have been
captured by either package; the comparison limits are the JAX package's.

Comparison contract mirrors the reference: exact-ish (tiny float tolerance)
for images, exact for candidate indices/masks, tolerance for descriptors
(±1 in the reference's half space, HostInterface.cu:369-376; ±1 of 255
here against the quantized output).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sift_tpu_torch.config import SIFT_IMG_BORDER
from sift_tpu_torch.core.types import build_plan
from sift_tpu_torch.ops import compact as C
from sift_tpu_torch.ops import descriptor as D
from sift_tpu_torch.ops import orientation as O
from sift_tpu_torch.ops.peaks import find_candidates
from sift_tpu_torch.ops.pyramid import gaussian_pyramid, plan_operators
from sift_tpu_torch.ops.refine import refine_keypoints
from sift_tpu_torch.perf.checkpoint import config_from_params
from sift_tpu_torch.pipeline.detector import (full_precision_matmul,
                                              resolve_device)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, atol) -> Tuple[bool, float]:
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        return False, float("inf")
    if a.dtype == bool or b.dtype == bool:
        err = float(np.logical_xor(a, b).sum())
    else:
        err = float(np.abs(a - b).max()) if a.size else 0.0
    return err <= atol, err


class Replayer:
    """Loads a golden checkpoint and exposes one verify function per stage
    (the capability of HostInterface::runFilter/runResize/runMinus/
    runFindPeaks/runAdjustPts/runOrientationHist/runDescriptor).

    ``device=None`` means the GPU (raises without one); pass
    ``device="cpu"`` for the plain versions on the CPU."""

    def __init__(self, params: Dict, inputs: Dict, expected: Dict,
                 device=None):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.cfg = config_from_params(params)
        self.plan = build_plan(self.cfg)
        self._ops = plan_operators(self.plan, self.device)
        self.inp = inputs
        self.exp = expected

    def _t(self, name: str) -> torch.Tensor:
        """Checkpoint input ``name`` as a tensor on the replay device."""
        return torch.as_tensor(np.asarray(self.inp[name]),
                               device=self.device)

    def _pyramid(self):
        return gaussian_pyramid(self.plan,
                                self._t("image").to(torch.float32),
                                self._ops)

    def _refine(self):
        return refine_keypoints(
            self._t("dog0"), self._t("cand_x"), self._t("cand_y"),
            self._t("cand_layer"), self._t("cand_valid"), 0, self.cfg)

    # -- stage 1: base blur + per-octave blur chain (runFilter) --
    def run_filter(self):
        gauss = self._pyramid()
        ok, err = _close(gauss[0], self.exp["gauss0"], 1e-2)
        return ok, {"max_err": err}

    # -- stage 2: octave downsample (runResize) --
    def run_resize(self):
        if len(self.plan.octaves) < 2:
            return True, {"skipped": "single octave"}
        gauss = self._pyramid()
        ok, err = _close(gauss[1][0], self.exp["resized1"], 1e-2)
        return ok, {"max_err": err}

    # -- stage 3: DoG subtraction (runMinus) --
    def run_minus(self):
        g0 = self._t("gauss0")
        dog = g0[1:] - g0[:-1]
        ok, err = _close(dog, self.exp["dog0"], 1e-4)
        return ok, {"max_err": err}

    # -- stage 4: extrema detection (runFindPeaks) --
    def run_find_peaks(self):
        cap = self.plan.octaves[0].cand_cap
        cx, cy, clyr, cval = find_candidates(
            self._t("dog0"), self.cfg.peak_threshold, SIFT_IMG_BORDER, cap)
        ok_v, _ = _close(cval, self.exp["cand_valid"], 0)
        m = _np(cval)
        ok_x, _ = _close(_np(cx)[m], self.exp["cand_x"][m], 0)
        ok_y, _ = _close(_np(cy)[m], self.exp["cand_y"][m], 0)
        ok_l, _ = _close(_np(clyr)[m], self.exp["cand_layer"][m], 0)
        n = int(m.sum())
        return ok_v and ok_x and ok_y and ok_l, {"count": n}

    # -- stage 5: refinement (runAdjustPts) --
    def run_adjust_pts(self):
        ref = self._refine()
        ok_v, _ = _close(ref.valid, self.exp["ref_valid"], 0)
        m = _np(ref.valid)
        ok_x, ex = _close(_np(ref.x)[m], self.exp["ref_x"][m], 1e-3)
        ok_y, ey = _close(_np(ref.y)[m], self.exp["ref_y"][m], 1e-3)
        ok_s, es = _close(_np(ref.size)[m], self.exp["ref_size"][m], 1e-3)
        return ok_v and ok_x and ok_y and ok_s, \
            {"count": int(m.sum()), "max_err": max(ex, ey, es)}

    # -- stage 6: orientation (runOrientationHist) --
    def run_orientation_hist(self):
        block = self._t("gauss0") \
            if self.cfg.orientation_source == "gaussian" else self._t("dog0")
        ref = self._refine()
        idx, val = C.stream_compact(ref.valid, self.plan.octaves[0].kpt_cap)
        idx = idx.to(torch.int64)
        hist = O.orientation_histograms(
            block, ref.x[idx], ref.y[idx], ref.layer[idx], ref.size[idx],
            val, 0, self.cfg)
        angles, peaks = O.orientation_peaks(hist, val, self.cfg)
        ok_h, eh = _close(hist, self.exp["hist"], 1e-2)
        ok_p, _ = _close(peaks, self.exp["peaks"], 0)
        ok_a, ea = _close(_np(angles)[_np(peaks)],
                          self.exp["angles"][self.exp["peaks"]], 1e-3)
        return ok_h and ok_p and ok_a, {"hist_err": eh, "angle_err": ea}

    # -- stage 7: descriptor (runDescriptor) --
    def run_descriptor(self):
        valid = self._t("kpt_valid")
        desc, nrm2 = D.compute_descriptors(
            self._t("gauss0"), self._t("kpt_x"), self._t("kpt_y"),
            self._t("kpt_layer"), self._t("kpt_size"), self._t("kpt_angle"),
            valid, 0, self.cfg)
        q = D.quantize_descriptor(desc, nrm2, "opencv")
        q = torch.where(valid[:, None], q, torch.zeros_like(q))
        # ±1 quantization-step tolerance (HostInterface.cu:369-376).
        ok, err = _close(q, self.exp["descriptor"], 1.0)
        return ok, {"max_err": err}

    ALL = ("filter", "resize", "minus", "find_peaks", "adjust_pts",
           "orientation_hist", "descriptor")

    def run_all(self):
        results = {}
        for name in self.ALL:
            ok, info = getattr(self, f"run_{name}")()
            results[name] = (bool(ok), info)
        return results
