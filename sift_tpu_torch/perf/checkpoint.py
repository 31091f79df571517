"""Golden-checkpoint capture — stage-boundary state dumps for replay/verify.

Counterpart of ``sift_tpu/perf/checkpoint.py`` (``capture_golden``,
``load_golden``, ``config_from_params``): the capability of the reference's
serialization sidecar (sift_cuda/perf/*, capture hooks
interface/Detector.cu:145-228) as compressed npz with the same three-file
contract: ``params`` (config), ``input`` (stage inputs for octave 0),
``expected`` (stage outputs for octave 0).  File names and npz keys are the
JAX package's, so either package reads and replays the other's checkpoint.

``save_ba_state`` / ``load_ba_state`` checkpoint a bundle adjustment's
state mid-LM with the JAX package's keys.

Captured stages mirror the seven ``HostInterface::run*`` targets
(interface/HostInterface.hh:11-69): filter, resize, minus, find_peaks,
adjust_pts, orientation_hist, descriptor.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from sift_tpu_torch.config import SIFT_IMG_BORDER, SiftConfig
from sift_tpu_torch.core.types import SiftPlan, build_plan
from sift_tpu_torch.ops import compact as C
from sift_tpu_torch.ops import descriptor as D
from sift_tpu_torch.ops import orientation as O
from sift_tpu_torch.ops.peaks import find_candidates
from sift_tpu_torch.ops.pyramid import dog_pyramid, gaussian_pyramid
from sift_tpu_torch.ops.refine import refine_keypoints
from sift_tpu_torch.pipeline.detector import (full_precision_matmul,
                                              resolve_device)

PARAMS_FILE = "params.npz"
INPUT_FILE = "input.npz"
EXPECTED_FILE = "expected.npz"


def _staged_capture(plan: SiftPlan, img: torch.Tensor) -> Dict:
    """All stage-boundary intermediates for octave 0, on ``img``'s
    device."""
    cfg = plan.config
    op = plan.octaves[0]

    gauss = gaussian_pyramid(plan, img)
    dogs = dog_pyramid(gauss)

    cx, cy, clyr, cval = find_candidates(
        dogs[0], cfg.peak_threshold, SIFT_IMG_BORDER, op.cand_cap)
    ref = refine_keypoints(dogs[0], cx, cy, clyr, cval, 0, cfg)
    idx, val = C.stream_compact(ref.valid, op.kpt_cap)
    idx = idx.to(torch.int64)
    kx, ky = ref.x[idx], ref.y[idx]
    klyr, ksize = ref.layer[idx], ref.size[idx]

    ori_block = gauss[0] if cfg.orientation_source == "gaussian" else dogs[0]
    hist = O.orientation_histograms(ori_block, kx, ky, klyr, ksize, val,
                                    0, cfg)
    angles, peaks = O.orientation_peaks(hist, val, cfg)
    eidx, evalid = C.stream_compact(peaks.reshape(-1), op.kpt_cap)
    eidx = eidx.to(torch.int64)
    src = eidx // angles.shape[1]
    ox, oy, olyr, osize = kx[src], ky[src], klyr[src], ksize[src]
    oang = angles.reshape(-1)[eidx]

    desc, nrm2 = D.compute_descriptors(gauss[0], ox, oy, olyr, osize, oang,
                                       evalid, 0, cfg)
    desc_q = D.quantize_descriptor(desc, nrm2, "opencv")
    desc_q = torch.where(evalid[:, None], desc_q, torch.zeros_like(desc_q))
    return dict(
        gauss0=gauss[0],
        gauss1=gauss[1] if len(gauss) > 1 else torch.zeros(1),
        dog0=dogs[0], cx=cx, cy=cy, clyr=clyr, cval=cval, ref=ref,
        hist=hist, angles=angles, peaks=peaks,
        ox=ox, oy=oy, olyr=olyr, osize=osize, oang=oang, evalid=evalid,
        desc_q=desc_q)


def capture_golden(cfg: SiftConfig, image: np.ndarray, path: str,
                   device=None) -> Dict:
    """Run the pipeline once on ``image``, recording octave-0 inputs and
    outputs of every stage (the capability of Detector::setDataGen + one
    detectAndCompute, Detector.hh:46-51).  Writes params/input/expected npz
    files to ``path``.  ``device=None`` means the GPU (raises without one);
    pass ``device="cpu"`` for the plain versions on the CPU."""
    dev = resolve_device(device)
    full_precision_matmul()
    os.makedirs(path, exist_ok=True)
    plan = build_plan(cfg)
    image = np.asarray(image)
    img = torch.as_tensor(image).to(device=dev, dtype=torch.float32)
    s = _staged_capture(plan, img)
    n = lambda t: t.detach().cpu().numpy()
    ref = s["ref"]
    gauss0, gauss1, dog0 = n(s["gauss0"]), n(s["gauss1"]), n(s["dog0"])
    cx, cy, clyr, cval = n(s["cx"]), n(s["cy"]), n(s["clyr"]), n(s["cval"])
    evalid = n(s["evalid"])

    np.savez_compressed(
        os.path.join(path, PARAMS_FILE),
        width=cfg.width, height=cfg.height,
        num_features=cfg.num_features,
        num_octave_layers=cfg.num_octave_layers,
        contrast_threshold=cfg.contrast_threshold,
        edge_threshold=cfg.edge_threshold, sigma=cfg.sigma,
        upscale=cfg.upscale, kernel_truncate=cfg.kernel_truncate,
        downsample=cfg.downsample,
        orientation_source=cfg.orientation_source,
        subpixel=cfg.subpixel,
        interpolate_orientation=cfg.interpolate_orientation)

    inputs = {
        "image": image.astype(np.float32),
        "init_kernel": plan.init_kernel_1d,
        "kernels": np.concatenate([k for k in plan.kernels_1d]),
        "kernel_sizes": np.array([len(k) for k in plan.kernels_1d]),
        "gauss0": gauss0, "gauss1": gauss1, "dog0": dog0,
        "cand_x": cx, "cand_y": cy, "cand_layer": clyr, "cand_valid": cval,
        "kpt_x": n(s["ox"]), "kpt_y": n(s["oy"]),
        "kpt_layer": n(s["olyr"]), "kpt_size": n(s["osize"]),
        "kpt_angle": n(s["oang"]), "kpt_valid": evalid,
    }
    np.savez_compressed(os.path.join(path, INPUT_FILE), **inputs)

    expected = {
        "gauss0": gauss0,
        "resized1": gauss1[0] if gauss1.ndim == 3 else np.zeros(1),
        "dog0": dog0,
        "cand_x": cx, "cand_y": cy, "cand_layer": clyr, "cand_valid": cval,
        "ref_x": n(ref.x), "ref_y": n(ref.y), "ref_layer": n(ref.layer),
        "ref_xi": n(ref.xi), "ref_size": n(ref.size),
        "ref_response": n(ref.response), "ref_valid": n(ref.valid),
        "hist": n(s["hist"]),
        "angles": n(s["angles"]), "peaks": n(s["peaks"]),
        "descriptor": n(s["desc_q"]),
        "desc_valid": evalid,
    }
    np.savez_compressed(os.path.join(path, EXPECTED_FILE), **expected)
    return {"input": inputs, "expected": expected}


def load_golden(path: str):
    """Load the checkpoint triple (the capability of loadCompressed,
    Serialization.hpp:46-93 + perf.cu:31-36)."""
    # allow_pickle stays False: the params file holds only scalar/str
    # arrays, and checkpoint directories may come from untrusted sources.
    params = dict(np.load(os.path.join(path, PARAMS_FILE),
                          allow_pickle=False))
    inputs = dict(np.load(os.path.join(path, INPUT_FILE)))
    expected = dict(np.load(os.path.join(path, EXPECTED_FILE)))
    return params, inputs, expected


def save_ba_state(path: str, state, iteration: int) -> None:
    """Checkpoint a BAState mid-LM: the JAX package's npz keys
    (``iteration`` + the BAState fields), so either package reads the
    other's file.  Atomic write (tmp + rename), so a worker dying mid-save
    never leaves a torn checkpoint."""
    arrs = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in state._asdict().items()}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, iteration=np.int64(iteration), **arrs)
    os.replace(tmp, path)


def load_ba_state(path: str):
    """Returns (BAState of host (CPU) tensors, iteration) — (None, 0) if
    no checkpoint exists (fresh start)."""
    from sift_tpu_torch.geometry.ba import BAState

    if not os.path.exists(path):
        return None, 0
    d = dict(np.load(path, allow_pickle=False))
    it = int(d.pop("iteration"))
    return BAState(**{k: torch.from_numpy(np.array(d[k]))
                      for k in BAState._fields}), it


def config_from_params(params) -> SiftConfig:
    def val(k):
        v = params[k]
        return v.item() if hasattr(v, "item") else v

    return SiftConfig(
        width=int(val("width")), height=int(val("height")),
        num_features=int(val("num_features")),
        num_octave_layers=int(val("num_octave_layers")),
        contrast_threshold=float(val("contrast_threshold")),
        edge_threshold=float(val("edge_threshold")),
        sigma=float(val("sigma")), upscale=bool(val("upscale")),
        kernel_truncate=float(val("kernel_truncate")),
        downsample=str(val("downsample")),
        orientation_source=str(val("orientation_source")),
        subpixel=bool(val("subpixel")),
        interpolate_orientation=bool(val("interpolate_orientation")))
