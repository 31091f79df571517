"""OpenCV-oracle sidecar for golden checkpoints.

Counterpart of ``sift_tpu/perf/oracle.py``.  Golden replay (perf/replay.py)
catches regressions against a recorded run of THIS framework — it can never
catch a parity drift, because expected outputs come from the same code it
re-runs.  This module records the INDEPENDENT oracle the reference itself
gates on (cv2.SIFT, readme.md:5) next to a checkpoint, and verifies a fresh
pipeline run against it with the parity tolerances of
tests/test_pipeline.py.  ``tools/perf.py --oracle`` runs it from a
checkpoint directory alone.  Only ``capture_oracle`` needs OpenCV; the
oracle file is the JAX package's, so either package verifies against it.

``parity_gates`` holds the four gates of ``tests/test_pipeline.py``
(recall, precision, angle/size parity, descriptors) in one place: the
oracle check here, the port's own parity tests and ``chip_smoke.py`` all
call it.  ``load_parity_oracle`` reads the committed three-scene oracle
(``tests/data/cv2_parity_oracle.npz``: each scene's uint8 image and
cv2.SIFT's keypoints and descriptors), so the gates run where there is no
cv2, as on the machine with the card.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ORACLE_FILE = "oracle.npz"


def capture_oracle(cfg, image: np.ndarray, path: str) -> Dict:
    """Record cv2.SIFT keypoints/descriptors for ``image`` (requires
    opencv; config must describe the same image geometry)."""
    import cv2

    img8 = np.asarray(image).astype(np.uint8)
    sift = cv2.SIFT_create(contrastThreshold=cfg.contrast_threshold,
                           edgeThreshold=cfg.edge_threshold,
                           sigma=cfg.sigma)
    kps, desc = sift.detectAndCompute(img8, None)
    out = {
        "x": np.array([k.pt[0] for k in kps], np.float32),
        "y": np.array([k.pt[1] for k in kps], np.float32),
        "angle": np.array([k.angle for k in kps], np.float32),
        "size": np.array([k.size for k in kps], np.float32),
        "descriptors": (np.zeros((0, 128), np.float32)
                        if desc is None else desc.astype(np.float32)),
    }
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, ORACLE_FILE), **out)
    return out


def has_oracle(path: str) -> bool:
    return os.path.exists(os.path.join(path, ORACLE_FILE))


def _match_tables(ours: Dict, oracle: Dict):
    """Our first ``count`` rows and the oracle's, as float arrays, with
    the [ours, oracle] pixel distances."""
    n = int(ours["count"])
    kx = np.asarray(ours["x"])[:n]
    ky = np.asarray(ours["y"])[:n]
    ox = np.asarray(oracle["x"])
    oy = np.asarray(oracle["y"])
    d = np.hypot(kx[:, None] - ox[None, :], ky[:, None] - oy[None, :])
    return n, d


def parity_gates(ours: Dict, oracle: Dict) -> Dict:
    """``tests/test_pipeline.py``'s four gates of a detection against
    cv2.SIFT on the same uint8 frame (``upscale=True``).

    ours: numpy fields ``x y angle size descriptors`` and ``count``
    (core/convert.result_to_numpy); oracle: cv2's ``x y angle size
    descriptors``.  Returns one dict per gate, each with its numbers and
    an ``ok`` flag, and ``ok`` for all of them:
      * ``recall``: cv2 keypoints with none of ours within 0.5 px,
        <= max(2, n_cv // 100), and more than 100 of ours;
      * ``precision``: ours with no cv2 keypoint within 0.5 px,
        <= max(2, n // 20);
      * ``angle_size``: of ours with a cv2 keypoint within 0.5 px, >= 97 %
        have one within 1 degree (the closest in angle) whose size is
        within 5 %;
      * ``descriptor``: max |diff| over the 128 entries for each of ours
        paired (within 0.5 px and 1 degree, the closest) — at least 100
        pairs, p90 <= 2, median <= 1."""
    n, d = _match_tables(ours, oracle)
    ka = np.asarray(ours["angle"])[:n]
    ks = np.asarray(ours["size"])[:n]
    desc = np.asarray(ours["descriptors"])[:n]
    oa = np.asarray(oracle["angle"])
    osz = np.asarray(oracle["size"])
    odesc = np.asarray(oracle["descriptors"]).astype(np.float32)
    n_cv = len(oa)

    missed = n_cv if n == 0 else int((d.min(axis=0) > 0.5).sum())
    spurious = n if n_cv == 0 else int((d.min(axis=1) > 0.5).sum())
    ok_as = total = 0
    errs = []
    for i in range(n):
        da = np.abs(((oa - ka[i]) + 180) % 360 - 180)
        cand = np.nonzero(d[i] < 0.5)[0]
        if len(cand):
            total += 1
            j = cand[np.argmin(da[cand])]
            if da[cand].min() < 1.0 \
                    and abs(osz[j] - ks[i]) < 0.05 * osz[j]:
                ok_as += 1
        cand = np.nonzero((d[i] < 0.5) & (da < 1.0))[0]
        if len(cand):
            j = cand[np.argmin(d[i][cand])]
            errs.append(np.abs(odesc[j] - desc[i]).max())
    errs = np.asarray(errs, np.float32)
    p90 = float(np.percentile(errs, 90)) if len(errs) else float("inf")
    med = float(np.median(errs)) if len(errs) else float("inf")
    out = {
        "recall": {"missed": missed, "oracle_kpts": n_cv, "ours": n,
                   "ok": bool(n > 100 and missed <= max(2, n_cv // 100))},
        "precision": {"spurious": spurious, "ours": n,
                      "ok": bool(spurious <= max(2, n // 20))},
        "angle_size": {"parity": ok_as, "near": total,
                       "ok": bool(ok_as >= 0.97 * total)},
        "descriptor": {"pairs": len(errs), "p90_err": p90,
                       "median_err": med,
                       "ok": bool(len(errs) >= 100 and p90 <= 2.0
                                  and med <= 1.0)},
    }
    out["ok"] = all(g["ok"] for g in out.values())
    return out


PARITY_SCENES = ("discs", "textured", "photo")
PARITY_FIELDS = ("image", "x", "y", "angle", "size", "descriptors")


def load_parity_oracle(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The committed three-scene oracle: per scene its uint8 ``image`` and
    cv2.SIFT's ``x y angle size`` (float32) and ``descriptors`` (uint8),
    plus ``cv2_version`` (a str)."""
    with np.load(path, allow_pickle=False) as z:
        out = {s: {f: z[f"{s}_{f}"] for f in PARITY_FIELDS}
               for s in PARITY_SCENES}
        out["cv2_version"] = str(z["cv2_version"])
    return out


def cv2_sift(img8: np.ndarray, cfg=None) -> Dict[str, np.ndarray]:
    """cv2.SIFT on a uint8 frame with the config's thresholds (default
    contrast 0.04, edge 10, sigma 1.6): keypoint fields as float32 and the
    descriptors as uint8 (cv2 returns them as float32 integers; checked)."""
    import cv2

    ct, et, sg = (0.04, 10.0, 1.6) if cfg is None else \
        (cfg.contrast_threshold, cfg.edge_threshold, cfg.sigma)
    sift = cv2.SIFT_create(contrastThreshold=ct, edgeThreshold=et, sigma=sg)
    kps, desc = sift.detectAndCompute(np.asarray(img8, np.uint8), None)
    desc = np.zeros((0, 128), np.float32) if desc is None else desc
    if not np.array_equal(desc, np.round(desc)) or desc.min(initial=0) < 0 \
            or desc.max(initial=0) > 255:
        raise ValueError("cv2.SIFT descriptors are not integers in 0..255")
    f = lambda get: np.array([get(k) for k in kps], np.float32)
    return {"x": f(lambda k: k.pt[0]), "y": f(lambda k: k.pt[1]),
            "angle": f(lambda k: k.angle), "size": f(lambda k: k.size),
            "descriptors": desc.astype(np.uint8)}


def write_parity_oracle(path: str, images: Dict[str, np.ndarray]) -> Dict:
    """cv2.SIFT on each scene's uint8 frame, saved as the committed oracle
    (``load_parity_oracle``'s layout).  Needs cv2."""
    import cv2

    arrays = {"cv2_version": np.array(cv2.__version__)}
    for scene in PARITY_SCENES:
        img8 = np.asarray(images[scene]).astype(np.uint8)
        arrays[f"{scene}_image"] = img8
        for k, v in cv2_sift(img8).items():
            arrays[f"{scene}_{k}"] = v
    np.savez_compressed(path, **arrays)
    return arrays


def verify_oracle(path: str, device=None) -> Dict:
    """Run the full pipeline from a checkpoint directory's image + params
    and gate keypoints/descriptors against the recorded cv2.SIFT oracle.

    Thresholds (``parity_gates``'s numbers): <= max(2, 1 %) of the
    oracle's keypoints unmatched within 0.5 px, <= max(2, 5 %) of ours
    with no oracle keypoint within 0.5 px, p90 descriptor max-abs error
    <= 2/255 on angle-matched pairs, at least min(50, n/2) pairs.
    Returns per-check dicts with an "ok" flag.  ``device=None`` means the
    GPU; pass ``device="cpu"`` to run on the CPU."""
    from sift_tpu_torch.core.convert import result_to_numpy
    from sift_tpu_torch.perf.checkpoint import (config_from_params,
                                                load_golden)
    from sift_tpu_torch.pipeline.detector import SiftDetector

    params, inputs, _ = load_golden(path)
    orc = dict(np.load(os.path.join(path, ORACLE_FILE),
                       allow_pickle=False))
    cfg = config_from_params(params)
    det = SiftDetector(cfg, device=device)
    res = result_to_numpy(det.detect_and_compute(inputs["image"]))
    n = res["count"]
    gates = parity_gates(res, orc)
    checks = {}
    r = gates["recall"]
    checks["recall"] = {
        "missed": r["missed"], "oracle_kpts": r["oracle_kpts"],
        "ok": r["missed"] <= max(2, r["oracle_kpts"] // 100)}
    checks["precision"] = gates["precision"]
    g = gates["descriptor"]
    checks["descriptor"] = {
        "pairs": g["pairs"], "p90_err": g["p90_err"],
        "ok": bool(g["pairs"] >= min(50, max(1, n // 2))
                   and g["p90_err"] <= 2.0)}
    checks["ok"] = all(c["ok"] for c in checks.values())
    for name, c in checks.items():
        if isinstance(c, dict) and any(
                isinstance(v, float) and np.isnan(v) for v in c.values()):
            raise ValueError(f"NaN in check {name}")
    return checks
