"""Monocular visual odometry: landmark tracking with PnP pose estimation.

Counterpart of ``sift_tpu/geometry/odometry.py``, on the port's detector,
matcher and geometry (standard feature-based VO):

* bootstrap: first pair -> vectorized essential-matrix RANSAC with
  manifold-GN polish (twoview.py), unit-scale triangulation seeds the map;
* tracking: every later frame matches to the previous frame; matches whose
  previous keypoint carries a landmark give 3D-2D pairs -> robust
  Gauss-Newton PnP from the previous pose (pnp.py).  Pose AND metric scale
  come from the map;
* mapping: matches without landmarks are triangulated with the PnP pose
  (depth/reprojection gated) and added to the map;
* optional sliding-window BA over recent frames (ba.py), and optional loop
  closure against old keyframes with a pose-graph correction.

The host loop reads each frame's keypoints to numpy once; the detector adds
no synchronisation of its own.  ``device=None`` means the GPU and raises
without one.  Where the JAX module keeps a PRNG key, this one keeps a
``torch.Generator`` on the device (see ``load_state`` for resuming from a
JAX checkpoint).
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.core.types import Keypoints, SiftResult
from sift_tpu_torch.geometry import se3
from sift_tpu_torch.geometry.ba import BAProblem, lm_optimize
from sift_tpu_torch.geometry.pnp import pnp_gn
from sift_tpu_torch.geometry.twoview import (pixels_to_normalized,
                                             ransac_essential, triangulate)
from sift_tpu_torch.perf import telemetry as _telemetry
from sift_tpu_torch.pipeline.detector import SiftDetector, resolve_device
from sift_tpu_torch.pipeline.matcher import match_brute_force, match_pairs


class OdometryResult:
    def __init__(self):
        self.rotations: List[np.ndarray] = []     # world->camera
        self.translations: List[np.ndarray] = []
        self.n_matches: List[int] = []
        self.n_inliers: List[int] = []            # PnP/essential inliers
        self.modes: List[str] = []                # init/pnp/bootstrap/fallback

    def poses_cam_to_world(self) -> List[np.ndarray]:
        out = []
        for r, t in zip(self.rotations, self.translations):
            m = np.eye(4)
            m[:3, :3] = r.T
            m[:3, 3] = -r.T @ t
            out.append(m)
        return out

    def positions(self) -> np.ndarray:
        return np.stack([-r.T @ t for r, t in
                         zip(self.rotations, self.translations)])


def _res_to_dict(d: dict, prefix: str, res) -> None:
    for name, val in zip(Keypoints._fields, res.keypoints):
        d[f"{prefix}_kp_{name}"] = val.cpu().numpy()
    d[f"{prefix}_descriptors"] = res.descriptors.cpu().numpy()
    d[f"{prefix}_count"] = np.asarray(int(res.count), np.int32)
    d[f"{prefix}_raw_count"] = np.asarray(int(res.raw_count), np.int32)


def _res_from_dict(d: dict, prefix: str, device) -> SiftResult:
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    kps = Keypoints(*[t(d[f"{prefix}_kp_{n}"]) for n in Keypoints._fields])
    return SiftResult(keypoints=kps,
                      descriptors=t(d[f"{prefix}_descriptors"]),
                      count=t(d[f"{prefix}_count"]),
                      raw_count=t(d[f"{prefix}_raw_count"]))


def _xy(res) -> np.ndarray:
    """A frame's keypoint coordinates on the host, [capacity, 2]."""
    return torch.stack([res.keypoints.x, res.keypoints.y],
                       -1).cpu().numpy()


def seed_from_key_data(words) -> int:
    """The generator seed a JAX PRNG key's data (``rng_key``, uint32
    words) stands for: the words read as one big-endian integer, modulo
    2^64."""
    seed = 0
    for w in np.asarray(words, np.uint32).ravel():
        seed = ((seed << 32) | int(w)) % (1 << 64)
    return seed


class MonocularOdometry:
    def __init__(self, config: SiftConfig, fx: float, fy: float,
                 cx: float, cy: float, ratio: float = 0.8,
                 ransac_iters: int = 512,
                 ransac_threshold: Optional[float] = None,
                 min_pnp_points: int = 12, pnp_threshold_px: float = 3.0,
                 max_depth: float = 1e3, min_depth: float = 1e-2,
                 triangulation_err_px: float = 2.0,
                 ba_interval: int = 0, ba_window: int = 5, seed: int = 0,
                 tiers: tuple = (), loop_closure: bool = False,
                 kf_interval: int = 4, loop_min_gap: int = 8,
                 loop_min_matches: int = 25, loop_min_inliers: int = 20,
                 loop_edge_weight: float = 5.0,
                 loop_max_candidates: int = 8, telemetry=None,
                 device=None):
        """``tiers``: the detector's capacity tiers (``SiftDetector``).
        ``device=None`` means the GPU (raises without one); pass
        ``device="cpu"`` for the plain versions on the CPU."""
        self.telemetry = _telemetry.get(telemetry)
        self.device = resolve_device(device)
        self.detector = SiftDetector(config, tiers=tiers, device=self.device)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.ratio = ratio
        self.ransac_iters = ransac_iters
        # Squared Sampson threshold in normalized coords: ~0.75 px.
        self.ransac_threshold = ransac_threshold if ransac_threshold \
            is not None else (0.75 / fx) ** 2
        self.min_pnp_points = min_pnp_points
        self.pnp_threshold_px = pnp_threshold_px
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.triangulation_err_px = triangulation_err_px
        self.ba_interval = ba_interval
        self.ba_window = ba_window
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.result = OdometryResult()
        self._prev = None                 # previous frame's SiftResult
        self._prev_xy = None              # its keypoints on the host
        # landmark map: previous-frame keypoint index -> landmark id
        self._prev_lms: Dict[int, int] = {}
        self._points: List[np.ndarray] = []   # landmark world positions
        self._obs = []                    # (frame, landmark, uv) for BA
        # loop closure
        self.loop_closure = loop_closure
        self.kf_interval = kf_interval
        self.loop_min_gap = loop_min_gap
        self.loop_min_matches = loop_min_matches
        self.loop_min_inliers = loop_min_inliers
        self.loop_edge_weight = loop_edge_weight
        self.loop_max_candidates = loop_max_candidates
        self._keyframes = []      # (fidx, SiftResult, {kpt_idx: landmark})
        # Per-keyframe global descriptor signature (normalized mean
        # descriptor) for the O(1)-per-keyframe loop-closure pre-filter.
        self._kf_sigs: List[np.ndarray] = []
        self.closures: List[tuple] = []   # (kf_fidx, fidx, n_inliers)

    # ------------------------------------------------------------------

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _stage(self, name: str):
        """Timer of one stage into the telemetry series ``<name>_s``, the
        device synchronised at both ends — only when a telemetry sink is
        configured (no synchronisation is added otherwise)."""
        if self.telemetry is _telemetry.get(None):
            return contextlib.nullcontext()
        return self._synced_timer(name)

    @contextlib.contextmanager
    def _synced_timer(self, name: str):
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        with self.telemetry.timer(name):
            yield
            sync()

    def process(self, frame) -> np.ndarray:
        """Returns the 4x4 cam-to-world pose of this frame."""
        with self._stage("detect"):
            res = self.detector.detect_and_compute(frame)
            xy = _xy(res)
        out = self.result
        if self._prev is None:
            out.rotations.append(np.eye(3, dtype=np.float32))
            out.translations.append(np.zeros(3, np.float32))
            out.n_matches.append(0)
            out.n_inliers.append(0)
            out.modes.append("init")
            self._prev, self._prev_xy = res, xy
            return self._pose_mat(-1)

        a, b = self._prev, res
        with self._stage("match"):
            qi, ti = match_pairs(b.descriptors, a.descriptors,
                                 b.keypoints.valid, a.keypoints.valid,
                                 ratio=self.ratio)
        pa = self._prev_xy[ti] if len(qi) else np.zeros((0, 2), np.float32)
        pb = xy[qi] if len(qi) else np.zeros((0, 2), np.float32)

        # 3D-2D pairs through existing landmarks.
        lm_rows = [k for k in range(len(qi))
                   if int(ti[k]) in self._prev_lms]
        fidx = len(out.rotations)

        if len(lm_rows) >= self.min_pnp_points:
            with self._stage("pnp"):
                ok = self._track_pnp(qi, ti, pb, lm_rows, fidx)
            mode = "pnp"
        else:
            ok = False
        if not ok:
            with self._stage("ransac"):
                ok = self._bootstrap(qi, ti, pa, pb, fidx)
            mode = "bootstrap"
        if not ok:
            self._append_fallback()
            out.n_matches.append(len(qi))
            out.n_inliers.append(0)
            out.modes.append("fallback")
            self._prev_lms = {}
        else:
            out.n_matches.append(len(qi))
            out.modes.append(mode)
        self._prev, self._prev_xy = res, xy

        if self.ba_interval and ok and fidx % self.ba_interval == 0 \
                and fidx >= 2:
            self._run_window_ba(fidx)
        if self.loop_closure and ok:
            if fidx % self.kf_interval == 0 and self._prev_lms:
                self._keyframes.append((fidx, res, dict(self._prev_lms)))
                self._kf_sigs.append(self._signature(res))
            with self._stage("loop_closure"):
                self._try_loop_closure(res, xy, fidx)
        self.telemetry.emit(
            "frame", frame=fidx, mode=out.modes[-1],
            keypoints=int(res.count), matches=out.n_matches[-1],
            inliers=out.n_inliers[-1], landmarks=len(self._points),
            keyframes=len(self._keyframes), closures=len(self.closures))
        self.telemetry.count("frames")
        self.telemetry.count("mode_" + out.modes[-1])
        return self._pose_mat(-1)

    # ------------------------------------------------------------------

    def _pnp(self, pts_w, uv):
        """PnP from the last pose on the device; host (r, t, inliers)."""
        out = self.result
        r, t, inl, _ = pnp_gn(
            self._tensor(pts_w), self._tensor(uv),
            torch.ones(len(uv), dtype=torch.bool, device=self.device),
            self.fx, self.fy, self.cx, self.cy,
            self._tensor(out.rotations[-1]),
            self._tensor(out.translations[-1]),
            threshold_px=self.pnp_threshold_px)
        return (r.cpu().numpy().astype(np.float32),
                t.cpu().numpy().astype(np.float32), inl.cpu().numpy())

    def _track_pnp(self, qi, ti, pb, lm_rows, fidx) -> bool:
        out = self.result
        pts_w = np.stack([self._points[self._prev_lms[int(ti[k])]]
                          for k in lm_rows])
        uv = pb[lm_rows]
        r_w, t_w, inl_np = self._pnp(pts_w, uv)
        n_inl = int(inl_np.sum())
        if n_inl < self.min_pnp_points:
            return False
        if not (np.isfinite(r_w).all() and np.isfinite(t_w).all()):
            # Degenerate geometry (e.g. the scene left the view): a NaN
            # pose would poison every subsequent frame through the
            # constant-velocity fallback.
            return False
        out.rotations.append(r_w)
        out.translations.append(t_w)
        out.n_inliers.append(n_inl)

        # carry landmark associations + PnP observations
        new_lms: Dict[int, int] = {}
        for j, k in enumerate(lm_rows):
            if inl_np[j]:
                lm = self._prev_lms[int(ti[k])]
                new_lms[int(qi[k])] = lm
                self._obs.append((fidx, lm, uv[j]))
        self._triangulate_new(qi, ti, pb, fidx, new_lms, set(lm_rows))
        self._prev_lms = new_lms
        return True

    def _to_world(self, r, t, pts_c) -> np.ndarray:
        """Camera-frame points of pose (r, t) in the world, [N, 3]."""
        ri, ti = se3.inverse(self._tensor(r), self._tensor(t))
        return se3.transform(ri, ti, self._tensor(pts_c)).cpu().numpy()

    def _normalized(self, pix) -> torch.Tensor:
        return pixels_to_normalized(self._tensor(pix), self.fx, self.fy,
                                    self.cx, self.cy)

    def _bootstrap(self, qi, ti, pa, pb, fidx) -> bool:
        """Two-view initialization (first pair, or re-init after a track
        loss): essential RANSAC + unit-scale triangulation."""
        out = self.result
        if len(qi) < 16:
            return False
        na, nb = self._normalized(pa), self._normalized(pb)
        tv = ransac_essential(na, nb,
                              torch.ones(len(qi), dtype=torch.bool,
                                         device=self.device),
                              generator=self._gen,
                              n_hypotheses=self.ransac_iters,
                              threshold=self.ransac_threshold)
        n_inl = int(tv.num_inliers)
        if n_inl < self.min_pnp_points:
            return False
        prev_r = out.rotations[-1]
        prev_t = out.translations[-1]
        r_rel = tv.rotation.cpu().numpy()
        t_rel = tv.translation.cpu().numpy()
        r_w = (r_rel @ prev_r).astype(np.float32)
        t_w = (r_rel @ prev_t + t_rel).astype(np.float32)
        if not (np.isfinite(r_w).all() and np.isfinite(t_w).all()):
            return False
        out.rotations.append(r_w)
        out.translations.append(t_w)
        out.n_inliers.append(n_inl)

        # triangulated points are in the previous camera's frame
        pts_c = tv.points3d.cpu().numpy()
        pc2 = pts_c @ r_rel.T + t_rel
        inl = tv.inliers.cpu().numpy() & (pts_c[:, 2] > self.min_depth) \
            & (pts_c[:, 2] < self.max_depth) & (pc2[:, 2] > self.min_depth)
        pts_w = self._to_world(prev_r, prev_t, pts_c)
        new_lms: Dict[int, int] = {}
        for k in np.nonzero(inl)[0]:
            lm = len(self._points)
            self._points.append(pts_w[k].astype(np.float32))
            self._obs.append((fidx - 1, lm, pa[k]))
            self._obs.append((fidx, lm, pb[k]))
            new_lms[int(qi[k])] = lm
        self._prev_lms = new_lms
        return True

    def _triangulate_new(self, qi, ti, pb, fidx, new_lms, used_rows):
        """Triangulate landmark-less matches with the last two poses."""
        out = self.result
        rows = [k for k in range(len(qi)) if k not in used_rows]
        if not rows:
            return
        pa = self._prev_xy[ti[rows]]
        pbn = pb[rows]
        r_a = out.rotations[-2]
        t_a = out.translations[-2]
        r_b = out.rotations[-1]
        t_b = out.translations[-1]
        r_rel = r_b @ r_a.T
        t_rel = t_b - r_rel @ t_a
        na, nb = self._normalized(pa), self._normalized(pbn)
        pts_c = triangulate(self._tensor(r_rel), self._tensor(t_rel),
                            na, nb).cpu().numpy()
        na, nb = na.cpu().numpy(), nb.cpu().numpy()
        z1 = pts_c[:, 2]
        pc2 = pts_c @ r_rel.T + t_rel
        e1 = np.linalg.norm(pts_c[:, :2] / np.maximum(z1[:, None], 1e-9)
                            - na, axis=-1) * self.fx
        e2 = np.linalg.norm(pc2[:, :2] / np.maximum(pc2[:, 2:], 1e-9)
                            - nb, axis=-1) * self.fx
        good = ((z1 > self.min_depth) & (z1 < self.max_depth)
                & (pc2[:, 2] > self.min_depth)
                & (e1 < self.triangulation_err_px)
                & (e2 < self.triangulation_err_px))
        pts_w = self._to_world(r_a, t_a, pts_c)
        for j in np.nonzero(good)[0]:
            k = rows[j]
            lm = len(self._points)
            self._points.append(pts_w[j].astype(np.float32))
            self._obs.append((fidx - 1, lm, pa[j]))
            self._obs.append((fidx, lm, pbn[j]))
            new_lms[int(qi[k])] = lm

    # ------------------------------------------------------------------
    # Checkpoint / resume: a process can die anywhere and a replacement
    # resumes BIT-IDENTICAL tracking from the last checkpoint — pose chain,
    # landmark map, observations, keyframes, match state and the RANSAC
    # generator are all state.  The npz keys are the JAX package's, apart
    # from the random state.

    def _rng_entries(self) -> dict:
        state = self._gen.get_state().numpy().copy()
        words = np.frombuffer(hashlib.sha256(state.tobytes()).digest()[:8],
                              np.uint32).copy()
        return {"torch_rng_state": state,
                "torch_rng_device": np.asarray(self._gen.device.type),
                # A key for readers without this generator (the JAX
                # package, or another device type): a hash of the state.
                "rng_key": words}

    def save_state(self, path: str) -> None:
        """Serialize the full tracking state to one npz file."""
        out = self.result
        d = {
            "rotations": (np.stack(out.rotations).astype(np.float32)
                          if out.rotations else np.zeros((0, 3, 3),
                                                         np.float32)),
            "translations": (np.stack(out.translations).astype(np.float32)
                             if out.translations else np.zeros((0, 3),
                                                               np.float32)),
            "n_matches": np.asarray(out.n_matches, np.int32),
            "n_inliers": np.asarray(out.n_inliers, np.int32),
            "modes": np.asarray(out.modes),
            "points": (np.stack(self._points).astype(np.float32)
                       if self._points else np.zeros((0, 3), np.float32)),
            "obs_frame": np.asarray([f for f, _, _ in self._obs],
                                    np.int32),
            "obs_lm": np.asarray([l for _, l, _ in self._obs], np.int32),
            "obs_uv": (np.stack([uv for _, _, uv in self._obs])
                       .astype(np.float32) if self._obs
                       else np.zeros((0, 2), np.float32)),
            "prev_lms_k": np.asarray(list(self._prev_lms.keys()),
                                     np.int32),
            "prev_lms_v": np.asarray(list(self._prev_lms.values()),
                                     np.int32),
            "closures": np.asarray(self.closures, np.int32).reshape(-1, 3),
            "kf_fidx": np.asarray([f for f, _, _ in self._keyframes],
                                  np.int32),
            "kf_sigs": (np.stack(self._kf_sigs).astype(np.float32)
                        if self._kf_sigs else np.zeros((0, 128),
                                                       np.float32)),
            "has_prev": np.asarray(self._prev is not None),
            **self._rng_entries(),
        }
        if self._prev is not None:
            _res_to_dict(d, "prev", self._prev)
        for i, (_, res, lms) in enumerate(self._keyframes):
            _res_to_dict(d, f"kf{i}", res)
            d[f"kf{i}_lms_k"] = np.asarray(list(lms.keys()), np.int32)
            d[f"kf{i}_lms_v"] = np.asarray(list(lms.values()), np.int32)
        np.savez_compressed(path, **d)

    def load_state(self, path: str) -> None:
        """Restore a ``save_state`` checkpoint of EITHER package;
        subsequent process() calls continue bit-identically to an
        uninterrupted run of this package on the same device type.

        Random state: a checkpoint of this package on the same device type
        restores the generator's state.  Otherwise (a JAX checkpoint, which
        holds only ``rng_key``, or one saved on another device type) the
        generator is seeded with ``seed_from_key_data(rng_key)``: the
        key's uint32 words read as one big-endian integer, modulo 2^64.
        RANSAC draws after such a resume differ from the writer's; frames
        that track by PnP draw nothing."""
        d = dict(np.load(path, allow_pickle=False))
        out = self.result = OdometryResult()
        out.rotations = [r for r in d["rotations"]]
        out.translations = [t for t in d["translations"]]
        out.n_matches = [int(v) for v in d["n_matches"]]
        out.n_inliers = [int(v) for v in d["n_inliers"]]
        out.modes = [str(m) for m in d["modes"]]
        self._points = [p for p in d["points"]]
        self._obs = [(int(f), int(l), uv) for f, l, uv in
                     zip(d["obs_frame"], d["obs_lm"], d["obs_uv"])]
        self._prev_lms = {int(k): int(v) for k, v in
                          zip(d["prev_lms_k"], d["prev_lms_v"])}
        if "torch_rng_state" in d and \
                str(d["torch_rng_device"]) == self._gen.device.type:
            self._gen.set_state(torch.from_numpy(d["torch_rng_state"]))
        else:
            self._gen.manual_seed(seed_from_key_data(d["rng_key"]))
        self.closures = [tuple(int(v) for v in row)
                         for row in d["closures"]]
        self._kf_sigs = [s for s in d["kf_sigs"]]
        self._prev = _res_from_dict(d, "prev", self.device) \
            if bool(d["has_prev"]) else None
        self._prev_xy = _xy(self._prev) if self._prev is not None else None
        self._keyframes = []
        for i, fidx in enumerate(d["kf_fidx"]):
            lms = {int(k): int(v) for k, v in
                   zip(d[f"kf{i}_lms_k"], d[f"kf{i}_lms_v"])}
            self._keyframes.append(
                (int(fidx), _res_from_dict(d, f"kf{i}", self.device), lms))

    def _try_loop_closure(self, res, xy, fidx: int):
        """Relocalization-style closure: match the current frame against
        old keyframes; landmarks seen from the keyframe give METRIC 3D-2D
        pairs -> PnP -> an absolute corrected pose; a high-weight pose-
        graph edge then redistributes the drift over the trajectory."""
        from sift_tpu_torch.geometry.posegraph import PoseGraph, optimize

        out = self.result
        # Candidate pre-filter: rank eligible keyframes by global-signature
        # similarity and run the full matcher on at most
        # ``loop_max_candidates`` of them.
        sig = self._signature(res)
        eligible = [i for i, (kf_fidx, _, _) in enumerate(self._keyframes)
                    if fidx - kf_fidx >= self.loop_min_gap]
        if len(eligible) > self.loop_max_candidates:
            sims = np.array([float(sig @ self._kf_sigs[i])
                             for i in eligible])
            order = np.argsort(-sims)[: self.loop_max_candidates]
            eligible = [eligible[int(j)] for j in order]
        best = None
        if not eligible:
            return
        # ONE matcher call for all candidates, the train axis padded to the
        # static loop_max_candidates (one program shape per run).
        cc = self.loop_max_candidates
        pad = cc - len(eligible)
        kfs = [self._keyframes[i][1] for i in eligible]
        train = torch.stack([k.descriptors for k in kfs]
                            + [torch.zeros_like(res.descriptors)] * pad)
        tval = torch.stack([k.keypoints.valid for k in kfs]
                           + [torch.zeros_like(res.keypoints.valid)] * pad)
        mm = match_brute_force(res.descriptors, train, res.keypoints.valid,
                               tval, ratio=self.ratio).cpu().numpy()
        for c, i in enumerate(eligible):
            kf_fidx, kf_res, kf_lms = self._keyframes[i]
            qi = np.nonzero(mm[c] >= 0)[0]
            ti = mm[c][qi]
            rows = [k for k in range(len(qi)) if int(ti[k]) in kf_lms]
            if len(rows) >= self.loop_min_matches and \
                    (best is None or len(rows) > best[0]):
                best = (len(rows), kf_fidx, kf_lms, qi, ti, rows)
        if best is None:
            return
        _, kf_fidx, kf_lms, qi, ti, rows = best
        pts_w = np.stack([self._points[kf_lms[int(ti[k])]] for k in rows])
        uv = xy[qi[rows]]
        r_c, t_c, inl = self._pnp(pts_w, uv)
        n_inl = int(inl.sum())
        if n_inl < self.loop_min_inliers:
            return
        self.closures.append((kf_fidx, fidx, n_inl))
        self.telemetry.emit("loop_closure", frame=fidx,
                            keyframe=kf_fidx, inliers=n_inl)

        # Pose graph over all frames: sequential odometry edges + the
        # closure edge anchoring the corrected current pose to the
        # keyframe (relative measurement from the PnP result).
        n = len(out.rotations)
        n_edges = n + len(self.closures)
        ei, ej, rrel, trel, wts = [], [], [], [], []
        for i in range(n - 1):
            ri, tsi = out.rotations[i], out.translations[i]
            rj, tsj = out.rotations[i + 1], out.translations[i + 1]
            rr = rj @ ri.T
            ei.append(i)
            ej.append(i + 1)
            rrel.append(rr)
            trel.append(tsj - rr @ tsi)
            wts.append(1.0)
        r_kf = out.rotations[kf_fidx]
        t_kf = out.translations[kf_fidx]
        rr = r_c @ r_kf.T
        ei.append(kf_fidx)
        ej.append(n - 1)
        rrel.append(rr)
        trel.append(t_c - rr @ t_kf)
        wts.append(self.loop_edge_weight)
        pad = n_edges - len(ei)
        g = PoseGraph.empty(n, n_edges, device=self.device)._replace(
            rotations=self._tensor(np.stack(out.rotations)),
            translations=self._tensor(np.stack(out.translations)),
            pose_valid=torch.ones((n,), dtype=torch.bool,
                                  device=self.device),
            edge_i=self._tensor(ei + [0] * pad, torch.int32),
            edge_j=self._tensor(ej + [0] * pad, torch.int32),
            rel_rot=self._tensor(np.stack(
                rrel + [np.eye(3, dtype=np.float32)] * pad)),
            rel_t=self._tensor(np.stack(
                trel + [np.zeros(3, np.float32)] * pad)),
            edge_weight=self._tensor(wts + [0.0] * pad))
        opt = optimize(g, iterations=15)
        rot = opt.rotations.cpu().numpy().astype(np.float32)
        tr = opt.translations.cpu().numpy().astype(np.float32)
        for i in range(n):
            out.rotations[i] = rot[i]
            out.translations[i] = tr[i]

    def _append_fallback(self):
        """Constant-velocity fallback when tracking fails."""
        out = self.result
        if len(out.rotations) >= 2:
            r_prev2 = out.rotations[-2]
            t_prev2 = out.translations[-2]
            r_rel = out.rotations[-1] @ r_prev2.T
            t_rel = out.translations[-1] - r_rel @ t_prev2
        else:
            r_rel, t_rel = np.eye(3, dtype=np.float32), np.zeros(3)
        out.rotations.append(
            (r_rel @ out.rotations[-1]).astype(np.float32))
        out.translations.append(
            (r_rel @ out.translations[-1] + t_rel).astype(np.float32))

    def _run_window_ba(self, fidx: int):
        from collections import Counter

        lo = max(0, fidx - self.ba_window + 1)
        frames = list(range(lo, fidx + 1))
        fmap = {f: i for i, f in enumerate(frames)}
        obs = [(f, lm, uv) for (f, lm, uv) in self._obs if f in fmap]
        cnt = Counter(lm for _, lm, _ in obs)
        lms = sorted(lm for lm in cnt if cnt[lm] >= 2)
        if len(lms) < 8 or len(obs) < 24:
            return
        lmap = {lm: i for i, lm in enumerate(lms)}
        obs = [(f, lm, uv) for (f, lm, uv) in obs if lm in lmap]

        out = self.result
        prob = BAProblem(
            rotations=self._tensor(np.stack(
                [out.rotations[f] for f in frames])),
            translations=self._tensor(np.stack(
                [out.translations[f] for f in frames])),
            points=self._tensor(np.stack([self._points[lm] for lm in lms])),
            cam_idx=self._tensor([fmap[f] for f, _, _ in obs], torch.int64),
            pt_idx=self._tensor([lmap[lm] for _, lm, _ in obs],
                                torch.int64),
            uv=self._tensor(np.stack([uv for _, _, uv in obs])),
            valid=torch.ones(len(obs), dtype=torch.bool,
                             device=self.device),
            fx=float(self.fx), fy=float(self.fy), cx=float(self.cx),
            cy=float(self.cy))
        with self._stage("window_ba"):
            ba = lm_optimize(prob, iterations=6)
            rot = ba.rotations.cpu().numpy()
            tr = ba.translations.cpu().numpy()
            pts = ba.points.cpu().numpy()
        self.telemetry.emit("window_ba", frame=fidx, cams=len(frames),
                            points=len(lms), obs=len(obs),
                            cost=float(ba.cost))
        if not (np.isfinite(rot).all() and np.isfinite(tr).all()
                and np.isfinite(pts).all()):
            return  # diverged LM: keep the tracked poses
        for f in frames:
            i = fmap[f]
            out.rotations[f] = rot[i]
            out.translations[f] = tr[i]
        for lm in lms:
            self._points[lm] = pts[lmap[lm]]

    @staticmethod
    def _signature(res) -> np.ndarray:
        """Global frame signature: L2-normalized mean of valid
        descriptors.  Cosine similarity between signatures is the
        loop-closure candidate pre-filter (cheap proxy for match count)."""
        d = res.descriptors.cpu().numpy().astype(np.float32)
        v = res.keypoints.valid.cpu().numpy()
        m = d[v].mean(axis=0) if v.any() else np.zeros(d.shape[1], np.float32)
        n = np.linalg.norm(m)
        return m / n if n > 0 else m

    def _pose_mat(self, idx: int) -> np.ndarray:
        r = self.result.rotations[idx]
        t = self.result.translations[idx]
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ t
        return m
