"""PyTorch port vs the JAX package: monocular odometry as a whole slice,
its checkpoints across packages, telemetry, the odometry and reconstruct
CLIs and the image IO they read frames with.

No detector runs here: each package's ``MonocularOdometry.detector`` is
replaced (in the test) by a stub that hands out precomputed frames — a
seeded 3D point set, each point with its own random uint8 descriptor,
projected with 0.3 px noise into the cameras of tests/test_odometry.py's
``render_sequence`` trajectory.  Both packages see the same keypoints.
"""
import contextlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu.geometry.odometry as jodo
from sift_tpu.config import SiftConfig as JConfig
from sift_tpu.core.types import Keypoints as JKeypoints
from sift_tpu.core.types import SiftResult as JResult
from sift_tpu.geometry import pnp as jpnp
from sift_tpu.geometry import posegraph as jpg
from sift_tpu.geometry import twoview as jtv
from sift_tpu.geometry.trajectory import ate_rmse
from sift_tpu_torch.config import SiftConfig as TConfig
from sift_tpu_torch.core import convert
import sift_tpu_torch.geometry.odometry as todo

W, H = 320, 240
FX = 0.9 * W
CAP = 400
N_FRAMES = 8
RANSAC_ITERS = 64
SPLIT = 5          # checkpoint after this many frames


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trajectory_pose(i):
    """render_sequence's camera i (tests/test_odometry.py:43): world->camera
    (r, t) and the camera centre."""
    ang = 0.01 * i
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    center = np.array([-0.22, 0.03, 0.12]) * i
    return r, -r @ center, center


def loop_pose(i, n):
    """tests/test_loop_closure.py's out-and-back camera i of n."""
    u = i if i < n // 2 else (n - 1 - i)
    ang = 0.008 * u
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    center = np.array([-0.22 * u, 0.02 * u, 0.1 * u])
    return r, -r @ center, center


def stub_frames(poses, seed=5, n_pts=360):
    """Per frame, the visible points' keypoint fields (numpy, capacity
    CAP, a per-frame shuffle) and the ground-truth camera centres."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-4, -2.5, 6], [4, 2.5, 16], (n_pts, 3))
    desc = rng.integers(0, 256, (n_pts, 128))
    frames, centers = [], []
    for r, t, center in poses:
        pc = pts @ r.T + t
        z = pc[:, 2]
        u = pc[:, 0] / z * FX + W / 2 + rng.normal(0, 0.3, n_pts)
        v = pc[:, 1] / z * FX + H / 2 + rng.normal(0, 0.3, n_pts)
        ids = np.nonzero((z > 0.5) & (u >= 0) & (u < W) & (v >= 0)
                         & (v < H))[0]
        ids = rng.permutation(ids)[:CAP]
        n = len(ids)
        f = {k: np.zeros(CAP, np.float32) for k in
             ("x", "y", "xi", "size", "response", "angle")}
        f.update(layer=np.zeros(CAP, np.int32), octave=np.zeros(CAP,
                                                                np.int32),
                 valid=np.arange(CAP) < n)
        f["x"][:n], f["y"][:n] = u[ids], v[ids]
        f["size"][:n] = 4.0
        d = np.zeros((CAP, 128), np.uint8)
        d[:n] = np.clip(desc[ids] + rng.integers(-2, 3, (n, 128)), 0, 255)
        f.update(descriptors=d, count=n, raw_count=n)
        frames.append(f)
        centers.append(center)
    return frames, np.stack(centers)


def jax_result(f):
    kp = JKeypoints(**{k: jnp.asarray(f[k]) for k in JKeypoints._fields})
    return JResult(keypoints=kp, descriptors=jnp.asarray(f["descriptors"]),
                   count=jnp.int32(f["count"]),
                   raw_count=jnp.int32(f["raw_count"]))


class StubDetector:
    """``detect_and_compute(i)`` returns frame i's precomputed result."""

    def __init__(self, results):
        self.results = results

    def detect_and_compute(self, i):
        return self.results[i]


def make_odometry(pkg, frames, **kw):
    """A MonocularOdometry of either package, its detector replaced by
    the stub over ``frames``."""
    if pkg == "jax":
        odo = jodo.MonocularOdometry(
            JConfig(width=W, height=H, num_features=CAP), fx=FX, fy=FX,
            cx=W / 2, cy=H / 2, ransac_iters=RANSAC_ITERS, **kw)
        odo.detector = StubDetector([jax_result(f) for f in frames])
    else:
        odo = todo.MonocularOdometry(
            TConfig(width=W, height=H, num_features=CAP), fx=FX, fy=FX,
            cx=W / 2, cy=H / 2, ransac_iters=RANSAC_ITERS, device="cpu",
            **kw)
        odo.detector = StubDetector([convert.sift_result_from_numpy(f)
                                     for f in frames])
    return odo


@contextlib.contextmanager
def jax_geometry_jitted():
    """The JAX odometry's geometry calls under jax.jit, as the JAX
    package's own tests run them (tests/test_twoview.py, test_ba.py): the
    same functions, compiled once per shape instead of op by op.  Only
    the test's view of the module changes."""
    static = dict(
        pnp_gn=(jpnp.pnp_gn, ("iters", "threshold_px", "damping")),
        triangulate=(jtv.triangulate, ()),
        ransac_essential=(jtv.ransac_essential,
                          ("n_hypotheses", "threshold", "sample_size",
                           "refit_iters")))
    with pytest.MonkeyPatch.context() as mp:
        for name, (fn, names) in static.items():
            mp.setattr(jodo, name, jax.jit(fn, static_argnames=names))
        mp.setattr(jpg, "optimize",
                   jax.jit(jpg.optimize, static_argnames=("iterations",
                                                          "damping")))
        yield


@pytest.fixture(scope="module")
def sequence():
    return stub_frames([trajectory_pose(i) for i in range(N_FRAMES)])


@pytest.fixture(scope="module")
def jax_run(sequence, tmp_path_factory):
    """ONE JAX run shared by the tests: frames [0, SPLIT), its checkpoint,
    then the rest of the sequence on the same instance (which equals an
    uninterrupted run, tests/test_odometry.py:286)."""
    frames, _ = sequence
    with jax_geometry_jitted():
        odo = make_odometry("jax", frames)
        for i in range(SPLIT):
            odo.process(i)
        ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "state.npz")
        odo.save_state(ckpt)
        for i in range(SPLIT, N_FRAMES):
            odo.process(i)
    return odo, ckpt


def _run(odo, idx):
    for i in idx:
        odo.process(i)
    return odo


def test_stub_vo_matches_jax(sequence, jax_run):
    """The whole slice on identical keypoints: modes and match counts
    equal, inliers within 2 per frame, trajectories within 1e-3 (ATE
    between the packages), each within 0.15 of the ground truth."""
    frames, gt = sequence
    jo, _ = jax_run
    to = _run(make_odometry("torch", frames), range(N_FRAMES))
    rj, rt = jo.result, to.result
    assert rt.modes == rj.modes
    assert rt.modes[:2] == ["init", "bootstrap"]
    assert all(m == "pnp" for m in rt.modes[2:]), rt.modes
    assert rt.n_matches == rj.n_matches
    assert max(abs(a - b) for a, b in zip(rt.n_inliers, rj.n_inliers)) <= 2
    assert min(rt.n_inliers[1:]) >= 12
    pj, pt = rj.positions(), rt.positions()
    assert ate_rmse(pt, pj, with_scale=True) < 1e-3
    assert ate_rmse(pj, gt, with_scale=True) < 0.15
    assert ate_rmse(pt, gt, with_scale=True) < 0.15
    assert len(to._points) > 50
    for r in rt.rotations:
        assert r.dtype == np.float32


def test_port_checkpoint_resume_bitwise(sequence, tmp_path):
    """Kill the port's tracker mid-sequence, resume a FRESH instance from
    its checkpoint: the continued run (window BA included) equals an
    uninterrupted one bit for bit."""
    frames, _ = sequence
    kw = dict(ba_interval=3, ba_window=4)
    full = _run(make_odometry("torch", frames, **kw), range(N_FRAMES))
    first = _run(make_odometry("torch", frames, **kw), range(SPLIT))
    ckpt = str(tmp_path / "state.npz")
    first.save_state(ckpt)
    resumed = make_odometry("torch", frames, **kw)
    resumed.load_state(ckpt)
    _run(resumed, range(SPLIT, N_FRAMES))
    np.testing.assert_array_equal(np.stack(full.result.rotations),
                                  np.stack(resumed.result.rotations))
    np.testing.assert_array_equal(np.stack(full.result.translations),
                                  np.stack(resumed.result.translations))
    assert full.result.modes == resumed.result.modes
    assert full.result.n_inliers == resumed.result.n_inliers
    np.testing.assert_array_equal(np.stack(full._points),
                                  np.stack(resumed._points))
    # the generator's state is part of the checkpoint
    d = np.load(ckpt)
    assert {"torch_rng_state", "torch_rng_device", "rng_key"} <= set(d)
    a = make_odometry("torch", frames)
    a.load_state(ckpt)
    assert torch.equal(a._gen.get_state(), first._gen.get_state())


def test_jax_checkpoint_resumes_in_the_port(sequence, jax_run):
    """A checkpoint written by the JAX package, loaded by the port: the
    PnP-tracked frames after it continue within 1e-4 of JAX's own
    continuation.  Its PRNG key seeds the port's generator by the rule in
    load_state's docstring."""
    frames, _ = sequence
    jo, ckpt = jax_run
    to = make_odometry("torch", frames)
    to.load_state(ckpt)
    key = np.load(ckpt)["rng_key"]
    g = torch.Generator().manual_seed(todo.seed_from_key_data(key))
    assert torch.equal(to._gen.get_state(), g.get_state())
    assert len(to.result.rotations) == SPLIT
    _run(to, range(SPLIT, N_FRAMES))
    assert to.result.modes == jo.result.modes
    assert to.result.n_matches == jo.result.n_matches
    np.testing.assert_allclose(np.stack(to.result.rotations),
                               np.stack(jo.result.rotations), atol=1e-4)
    np.testing.assert_allclose(np.stack(to.result.translations),
                               np.stack(jo.result.translations), atol=1e-4)
    assert max(abs(a - b) for a, b in zip(to.result.n_inliers,
                                          jo.result.n_inliers)) <= 2


def test_telemetry_stream(sequence, tmp_path):
    """tests/test_odometry.py:260-283's fields, plus the port's stage
    timers."""
    from sift_tpu_torch.perf.telemetry import Telemetry

    frames, _ = sequence
    tel = Telemetry()
    _run(make_odometry("torch", frames, ba_interval=3, ba_window=4,
                       telemetry=tel), range(5))
    ev = [e for e in tel.events if e["kind"] == "frame"]
    assert len(ev) == 4  # frame 0 is init-only
    assert {"mode", "keypoints", "matches", "inliers",
            "landmarks"} <= set(ev[0])
    assert tel.counters["frames"] == 4
    assert any(e["kind"] == "window_ba" for e in tel.events)
    path = tmp_path / "tel.jsonl"
    tel.write_jsonl(str(path))
    rows = [json.loads(line) for line in open(path)]
    assert rows[-1]["kind"] == "summary"
    assert rows[-1]["counters"]["frames"] == 4
    series = rows[-1]["series"]
    assert {"window_ba_s", "detect_s", "match_s", "ransac_s",
            "pnp_s"} <= set(series)
    assert series["detect_s"]["n"] == 5 and series["ransac_s"]["n"] == 1


def test_odometry_entry_point_rules():
    cfg = TConfig(width=W, height=H, num_features=CAP)
    odo = todo.MonocularOdometry(cfg, FX, FX, W / 2, H / 2, tiers=(256,),
                                 device="cpu")
    assert odo.detector.tiers == (256,)      # handed to the detector
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            todo.MonocularOdometry(cfg, FX, FX, W / 2, H / 2)
    assert todo.seed_from_key_data(np.array([1, 2], np.uint32)) \
        == (1 << 32) | 2


def test_sift_result_from_numpy_roundtrip(sequence):
    f = sequence[0][0]
    res = convert.sift_result_from_numpy(f)
    back = convert.result_to_numpy(res)
    for k in ("x", "y", "valid", "descriptors"):
        np.testing.assert_array_equal(back[k], f[k])
    assert back["count"] == f["count"] and res.count.dtype == torch.int32


# ---------------------------------------------------------------------------
# image IO and the CLIs
# ---------------------------------------------------------------------------

def write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P5\n{w} {h}\n255\n".encode())
        fh.write(np.clip(img, 0, 255).astype(np.uint8).tobytes())


def pgm_dir(tmp_path, n, name="seq"):
    d = tmp_path / name
    d.mkdir()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (H, W)).astype(np.float32)
            for _ in range(n)]
    for i, im in enumerate(imgs):
        write_pgm(d / f"frame_{i:04d}.pgm", im)
    return d, imgs


def test_image_directory_io(tmp_path, monkeypatch):
    from sift_tpu_torch.io import image, native

    d, imgs = pgm_dir(tmp_path, 3)
    assert native.available(), native.build_error()
    names, frames = image.load_image_directory(str(d))
    assert names == [f"frame_{i:04d}.pgm" for i in range(3)]
    for a, b in zip(frames, imgs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        image.load_grayscale(str(d / names[1])), imgs[1])
    # A PNG directory goes through cv2 and nothing else: without cv2 it
    # raises the ImportError.
    import cv2
    p = tmp_path / "png"
    p.mkdir()
    cv2.imwrite(str(p / "a.png"), imgs[0].astype(np.uint8))
    np.testing.assert_array_equal(image.load_image_directory(str(p))[1][0],
                                  imgs[0])
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError):
        image.load_image_directory(str(p))
    # ... and a PNM directory without the native library raises too.
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native loader"):
        image.load_image_directory(str(d))


class _CallOrderDetector:
    """A SiftDetector stand-in for the CLIs: the k-th frame it is given
    returns the k-th precomputed result."""

    results = []

    def __init__(self, config, *a, device=None, **kw):
        self.config, self.device = config, device
        self.k = 0

    def detect_and_compute(self, image):
        self.k += 1
        return self.results[self.k - 1]


def test_odometry_cli(sequence, tmp_path, monkeypatch, capsys):
    """tools/odometry.py on a PGM directory, the detector stubbed: TUM
    output round-trips, ATE printed against a TUM ground truth, --device
    cpu; without --device and without a GPU it raises."""
    from sift_tpu_torch.geometry import trajectory as T
    from sift_tpu_torch.tools import odometry as cli

    frames, gt = sequence
    monkeypatch.setattr(_CallOrderDetector, "results",
                        [convert.sift_result_from_numpy(f) for f in frames])
    monkeypatch.setattr(todo, "SiftDetector", _CallOrderDetector)
    d, _ = pgm_dir(tmp_path, N_FRAMES)
    gt_poses = []
    for c in gt:
        m = np.eye(4)
        m[:3, 3] = c
        gt_poses.append(m)
    gt_file, out_file = tmp_path / "gt.tum", tmp_path / "est.tum"
    T.write_tum_trajectory(str(gt_file), np.arange(N_FRAMES, dtype=float),
                           gt_poses)
    tel = tmp_path / "tel.jsonl"
    odo = cli.main([str(d), "--fx", str(FX), "--num-features", str(CAP),
                    "--out", str(out_file), "--gt", str(gt_file),
                    "--telemetry", str(tel), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{N_FRAMES} frames {W}x{H}" in out
    m = re.search(r"ATE \(Sim3-aligned RMSE\): ([0-9.]+)", out)
    assert m, out
    ate = float(m.group(1))
    assert ate < 0.15
    assert "RPE: trans" in out and tel.exists()
    ts, est = T.read_tum_trajectory(str(out_file))
    assert len(est) == N_FRAMES
    np.testing.assert_allclose(
        np.stack([p[:3, 3] for p in est]),
        np.stack([p[:3, 3] for p in odo.result.poses_cam_to_world()]),
        atol=1e-5)
    est_p = np.stack([p[:3, 3] for p in est])
    assert abs(ate_rmse(est_p, gt, with_scale=True) - ate) < 6e-5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([str(d), "--fx", str(FX)])


def test_odometry_cli_seed(sequence, tmp_path, monkeypatch, capsys):
    """``--seed`` seeds the odometry's RANSAC generator (0 by default, as
    the JAX tool draws from key 0); the detector is stubbed."""
    from sift_tpu_torch.tools import odometry as cli

    frames, _ = sequence
    d, _ = pgm_dir(tmp_path, 3)
    monkeypatch.setattr(todo, "SiftDetector", _CallOrderDetector)
    for argv, seed in (([], 0), (["--seed", "7"], 7)):
        monkeypatch.setattr(_CallOrderDetector, "results", [
            convert.sift_result_from_numpy(f) for f in frames[:3]])
        odo = cli.main([str(d), "--fx", str(FX), "--num-features", str(CAP),
                        "--device", "cpu", *argv])
        assert odo._gen.initial_seed() == seed
    capsys.readouterr()


def test_reconstruct_cli(sequence, tmp_path, monkeypatch, capsys):
    """tools/reconstruct.py on three PGM frames, the detector stubbed:
    the BA line tests/test_reconstruct.py parses, and its gates."""
    from sift_tpu_torch.tools import reconstruct as cli

    frames, _ = sequence
    monkeypatch.setattr(_CallOrderDetector, "results",
                        [convert.sift_result_from_numpy(f)
                         for f in frames[:3]])
    monkeypatch.setattr(cli, "SiftDetector", _CallOrderDetector)
    d, _ = pgm_dir(tmp_path, 3)
    files = sorted(str(p) for p in d.iterdir())
    cli.main(files + ["--fx", str(FX), "--num-features", str(CAP),
                      "--ransac-iters", str(RANSAC_ITERS), "--device",
                      "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"mean sq reproj ([0-9.]+) -> ([0-9.]+) px\^2 over "
                  r"(\d+) observations, (\d+) points", out)
    assert m, out
    c0, c1 = float(m.group(1)), float(m.group(2))
    n_obs, n_pts = int(m.group(3)), int(m.group(4))
    assert n_pts > 50 and n_obs >= 2 * n_pts
    assert c1 <= c0 and c1 < 1.0, out
    assert "BA (single device)" in out and "pose 2: |rot|" in out
    # --distributed: BA over 4 CPU shards (tests/test_reconstruct.py:45-49)
    cli.main(files + ["--fx", str(FX), "--num-features", str(CAP),
                      "--ransac-iters", str(RANSAC_ITERS), "--device",
                      "cpu", "--distributed", "--cpu-mesh", "4"])
    out = capsys.readouterr().out
    m = re.search(r"mean sq reproj ([0-9.]+) -> ([0-9.]+) px\^2 over "
                  r"(\d+) observations, (\d+) points", out)
    assert m, out
    c0d, c1d = float(m.group(1)), float(m.group(2))
    assert (c0d, int(m.group(3)), int(m.group(4))) == (c0, n_obs, n_pts)
    assert c1d <= c0d and c1d < 1.0, out
    assert "distributed over 4 devices" in out and "pose 2: |rot|" in out


def test_scenes_render_as_the_jax_tests_do():
    """perf/scenes (no cv2, for the card) draws the JAX tests' odometry
    scenes: the disc sequences pixel for pixel as tests/test_odometry.py
    and tests/test_loop_closure.py draw them with cv2, the same ground
    truth, and the backdrop warp as cv2.warpPerspective."""
    import cv2

    from sift_tpu_torch.perf import scenes
    from tests.test_loop_closure import render_loop_sequence
    from tests.test_odometry import render_sequence

    a, ga, pa = render_sequence(n_frames=3)
    b, gb, pb = scenes.render_sequence(n_frames=3)
    for x, y in zip(a + pa, b + pb):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ga, gb)
    la, lga = render_loop_sequence(n=3)
    lb, lgb = scenes.render_loop_sequence(n=3)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(lga, lgb)

    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    src = np.float32([[0, 0], [96, 0], [96, 64], [0, 64]])
    dst = np.float32([[10, 5], [300, 20], [280, 230], [20, 200]])
    m = cv2.getPerspectiveTransform(src, dst)
    np.testing.assert_allclose(scenes._homography(src, dst), m, atol=1e-6)
    want = cv2.warpPerspective(tex, m, (W, H), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT_101)
    got = scenes.warp_perspective(tex, m, W, H)
    assert np.abs(got - want).mean() < 0.05
    assert np.percentile(np.abs(got - want), 99) < 1.0


def test_corridor_renders_as_the_jax_test_does():
    """perf/scenes.render_corridor draws tests/test_odometry.py's corridor:
    untextured pixel for pixel, with the same ground truth; the side
    walls' constant-border warp as cv2.warpPerspective with
    BORDER_CONSTANT at -1 (its >= 0 mask, which decides where a wall is
    painted, differs on under 0.5 % of the pixels); and the textured
    corridor within the backdrop warp's limits.  Textured frames are not
    bit-equal: ``bench_image`` differs across the packages (torch
    bicubic, not cv2), and so does the bilinear warp's rounding."""
    import cv2

    from sift_tpu_torch.perf import scenes
    from tests.test_odometry import render_corridor

    a, ga, pa = render_corridor(n_frames=3, textured=False)
    b, gb, pb = scenes.render_corridor(n_frames=3, textured=False)
    for x, y in zip(a + pa, b + pb):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ga, gb)

    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    src = np.float32([[0, 0], [96, 0], [96, 64], [0, 64]])
    for dst in (np.float32([[10, 5], [300, 20], [280, 230], [20, 200]]),
                np.float32([[-40, -30], [250, 20], [360, 260],
                            [-10, 200]])):
        m = cv2.getPerspectiveTransform(src, dst)
        want = cv2.warpPerspective(tex, m, (W, H), flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT,
                                   borderValue=-1.0)
        got = scenes.warp_perspective(tex, m, W, H, border=-1.0)
        assert np.abs(got - want).mean() < 0.05
        assert np.percentile(np.abs(got - want), 99) < 1.0
        assert ((got >= 0) != (want >= 0)).mean() < 0.005

    a, ga, pa = render_corridor(n_frames=3)
    b, gb, pb = scenes.render_corridor(n_frames=3)
    for x, y in zip(a, b):
        assert x.shape == y.shape == (H, W)
        assert np.abs(x - y).mean() < 0.05
        assert np.percentile(np.abs(x - y), 99) < 1.0
    np.testing.assert_array_equal(ga, gb)
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.slow
def test_corridor_through_the_cli(tmp_path, capsys):
    """The 60-frame textured corridor as tests/test_odometry.py's TUM gate
    runs it, through the port's CLI on the CPU: PGM frames through the
    native loader, a TUM ground truth, window BA every 5 frames over 6,
    800 features.  ATE < 0.6 (the JAX test's gate), 60 poses read back,
    the ATE recomputed from the file within the print's round-off."""
    from sift_tpu_torch.geometry import trajectory as T
    from sift_tpu_torch.io import native
    from sift_tpu_torch.perf import scenes
    from sift_tpu_torch.tools import odometry as cli

    if not native.available():
        pytest.fail(f"native loader: {native.build_error()}")
    frames, gt_pos, gt_poses = scenes.render_corridor()
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        scenes.write_pgm(str(seq / f"frame_{i:04d}.pgm"), f)
    gt_file, out_file = tmp_path / "gt.tum", tmp_path / "est.tum"
    T.write_tum_trajectory(str(gt_file), np.arange(60, dtype=float),
                           gt_poses)
    odo = cli.main([str(seq), "--fx", str(FX), "--num-features", "800",
                    "--ba-interval", "5", "--ba-window", "6",
                    "--out", str(out_file), "--gt", str(gt_file),
                    "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"ATE \(Sim3-aligned RMSE\): ([0-9.]+)", out)
    assert m, out
    ate = float(m.group(1))
    assert ate < 0.6, out
    assert odo.result.modes[1] == "bootstrap"
    assert all(md == "pnp" for md in odo.result.modes[2:]), odo.result.modes
    _, est = T.read_tum_trajectory(str(out_file))
    assert len(est) == 60
    est_p = np.stack([p[:3, 3] for p in est])
    assert abs(ate_rmse(est_p, gt_pos, with_scale=True) - ate) < 6e-5
