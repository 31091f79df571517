"""PyTorch port: capacity tiers (``SiftDetector(tiers=...)``,
``build_detect_fn(kpt_cap=...)``), tests/test_tiers.py's contract on the
port — a tiered result equals the full-capacity one EXACTLY, the saturation
fallback included — the port's tiered frame against the JAX package's, and
``MonocularOdometry(tiers=...)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from conftest import synthetic_image
from sift_tpu_torch.core.convert import result_to_numpy
from test_torch_detector import _hold


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off the cores of the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def detectors(test_image):
    h, w = test_image.shape
    cfg = stt.SiftConfig(width=w, height=h, num_features=1000)
    return (stt.SiftDetector(cfg, device="cpu"),
            stt.SiftDetector(cfg, device="cpu", tiers=(128, 256)),
            test_image)


@pytest.fixture(scope="module")
def full_result(detectors):
    """The full-capacity detector's result on the test image."""
    full, _, img = detectors
    return full.detect_and_compute(img)


def _np_result(res):
    n = int(res.count)
    return n, {f: getattr(res.keypoints, f).numpy()
               for f in res.keypoints._fields}, res.descriptors.numpy()


def test_tier_matches_full(detectors, full_result):
    _, tiered, img = detectors
    # frame 1 runs full (no prior count); frame 2 picks a tier
    r_full = full_result
    tiered.detect_and_compute(img)
    assert tiered._pick_tier() == 256
    r_tier = tiered.detect_and_compute(img)
    n1, k1, d1 = _np_result(r_full)
    n2, k2, d2 = _np_result(r_tier)
    assert n1 == n2 and 100 < n1 < 256
    assert d1.shape == d2.shape  # padded to num_features
    for f in k1:
        assert k1[f].shape == k2[f].shape
        np.testing.assert_array_equal(k1[f][:n1], k2[f][:n1], err_msg=f)
    np.testing.assert_array_equal(d1[:n1], d2[:n1])
    assert not k2["valid"][n1:].any() and not d2[n1:].any()
    assert int(r_tier.raw_count) == int(r_full.raw_count)


def test_tier_selection_logic(detectors):
    _, tiered, _ = detectors
    tiered._last_count = 10
    assert tiered._pick_tier() == 128
    tiered._last_count = 100
    assert tiered._pick_tier() == 256
    tiered._last_count = 200
    assert tiered._pick_tier() is None  # needs full capacity
    tiered._last_count = None
    assert tiered._pick_tier() is None  # first frame -> full


def test_saturation_falls_back_to_full(detectors, full_result,
                                      monkeypatch):
    """A tier too small for the frame must trigger the exact re-run.
    tests/test_tiers.py forces a tier of 16, which _pick_tier never picks
    (it needs at least 64 rows) — so here the tier is 64, and the tiered
    function is seen to run before the full one."""
    full, _, test_image = detectors
    det = stt.SiftDetector(full.config, device="cpu", tiers=(64, 5000))
    assert det.tiers == (64,)                  # tiers >= capacity dropped
    r1 = full_result                           # the full-capacity result
    n_true = int(r1.count)
    assert n_true > 64
    det._last_count = 5                        # force the tiny tier
    assert det._pick_tier() == 64
    calls = []
    for key, fn in [(64, det._tier_fns[64]), ("full", det._fn)]:
        def spy(img, fn=fn, key=key):
            calls.append(key)
            return fn(img)
        if key == "full":
            monkeypatch.setattr(det, "_fn", spy)
        else:
            monkeypatch.setitem(det._tier_fns, 64, spy)
    r2 = det.detect_and_compute(test_image)
    assert calls == [64, "full"]
    assert int(r2.count) == n_true             # fallback produced full set
    assert torch.equal(r2.descriptors, r1.descriptors)
    assert det._last_count == n_true
    assert det.warm_up() is True               # full and every tier


def test_tiered_frame_matches_jax():
    """build_detect_fn(kpt_cap=128) of both packages on one 160x120 frame
    (JAX: its non-fused "xla" path): every keypoint paired, descriptors
    within 1 on >= 99 % of pairs and 2 on all (the JAX flat path reads
    10/14-bit packed gradients; test_torch_detector.py)."""
    img = synthetic_image(height=120, width=160, seed=3, n_blobs=25)
    kw = dict(width=160, height=120, num_features=512)
    jfn = jax.jit(sift_tpu.build_detect_fn(
        sift_tpu.build_plan(sift_tpu.SiftConfig(**kw, gather_impl="xla")),
        kpt_cap=128))
    r = jfn(jnp.asarray(img, jnp.float32))
    a = {f: np.asarray(getattr(r.keypoints, f)) for f in r.keypoints._fields}
    a["descriptors"] = np.asarray(r.descriptors)
    a["count"] = int(r.count)
    tfn = stt.build_detect_fn(stt.build_plan(stt.SiftConfig(**kw)),
                              kpt_cap=128, device="cpu")
    b = result_to_numpy(tfn(torch.from_numpy(img)))
    assert b["descriptors"].shape == (512, 128) == a["descriptors"].shape
    assert 20 < a["count"] < 128
    assert a["count"] == b["count"]
    _hold(a, b, min_count=20)
    from sift_tpu_torch.perf.compare import pair_keypoints
    assert len(pair_keypoints(a, b)[0]) == a["count"]


def test_monocular_odometry_with_tiers():
    """MonocularOdometry(tiers=...) hands the tiers to its detector and
    tracks: two rendered frames, the second picks a tier."""
    from sift_tpu_torch.geometry.odometry import MonocularOdometry
    from sift_tpu_torch.perf.scenes import render_sequence

    frames, _, _ = render_sequence(n_frames=2, width=320, height=240)
    cfg = stt.SiftConfig(width=320, height=240, num_features=2000)
    odo = MonocularOdometry(cfg, fx=288.0, fy=288.0, cx=160.0, cy=120.0,
                            ransac_iters=64, tiers=(512, 1024),
                            device="cpu")
    assert odo.detector.tiers == (512, 1024)
    for f in frames:
        odo.process(f)
    n0 = odo.result.n_matches
    assert len(odo.result.rotations) == 2 and n0[-1] > 20
    assert odo.detector._last_count is not None
    assert odo.detector._pick_tier() in (512, 1024)
