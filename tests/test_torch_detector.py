"""PyTorch port vs the JAX package: the slice as a whole —
``SiftDetector(cfg, device="cpu")`` (plain versions of the kernels) against
``sift_tpu.build_detect_fn`` on the same frames.

Keypoints are paired by identity (octave, layer, |dx|, |dy| <= 1e-3 *
2^octave, same orientation peak; sift_tpu_torch/perf/compare.py) rather
than index for index: the two packages emit the same set, but an
orientation histogram that differs in its last bit may order two peaks of
one point differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from conftest import synthetic_image, textured_image
from sift_tpu_torch.core.convert import result_to_numpy
from sift_tpu_torch.kernels import expand as FE
from sift_tpu_torch.kernels import fused_detect as FD
from sift_tpu_torch.kernels import fused_stages as FS
from sift_tpu_torch.perf.compare import pair_keypoints


def _jax_result(img, gather_impl, **kw):
    h, w = img.shape
    cfg = sift_tpu.SiftConfig(width=w, height=h, num_features=512,
                              gather_impl=gather_impl, **kw)
    fn = jax.jit(sift_tpu.build_detect_fn(sift_tpu.build_plan(cfg)))
    r = fn(jnp.asarray(img, jnp.float32))
    out = {f: np.asarray(getattr(r.keypoints, f))
           for f in r.keypoints._fields}
    out["descriptors"] = np.asarray(r.descriptors)
    out["count"] = int(r.count)
    return out


def _port_result(img, **kw):
    h, w = img.shape
    det = stt.SiftDetector(stt.SiftConfig(width=w, height=h,
                                          num_features=512, **kw),
                           device="cpu")
    res = det.detect_and_compute(img)
    assert res.descriptors.dtype == torch.uint8
    assert tuple(res.descriptors.shape) == (512, 128)
    assert res.keypoints.x.shape == (512,)
    return result_to_numpy(res)


def _hold(a, b, min_count, desc_all=2, desc_most=1):
    """a: JAX result, b: port result, as numpy dicts."""
    na, nb = a["count"], b["count"]
    assert na > min_count and nb > min_count
    assert abs(na - nb) <= 0.01 * max(na, nb)          # counts within 1 %
    ia, ib = pair_keypoints(a, b, pos_tol=1e-3, angle_tol=0.5)
    assert len(ia) >= 0.99 * na and len(ia) >= 0.99 * nb
    assert len(set(ib.tolist())) == len(ib)            # one-to-one
    # On pairs: x/y atol 1e-3 px (same packed records decoded by both),
    # size rtol 2e-4 (pow), angle atol 0.05 degrees mod 360 (parabolic
    # interpolation of histograms that agree to rel 1e-4), response and
    # octave/layer exact-ish.
    np.testing.assert_allclose(b["x"][ib], a["x"][ia], atol=1e-3, rtol=0)
    np.testing.assert_allclose(b["y"][ib], a["y"][ia], atol=1e-3, rtol=0)
    np.testing.assert_allclose(b["size"][ib], a["size"][ia], rtol=2e-4)
    np.testing.assert_allclose(b["response"][ib], a["response"][ia],
                               atol=1e-6)
    np.testing.assert_array_equal(b["octave"][ib], a["octave"][ia])
    np.testing.assert_array_equal(b["layer"][ib], a["layer"][ia])
    da = np.abs(b["angle"][ib] - a["angle"][ia])
    assert np.minimum(da, 360.0 - da).max() <= 0.05
    dd = np.abs(a["descriptors"][ia].astype(np.int32)
                - b["descriptors"][ib].astype(np.int32)).max(axis=1)
    assert (dd <= desc_most).mean() >= 0.99
    assert dd.max() <= desc_all
    # rows past the count are empty in the port as in the JAX package
    assert not b["valid"][nb:].any() and b["valid"][:nb].all()
    assert not b["descriptors"][nb:].any()
    assert (b["descriptors"][:nb].sum(1) > 0).all()


@pytest.mark.parametrize("scene", ["synthetic", "textured"])
def test_detector_matches_jax_flat_path(scene):
    """vs gather_impl="xla" at 320x240.  The JAX flat path reads 10/14-bit
    packed gradients (tests/test_fused.py:106-108) where the port
    recomputes them in full precision, hence descriptors |diff| <= 1 for
    >= 99 % of pairs and <= 2 for all."""
    img = synthetic_image() if scene == "synthetic" else textured_image()
    _hold(_jax_result(img, "xla"), _port_result(img), min_count=100)


def test_detector_upscale_matches_jax():
    """upscale=True at 160x120 (octave -1, halved coordinates)."""
    img = synthetic_image(height=120, width=160, seed=3, n_blobs=25)
    a = _jax_result(img, "xla", upscale=True)
    b = _port_result(img, upscale=True)
    _hold(a, b, min_count=50)
    assert b["octave"][:b["count"]].min() == -1


def test_detector_on_the_jax_plan_and_dog_orientation():
    """The port on the JAX package's own operators (plan_from_numpy), and
    the orientation_source="dog" mode, against the JAX flat path."""
    from sift_tpu_torch.core.convert import plan_from_numpy
    img = synthetic_image(height=120, width=160, seed=4, n_blobs=25)
    jcfg = sift_tpu.SiftConfig(width=160, height=120, num_features=512,
                               gather_impl="xla", orientation_source="dog")
    jplan = sift_tpu.build_plan(jcfg)
    arrays = {n: [np.asarray(x) for x in getattr(jplan, n)]
              for n in ("blur_v", "blur_h", "carry_v", "carry_h")}
    arrays.update(init_v=jplan.init_v, init_h=jplan.init_h,
                  up_v=None, up_h=None)
    plan = plan_from_numpy(dataclasses.asdict(jcfg), arrays)
    det = stt.SiftDetector(plan.config, device="cpu", plan=plan)
    assert det.config.orientation_source == "dog"
    b = result_to_numpy(det.detect_and_compute(img))
    a = _jax_result(img, "xla", orientation_source="dog")
    _hold(a, b, min_count=30)


def test_detector_contract_errors_and_state():
    cfg = stt.SiftConfig(width=64, height=48, num_features=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # device=None means the GPU
            stt.SiftDetector(cfg)
    with pytest.raises(ValueError):             # no silent plain fallback
        stt.SiftDetector(dataclasses.replace(cfg, kernel_impl="cuda"),
                         device="cpu")
    assert stt.SiftDetector(cfg, device="cpu", tiers=(32,)).tiers == (32,)
    for cap in (-1, 65):                        # a tier within the capacity
        with pytest.raises(ValueError):
            stt.build_detect_fn(stt.build_plan(cfg), kpt_cap=cap,
                                device="cpu")
    with pytest.raises(ValueError):             # a plan of another config
        stt.SiftDetector(cfg, device="cpu", plan=stt.build_plan(
            dataclasses.replace(cfg, num_features=32)))
    det = stt.SiftDetector(cfg, device="cpu")
    assert det.warm_up() is True
    with pytest.raises(ValueError):
        det.detect_and_compute(np.zeros((10, 10), np.float32))
    assert det.prev_descriptors is None
    launches = {**FD.launches, **FE.launches, **FS.launches}
    plain = {**FD.plain_calls, **FE.plain_calls, **FS.plain_calls}
    rng = np.random.default_rng(0)
    r1 = det.detect_and_compute(rng.uniform(0, 255, (48, 64)))
    assert det.prev_descriptors is None
    r2 = det.detect_and_compute(rng.uniform(0, 255, (48, 64)))
    assert det.prev_descriptors is r1.descriptors
    assert det.last_result is r2
    # On the CPU every kernel's plain version ran (once per frame for the
    # record field of all octaves), and no CUDA kernel was launched.
    assert {**FD.launches, **FE.launches, **FS.launches} == launches
    now = {**FD.plain_calls, **FE.plain_calls, **FS.plain_calls}
    assert now["detect_records"] - plain["detect_records"] == 2
    assert now["orientation_hist"] - plain["orientation_hist"] == 2
    assert now["descriptor_hist"] - plain["descriptor_hist"] == 2
    assert now["expand_lane_copies"] - plain["expand_lane_copies"] == 2
    # float32 descriptors and the "reference" quantisation
    det_f = stt.SiftDetector(
        dataclasses.replace(cfg, descriptor_dtype="float32"), device="cpu")
    assert det_f.detect_and_compute(
        np.zeros((48, 64))).descriptors.dtype == torch.float32
    det_r = stt.SiftDetector(cfg, quant_mode="reference", device="cpu")
    assert det_r.detect_and_compute(
        np.zeros((48, 64))).descriptors.dtype == torch.float32
