"""PyTorch port vs the JAX package: the host-level orientation and
descriptor functions (ops/orientation.py, ops/descriptor.py) of both
packages on the same keypoints — the port on a single-copy slab with
corner-exact window origins, the JAX package on its own lane-shifted slab
through its Pallas kernels in interpret mode.  (The kernel-level
comparison on identical arrays is tests/test_torch_fused_stages.py, whose
keypoint set this file shares.)
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.ops import descriptor as JD
from sift_tpu.ops import orientation as JO
from sift_tpu_torch.ops import descriptor as TD
from sift_tpu_torch.ops import orientation as TO
from test_torch_fused_stages import (K, _jk, _jslab, _rel, _tk, _tslab,
                                     setup)  # noqa: F401 (fixture)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def histograms(setup):
    """orientation_histograms_fused of both packages on the same
    keypoints, once for the module: (port, JAX) as numpy."""
    s = setup
    k, jk = _tk(s), _jk(s)
    th = TO.orientation_histograms_fused(
        _tslab(s, 1), k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["valid"], s["tcfg"]).numpy()
    jh = np.asarray(JO.orientation_histograms_fused(
        _jslab(s, 4), jk["octave"], jk["x"], jk["y"], jk["layer"],
        jk["size"], jk["valid"], s["jcfg"], interpret=True))
    return th, jh


@pytest.fixture(scope="module")
def descriptors(setup):
    """compute_descriptors_fused of both packages on the same keypoints,
    once for the module: (port descriptors, norms, JAX descriptors,
    norms)."""
    s = setup
    k, jk = _tk(s), _jk(s)
    td, tn = TD.compute_descriptors_fused(
        _tslab(s, 1), k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["angle"], k["valid"], s["tcfg"])
    jd, jn = JD.compute_descriptors_fused(
        _jslab(s, 2), jk["octave"], jk["x"], jk["y"], jk["layer"],
        jk["size"], jk["angle"], jk["valid"], s["jcfg"], interpret=True)
    return td, tn, jd, jn


def test_orientation_host_level_matches_jax(setup, histograms):
    """orientation_histograms_fused of both packages on the same
    keypoints: the port on a single-copy slab with corner-exact origins,
    the JAX package on its own 4-copy slab (interpret mode).  Same limit
    (rel < 1e-4)."""
    s = setup
    th, jh = histograms
    live = s["kp"]["valid"]
    assert np.isfinite(th).all()
    assert _rel(jh, th)[s["inc"] & live].max() < 1e-4


def test_orientation_peaks_match_jax(setup, histograms):
    """orientation_peaks of both packages on identical (the JAX
    package's) histograms."""
    s = setup
    k, jk = _tk(s), _jk(s)
    _, jh = histograms
    live = s["kp"]["valid"]
    ja, jp = JO.orientation_peaks(jnp.asarray(jh), jk["valid"], s["jcfg"])
    ta, tp = TO.orientation_peaks(torch.from_numpy(jh.copy()), k["valid"],
                                  s["tcfg"])
    ja, jp, ta, tp = np.asarray(ja), np.asarray(jp), ta.numpy(), tp.numpy()
    # Peak decisions may differ only where the smoothed histogram is
    # within 1e-4 (relative) of a tie or of the 0.8 threshold.
    sm = np.asarray(JO.smooth_histogram(jnp.asarray(jh)))
    np.testing.assert_allclose(
        TO.smooth_histogram(torch.from_numpy(jh.copy())).numpy(), sm, rtol=1e-6)
    mx = sm.max(1, keepdims=True)
    margin = np.minimum.reduce([
        np.abs(sm - np.roll(sm, 1, 1)), np.abs(sm - np.roll(sm, -1, 1)),
        np.abs(sm - 0.8 * mx)]) / (mx + 1e-12)
    clear = margin > 1e-4
    np.testing.assert_array_equal(tp[clear], jp[clear])
    both = tp & jp
    assert both.sum() >= live.sum()
    d = np.abs(ta - ja)[both]
    assert np.minimum(d, 360.0 - d).max() <= 0.05      # degrees


def test_orientation_peaks_without_interpolation_match_jax(setup,
                                                           histograms):
    """Without interpolation the peaks sit at the bin centres in both
    packages."""
    s = setup
    k, jk = _tk(s), _jk(s)
    _, jh = histograms
    ta2, _ = TO.orientation_peaks(
        torch.from_numpy(jh.copy()), k["valid"],
        dataclasses.replace(s["tcfg"], interpolate_orientation=False))
    ja2, _ = JO.orientation_peaks(
        jnp.asarray(jh), jk["valid"],
        dataclasses.replace(s["jcfg"], interpolate_orientation=False))
    np.testing.assert_allclose(
        ta2.numpy(), np.broadcast_to(np.asarray(ja2), ta2.shape), atol=1e-4)


def test_descriptor_host_level_matches_jax(setup, descriptors):
    """compute_descriptors_fused of both packages on the same keypoints:
    ONE launch over all radii in the port against the JAX package's three
    radius-class launches.  |diff| <= 1 uint8 per radius range, <= 10% of
    entries differing."""
    s = setup
    td, tn, jd, jn = descriptors
    assert tuple(td.shape) == (K, 128) and tuple(tn.shape) == (K, 1)
    qt = TD.quantize_descriptor(td, tn, "opencv").numpy()
    qj = np.asarray(JD.quantize_descriptor(jd, jn, "opencv"))
    assert np.isfinite(qt).all()
    assert qt.min() >= 0 and qt.max() <= 255 and (qt == np.round(qt)).all()
    live = s["kp"]["valid"]
    assert (qt[~live] == 0).all()
    diff = np.abs(qj - qt).max(axis=1)
    for name, m in s["classes"].items():
        assert diff[m & live].max() <= 1.0, name
    assert (np.abs(qj - qt)[s["inc"]] > 0).mean() < 0.1


def test_descriptor_reference_quantisation_matches_jax(setup, descriptors):
    """The "reference" quantisation of the same descriptors: continuous
    0..512 values, same scale, within 1 on in-contract rows."""
    s = setup
    td, tn, jd, jn = descriptors
    rt = TD.quantize_descriptor(td, tn, "reference").numpy()
    rj = np.asarray(JD.quantize_descriptor(jd, jn, "reference"))
    inc = s["inc"] & s["kp"]["valid"]
    assert np.abs(rt - rj)[inc].max() <= 1.0
    assert rt.max() <= 512.0
