"""PyTorch port vs the JAX package: the non-fused ("flat") stages — padded
pyramid, dense gradients, per-keypoint windows, orientation and descriptor
histograms on them, candidate search, the stacked-record Newton walk, and
the detector branch that runs them for large patch radii.

The JAX side takes ``gather_impl="xla"`` (its plain window reference); the
port takes the plain version of its window-copy kernel (CPU tensors).
Keypoints and noise octaves are those of tests/test_torch_fused_stages.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from conftest import synthetic_image
from sift_tpu.ops import descriptor as JD
from sift_tpu.ops import flatpyr as JF
from sift_tpu.ops import orientation as JO
from sift_tpu.ops import peaks as JP
from sift_tpu.ops import refine_dense as JR
from sift_tpu_torch.core.convert import padded_pyramid_from_numpy
from sift_tpu_torch.ops import descriptor as TD
from sift_tpu_torch.ops import flatpyr as TF
from sift_tpu_torch.ops import orientation as TO
from sift_tpu_torch.ops import peaks as TP
from sift_tpu_torch.ops import refine_dense as TR
from sift_tpu_torch.ops.refine import refine_keypoints
from test_torch_detector import _hold, _jax_result, _port_result
from test_torch_fused_stages import _jk, _rel, _tk, setup  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpad(s):
    return JF.pad_pyramid([jnp.asarray(b) for b in s["blocks"]])


def _tpad(s):
    return TF.pad_pyramid([torch.from_numpy(b) for b in s["blocks"]])


def _to_port(jp):
    """The JAX PaddedPyramid's very arrays as the port's PaddedPyramid."""
    return padded_pyramid_from_numpy(np.asarray(jp.values),
                                     np.asarray(jp.height),
                                     np.asarray(jp.width), jp.layers,
                                     jp.copies)


@pytest.mark.parametrize("copies", [1, 4])
def test_padded_pyramid_and_shift_copies_match_jax(setup, copies):
    """Pads and concatenations: exact."""
    jp, tp = _jpad(setup), _tpad(setup)
    if copies > 1:
        jp, tp = JF.shift_copies(jp, copies), TF.shift_copies(tp, copies)
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    np.testing.assert_array_equal(tp.height.numpy(), np.asarray(jp.height))
    np.testing.assert_array_equal(tp.width.numpy(), np.asarray(jp.width))
    assert (tp.layers, tp.copies) == (jp.layers, jp.copies) \
        == (setup["L"], copies)
    octv = setup["kp"]["octave"]
    th, tw = tp.octave_geometry(torch.from_numpy(octv))
    jh, jw = jp.octave_geometry(jnp.asarray(octv))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = _to_port(jp)
    assert back.copies == copies and torch.equal(back.values, tp.values)


def test_dense_gradients_match_jax(setup):
    """Magnitude: rtol 1e-6 (sqrt of a sum of two squares, one rounding of
    difference).  Orientation: atol 1e-4 degrees off the 0/360 seam
    (atan2 implementations differ by an ulp).  Packed words: equal, except
    where that ulp crosses a rounding boundary of the 10/14-bit grid —
    counted, at most 1e-4 of the pixels, and then by ONE orientation or
    magnitude step."""
    jp, tp = _jpad(setup), _tpad(setup)
    jm, jo = JF.dense_gradients_padded(jp)
    tm, to = TF.dense_gradients_padded(tp)
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               rtol=1e-6, atol=1e-6)
    d = np.abs(to.values.numpy() - np.asarray(jo.values))
    assert np.minimum(d, 360.0 - d).max() <= 1e-4
    assert float(to.values.min()) >= 0.0 and float(to.values.max()) <= 360.0

    jq = np.asarray(JF.dense_gradients_packed(jp).values).astype(np.int64)
    tq = TF.dense_gradients_packed(tp).values.numpy().astype(np.int64)
    differ = jq != tq
    assert differ.mean() <= 1e-4, differ.sum()
    dm = np.abs(jq // 16384 - tq // 16384)[differ]
    do = np.abs(jq % 16384 - tq % 16384)[differ]
    do = np.minimum(do, 16384 - do)
    assert (dm <= 1).all() and (do <= 1).all() and ((dm + do) == 1).all()

    # Decoding the same packed words: exact.
    um, uo = TF.unpack_gradients(torch.from_numpy(jq.astype(np.float32)))
    vm, vo = JF.unpack_gradients(jnp.asarray(jq.astype(np.float32)))
    np.testing.assert_array_equal(um.numpy(), np.asarray(vm))
    np.testing.assert_array_equal(uo.numpy(), np.asarray(vo))

    # The per-octave list form computes the same planes at natural shapes.
    mags, oris = TF.dense_gradients([torch.from_numpy(b)
                                     for b in setup["blocks"]])
    jmags, _ = JF.dense_gradients([jnp.asarray(b) for b in setup["blocks"]])
    for o, (m, jmo) in enumerate(zip(mags, jmags)):
        np.testing.assert_allclose(m.numpy(), np.asarray(jmo), rtol=1e-6,
                                   atol=1e-6)
        assert oris[o].shape == m.shape == setup["blocks"][o].shape


@pytest.mark.parametrize("copies", [1, 4])
def test_keypoint_windows_match_jax(setup, copies):
    """The same slab bytes through both packages' window access: windows
    and per-pixel offsets exact (integer origin arithmetic + a copy), in
    the 1-copy / 256-column and the 4-copy / 128-column branch, for the
    pair and the packed form."""
    s = setup
    jm, jo = JF.dense_gradients_padded(_jpad(s))
    jq = JF.dense_gradients_packed(_jpad(s))
    if copies > 1:
        jm, jo, jq = (JF.shift_copies(p, copies) for p in (jm, jo, jq))
    kp = s["kp"]
    inv = 2.0 ** -kp["octave"].astype(np.float64)
    px = np.round(kp["x"] * inv).astype(np.int32)
    py = np.round(kp["y"] * inv).astype(np.int32)
    radius = 38 if copies == 1 else 30
    ja = [jnp.asarray(a) for a in (kp["octave"], kp["layer"], py, px)]
    ta = [torch.from_numpy(a) for a in (kp["octave"], kp["layer"], py, px)]
    want = JF.keypoint_window_pair(jm, jo, *ja, radius, "xla")
    got = TF.keypoint_window_pair(_to_port(jm), _to_port(jo), *ta, radius)
    assert tuple(got[0].shape) == (len(px), TF.window_rows(radius),
                                   256 if copies == 1 else 128)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = JF.keypoint_window_packed(jq, *ja, radius, "xla")
    got = TF.keypoint_window_packed(_to_port(jq), *ta, radius)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("copies", [1, 4])
def test_orientation_histograms_flat_match_jax(setup, copies):
    """orientation_histograms_flat on the SAME gradient slabs: rel < 1e-4
    (the limit of tests/test_fused.py:91; exp and the sum order differ)."""
    s = setup
    jm, jo = JF.dense_gradients_padded(_jpad(s))
    if copies > 1:
        jm, jo = JF.shift_copies(jm, copies), JF.shift_copies(jo, copies)
    k, jk = _tk(s), _jk(s)
    jh = np.asarray(JO.orientation_histograms_flat(
        jm, jo, jk["octave"], jk["x"], jk["y"], jk["layer"], jk["size"],
        jk["valid"], s["jcfg"]))
    th = TO.orientation_histograms_flat(
        _to_port(jm), _to_port(jo), k["octave"], k["x"], k["y"], k["layer"],
        k["size"], k["valid"], s["tcfg"], chunk=20).numpy()   # 3 chunks
    assert th.shape == jh.shape == (len(s["kp"]["x"]), 36)
    assert np.isfinite(th).all()
    assert _rel(jh, th).max() < 1e-4
    assert not th[~s["kp"]["valid"]].any()


@pytest.mark.parametrize("copies", [1, 4])
def test_compute_descriptors_flat_match_jax(setup, copies):
    """compute_descriptors_flat on the SAME packed slab: uint8 after
    quantize |diff| <= 1 (the limit of tests/test_fused.py:111).  With 4
    shifted copies the 128-column window holds radii up to 47, so
    keypoints beyond are left out there."""
    s = setup
    jq = JF.dense_gradients_packed(_jpad(s))
    if copies > 1:
        jq = JF.shift_copies(jq, copies)
    k, jk = _tk(s), _jk(s)
    jd, jn = JD.compute_descriptors_flat(
        jq, jk["octave"], jk["x"], jk["y"], jk["layer"], jk["size"],
        jk["angle"], jk["valid"], s["jcfg"])
    td, tn = TD.compute_descriptors_flat(
        _to_port(jq), k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["angle"], k["valid"], s["tcfg"], chunk=20)
    assert tuple(td.shape) == (len(s["kp"]["x"]), 128)
    ju = np.asarray(JD.quantize_descriptor(jd, jn, "opencv"))
    tu = TD.quantize_descriptor(td, tn, "opencv").numpy()
    live = s["kp"]["valid"]
    assert np.abs(ju - tu)[live].max() <= 1.0
    assert (tu[live].sum(1) > 0).all() and not td[~live].any()


def test_single_octave_stage_wrappers_match_jax(setup):
    """orientation_histograms / compute_descriptors (the replay stages'
    entry points), each package on its OWN gradients of the same block.
    A pixel whose orientation sits within an ulp of a histogram-bin or
    packing boundary may land in the neighbouring bin in one package, so
    the limits hold for all but a counted few rows: rel < 1e-4 for >= 90 %
    of keypoints and < 2e-2 for all; descriptors |diff| <= 1 for >= 90 %
    and <= 2 for all (as the detector tests hold them)."""
    s = setup
    block = s["blocks"][1]
    sel = s["kp"]["octave"] == 1
    kp = {n: v[sel] for n, v in s["kp"].items()}
    j = {n: jnp.asarray(v) for n, v in kp.items()}
    t = {n: torch.from_numpy(v) for n, v in kp.items()}
    jh = np.asarray(JO.orientation_histograms(
        jnp.asarray(block), j["x"], j["y"], j["layer"], j["size"],
        j["valid"], 1, s["jcfg"]))
    th = TO.orientation_histograms(
        torch.from_numpy(block), t["x"], t["y"], t["layer"], t["size"],
        t["valid"], 1, s["tcfg"]).numpy()
    rel = _rel(jh, th)
    assert (rel < 1e-4).mean() >= 0.9 and rel.max() < 2e-2
    jd, jn = JD.compute_descriptors(
        jnp.asarray(block), j["x"], j["y"], j["layer"], j["size"],
        j["angle"], j["valid"], 1, s["jcfg"])
    td, tn = TD.compute_descriptors(
        torch.from_numpy(block), t["x"], t["y"], t["layer"], t["size"],
        t["angle"], t["valid"], 1, s["tcfg"])
    dd = np.abs(np.asarray(JD.quantize_descriptor(jd, jn, "opencv"))
                - TD.quantize_descriptor(td, tn, "opencv").numpy()).max(1)
    assert (dd <= 1).mean() >= 0.9 and dd.max() <= 2


# ---------------------------------------------------------------------------
# Candidates and the stacked-record walk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dogs():
    """DoG stacks of two octaves of a real pyramid: the port's own, of a
    value-noise texture (hundreds of extrema at 160x120)."""
    from sift_tpu_torch.perf.benchimg import bench_image
    img = bench_image(120, 160, seed=5)
    cfg = stt.SiftConfig(width=160, height=120, num_features=300)
    from sift_tpu_torch.ops.pyramid import dog_pyramid, gaussian_pyramid
    g = gaussian_pyramid(stt.build_plan(cfg), torch.from_numpy(img))
    return [d.numpy() for d in dog_pyramid(g)[:2]], cfg


@pytest.mark.parametrize("cap", [40, 4096])
def test_find_candidates_match_jax(dogs, cap):
    """Comparisons only: the valid mask and every valid slot exact, with
    the capacity binding (40) and not binding."""
    (dog, _), cfg = dogs
    j = JP.find_candidates(jnp.asarray(dog), cfg.peak_threshold, 5, cap)
    t = TP.find_candidates(torch.from_numpy(dog), cfg.peak_threshold, 5, cap)
    m = np.asarray(j[3])
    np.testing.assert_array_equal(t[3].numpy(), m)
    assert m.sum() == (40 if cap == 40 else m.sum()) and m.sum() >= 40
    for a, b in zip(j[:3], t[:3]):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy()[m], np.asarray(a)[m])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["one_octave", "all_octaves"])
def test_refine_keypoints_dense_match_jax(dogs, dtype, entry):
    """The stacked-record walk: valid mask exact; x / y / size atol 1e-4 on
    valid rows (the records agree bit for bit on decision bits, the
    offsets to float32 rounding), layer exact; float32 and bfloat16
    records."""
    dl, cfg = dogs
    tcfg = dataclasses.replace(cfg, refine_record_dtype=dtype)
    jcfg = sift_tpu.SiftConfig(width=160, height=120, num_features=300,
                               refine_record_dtype=dtype)
    assert TR.record_dtype(tcfg) == getattr(torch, dtype)
    assert TR.record_dtype(dataclasses.replace(
        tcfg, refine_record_dtype="auto")) == torch.float32
    assert TR.record_dtype(stt.SiftConfig(width=1024, height=1024)) \
        == torch.bfloat16
    cands = [TP.find_candidates(torch.from_numpy(d), cfg.peak_threshold, 5,
                                512) for d in dl]
    jc = [tuple(jnp.asarray(a.numpy()) for a in c) for c in cands]
    if entry == "one_octave":
        jr = JR.refine_keypoints_dense(jnp.asarray(dl[1]), *jc[1], 1, jcfg)
        tr = refine_keypoints(torch.from_numpy(dl[1]), *cands[1], 1, tcfg)
    else:
        jr, joct = JR.refine_keypoints_dense_all(
            [jnp.asarray(d) for d in dl], jc, jcfg)
        tr, toct = TR.refine_keypoints_dense_all(
            [torch.from_numpy(d) for d in dl], cands, tcfg)
        np.testing.assert_array_equal(toct.numpy(), np.asarray(joct))
    m = np.asarray(jr.valid)
    np.testing.assert_array_equal(tr.valid.numpy(), m)             # exact
    assert m.sum() >= 10
    for f in ("x", "y", "size"):
        np.testing.assert_allclose(getattr(tr, f).numpy()[m],
                                   np.asarray(getattr(jr, f))[m], atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(tr.layer.numpy()[m],
                                  np.asarray(jr.layer)[m])
    np.testing.assert_allclose(tr.response.numpy()[m],
                               np.asarray(jr.response)[m], atol=1e-6)


# ---------------------------------------------------------------------------
# The detector's non-fused branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [2.0, 1.97])
def test_detector_flat_branch_matches_jax(sigma):
    """Patch radius 48 (sigma 2.0: unshifted 256-column windows) and 47
    (sigma 1.97: 4 shifted copies) exceed the per-keypoint kernels' window
    contract, so both detectors take the non-fused stages; 320x240, held
    as the other detector tests hold the frame."""
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.kernels import window_gather as WG
    cfg = stt.SiftConfig(width=320, height=240, sigma=sigma)
    assert TD.max_descr_radius(cfg) == (48 if sigma == 2.0 else 47)
    img = synthetic_image()
    plain = WG.plain_calls["gather_windows"]
    fused = dict(FS.plain_calls)
    b = _port_result(img, sigma=sigma)
    # 512 keypoints: 1 orientation chunk x 2 slabs + 1 descriptor chunk
    assert WG.plain_calls["gather_windows"] - plain == 3
    assert FS.plain_calls == fused          # the fused stages did not run
    _hold(_jax_result(img, "xla", sigma=sigma), b, min_count=50)


def test_detector_radius_beyond_the_flat_window_raises():
    with pytest.raises(NotImplementedError):
        stt.SiftDetector(stt.SiftConfig(width=64, height=48, sigma=2.7),
                         device="cpu")
    det = stt.SiftDetector(stt.SiftConfig(width=64, height=48, sigma=2.6,
                                          num_features=64), device="cpu")
    assert det.warm_up() is True
