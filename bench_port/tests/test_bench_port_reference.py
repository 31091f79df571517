"""The plain reference agrees with the port on the CPU at small sizes:
the exact matcher with ``match_brute_force``, and the plain SIFT
detector, written from the algorithm's definition, with ``SiftDetector``
on its plain path, as far as float32 against float64 allows."""

import numpy as np
import pytest
import torch

from bench_port import inputs
from bench_port import rooflines
from bench_port.reference import PlainSift, match_exact
from bench_port.reference.compare import FIELDS, detector_gaps, pair_keypoints


def _sets(seed, q=300, s=400):
    g = torch.Generator().manual_seed(seed)
    p = {"num_sets": 3, "live_mean": 250, "live_spread": 40,
         "latent_dim": 22, "shared_share": 0.9, "noise": 0.02,
         "pool_size": 400}
    desc, valid = inputs.landmark_sets(max(q, s), p, g, "cpu")
    # Duplicated train rows: ties for the nearest row never match.
    desc[1, 10:20] = desc[1, 0:10]
    return desc, valid


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_exact_matcher_equals_the_ports_matcher(seed):
    from sift_tpu_torch import match_brute_force
    desc, valid = _sets(seed)
    want = match_brute_force(desc[0], desc[1], valid[0], valid[1], 0.8)
    got = match_exact(desc[0], desc[1], valid[0], valid[1], 0.8)
    assert torch.equal(want.to(torch.int64), got)
    assert int((got >= 0).sum()) > 20          # real matches exist
    # One query set against a stack of train sets, as the sequential mix
    # calls it.
    stack = match_brute_force(desc[0], desc[1:], valid[0], valid[1:], 0.8)
    for j in range(2):
        assert torch.equal(stack[j].to(torch.int64),
                           match_exact(desc[0], desc[1 + j], valid[0],
                                       valid[1 + j], 0.8))


def test_the_landmark_sets_keep_the_detectors_contract():
    desc, valid = _sets(4)
    live = valid.sum(1)
    assert bool((valid == (torch.arange(valid.shape[1]) < live[:, None]))
                .all())
    assert not bool(desc[~valid].any())
    assert desc.dtype == torch.uint8


@pytest.fixture(scope="module")
def frame():
    g = inputs.generator(7, "cpu")
    p = {"views": 2, "path_radius": 0.04, "roll_deg": 2.0, "zoom": 0.03,
         "texture_scales": [2, 4, 8, 16], "texture_exponent": 0.4}
    return inputs.rendered_views(96, 128, p, g, "cpu")


SIFT = {"num_features": 200}


def _fields(res):
    return {f: getattr(res.keypoints, f).numpy() for f in FIELDS}


def test_the_plain_detector_agrees_with_the_ports_plain_path(frame):
    from sift_tpu_torch import SiftConfig, SiftDetector
    det = SiftDetector(SiftConfig(width=128, height=96, **SIFT),
                       device="cpu")
    ref = PlainSift(128, 96, SIFT, "cpu")
    for img in frame:
        a, b = det.detect_and_compute(img), ref(img)
        assert len(b.descriptors) > 5
        unpaired, diff = detector_gaps(_fields(a), a.descriptors.numpy(),
                                       b.fields, b.descriptors)
        assert unpaired <= 0.02 and diff <= 1, (unpaired, diff)


def test_the_tf32_control_pairs_almost_nothing(frame):
    ref = PlainSift(128, 96, SIFT, "cpu")
    ctl = PlainSift(128, 96, SIFT, "cpu", precision="tf32")
    for img in frame:
        a, b = ctl(img), ref(img)
        unpaired, _ = detector_gaps(a.fields, a.descriptors, b.fields,
                                    b.descriptors)
        assert unpaired > 0.5


def test_descriptor_windows_count_the_reference_descriptors_pixels(frame):
    """``rooflines.descriptor_rows`` bounds each keypoint's window as the
    plain descriptor does: the same pixels are masked in and fall in the
    rotated grid."""
    ref = PlainSift(128, 96, SIFT, "cpu")
    pyr = ref.pyramid(frame[0])
    kp = ref.orientations(pyr, ref.keypoints(pyr))
    f32 = {k: v.to(torch.float32) for k, v in kp.items()}
    valid = torch.ones(len(kp["x"]), dtype=torch.bool)
    par, rows, n = rooflines.descriptor_rows(
        f32["x"], f32["y"], kp["octave"], f32["size"], f32["angle"], valid,
        ref.shapes)
    nrow, ncol, _ = rooflines.window_work(par, rows, rows, n)
    grid = rooflines.grid_pixels(par, rows, rows, n)
    # The plain descriptor's masks, counted.
    scl = kp["size"] * 0.5 / torch.exp2(kp["octave"].to(torch.float64))
    ori = 360.0 - kp["angle"]
    hw = 3.0 * scl
    hs = torch.as_tensor(ref.shapes, dtype=torch.float64)[kp["octave"]]
    rad = torch.minimum(torch.round(hw * 2 ** 0.5 * 2.5),
                        torch.sqrt((hs ** 2).sum(1)))
    i, j, _, _, inner = ref._window(pyr, kp, int(rad.max()))
    masked = inner & (i.abs() <= rad[:, None]) & (j.abs() <= rad[:, None])
    a = torch.deg2rad(ori)[:, None]
    c, s = torch.cos(a) / hw[:, None], torch.sin(a) / hw[:, None]
    rb, cb = j * s + i * c + 1.5, j * c - i * s + 1.5
    ingrid = masked & (rb > -1) & (rb < 4) & (cb > -1) & (cb < 4)
    assert int((nrow * ncol).sum()) == int(masked.sum())
    assert abs(grid - int(ingrid.sum())) <= 0.001 * int(ingrid.sum())


def _kp(x, y, ang, valid=None):
    n = len(x)
    return {"x": np.asarray(x, np.float32), "y": np.asarray(y, np.float32),
            "octave": np.zeros(n, np.int32), "layer": np.ones(n, np.int32),
            "angle": np.asarray(ang, np.float32),
            "valid": np.ones(n, bool) if valid is None else np.asarray(valid)}


def test_pairing_takes_rows_out_of_order_and_counts_the_rest():
    a = _kp([1, 2, 3, 4], [1, 1, 1, 1], [10, 20, 30, 40])
    b = _kp([2, 1, 3, 9], [1, 1, 1, 1], [20, 10, 30.05, 40])
    ia, ib = pair_keypoints(a, b)
    assert sorted(zip(ia.tolist(), ib.tolist())) == [(0, 1), (1, 0),
                                                     (2, 2)]
    da = np.zeros((4, 128), np.uint8)
    db = da.copy()
    db[2, 5] = 3
    unpaired, diff = detector_gaps(a, da, b, db)
    assert unpaired == pytest.approx(0.25) and diff == 3


def test_keypoints_that_round_to_other_window_centres_do_not_pair():
    a = _kp([10.49998, 20.0], [5.0, 5.0], [10, 10])
    b = _kp([10.50002, 20.0], [5.0, 5.0], [10, 10])
    ia, ib = pair_keypoints(a, b)
    assert ia.tolist() == [1] and ib.tolist() == [1]
