"""PyTorch port vs OpenCV: ``tests/test_pipeline.py``'s parity gates on the
port's detector (``SiftDetector(device="cpu")``, the plain versions of the
kernels), and the committed cv2 oracle those gates also run from on the
card (``chip_smoke.py``, phase ``cv2_parity``).

The oracle, ``tests/data/cv2_parity_oracle.npz``, holds the three parity
scenes as uint8 frames (the discs and the textured plane of
``tests/conftest.py``, the photograph ``tests/data/real_photo.png``) with
cv2.SIFT's keypoints and descriptors on each.  Regenerate it, on a machine
with cv2, with

    JAX_PLATFORMS=cpu python tests/test_torch_pipeline.py

``test_committed_oracle_is_current`` fails when it no longer matches a
fresh cv2 run.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]   # also when run as a script

import sift_tpu_torch as stt  # noqa: E402
from sift_tpu_torch.core.convert import result_to_numpy  # noqa: E402
from sift_tpu_torch.perf import oracle as TOR  # noqa: E402

ORACLE_PATH = os.path.join(HERE, "data", "cv2_parity_oracle.npz")
GATES = ("recall", "precision", "angle_size", "descriptor")


def scene_images():
    """The three parity scenes of tests/test_pipeline.py as uint8 frames
    (both sides of its gates see the frame truncated to uint8)."""
    import cv2

    from conftest import synthetic_image, textured_image
    photo = cv2.imread(os.path.join(HERE, "data", "real_photo.png"),
                       cv2.IMREAD_GRAYSCALE)
    return {"discs": synthetic_image().astype(np.uint8),
            "textured": textured_image().astype(np.uint8),
            "photo": photo.astype(np.float32).astype(np.uint8)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off the cores of the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle():
    return TOR.load_parity_oracle(ORACLE_PATH)


@pytest.fixture(scope="module")
def gates(oracle):
    """Each scene through the port at the parity config (upscale=True,
    num_features=2000), gated against the committed oracle."""
    out = {}
    for scene in TOR.PARITY_SCENES:
        img = oracle[scene]["image"]
        h, w = img.shape
        det = stt.SiftDetector(stt.SiftConfig(width=w, height=h,
                                              num_features=2000,
                                              upscale=True), device="cpu")
        res = result_to_numpy(det.detect_and_compute(img.astype(np.float32)))
        out[scene] = TOR.parity_gates(res, oracle[scene])
    return out


@pytest.mark.parametrize("scene", TOR.PARITY_SCENES)
@pytest.mark.parametrize("gate", GATES)
def test_parity_gate(gates, scene, gate):
    """recall: missed <= max(2, n_cv // 100) and n > 100; precision:
    spurious <= max(2, n // 20); angle_size: >= 97 %; descriptor: >= 100
    pairs, p90 <= 2, median <= 1 (tests/test_pipeline.py:59-124)."""
    assert gates[scene][gate]["ok"], (scene, gates[scene][gate])


def _sorted(fields):
    order = np.lexsort((fields["size"], fields["angle"], fields["y"],
                        fields["x"]))
    return {k: np.asarray(v)[order] for k, v in fields.items()}


@pytest.mark.parametrize("scene", TOR.PARITY_SCENES)
def test_committed_oracle_is_current(oracle, scene):
    """The committed frames equal the scenes as the JAX tests draw them,
    and cv2.SIFT on them gives the committed keypoints and descriptors
    (the same set; cv2's order is compared after a sort)."""
    img = scene_images()[scene]
    np.testing.assert_array_equal(oracle[scene]["image"], img)
    assert oracle[scene]["descriptors"].dtype == np.uint8
    fresh = _sorted(TOR.cv2_sift(img))
    want = _sorted({k: oracle[scene][k] for k in fresh})
    assert len(fresh["x"]) == len(want["x"])
    for k in ("x", "y", "angle", "size"):
        np.testing.assert_allclose(fresh[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(fresh["descriptors"], want["descriptors"])


@pytest.fixture(scope="module")
def small_detector(test_image):
    h, w = test_image.shape
    cfg = stt.SiftConfig(width=w, height=h, num_features=500, upscale=False)
    return stt.SiftDetector(cfg, device="cpu")


def test_no_upscale_mode(small_detector, test_image):
    """The reference's default config (upscale=false) runs and finds
    keypoints; rows past the count are invalid."""
    res = small_detector.detect_and_compute(test_image)
    n = int(res.count)
    assert 10 < n <= 500
    assert res.keypoints.valid[:n].all()
    assert not res.keypoints.valid[n:].any()


def test_prev_descriptor_rotation(small_detector, test_image):
    """prev_descriptors carries frame t-1 (Detector.cu:136-141)."""
    r1 = small_detector.detect_and_compute(test_image)
    r2 = small_detector.detect_and_compute(test_image[::-1].copy())
    assert small_detector.prev_descriptors is not None
    assert torch.equal(small_detector.prev_descriptors, r1.descriptors)
    assert torch.equal(small_detector.last_result.descriptors,
                       r2.descriptors)


def test_wrong_shape_raises(small_detector):
    with pytest.raises(ValueError):
        small_detector.detect_and_compute(np.zeros((10, 10), np.float32))


if __name__ == "__main__":
    arrays = TOR.write_parity_oracle(ORACLE_PATH, scene_images())
    print(f"{ORACLE_PATH}: cv2 {arrays['cv2_version']}, "
          + ", ".join(f"{s} {len(arrays[s + '_x'])} keypoints"
                      for s in TOR.PARITY_SCENES))
