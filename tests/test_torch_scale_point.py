"""PyTorch port vs the JAX package at the capacity of the JAX package's
largest documented configuration, 3840x2160 with ``num_features=10000``
(doc/performance.md:57), on small frames on the CPU.

Capacity is what changes the shapes of the candidate walk (``2 *
num_features`` rows), of the compactions and of the orientation and
descriptor stages' rows; the frame's width picks the slab's copy count
(``pipeline/detector.slab_copies``).  So two frames: 320x240 (8 octaves, 2
copies) and 128x96 (7 octaves, 4 copies: octave 0 spans fewer than 256
aligned columns).  Both packages run their CPU routes: the JAX package its
flat ``gather_impl="xla"`` path, the port the plain versions of its
kernels, held with ``_hold``'s limits for that route (descriptors within 1
on 99 % of the pairs and within 2 on all).  The full-size frame runs on the
card only (``chip_smoke.py`` ``scale_point``).

Every case is ``slow``: one JAX CPU frame at this capacity takes minutes.
"""
import pytest
import torch

import sift_tpu_torch as stt
from conftest import synthetic_image, textured_image
from sift_tpu_torch.pipeline.detector import slab_copies
from test_torch_detector import _hold, _jax_result, _port_result

SCALE_FEATURES = 10000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off
    the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.slow
@pytest.mark.parametrize("width,height,octaves,copies,min_count", [
    (320, 240, 8, 2, 100),   # synthetic: 116 keypoints in the port
    (128, 96, 7, 4, 30),     # textured: 38 keypoints in the port
])
def test_scale_point_capacity_matches_jax(width, height, octaves, copies,
                                          min_count):
    """One frame at ``num_features=10000`` through both packages: the
    plan has the octaves and copies named, and the port holds against the
    JAX flat path as tests/test_torch_detector.py holds it at 512."""
    cfg = stt.SiftConfig(width=width, height=height,
                         num_features=SCALE_FEATURES)
    plan = stt.build_plan(cfg)
    assert len(plan.octaves) == octaves
    assert slab_copies(plan) == copies
    img = synthetic_image(height=height, width=width) if copies == 2 \
        else textured_image(height=height, width=width)
    _hold(_jax_result(img, "xla", SCALE_FEATURES),
          _port_result(img, SCALE_FEATURES), min_count=min_count)
