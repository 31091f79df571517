"""PyTorch port vs the JAX package's production path: the whole slice
against ``gather_impl="pallas_interpret"`` — the JAX package's four Pallas
kernels run through the interpreter on the CPU, as its own tests run them.
Kept in a file of its own because the interpreter is slow: the JAX frame is
computed once for the module, and each part of the hold is a case of its
own on it.
"""
import pytest
import torch

from conftest import synthetic_image
from test_torch_detector import HOLD_PARTS, _hold, _jax_result, _port_result

# The frame below gives 51 keypoints (25 before the orientation expansion)
# in both packages.  A capacity of 64 holds them all, and its walk's 128
# rows every candidate: each result equals the one at capacity 512 (checked
# on the port and on the JAX flat path), with smaller keypoint grids for
# the kernels.
CAPACITY = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    """(JAX result, port result) at 160x120: octave 0 takes all four
    Pallas kernels (at least 128 columns and 64 rows), and the frame has
    more than 30 keypoints."""
    img = synthetic_image(height=120, width=160, seed=3, n_blobs=25)
    return (_jax_result(img, "pallas_interpret", CAPACITY),
            _port_result(img, CAPACITY))


@pytest.mark.parametrize("part", HOLD_PARTS)
def test_detector_matches_jax_fused_path_interpret(both, part):
    """vs gather_impl="pallas_interpret" (the JAX package's production
    path, its four Pallas kernels in interpret mode) at 160x120: both
    sides compute full-precision gradients, so |diff| <= 1 everywhere."""
    _hold(*both, min_count=30, desc_all=1, parts=(part,))
