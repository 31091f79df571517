"""PyTorch port vs the JAX package's production path: the whole slice
against ``gather_impl="pallas_interpret"`` — the JAX package's four Pallas
kernels run through the interpreter on the CPU, as its own tests run them.
Kept in a file of its own because the interpreter is slow.
"""
from conftest import synthetic_image
from test_torch_detector import _hold, _jax_result, _port_result


def test_detector_matches_jax_fused_path_interpret():
    """vs gather_impl="pallas_interpret" (the JAX package's production
    path, its four Pallas kernels in interpret mode) at 160x120: both
    sides compute full-precision gradients, so |diff| <= 1 everywhere."""
    img = synthetic_image(height=120, width=160, seed=3, n_blobs=25)
    _hold(_jax_result(img, "pallas_interpret"), _port_result(img),
          min_count=30, desc_all=1)
