"""PyTorch port vs the JAX package: loop closure on an out-and-back stub
sequence (tests/test_loop_closure.py's trajectory), the detector replaced
by the stub of tests/test_torch_odometry.py in both packages."""
import numpy as np
import pytest

from sift_tpu.geometry.trajectory import ate_rmse
from tests.test_torch_odometry import (_one_torch_thread,  # noqa: F401
                                       jax_geometry_jitted, loop_pose,
                                       make_odometry, stub_frames)

N_LOOP = 9
LOOP_KW = dict(loop_closure=True, kf_interval=2, loop_min_gap=6,
               loop_min_matches=20, loop_min_inliers=15)


@pytest.fixture(scope="module")
def loop_sequence():
    return stub_frames([loop_pose(i, N_LOOP) for i in range(N_LOOP)],
                       seed=9)


@pytest.fixture(scope="module")
def port_loop(loop_sequence):
    frames, _ = loop_sequence
    odo = make_odometry("torch", frames, **LOOP_KW)
    for i in range(N_LOOP):
        odo.process(i)
    return odo


@pytest.fixture(scope="module")
def jax_loop(loop_sequence):
    frames, _ = loop_sequence
    with jax_geometry_jitted():
        odo = make_odometry("jax", frames, **LOOP_KW)
        for i in range(N_LOOP):
            odo.process(i)
    return odo


def test_loop_closure_in_both_packages(loop_sequence, port_loop, jax_loop):
    """At least one closure in each package, the same closures (keyframe,
    frame), inliers within 2, a pose-graph correction that keeps the
    trajectory within the JAX gate (ATE < 0.2) and within 1e-3 of JAX's."""
    _, gt = loop_sequence
    to, jo = port_loop, jax_loop
    assert len(jo.closures) >= 1 and len(to.closures) >= 1
    assert [c[:2] for c in to.closures] == [c[:2] for c in jo.closures]
    for (kf, cur, n_t), (_, _, n_j) in zip(to.closures, jo.closures):
        assert cur - kf >= 6 and n_t >= 15 and abs(n_t - n_j) <= 2
    assert to.result.modes == jo.result.modes
    pt, pj = to.result.positions(), jo.result.positions()
    assert ate_rmse(pt, gt, with_scale=True) < 0.2
    assert ate_rmse(pj, gt, with_scale=True) < 0.2
    assert ate_rmse(pt, pj, with_scale=True) < 1e-3
    assert len(to._keyframes) == len(jo._keyframes)
    for (fa, _, la), (fb, _, lb) in zip(to._keyframes, jo._keyframes):
        assert fa == fb and la.keys() == lb.keys()


def test_loop_closure_checkpoint_carries_keyframes(loop_sequence, port_loop,
                                                   tmp_path):
    """Keyframes, their signatures and the closures go through the port's
    checkpoint: a resumed run closes the same loops bit-identically."""
    frames, _ = loop_sequence
    full = port_loop
    first = make_odometry("torch", frames, **LOOP_KW)
    for i in range(6):
        first.process(i)
    ckpt = str(tmp_path / "loop.npz")
    first.save_state(ckpt)
    resumed = make_odometry("torch", frames, **LOOP_KW)
    resumed.load_state(ckpt)
    assert len(resumed._keyframes) == len(first._keyframes) > 0
    for i in range(6, N_LOOP):
        resumed.process(i)
    assert resumed.closures == full.closures
    np.testing.assert_array_equal(np.stack(full.result.rotations),
                                  np.stack(resumed.result.rotations))
    np.testing.assert_array_equal(np.stack(full.result.translations),
                                  np.stack(resumed.result.translations))
