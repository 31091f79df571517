"""PyTorch port vs the JAX package: distributed bundle adjustment
(``parallel/dba.py``) on a mesh of 8 CPU shards, against the port's
single-problem ``lm_optimize`` and the JAX package's ``make_distributed_lm``
on its 8 virtual CPU devices, with tests/test_dba.py's tolerances; and the
JAX-free BA generators of ``perf/scenes.py`` against the tests' own.
"""
import jax
import numpy as np
import pytest
import torch

from sift_tpu.parallel.batched import make_mesh as jax_mesh
from sift_tpu.parallel.dba import make_distributed_lm as jax_dlm
from sift_tpu_torch.core import convert
from sift_tpu_torch.geometry import ba as tba
from sift_tpu_torch.parallel.batched import make_mesh
from sift_tpu_torch.parallel.dba import make_distributed_lm, make_lm_stepper
from sift_tpu_torch.perf import checkpoint as tck
from sift_tpu_torch.perf import scenes
from tests.test_ba import synthetic_ba as jax_synthetic_ba
from tests.test_dba import synthetic_ba_chain as jax_synthetic_ba_chain


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The problems here are small: one intra-op thread keeps this file
    off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n=8):
    return make_mesh(n, device="cpu")


@pytest.mark.parametrize("seed,n_cams,n_pts", [(0, 5, 96), (1, 4, 37),
                                               (3, 5, 96)])
def test_synthetic_ba_equals_the_tests_generator(seed, n_cams, n_pts):
    """perf/scenes.synthetic_ba (no JAX: what the workers and the smoke
    run use) against tests/test_ba.py's: parameters within 1e-6; the
    float32 pixels within one float32 step (the two so3_exp differ in
    their last bit, which moves a projection by at most one step)."""
    want, *gt_j = jax_synthetic_ba(seed=seed, n_cams=n_cams, n_pts=n_pts)
    got, *gt_t = scenes.synthetic_ba(seed=seed, n_cams=n_cams, n_pts=n_pts)
    for k in ("rotations", "translations", "points"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-6,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(got.uv.numpy(), np.asarray(want.uv),
                               rtol=2.0 ** -23, atol=1e-6)
    for k in ("cam_idx", "pt_idx", "valid", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    for a, b in zip(gt_t, gt_j):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_synthetic_ba_chain_equals_the_tests_generator():
    want = jax_synthetic_ba_chain(n_cams=2000)
    got = scenes.synthetic_ba_chain(n_cams=2000)
    assert got.cam_idx.shape[0] == want.cam_idx.shape[0] > 27000
    for k in got._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_distributed_matches_single_device_and_jax():
    """The same problem (tests/test_ba.py's, as numpy) through the port's
    8-shard dense LM, the port's lm_optimize and the JAX package's
    8-device make_distributed_lm: cost rtol 1e-2, rotations atol 1e-4."""
    jprob, *_ = jax_synthetic_ba(seed=0, n_cams=5, n_pts=96)
    prob = convert.ba_problem_from_numpy(jprob, device="cpu")
    single = tba.lm_optimize(prob, iterations=10)
    fn, place = make_distributed_lm(cpu_mesh(), iterations=10)
    dist = fn(place(prob))
    jfn, jplace = jax_dlm(jax_mesh(8), iterations=10)
    jdist = jax.block_until_ready(jfn(jplace(jprob)))

    assert float(dist.cost) < 1e-4
    for ref_cost, ref_rot in ((single.cost.numpy(), single.rotations.numpy()),
                              (np.asarray(jdist.cost),
                               np.asarray(jdist.rotations))):
        np.testing.assert_allclose(dist.cost.numpy(), ref_cost, rtol=1e-2,
                                   atol=1e-6)
        np.testing.assert_allclose(dist.rotations.numpy(), ref_rot,
                                   atol=1e-4)


def test_one_shard_is_the_single_problem_path_bit_for_bit():
    """A one-shard mesh runs the same arithmetic as lm_optimize (dense)
    and solve_schur_cg (cg); more shards only reorder the sums (held in
    float64: in float32 the free scale gauge amplifies the reordering)."""
    prob, *_ = scenes.synthetic_ba(seed=2, n_cams=5, n_pts=96)
    single = tba.lm_optimize(prob, iterations=6)
    fn, place = make_distributed_lm(cpu_mesh(1), iterations=6)
    one = fn(place(prob))
    for k in single._fields:
        assert torch.equal(getattr(one, k), getattr(single, k)), k

    p64 = prob._replace(**{k: getattr(prob, k).double() for k in (
        "rotations", "translations", "points", "uv", "fx", "fy", "cx",
        "cy")})
    lam = torch.tensor(1e-3, dtype=torch.float64)
    want = tba.solve_schur_cg(p64, lam, cg_iters=20)
    for n in (1, 3):
        _, _, place = make_lm_stepper(cpu_mesh(n), solver="cg")
        got = tba.solve_schur_cg_shards(place(p64).shards, lam,
                                        cg_iters=20)
        for a, b in zip(got, want):
            if n == 1:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_distributed_handles_nondivisible_observations():
    prob, *_ = scenes.synthetic_ba(seed=1, n_cams=4, n_pts=37)
    assert prob.cam_idx.shape[0] % 8 != 0          # 148 observations
    fn, place = make_distributed_lm(cpu_mesh(), iterations=8)
    placed = place(prob)
    assert sum(int(q.valid.sum()) for q, _ in placed.shards) == 148
    assert {q.cam_idx.shape[0] for q, _ in placed.shards} == {19}
    assert float(fn(placed).cost) < 1e-4


def test_distributed_cg_solver_converges():
    """solver="cg" (observation-space PCG Schur matvecs summed over the
    shards) reaches the dense solver's cost floor on the same problem."""
    prob, *_ = scenes.synthetic_ba(seed=0, n_cams=5, n_pts=96)
    fn, place = make_distributed_lm(cpu_mesh(), iterations=12, solver="cg")
    assert float(fn(place(prob)).cost) < 1e-4


@pytest.mark.slow
def test_cg_scales_to_2000_cameras():
    """Map-block-scale BA: 2000 cameras / 4000 points / ~28k observations
    on the 8-shard mesh with solver="cg" — nothing dense in C is formed.
    Gate: an order of magnitude cost reduction in 6 LM iterations."""
    prob = scenes.synthetic_ba_chain(n_cams=2000)
    c0 = float(tba._mean_cost(prob, prob.rotations, prob.translations,
                              prob.points))
    fn, place = make_distributed_lm(cpu_mesh(), iterations=6, solver="cg",
                                    cg_iters=30)
    out = fn(place(prob))
    assert float(out.cost) < c0 / 10, (c0, float(out.cost))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_stepper_chunked_resume_bit_identical(tmp_path, solver):
    """Elastic-recovery contract: k chunks of n LM iterations through
    make_lm_stepper — with a save/load_ba_state npz round trip between
    chunks — equal one uninterrupted run bit for bit."""
    prob, *_ = scenes.synthetic_ba(seed=3, n_cams=5, n_pts=96)
    init, step, place = make_lm_stepper(cpu_mesh(), chunk=5, solver=solver)
    placed = place(prob)
    straight = step(placed, step(placed, init(placed)))
    _, step10, _ = make_lm_stepper(cpu_mesh(), chunk=10, solver=solver)
    once = step10(placed, init(placed))

    path = str(tmp_path / "ba_ckpt.npz")
    tck.save_ba_state(path, step(placed, init(placed)), iteration=5)
    loaded, it = tck.load_ba_state(path)
    assert it == 5
    resumed = step(placed, loaded)
    for k in straight._fields:
        assert torch.equal(getattr(straight, k), getattr(resumed, k)), k
        assert torch.equal(getattr(straight, k), getattr(once, k)), k
