"""PyTorch port vs the JAX package: bundle adjustment (LM with Schur
elimination, the CG solver, float64), the BA checkpoint and the pose
graph, on the same seeded numpy inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.geometry import ba as jba
from sift_tpu.geometry import posegraph as jpg
from sift_tpu.geometry import se3 as jse3
from sift_tpu.perf import checkpoint as jck
from sift_tpu_torch.core import convert
from sift_tpu_torch.geometry import ba as tba
from sift_tpu_torch.geometry import posegraph as tpg
from sift_tpu_torch.geometry import se3 as tse3
from sift_tpu_torch.perf import checkpoint as tck


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_ba(seed=0, n_cams=6, n_pts=120, noise_px=0.0, perturb=0.02):
    """tests/test_ba.py's generator, as numpy: cameras on an arc looking
    at a point cloud; observations = exact projections + noise; initial
    estimate = ground truth perturbed (camera 0 exact)."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
    rots, trs = [], []
    for i in range(n_cams):
        w = np.array([0.0, 0.25 * (i / max(n_cams - 1, 1) - 0.5), 0.0])
        rots.append(np.asarray(jse3.so3_exp(jnp.asarray(w))))
        trs.append(np.array([-0.8 * i / max(n_cams - 1, 1) + 0.4, 0.0,
                             0.0]))
    rots, trs = np.stack(rots), np.stack(trs)
    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        pc = pts @ rots[c].T + trs[c]
        uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                       pc[:, 1] / pc[:, 2] * fy + cy], -1)
        cam_idx += [c] * n_pts
        pt_idx += list(range(n_pts))
        uvs.append(uv + rng.normal(0, noise_px, uv.shape))
    rots_i, trs_i = rots.copy(), trs.copy()
    for c in range(1, n_cams):
        dw = rng.normal(0, perturb, 3)
        rots_i[c] = np.asarray(jse3.so3_exp(jnp.asarray(dw))) @ rots[c]
        trs_i[c] = trs[c] + rng.normal(0, perturb, 3)
    pts_i = pts + rng.normal(0, perturb, pts.shape)
    prob = dict(rotations=rots_i.astype(np.float32),
                translations=trs_i.astype(np.float32),
                points=pts_i.astype(np.float32),
                cam_idx=np.asarray(cam_idx, np.int32),
                pt_idx=np.asarray(pt_idx, np.int32),
                uv=np.concatenate(uvs).astype(np.float32),
                valid=np.ones(len(cam_idx), bool),
                fx=np.float32(fx), fy=np.float32(fy), cx=np.float32(cx),
                cy=np.float32(cy))
    return prob, rots, trs, pts


def _jax_problem(d, dtype=jnp.float32):
    return jba.BAProblem(**{
        k: jnp.asarray(v, dtype) if np.asarray(v).dtype.kind == "f"
        else jnp.asarray(v) for k, v in d.items()})


def _as64(d):
    return {k: (np.asarray(v, np.float64) if np.asarray(v).dtype.kind == "f"
                else v) for k, v in d.items()}


@pytest.fixture(scope="module")
def problem64():
    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    return _as64(prob)


def test_segment_sums_are_deterministic_and_exact():
    """Segments.sum equals index_add_ (up to summation order), keeps each
    segment's rows in index order, and gives the same bits twice."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 17, 500))
    x = torch.from_numpy(rng.normal(size=(500, 6, 3)))
    seg = tba.Segments.build(idx, 20)
    want = torch.zeros(20, 6, 3, dtype=x.dtype).index_add_(0, idx, x)
    got = seg.sum(x)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.equal(got, seg.sum(x))
    assert torch.equal(got[17:], torch.zeros(3, 6, 3, dtype=x.dtype))
    assert seg.width == int(torch.bincount(idx).max())
    # rows of one segment sit in index order
    rows = torch.nonzero(idx == 3)[:, 0]
    assert torch.equal(seg.rank[rows], torch.arange(len(rows)))


def test_lm_step_and_cg_float64_match_jax_x64(problem64):
    """float64 lm_step (dense Schur) and solve_schur_cg, port against the
    JAX package in x64 (tests/test_ba.py:109-131's tolerances)."""
    p64 = convert.ba_problem_from_numpy(problem64, device="cpu")
    assert p64.points.dtype == torch.float64
    lam = torch.tensor(1e-4, dtype=torch.float64)
    dc_t, dp_t = tba.lm_step(p64, lam)
    cc_t, cp_t = tba.solve_schur_cg(p64, lam, cg_iters=40)
    assert dc_t.dtype == cc_t.dtype == torch.float64
    jax.config.update("jax_enable_x64", True)
    try:
        pj = _jax_problem(problem64, jnp.float64)
        lj = jnp.asarray(1e-4, jnp.float64)
        dc_j, dp_j = jba.lm_step(pj, lj)
        cc_j, cp_j = jba.solve_schur_cg(pj, lj, cg_iters=40)
        dc_j, dp_j, cc_j, cp_j = map(np.asarray, (dc_j, dp_j, cc_j, cp_j))
        oj = {k: np.asarray(v)
              for k, v in jba.lm_optimize(pj, iterations=15)._asdict().items()}
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(dc_t.numpy(), dc_j, atol=1e-8)
    np.testing.assert_allclose(dp_t.numpy(), dp_j, atol=1e-7)
    np.testing.assert_allclose(cc_t.numpy(), cc_j, atol=1e-8)
    np.testing.assert_allclose(cp_t.numpy(), cp_j, atol=1e-7)
    # the port's own CG and dense steps agree as the JAX ones do
    np.testing.assert_allclose(cc_t.numpy(), dc_t.numpy(), atol=1e-8)
    # The whole LM loop in float64: the same poses, scale gauge included.
    ot = tba.lm_optimize(p64, iterations=15)
    assert ot.rotations.dtype == torch.float64
    for k in ("rotations", "translations", "points"):
        np.testing.assert_allclose(getattr(ot, k).numpy(), oj[k], atol=1e-7)
    assert float(ot.cost) < 1e-8
    # the reduce hook sees every observation sum; identity by default
    seen = []
    tba.solve_schur_cg(p64, lam, cg_iters=2,
                       reduce=lambda v: seen.append(v.shape) or v)
    assert (5, 6, 6) in seen and (96, 3) in seen


@pytest.fixture(scope="module")
def jax_lm():
    """The JAX package's lm_optimize (jit, as tests/test_ba.py runs it) on
    the noiseless and the noisy problem, the same shapes — one compile."""
    fn = jax.jit(lambda p: jba.lm_optimize(p, iterations=15))
    out = {}
    for name, kw in (("noiseless", {}), ("noisy", dict(noise_px=0.5,
                                                       seed=1))):
        d, rots, *_ = synthetic_ba(**kw)
        o = fn(_jax_problem(d))
        out[name] = (d, rots, {k: np.asarray(v)
                               for k, v in o._asdict().items()})
    return out


def _centers_up_to_scale(rot, tr):
    """Camera centres relative to camera 0, divided by their norm: the
    problem fixes camera 0 but not the scale (its gauge is free, as in the
    JAX package), so float32 runs may walk along it differently."""
    c = -np.einsum("nji,nj->ni", rot, tr)
    c = c - c[0]
    return c / np.linalg.norm(c)


@pytest.mark.parametrize("name,gate", [("noiseless", 1e-4), ("noisy", 0.6)])
def test_lm_optimize_reaches_the_jax_gates(jax_lm, name, gate):
    """float32 lm_optimize on tests/test_ba.py's problems: both packages
    reach its gates; rotations agree at 1e-3 and camera centres at 1e-3 up
    to the free scale (float32 roundoff moves the solution along the scale
    gauge by ~1e-2; the float64 test above holds translations too)."""
    d, rots_gt, oj = jax_lm[name]
    p = convert.ba_problem_from_numpy(d, device="cpu")
    c0 = float(tba._mean_cost(p, p.rotations, p.translations, p.points))
    assert c0 > 1.0
    ot = tba.lm_optimize(p, iterations=15)
    assert float(ot.cost) < gate and float(oj["cost"]) < gate
    np.testing.assert_allclose(ot.rotations.numpy(), oj["rotations"],
                               atol=1e-3)
    np.testing.assert_allclose(
        _centers_up_to_scale(ot.rotations.numpy(), ot.translations.numpy()),
        _centers_up_to_scale(oj["rotations"], oj["translations"]),
        atol=1e-3)
    # camera 0 is the gauge: untouched
    np.testing.assert_array_equal(ot.rotations[0].numpy(),
                                  d["rotations"][0])
    if name == "noiseless":
        for c in range(len(rots_gt)):
            dr = tse3.so3_log(torch.from_numpy(rots_gt[c].T.astype(
                np.float32)) @ ot.rotations[c])
            assert float(dr.norm()) < 2e-3


def test_lm_respects_valid_mask():
    d, *_ = synthetic_ba(seed=2)
    bad = np.zeros(len(d["uv"]), bool)
    bad[::2] = True
    d["uv"] = d["uv"].copy()
    d["uv"][bad] += 500.0
    d["valid"] = ~bad
    out = tba.lm_optimize(convert.ba_problem_from_numpy(d, device="cpu"),
                          iterations=15)
    assert float(out.cost) < 1e-4


def test_ba_state_checkpoint_across_packages(tmp_path, jax_lm):
    """save_ba_state / load_ba_state: each package reads the other's file
    (same npz keys, atomic write)."""
    d, _, oj = jax_lm["noisy"]
    jstate = jba.BAState(**{k: jnp.asarray(v) for k, v in oj.items()})
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_ba_state(a, jstate, 7)
    st, it = tck.load_ba_state(a)
    assert it == 7 and isinstance(st, tba.BAState)
    for k in tba.BAState._fields:
        np.testing.assert_array_equal(getattr(st, k).numpy(), oj[k])
    tck.save_ba_state(b, st, 8)
    assert not (tmp_path / "torch.npz.tmp.npz").exists()
    back, it2 = jck.load_ba_state(b)
    assert it2 == 8
    for k in jba.BAState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), oj[k])
    assert tck.load_ba_state(str(tmp_path / "none.npz")) == (None, 0)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _ring(n=8, noise=0.0, seed=0):
    """tests/test_posegraph.py's ring trajectory and its measurements."""
    rng = np.random.default_rng(seed)
    rots, trs = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        rots.append(np.asarray(jse3.so3_exp(jnp.asarray([0.0, ang, 0.0])),
                               np.float32))
        trs.append(np.array([np.cos(ang), 0.0, np.sin(ang)], np.float32))
    meas = []
    for i in range(n):
        j = (i + 1) % n
        rrel = rots[j] @ rots[i].T
        trel = trs[j] - rrel @ trs[i]
        if noise:
            dw = rng.normal(0, noise, 3)
            rrel = np.asarray(jse3.so3_exp(jnp.asarray(dw)),
                              np.float32) @ rrel
            trel = trel + rng.normal(0, noise, 3)
        meas.append((i, j, rrel.astype(np.float32),
                     trel.astype(np.float32)))
    return rots, trs, meas


def _graphs(noise, seed):
    """The same incremental graph built by both packages' builders: chain
    initialization from noisy edges + an exact loop-closure edge."""
    rots, trs, meas = _ring(noise=noise, seed=seed)
    out = []
    for mod in (jpg, tpg):
        g = mod.IncrementalPoseGraph(8, 16)
        g.add_pose(rots[0], trs[0])
        for (i, j, rr, rt) in meas[:-1]:
            g.add_pose()
            g.add_edge(i, j, rr, rt)
        i, j, _, _ = meas[-1]
        rrel = rots[j] @ rots[i].T
        g.add_edge(i, j, rrel, trs[j] - rrel @ trs[i], weight=4.0)
        out.append(g)
    return rots, out


def test_edge_residuals_match_jax():
    _, (gj, gt) = _graphs(noise=0.02, seed=1)
    for a, b in zip((gj._rot, gj._t, gj._w), (gt._rot, gt._t, gt._w)):
        np.testing.assert_array_equal(a, b)
    pj = gj.to_device()
    pt = convert.pose_graph_from_numpy(pj._asdict(), device="cpu")
    rj = np.asarray(jpg.edge_residuals(pj))
    np.testing.assert_allclose(tpg.edge_residuals(pt).numpy(), rj,
                               atol=1e-5)
    np.testing.assert_allclose(
        tpg.edge_residuals(gt.to_device("cpu")).numpy(), rj, atol=1e-5)
    assert np.abs(rj[:-1]).max() > 1e-3       # noisy chain, exact closure


def test_pose_graph_optimize_matches_jax():
    rots, (gj, gt) = _graphs(noise=0.02, seed=1)
    before = tpg.edge_residuals(gt.to_device("cpu"))
    oj = gj.optimize(iterations=25)
    ot = gt.optimize(iterations=25, device="cpu")
    np.testing.assert_allclose(ot.rotations.numpy(),
                               np.asarray(oj.rotations), atol=1e-4)
    np.testing.assert_allclose(ot.translations.numpy(),
                               np.asarray(oj.translations), atol=1e-4)
    np.testing.assert_allclose(gt._rot, gj._rot, atol=1e-4)
    np.testing.assert_allclose(ot.rotations[0].numpy(), rots[0], atol=1e-5)
    after = tpg.edge_residuals(ot)
    assert (after ** 2).sum() < 0.5 * (before ** 2).sum()


def test_incremental_pose_graph_capacity_errors():
    for mod in (jpg, tpg):
        g = mod.IncrementalPoseGraph(2, 1)
        g.add_pose()
        g.add_pose()
        with pytest.raises(ValueError, match="pose capacity"):
            g.add_pose()
        g.add_edge(0, 1, np.eye(3), np.zeros(3))
        with pytest.raises(ValueError, match="edge capacity"):
            g.add_edge(0, 1, np.eye(3), np.zeros(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpg.IncrementalPoseGraph(2, 1).to_device()
