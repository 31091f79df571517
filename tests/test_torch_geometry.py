"""PyTorch port vs the JAX package: SE(3) math, two-view geometry, PnP,
trajectory metrics and telemetry, on the same seeded numpy inputs.

Tolerances are the JAX tests' own or tighter.  JAX runs eagerly here and
recompiles for every new shape, so the cases share few shapes and small
hypothesis counts.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.geometry import pnp as jpnp
from sift_tpu.geometry import se3 as jse3
from sift_tpu.geometry import trajectory as jtraj
from sift_tpu.geometry import twoview as jtv
from sift_tpu.perf import telemetry as jtel
from sift_tpu_torch.geometry import pnp as tpnp
from sift_tpu_torch.geometry import se3 as tse3
from sift_tpu_torch.geometry import trajectory as ttraj
from sift_tpu_torch.geometry import twoview as ttv
from sift_tpu_torch.perf import telemetry as ttel

N_PTS = 120     # one correspondence count for every two-view case
N_HYP = 32      # one hypothesis count for every RANSAC case


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def test_se3_functions_match_jax():
    rng = np.random.default_rng(0)
    w = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    w[0] = 0.0                                 # exact zero: small branch
    w[1] = 1e-9                                # below the 1e-7 switch
    xi = rng.uniform(-1, 1, (16, 6)).astype(np.float32)
    xi[0] = 0.0
    pts = rng.uniform(-3, 3, (16, 10, 3)).astype(np.float32)
    pts[..., 2] += 8.0

    def both(name, *args):
        j = getattr(jse3, name)(*[_j(a) for a in args])
        t = getattr(tse3, name)(*[_t(a) for a in args])
        return j, t

    for name, args in (("hat", (w,)), ("so3_exp", (w,))):
        j, t = both(name, *args)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    r = np.asarray(jse3.so3_exp(_j(w)))
    j, t = both("so3_log", r)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), w, atol=1e-5)
    (jr, jt), (tr, tt) = both("se3_exp", xi)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    ra, ta = np.asarray(jr), np.asarray(jt)
    rb, tb = ra[::-1].copy(), ta[::-1].copy()
    for name, args in (("compose", (ra, ta, rb, tb)),
                       ("inverse", (ra, ta)),
                       ("transform", (ra, ta, pts))):
        j, t = both(name, *args)
        j, t = (j, t) if isinstance(j, tuple) else ((j,), (t,))
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    j = jse3.project(_j(pts), 400.0, 410.0, 320.0, 240.0)
    t = tse3.project(_t(pts), 400.0, 410.0, 320.0, 240.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("fn", ["se3_exp_r", "se3_exp_t", "so3_exp",
                                "so3_log_exp", "edge"])
def test_jacobians_at_zero_twist_finite_and_equal_to_jax(fn):
    """torch.func.jacfwd at the zero twist, where the small-angle branch
    is selected and the unselected branch's tangent is 0/0: finite and
    equal to jax.jacfwd."""
    rng = np.random.default_rng(1)
    r0 = np.asarray(jse3.so3_exp(_j(rng.uniform(-.5, .5, 3)
                                    .astype(np.float32))))
    t0 = rng.uniform(-1, 1, 3).astype(np.float32)

    def make(m):
        def f(x):
            if fn == "se3_exp_r":
                return m.se3_exp(x)[0]
            if fn == "se3_exp_t":
                return m.se3_exp(x)[1]
            if fn == "so3_exp":
                return m.so3_exp(x[3:])
            if fn == "so3_log_exp":
                return m.so3_log(m.so3_exp(x[3:]))
            # a pose-graph edge residual at a perfect measurement
            dr, dt = m.se3_exp(x)
            rr = dr @ (r0 if m is jse3 else _t(r0))
            tt = dr @ (t0 if m is jse3 else _t(t0)) + dt
            ri, ti = m.inverse(rr, tt)
            re, te = m.compose(ri, ti, rr, tt)
            return te + m.so3_log(re)
        return f

    jj = np.asarray(jax.jit(jax.jacfwd(make(jse3)))(jnp.zeros(6)))
    jt = torch.func.jacfwd(make(tse3))(torch.zeros(6))
    assert torch.isfinite(jt).all() and np.isfinite(jj).all()
    np.testing.assert_allclose(jt.numpy(), jj, atol=1e-5)


# ---------------------------------------------------------------------------
# two-view
# ---------------------------------------------------------------------------

def _scene(seed=0, n=N_PTS, outlier_frac=0.0, noise=0.0):
    """Random 3D points seen by two cameras with known relative pose
    (normalized coordinates), as tests/test_twoview.py builds them."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    w = np.array([0.05, -0.12, 0.08])
    r = np.asarray(jse3.so3_exp(jnp.asarray(w)), np.float64)
    t = np.array([0.5, -0.1, 0.05])
    p1 = pts[:, :2] / pts[:, 2:]
    pc2 = pts @ r.T + t
    p2 = pc2[:, :2] / pc2[:, 2:]
    p1 = p1 + rng.normal(0, noise, p1.shape)
    p2 = p2 + rng.normal(0, noise, p2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        p2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return p1.astype(np.float32), p2.astype(np.float32), r, t


def test_pixels_to_normalized_eight_point_and_sampson():
    p1, p2, r, t = _scene(seed=3)
    pix = np.stack([p1[:, 0] * 400 + 320, p1[:, 1] * 410 + 240], -1)
    np.testing.assert_allclose(
        ttv.pixels_to_normalized(_t(pix), 400., 410., 320., 240.).numpy(),
        np.asarray(jtv.pixels_to_normalized(_j(pix), 400., 410., 320.,
                                            240.)), atol=1e-6)
    # batched fits: a 16-point system and an exactly-8-point [8, 9] one
    for k in (16, 8):
        a1 = np.stack([p1[i:i + k] for i in range(0, 40, 10)])
        a2 = np.stack([p2[i:i + k] for i in range(0, 40, 10)])
        ej = np.asarray(jtv.eight_point(_j(a1), _j(a2)))
        et = ttv.eight_point(_t(a1), _t(a2)).numpy()
        for a, b in zip(et, ej):                     # E up to sign
            sgn = np.sign(np.sum(a * b))
            np.testing.assert_allclose(a * sgn, b, atol=1e-4)
        err_j = np.asarray(jtv.sampson_error(_j(ej), _j(p1)[None],
                                             _j(p2)[None]))
        err_t = ttv.sampson_error(_t(ej), _t(p1)[None], _t(p2)[None])
        np.testing.assert_allclose(err_t.numpy(), err_j, rtol=1e-4,
                                   atol=1e-12)
    e_gt = np.asarray(jse3.hat(jnp.asarray(t))) @ r
    assert ttv.sampson_error(_t(e_gt.astype(np.float32)), _t(p1),
                             _t(p2)).max() < 1e-8


def test_triangulate_and_recover_pose_match_jax():
    p1, p2, r, t = _scene(seed=4, noise=1e-3)
    r32, t32 = r.astype(np.float32), (t / np.linalg.norm(t)).astype(
        np.float32)
    xj = np.asarray(jtv.triangulate(_j(r32), _j(t32), _j(p1), _j(p2)))
    xt = ttv.triangulate(_t(r32), _t(t32), _t(p1), _t(p2)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=2e-3, atol=2e-3)

    e = (np.asarray(jse3.hat(jnp.asarray(t32))) @ r32).astype(np.float32)
    inl = np.ones(len(p1), bool)
    inl[::7] = False
    for e_in in (e, -e):                             # either SVD sign
        rj, tj, pj = jtv.recover_pose(_j(e_in), _j(p1), _j(p2), _j(inl))
        rt, tt, pt = ttv.recover_pose(_t(e_in), _t(p1), _t(p2), _t(inl))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
        np.testing.assert_allclose(rt.numpy(), r32, atol=2e-3)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=2e-3,
                                   atol=2e-3)
    # batched over a leading seed axis: each row as a single call
    rb, tb, _ = ttv.recover_pose(_t(np.stack([e, -e, e])), _t(p1), _t(p2),
                                 _t(np.stack([inl, inl, ~inl])))
    for k, (e_in, m) in enumerate(((e, inl), (-e, inl), (e, ~inl))):
        r1, t1, _ = ttv.recover_pose(_t(e_in), _t(p1), _t(p2), _t(m))
        torch.testing.assert_close(rb[k], r1)
        torch.testing.assert_close(tb[k], t1)


# jit, as tests/test_twoview.py runs it: one compile for both cases.
_jax_ransac = jax.jit(lambda p1, p2, valid, key: jtv.ransac_essential(
    p1, p2, valid, key, n_hypotheses=N_HYP))
_jax_pnp = jax.jit(jpnp.pnp_gn)


def _jax_samples(key, valid, n_hyp, sample_size=16):
    """The [H, S] indices jax ransac_essential draws from ``key``
    (sift_tpu/geometry/twoview.py:160-165)."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(sample_size,)))(
        jax.random.split(key, n_hyp)))


def _rot_angle(ra, rb):
    c = (np.trace(ra.T @ rb) - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


@pytest.mark.parametrize("case", ["outliers", "tied_scores"])
def test_ransac_from_samples_with_jax_indices(case):
    """The port's RANSAC after the draws, fed the SAME [H, S] indices that
    jax.random draws inside sift_tpu's ransac_essential.  ``tied_scores``:
    exact, outlier-free correspondences, so every hypothesis scores all N
    and the top-24 boundary is one big tie — jax.lax.top_k keeps the
    lowest indices, as the port's stable sort must."""
    if case == "outliers":
        p1, p2, r_gt, t_gt = _scene(seed=2, outlier_frac=0.1, noise=2e-4)
    else:
        p1, p2, r_gt, t_gt = _scene(seed=5)
    valid = np.ones(len(p1), bool)
    valid[-5:] = False
    key = jax.random.key(7)
    res_j = _jax_ransac(_j(p1), _j(p2), _j(valid), key)
    idx = _jax_samples(key, valid, N_HYP)
    res_t = ttv.ransac_from_samples(_t(p1), _t(p2), _t(valid), _t(idx))

    if case == "tied_scores":
        # the seeds' pre-polish scores really tie across the boundary
        es = ttv.eight_point(_t(p1)[_t(idx)], _t(p2)[_t(idx)])
        scores = ((ttv.sampson_error(es, _t(p1)[None], _t(p2)[None])
                   < 1e-5) & _t(valid)).sum(-1)
        assert int((scores == scores.max()).sum()) > 24
    inl_j = np.asarray(res_j.inliers)
    inl_t = res_t.inliers.numpy()
    assert (inl_j != inl_t).mean() <= 0.01
    assert abs(int(res_j.num_inliers) - int(res_t.num_inliers)) \
        <= 0.01 * len(p1)
    assert _rot_angle(np.asarray(res_j.rotation), res_t.rotation.numpy()) \
        < 1e-3
    cos = float(np.dot(np.asarray(res_j.translation),
                       res_t.translation.numpy()))
    assert cos > 0.9999
    # and both are right
    assert _rot_angle(r_gt, res_t.rotation.numpy().astype(np.float64)) \
        < 5e-3
    assert np.dot(res_t.translation.numpy(), t_gt / np.linalg.norm(t_gt)) \
        > 0.99
    assert not inl_t[-5:].any()


def test_ransac_essential_draws_from_a_generator():
    """The draws come from the given torch.Generator: the same seed gives
    the same result, valid rows only are sampled."""
    p1, p2, r_gt, _ = _scene(seed=6, outlier_frac=0.2, noise=2e-4)
    valid = np.ones(len(p1), bool)
    valid[:10] = False
    g = lambda s: torch.Generator().manual_seed(s)
    idx = ttv.draw_samples(_t(valid), N_HYP, 16, g(3))
    assert tuple(idx.shape) == (N_HYP, 16) and valid[idx.numpy()].all()
    a = ttv.ransac_essential(_t(p1), _t(p2), _t(valid), g(3),
                             n_hypotheses=N_HYP)
    b = ttv.ransac_essential(_t(p1), _t(p2), _t(valid), g(3),
                             n_hypotheses=N_HYP)
    c = ttv.ransac_from_samples(_t(p1), _t(p2), _t(valid), idx)
    for x, y in ((a, b), (a, c)):
        torch.testing.assert_close(x.rotation, y.rotation, rtol=0, atol=0)
        assert torch.equal(x.inliers, y.inliers)
    assert _rot_angle(r_gt, a.rotation.numpy().astype(np.float64)) < 5e-3


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def _pnp_scene(seed=0, n=80, outliers=0, noise_px=0.0):
    """tests/test_pnp.py's scene."""
    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    pts = rng.uniform([-3, -2, 5], [3, 2, 15], (n, 3)).astype(np.float32)
    r = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.1, 0.02],
                                            jnp.float32)))
    t = np.array([0.3, -0.1, 0.2], np.float32)
    pc = pts @ r.T + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)
    uv += rng.normal(0, noise_px, uv.shape)
    if outliers:
        uv[:outliers] += rng.uniform(30, 100, (outliers, 2))
    return pts, uv.astype(np.float32), r, t, (fx, fy, cx, cy)


@pytest.mark.parametrize("case", ["exact", "outliers", "valid_mask"])
def test_pnp_matches_jax(case):
    kw = dict(exact={}, outliers=dict(seed=1, outliers=20, noise_px=0.5),
              valid_mask=dict(seed=2))[case]
    pts, uv, r_gt, t_gt, intr = _pnp_scene(**kw)
    valid = np.ones(len(pts), bool)
    if case == "valid_mask":
        uv = uv.copy()
        uv[:30] += 500.0
        valid[:30] = False
    rj, tj, ij, ej = _jax_pnp(_j(pts), _j(uv), _j(valid), *intr,
                              jnp.eye(3), jnp.zeros(3))
    rt, tt, it, et = tpnp.pnp_gn(_t(pts), _t(uv), _t(valid), *intr,
                                 torch.eye(3), torch.zeros(3))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-3, atol=1e-4)
    atol = 0.02 if case == "outliers" else 1e-4
    np.testing.assert_allclose(tt.numpy(), t_gt, atol=atol)
    if case == "outliers":
        assert it.numpy()[20:].mean() > 0.9 and it.numpy()[:20].mean() < 0.2
    if case == "valid_mask":
        assert not it.numpy()[:30].any()


# ---------------------------------------------------------------------------
# trajectory + telemetry: copies of the numpy modules
# ---------------------------------------------------------------------------

def _trajectory(seed=0, n=20):
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        w = rng.normal(0, 0.3, 3)
        m = np.eye(4)
        m[:3, :3] = np.asarray(jse3.so3_exp(jnp.asarray(w)), np.float64)
        m[:3, 3] = rng.normal(0, 2, 3)
        poses.append(m)
    return poses


def test_trajectory_metrics_equal_jax_module():
    gt = _trajectory(0)
    est = _trajectory(1)
    gp = np.stack([m[:3, 3] for m in gt])
    ep = np.stack([m[:3, 3] for m in est])
    for ws in (True, False):
        a = jtraj.umeyama_alignment(ep, gp, ws)
        b = ttraj.umeyama_alignment(ep, gp, ws)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert jtraj.ate_rmse(ep, gp, ws) == ttraj.ate_rmse(ep, gp, ws)
    for d in (1, 3):
        assert jtraj.rpe(est, gt, d) == ttraj.rpe(est, gt, d)
    rots = np.stack([m[:3, :3] for m in gt])
    np.testing.assert_array_equal(ttraj.positions_from_rt(rots, gp),
                                  jtraj.positions_from_rt(rots, gp))
    ta = np.arange(10) * 0.1
    tb = ta[::-1] + 0.005
    assert ttraj.associate_timestamps(ta, tb) == \
        jtraj.associate_timestamps(ta, tb)


def test_trajectory_files_byte_equal(tmp_path):
    poses = _trajectory(2, 12)
    ts = np.arange(len(poses)) * 0.033
    for fmt in ("tum", "kitti"):
        a, b = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
        if fmt == "tum":
            jtraj.write_tum_trajectory(str(a), ts, poses)
            ttraj.write_tum_trajectory(str(b), ts, poses)
            ra, rb = (jtraj.read_tum_trajectory(str(a)),
                      ttraj.read_tum_trajectory(str(a)))
            np.testing.assert_array_equal(ra[0], rb[0])
            ra, rb = ra[1], rb[1]
        else:
            jtraj.write_kitti_trajectory(str(a), poses)
            ttraj.write_kitti_trajectory(str(b), poses)
            ra = jtraj.read_kitti_trajectory(str(a))
            rb = ttraj.read_kitti_trajectory(str(a))
        assert a.read_bytes() == b.read_bytes()
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


def test_telemetry_equal_jax_module(tmp_path, monkeypatch):
    """Same events, counters, series and JSONL bytes, on a shared fake
    clock (the records carry monotonic time stamps)."""
    class Clock:
        def __init__(self):
            self.now = 100.0

        def perf_counter(self):
            self.now += 0.25
            return self.now

    outs = []
    for mod, name in ((jtel, "j"), (ttel, "t")):
        monkeypatch.setattr(mod, "time", Clock())
        tel = mod.Telemetry()
        tel.emit("frame", frame=1, mode="pnp", inliers=40)
        tel.count("frames")
        tel.count("frames", 2)
        tel.record("x", 3)
        with tel.timer("stage"):
            pass
        path = tmp_path / f"{name}.jsonl"
        tel.write_jsonl(str(path))
        outs.append((tel.summary(), path.read_bytes()))
        assert mod.get(None) is mod.get(None)
        assert mod.get(tel) is tel
        null = mod.get(None)
        null.emit("frame")
        null.count("frames")
        assert null.events == [] and not null.counters
    assert outs[0] == outs[1]
    rows = [json.loads(x) for x in outs[1][1].decode().splitlines()]
    assert rows[-1]["kind"] == "summary" and rows[-1]["counters"] == {
        "frames": 3}
