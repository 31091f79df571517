"""PyTorch port vs the JAX package: the per-keypoint stages.

The same ``(slab, ys0, xs0, par, rows)`` arrays go through the JAX
package's Pallas kernels (interpret mode, as its own tests run them on the
CPU) and through the plain versions of the port's CUDA kernels; then the
host-level functions of both packages run on the same keypoints, the port
on a single-copy slab and the JAX package on its own lane-shifted one.  The
slab's copy expansion is held against the JAX package's Pallas kernel too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from sift_tpu.kernels import expand as JE
from sift_tpu.kernels import fused_stages as JFS
from sift_tpu.ops import descriptor as JD
from sift_tpu.ops import flatpyr as JF
from sift_tpu.ops import orientation as JO
from sift_tpu_torch.kernels import expand as TE
from sift_tpu_torch.kernels import fused_stages as TFS
from sift_tpu_torch.kernels.window_gather import window_rows
from sift_tpu_torch.ops import descriptor as TD
from sift_tpu_torch.ops import flatpyr as TF
from sift_tpu_torch.ops import orientation as TO

K = 48


@pytest.fixture(scope="module")
def setup():
    """The fused_setup of tests/test_fused.py:28-70, rebuilt with numpy:
    three noise octaves, K=48 keypoints whose sizes straddle the static
    window bound (and so all three radius ranges the JAX package treats
    as classes: <= 26, 27-30, 31-38, plus out-of-contract ones)."""
    rng = np.random.default_rng(0)
    jcfg = sift_tpu.SiftConfig(width=320, height=240, gather_impl="xla")
    tcfg = stt.SiftConfig(width=320, height=240)
    L = jcfg.num_octave_layers + 3
    blocks = [rng.normal(100, 40, (L, 240 >> o, 320 >> o)).astype(np.float32)
              for o in range(3)]
    octv = rng.integers(0, 3, K).astype(np.int32)
    hs = np.array([240, 120, 60])[octv]
    ws = np.array([320, 160, 80])[octv]
    px = rng.uniform(2, ws - 3)
    py = rng.uniform(2, hs - 3)
    kp = dict(
        octave=octv,
        x=(px * (2.0 ** octv)).astype(np.float32),
        y=(py * (2.0 ** octv)).astype(np.float32),
        layer=rng.integers(1, L - 2, K).astype(np.int32),
        size=(rng.uniform(1.6, 18.0, K) * (2.0 ** octv)).astype(np.float32),
        angle=rng.uniform(0, 360, K).astype(np.float32),
        valid=rng.uniform(0, 1, K) > 0.1)
    # The random draw leaves the middle radius range almost empty: pin
    # the first nine keypoints to radii across all three ranges.
    pinned = np.array([12, 22, 26, 27, 29, 30, 31, 35, 38], np.float64)
    n = len(pinned)
    kp["size"][:n] = (2.0 * pinned / (3.0 * np.sqrt(2.0) * 2.5)
                      * (2.0 ** octv[:n])).astype(np.float32)
    kp["valid"][:n] = True
    scl = kp["size"] * 0.5 * (2.0 ** -octv.astype(np.float64))
    radius = np.round(3.0 * scl * np.sqrt(2.0) * 2.5)
    rmax_d = TD.max_descr_radius(tcfg)
    assert rmax_d == JD.max_descr_radius(jcfg) == 38
    assert TO.max_ori_radius(tcfg) == JO.max_ori_radius(jcfg)
    inc = radius <= rmax_d
    classes = {"r_le_26": inc & (radius <= 26),
               "r_27_30": (radius >= 27) & (radius <= 30),
               "r_31_38": (radius >= 31) & (radius <= 38)}
    for name, m in classes.items():
        assert (m & kp["valid"]).sum() >= 2, name
    assert (~inc).sum() >= 2
    return dict(jcfg=jcfg, tcfg=tcfg, blocks=blocks, kp=kp, inc=inc,
                classes=classes, L=L, rmax=max(rmax_d,
                                               TO.max_ori_radius(tcfg)))


def _tslab(s, copies):
    return TF.stack_pyramid([torch.from_numpy(b) for b in s["blocks"]],
                            extra_rows=window_rows(s["rmax"]),
                            copies=copies, layer_lo=1, layer_hi=s["L"] - 2)


def _jslab(s, copies):
    return JF.stack_pyramid([jnp.asarray(b) for b in s["blocks"]],
                            extra_rows=window_rows(s["rmax"]),
                            copies=copies, layer_lo=1, layer_hi=s["L"] - 2)


def _tk(s):
    return {k: torch.from_numpy(v) for k, v in s["kp"].items()}


def _jk(s):
    return {k: jnp.asarray(v) for k, v in s["kp"].items()}


@pytest.mark.parametrize("copies", [1, 2, 4])
def test_stacked_slab_and_origins_match_jax(setup, copies):
    """Same slab bytes and, for the lane-shifted layouts, the same
    origins as the JAX package (exact)."""
    s = setup
    ts, js = _tslab(s, copies), _jslab(s, copies)
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    np.testing.assert_array_equal(ts.row_off.numpy(), np.asarray(js.row_off))
    assert ts.copy_rows == js.copy_rows and ts.layers == js.layers
    kp = s["kp"]
    inv = 2.0 ** -kp["octave"].astype(np.float64)
    px = np.round(kp["x"] * inv).astype(np.int32)
    py = np.round(kp["y"] * inv).astype(np.int32)
    rad = np.minimum(np.round(kp["size"] * 0.5 * inv * 10.6), 38) \
        .astype(np.int32)
    t = TF.stacked_origins(ts, *[torch.from_numpy(a) for a in
                                 (kp["octave"], kp["layer"], py, px, rad)])
    if copies > 1:
        j = JF.stacked_origins(js, *[jnp.asarray(a) for a in
                                     (kp["octave"], kp["layer"], py, px,
                                      rad)])
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        ys0, xs0, off, dy0, dx0 = [a.numpy() for a in t]
        # single copy: the window starts at the patch corner exactly
        assert (off == 0).all()
        np.testing.assert_array_equal(dx0, np.maximum(px - rad - 1, 0) - px)
        np.testing.assert_array_equal(dy0, np.maximum(py - rad - 1, 0) - py)
        np.testing.assert_array_equal(xs0, np.maximum(px - rad - 1, 0))


@pytest.mark.parametrize("copies", [2, 4])
def test_expand_plain_vs_pallas_interpret(copies):
    """expand_lane_copies_plain against the JAX package's Pallas kernel in
    interpret mode on the same base slab: pure data movement, so exact."""
    rng = np.random.default_rng(copies)
    base = rng.normal(0, 1, (48, 384)).astype(np.float32)
    calls = dict(TE.plain_calls)
    launches = dict(TE.launches)
    t = TE.expand_lane_copies(torch.from_numpy(base), copies)  # CPU -> plain
    assert TE.plain_calls["expand_lane_copies"] \
        == calls["expand_lane_copies"] + 1
    assert TE.launches == launches
    j = JE.expand_lane_copies(jnp.asarray(base), copies, interpret=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    step = 128 // copies
    c = copies - 1
    np.testing.assert_array_equal(t.numpy()[c * 48:(c + 1) * 48,
                                            :384 - c * step],
                                  base[:, c * step:])
    assert (t.numpy()[c * 48:(c + 1) * 48, 384 - c * step:] == 0).all()


def test_expand_wrapper_never_falls_back_and_window_lanes():
    base = torch.zeros((8, 256))
    with pytest.raises(ValueError):             # the kernel needs the card
        TE.expand_lane_copies_cuda(base, 2)
    with pytest.raises(ValueError):
        TE.expand_lane_copies(base, 2, impl="cuda")
    with pytest.raises(ValueError):
        TE.expand_lane_copies_plain(base, 3)
    with pytest.raises(ValueError):             # width not a multiple of 128
        TE.expand_lane_copies_plain(torch.zeros((8, 200)), 2)
    with pytest.raises(ValueError):
        TE.expand_lane_copies_plain(base.to(torch.float64), 2)
    # A patch of radius r is 2(r+1)+1 columns wide and starts up to
    # 128/copies - 1 columns into its window.
    assert TF.window_lanes(1, 38) == 128
    assert TF.window_lanes(4, 38) == 128        # 31 + 79
    assert TF.window_lanes(2, 38) == 256        # 63 + 79
    assert TF.window_lanes(2, 16) == 128        # 63 + 35


def _rel(a, b):
    return np.max(np.abs(a - b) / (np.abs(a) + 1e-3), axis=1)


def test_orientation_kernel_plain_vs_pallas_interpret(setup):
    """The SAME arrays through orientation_hist_fused(interpret=True) and
    orientation_hist_plain.  rel < 1e-4 on in-contract rows (f32
    accumulation order only), finite everywhere — the limits of
    tests/test_fused.py:90-92."""
    s = setup
    slab = _tslab(s, 4)
    k = _tk(s)
    ys0, xs0, par, rows, lanes = TO.orientation_params(
        slab, k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["valid"], s["tcfg"])
    assert tuple(par.shape) == (K, TFS.NPAR) == (K, JFS.NPAR)
    assert lanes == 128
    plain = TFS.orientation_hist_plain(slab.values, ys0, xs0, par, rows)
    rmax_o = TO.max_ori_radius(s["tcfg"])
    fused = JFS.orientation_hist_fused(
        jnp.asarray(slab.values.numpy()), jnp.asarray(ys0.numpy()),
        jnp.asarray(xs0.numpy()), jnp.asarray(par.numpy()), rows,
        pack=JFS.pack_factor(rmax_o), interpret=True)
    a, b = np.asarray(fused), plain.numpy()
    assert np.isfinite(b).all()
    live = s["kp"]["valid"]
    # In contract = descriptor radius <= 38, which also keeps the
    # orientation radius inside its window (tests/test_fused.py:89-91);
    # out-of-contract rows are truncated differently by the two window
    # layouts and only have to stay finite.
    assert _rel(a, b)[s["inc"] & live].max() < 1e-4
    assert (b[~live] == 0).all()
    # count gating: rows past the live count stay zero, rows before it
    # are unchanged.
    cnt = torch.tensor(K // 2, dtype=torch.int32)
    gated = TFS.orientation_hist_plain(slab.values, ys0, xs0, par, rows,
                                       count=cnt).numpy()
    np.testing.assert_array_equal(gated[:K // 2], b[:K // 2])
    assert (gated[K // 2:] == 0).all()


@pytest.mark.parametrize("copies,win_lanes", [(4, 128), (2, 256)])
def test_descriptor_kernel_plain_vs_pallas_interpret(setup, copies,
                                                     win_lanes):
    """The SAME arrays through descriptor_fused(interpret=True) at both
    window widths and descriptor_hist_plain, then finalize +
    quantize("opencv"): |diff| <= 1 uint8 in every radius range and <= 10%
    of entries differing at all (tests/test_fused.py:109-116: f32
    accumulation order; one unit is the reference's own descriptor
    tolerance)."""
    s = setup
    slab = _tslab(s, copies)
    k = _tk(s)
    ys0, xs0, par, rows, lanes = TD.descriptor_params(
        slab, k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["angle"], k["valid"], s["tcfg"])
    assert lanes == win_lanes      # the window width the slab's copies need
    plain = TFS.descriptor_hist_plain(slab.values, ys0, xs0, par, rows,
                                      lanes=win_lanes)
    fused = JFS.descriptor_fused(
        jnp.asarray(slab.values.numpy()), jnp.asarray(ys0.numpy()),
        jnp.asarray(xs0.numpy()), jnp.asarray(par.numpy()), rows,
        pack=1, interpret=True, win_lanes=win_lanes)
    qj = np.asarray(JD.quantize_descriptor(
        *JD.finalize_descriptor(fused), "opencv"))
    qt = TD.quantize_descriptor(*TD.finalize_descriptor(plain),
                                "opencv").numpy()
    assert np.isfinite(qt).all()
    diff = np.abs(qj - qt).max(axis=1)
    live = s["kp"]["valid"]
    for name, m in s["classes"].items():
        assert diff[m & live].max() <= 1.0, name
    assert (np.abs(qj - qt)[s["inc"]] > 0).mean() < 0.1
    # start/count window: only rows [start, start+count) are computed.
    st, cn = 10, 20
    sub = TFS.descriptor_hist_plain(slab.values, ys0, xs0, par, rows,
                                    lanes=win_lanes, count=cn,
                                    start=torch.tensor(st)).numpy()
    np.testing.assert_array_equal(sub[st:st + cn], plain.numpy()[st:st + cn])
    assert (sub[:st] == 0).all() and (sub[st + cn:] == 0).all()


def test_atan2_polynomial_matches_jax_kernel():
    rng = np.random.default_rng(3)
    dy = rng.normal(0, 30, 20000).astype(np.float32)
    dx = rng.normal(0, 30, 20000).astype(np.float32)
    dy[:4], dx[:4] = [0, 0, 1, -1], [0, -2, 0, 0]
    t = TFS._atan2_deg(torch.from_numpy(dy), torch.from_numpy(dx)).numpy()
    j = np.asarray(JFS._atan2_deg(jnp.asarray(dy), jnp.asarray(dx)))
    # Same polynomial, same evaluation order: last-bit agreement.
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-5)
    assert t[0] == 0.0 and np.isfinite(t).all()
    ref = np.degrees(np.arctan2(dy.astype(np.float64), dx.astype(np.float64)))
    assert np.abs(t - ref).max() < 1e-4


def test_wrappers_dispatch_by_device_and_never_fall_back(setup):
    s = setup
    slab = _tslab(s, 1)
    k = _tk(s)
    ys0, xs0, par, rows, lanes = TO.orientation_params(
        slab, k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["valid"], s["tcfg"])
    launches = dict(TFS.launches)
    plain = dict(TFS.plain_calls)
    TFS.orientation_hist(slab.values, ys0, xs0, par, rows)   # CPU -> plain
    TFS.descriptor_hist(slab.values, ys0, xs0, par, 88)
    assert TFS.launches == launches
    assert TFS.plain_calls == {n: c + 1 for n, c in plain.items()}
    for fn in (TFS.orientation_hist_cuda, TFS.descriptor_hist_cuda):
        with pytest.raises(ValueError):
            fn(slab.values, ys0, xs0, par, rows)
    with pytest.raises(ValueError):
        TFS.orientation_hist(slab.values, ys0, xs0, par, rows, impl="cuda")
    with pytest.raises(ValueError):         # slab too small for the window
        TFS.orientation_hist_plain(slab.values[:16], ys0, xs0, par, rows)
    with pytest.raises(ValueError):         # wrong dtype
        TFS.orientation_hist_plain(slab.values, ys0.to(torch.int64), xs0,
                                   par, rows)
