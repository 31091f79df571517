"""PyTorch port vs the JAX package: per-keypoint window extraction
(kernels/window_gather.py) and the window-loading experiment
(perf/window_proto.py).

The JAX side runs the window copy through its plain reference
(``ops/flatpyr._xla_windows``, what ``gather_impl="xla"`` takes: the Pallas
kernel has no interpret switch); the port runs the plain versions of its
CUDA kernels.  Pure data movement and integer arithmetic: everything here
is held EXACTLY.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.kernels import window_gather as JW
from sift_tpu.ops import flatpyr as JF
from sift_tpu_torch.kernels import window_gather as TW
from sift_tpu_torch.perf import window_proto as WP

# (L, Hp, Wp, rows, radius): a slab with room, one narrower than a window,
# one lower than a window, one smaller both ways.
SHAPES = {
    "roomy": (6, 120, 384, 48, 16),
    "narrow": (4, 64, 128, 40, 12),
    "low": (3, 16, 384, 48, 16),
    "tiny": (2, 8, 128, 88, 38),
}


def _centres(rng, hp, wp, k):
    """Keypoint centres all over the slab, and pinned at / past its rim so
    that cy - r is negative and the clamps bind."""
    cy = rng.integers(0, hp, k).astype(np.int32)
    cx = rng.integers(0, wp, k).astype(np.int32)
    cy[:4] = (0, hp - 1, 0, hp - 1)
    cx[:4] = (0, wp - 1, wp - 1, 0)
    return cy, cx


@pytest.mark.parametrize("shape", list(SHAPES))
def test_window_rows_and_origins_match_jax(shape):
    l, hp, wp, rows, radius = SHAPES[shape]
    assert TW.window_rows(radius) == JW.window_rows(radius)
    assert (TW.LANES, TW.SUBLANE) == (JW.LANES, JW.SUBLANE)
    rng = np.random.default_rng(3)
    cy, cx = _centres(rng, hp, wp, 64)
    lidx = rng.integers(-2, l + 2, 64).astype(np.int32)
    j = JW.window_origins((l, hp, wp), jnp.asarray(lidx), jnp.asarray(cy),
                          jnp.asarray(cx), rows, radius)
    t = TW.window_origins((l, hp, wp), torch.from_numpy(lidx),
                          torch.from_numpy(cy), torch.from_numpy(cx), rows,
                          radius)
    for a, b in zip(j, t):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())   # exact
    assert (t[1].numpy() % 8 == 0).all() and (t[2].numpy() % 128 == 0).all()


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gather_windows_plain_matches_jax_reference(shape, lanes):
    """gather_windows_plain == _xla_windows on the slab zero-padded to hold
    one window (what both JAX paths do), exactly, including a slab smaller
    than one window and origins at the clamp."""
    l, hp, wp, rows, radius = SHAPES[shape]
    rng = np.random.default_rng(4)
    values = rng.normal(size=(l, hp, wp)).astype(np.float32)
    k = 37                                  # not a multiple of anything
    cy, cx = _centres(rng, hp, wp, k)
    lidx, ys0, xs0 = TW.window_origins(
        (l, hp, wp), torch.from_numpy(rng.integers(0, l, k).astype(np.int32)),
        torch.from_numpy(cy), torch.from_numpy(cx), rows, radius)
    if lanes == 128:
        xs0 = torch.clamp(xs0, max=max(wp, lanes) - lanes)
    got = TW.gather_windows_plain(torch.from_numpy(values), lidx, ys0, xs0,
                                  rows, lanes)
    assert tuple(got.shape) == (k, rows, lanes)
    v = jnp.pad(jnp.asarray(values), ((0, 0), (0, max(0, rows - hp)),
                                      (0, max(0, lanes - wp))))
    want = JF._xla_windows(v, jnp.asarray(lidx.numpy()),
                           jnp.asarray(ys0.numpy()),
                           jnp.asarray(xs0.numpy()), rows, lanes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # exact
    # ... and equal to a numpy loop over windows.
    vp = np.asarray(v)
    for i in (0, 1, k - 1):
        y, x = int(ys0[i]), int(xs0[i])
        np.testing.assert_array_equal(
            got[i].numpy(), vp[int(lidx[i]), y:y + rows, x:x + lanes])


def test_gather_windows_outside_the_slab_reads_zero():
    """Out of contract (an origin past the slab, a layer index out of
    range): elements outside read 0 and the layer index is clamped — what
    the CUDA kernel does, so the two agree on every input."""
    values = torch.arange(2 * 8 * 128, dtype=torch.float32).reshape(2, 8, 128)
    i32 = lambda *a: torch.tensor(a, dtype=torch.int32)
    got = TW.gather_windows_plain(values, i32(5, -1), i32(8, 0),
                                  i32(0, 128), 8, 128)
    assert not got.any()
    got = TW.gather_windows_plain(values, i32(5), i32(0), i32(0), 8, 128)
    np.testing.assert_array_equal(got[0].numpy(), values[1].numpy())


def test_gather_windows_wrapper_contract():
    values = torch.zeros((2, 16, 128))
    idx = torch.zeros((3,), dtype=torch.int32)
    launches = dict(TW.launches)
    plain = TW.plain_calls["gather_windows"]
    out = TW.gather_windows(values, idx, idx, idx, 8, 128)   # CPU -> plain
    assert tuple(out.shape) == (3, 8, 128)
    assert TW.plain_calls["gather_windows"] == plain + 1
    assert TW.launches == launches
    with pytest.raises(ValueError):         # no silent plain fallback
        TW.gather_windows(values, idx, idx, idx, 8, 128, impl="cuda")
    with pytest.raises(ValueError):         # the kernel needs CUDA tensors
        TW.gather_windows_cuda(values, idx, idx, idx, 8, 128)
    for bad in (dict(rows=7), dict(lanes=100)):
        with pytest.raises(ValueError):
            TW.gather_windows_plain(values, idx, idx, idx,
                                    **{"rows": 8, "lanes": 128, **bad})
    with pytest.raises(ValueError):         # int64 origins
        TW.gather_windows_plain(values, idx.long(), idx, idx, 8, 128)
    with pytest.raises(ValueError):
        TW.gather_windows_plain(values[0], idx, idx, idx, 8, 128)


# ---------------------------------------------------------------------------
# The window-loading experiment: plain version against a numpy loop
# ---------------------------------------------------------------------------


def _proto_inputs(seed=0, h=96, w=384, rows=24, k=41, live=17):
    rng = np.random.default_rng(seed)
    slab = rng.normal(size=(h, w)).astype(np.float32)
    ys0 = (rng.integers(0, (h - rows) // 8, k) * 8).astype(np.int32)
    xs0 = (rng.integers(0, (w - 128) // 128 + 1, k) * 128).astype(np.int32)
    par = rng.normal(size=(k, 16)).astype(np.float32)
    return slab, ys0, xs0, par, rows, live


def _numpy_colsum(slab, ys0, xs0, rows, live, par=None, block_k=8):
    out = np.zeros((len(ys0), 128), np.float32)
    for i in range(live):
        win = slab[ys0[i]:ys0[i] + rows, xs0[i]:xs0[i] + 128]
        out[i] = win.astype(np.float64).sum(0)
        if par is not None and i % block_k == 0:
            out[i] += par[i, 0]
    return out


@pytest.mark.parametrize("scheme", ["static", "par", "ring"])
def test_window_colsum_plain_matches_numpy_loop(scheme):
    """The dispatchers on CPU tensors take the plain version.  Against a
    float64 numpy loop: atol 1e-4 (float32 sums of 24 normal values in
    another order); rows at or past ``count`` exactly zero."""
    slab, ys0, xs0, par, rows, live = _proto_inputs()
    t = torch.from_numpy
    count = torch.tensor([live], dtype=torch.int32)
    name = f"window_colsum_{scheme}"
    before = WP.plain_calls[name]
    if scheme == "static":
        got = WP.window_colsum_static(t(slab), t(ys0), t(xs0), rows, count)
        want = _numpy_colsum(slab, ys0, xs0, rows, live)
    elif scheme == "par":
        got = WP.window_colsum_par(t(slab), t(ys0), t(xs0), t(par), rows,
                                   count, block_k=4)
        want = _numpy_colsum(slab, ys0, xs0, rows, live, par, block_k=4)
    else:
        got = WP.window_colsum_ring(t(slab), t(ys0), t(xs0), rows, live,
                                    block_k=16, nbuf=2)
        want = _numpy_colsum(slab, ys0, xs0, rows, live)
    assert WP.plain_calls[name] == before + 1
    assert not any(WP.launches.values())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert not got[live:].any()


def test_window_proto_contract_and_workload():
    slab, ys0, xs0, par, rows, live = _proto_inputs()
    t = torch.from_numpy
    with pytest.raises(ValueError):         # CUDA kernels need CUDA tensors
        WP.window_colsum_static_cuda(t(slab), t(ys0), t(xs0), rows, live)
    with pytest.raises(ValueError):
        WP.window_colsum_ring(t(slab), t(ys0), t(xs0), rows, live,
                              impl="cuda")
    with pytest.raises(ValueError):
        WP.window_colsum_plain(t(slab), t(ys0), t(xs0), rows, live,
                               block_k=33)
    with pytest.raises(ValueError):         # par of the wrong width
        WP.window_colsum_plain(t(slab), t(ys0), t(xs0), rows, live,
                               t(par[:, :8].copy()))
    # Out-of-contract origins are clamped into the slab, never read past it.
    far = np.full_like(ys0, 10_000)
    got = WP.window_colsum_plain(t(slab), t(far), t(far), rows, live)
    np.testing.assert_allclose(
        got[0].numpy(), slab[-rows:, -128:].astype(np.float64).sum(0),
        atol=1e-4)
    # The experiment's workload is the JAX script's.
    wl = WP.workload("cpu")
    assert tuple(wl["slab"].shape) == (1536, 1024) and wl["rows"] == 72
    assert wl["ys0"].shape == (5000,) and int(wl["count"]) == 1080
    assert (wl["ys0"] % 8 == 0).all() and (wl["xs0"] % 128 == 0).all()
    assert int((wl["ys0"] + 72).max()) <= 1536
    assert WP.SWEEP == ((8, 2), (8, 4), (8, 8), (16, 4), (32, 2), (32, 4))
    if not torch.cuda.is_available():
        assert WP.main([]) == 1             # the experiment needs the card
