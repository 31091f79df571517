"""PyTorch port vs the JAX package: per-keypoint window extraction
(kernels/window_gather.py) and the window-loading experiment
(perf/window_proto.py).

The JAX side runs the window copy through its plain reference
(``ops/flatpyr._xla_windows``, what ``gather_impl="xla"`` takes: the Pallas
kernel of ``sift_tpu/kernels/window_gather.py`` has no interpret switch);
the experiment's Pallas kernels (``scripts/dma_proto.py``: ``p0``, ``p0b``,
``p1``) run in interpret mode, ``pallas_call`` patched for the test's
duration.  The port runs the plain versions of its CUDA kernels.  The window
copy is pure data movement and integer arithmetic, held EXACTLY; the column
sums are held against the JAX script within float32 rounding and against a
float32 numpy row-by-row sum bit for bit; the strip kernels' bucket plan
(``strip_plan``) is held exactly.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

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
    assert WP.SWEEP == ((8, 4, 8), (8, 8, 8), (8, 4, 24), (16, 4, 24),
                        (8, 4, 36), (4, 6, 36), (4, 2, 72), (8, 2, 72),
                        (16, 2, 72))
    assert WP.RING_DEFAULT == (8, 2, None) and (8, 2, 72) in WP.SWEEP
    assert WP.ring_band(72, None) == 72 and WP.ring_band(72, 24) == 24
    for bk, nbuf, band in WP.SWEEP:         # every point fits the kernel
        WP.check_ring(wl["rows"], bk, nbuf, band)
    if not torch.cuda.is_available():
        assert WP.main([]) == 1             # the experiment needs the card


@pytest.mark.parametrize("band_rows", [8, 24, 36, 72])
def test_window_colsum_plain_at_ring_band_sizes(band_rows):
    """The ring's dispatcher on CPU tensors at the experiment's 72-row
    windows and each band size the TMA ring takes: the plain version
    against a float64 numpy column sum (atol 1e-4: float32 sums of 72
    normal values in another order); rows past ``count`` zero."""
    slab, ys0, xs0, par, rows, live = _proto_inputs(seed=band_rows, h=160,
                                                    rows=72)
    t = torch.from_numpy
    got = WP.window_colsum_ring(t(slab), t(ys0), t(xs0), rows,
                                torch.tensor([live], dtype=torch.int32),
                                block_k=8, nbuf=2, band_rows=band_rows)
    want = _numpy_colsum(slab, ys0, xs0, rows, live)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert not got[live:].any()


def test_ring_layout_and_tensor_map():
    """Host-side arithmetic of the TMA ring, exactly: the block's shared
    memory, the tensor-map arguments, and the arguments it refuses."""
    # nbuf slots of band x 512 B + [2, block_k] x 512 B of warp sums +
    # 16 B of mbarriers per slot + 128 B of alignment slack.
    assert WP.ring_smem_bytes(8, 2, 72) == 2 * 36864 + 8192 + 32 + 128
    assert WP.ring_smem_bytes(8, 4, 24) == 57536
    assert WP.ring_smem_bytes(4, 6, 36) == 114912
    assert WP.ring_smem_bytes(16, 4, 24) == 65728
    assert WP.ROW_BYTES == 512
    src = (WP.build.CSRC / "window_proto.cu").read_text()
    assert "#define RING_ROW_BYTES (WP_LANES * 4)" in src
    assert WP.ring_tensor_map(1536, 1024, 72) == dict(
        global_dim=(1024, 1536), global_stride_bytes=(4096,),
        box_dim=(128, 72), element_strides=(1, 1), box_bytes=36864)
    assert WP.ring_tensor_map(96, 384, 8)["global_stride_bytes"] == (1536,)
    for bad in ((1536, 1022, 8), (1536, 64, 8), (1536, 1024, 257),
                (1536, 1024, 0), (16, 1024, 24)):
        with pytest.raises(ValueError):
            WP.ring_tensor_map(*bad)
    WP.check_ring(72, 32, 1, 72)
    for bad in (dict(band_rows=16),          # 72 % 16 != 0
                dict(band_rows=0), dict(nbuf=0), dict(block_k=33),
                dict(nbuf=7, band_rows=72)):  # 7 x 36,864 B > 227 KB
        args = {**dict(rows=72, block_k=8, nbuf=2, band_rows=24), **bad}
        with pytest.raises(ValueError):
            WP.check_ring(**args)
    with pytest.raises(ValueError):         # 300-row bands: no TMA box
        WP.check_ring(300, 8, 1, 300)
    t = torch.from_numpy
    slab, ys0, xs0, par, rows, live = _proto_inputs()
    with pytest.raises(ValueError):         # the dispatcher checks too
        WP.window_colsum_ring(t(slab), t(ys0), t(xs0), rows, live,
                              band_rows=16)


# ---------------------------------------------------------------------------
# The window-loading experiment against the JAX script, in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dma_proto():
    """scripts/dma_proto.py as a module (it is a script, not a package)."""
    path = Path(__file__).resolve().parent.parent / "scripts" / "dma_proto.py"
    spec = importlib.util.spec_from_file_location("dma_proto", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (script function, block_k, nbuf, slab h, slab w, rows, K, live)
JAX_CASES = {
    "p0_bk8": ("p0", 8, None, 64, 256, 24, 24, 13),
    "p0b_bk4": ("p0b", 4, None, 96, 384, 24, 20, 13),
    "p0b_bk8": ("p0b", 8, None, 160, 256, 72, 24, 11),
    "p1_bk8_nbuf2": ("p1", 8, 2, 96, 384, 24, 24, 13),
    "p1_bk4_nbuf3": ("p1", 4, 3, 160, 384, 72, 20, 9),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_window_colsum_plain_matches_jax_script(case, dma_proto,
                                                monkeypatch):
    """The plain version (and its ``par`` variant at the script's block)
    against the JAX script's kernels run by the Pallas interpreter, on live
    rows only (the script leaves the others unspecified): atol 1e-4, rtol
    1e-5 (float32 sums of up to 72 normal values in another order)."""
    fn, block_k, nbuf, h, w, rows, k, live = JAX_CASES[case]
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(len(case))
    slab = rng.normal(size=(h, w)).astype(np.float32)
    ys0 = (rng.integers(0, (h - rows) // 8 + 1, k) * 8).astype(np.int32)
    xs0 = (rng.integers(0, (w - 128) // 128 + 1, k) * 128).astype(np.int32)
    par = rng.normal(size=(k, 16)).astype(np.float32)
    j = lambda a: jnp.asarray(a)
    cnt = jnp.int32(live)
    if fn == "p0":
        want = dma_proto.p0(j(slab), j(ys0), j(xs0), rows, cnt, block_k)
    elif fn == "p0b":
        want = dma_proto.p0b(j(slab), j(ys0), j(xs0), j(par), rows, cnt,
                             block_k)
    else:
        want = dma_proto.p1(j(slab), j(ys0), j(xs0), rows, cnt, block_k,
                            nbuf)
    t = torch.from_numpy
    count = torch.tensor([live], dtype=torch.int32)
    if fn == "p0b":
        got = WP.window_colsum_par(t(slab), t(ys0), t(xs0), t(par), rows,
                                   count, block_k=block_k)
    else:
        got = WP.window_colsum_static(t(slab), t(ys0), t(xs0), rows, count,
                                      block_k=block_k)
    want = np.asarray(want)
    assert want.shape == (k, 128)
    np.testing.assert_allclose(got[:live].numpy(), want[:live], rtol=1e-5,
                               atol=1e-4)
    assert not got[live:].any()


# ---------------------------------------------------------------------------
# The row-ordered plain version and the strip kernels' bucket plan
# ---------------------------------------------------------------------------


def _rowwise(slab, ys0, xs0, rows, live, par=None, block_k=8):
    """float32 numpy: each window summed row by row, 0 + row 0 + row 1 +
    ..., origins clamped (columns aligned down to 4), ``par`` added last."""
    h, w = slab.shape
    y0 = np.clip(ys0.astype(np.int64), 0, h - rows)
    x0 = np.clip(xs0.astype(np.int64), 0, w - 128) // 4 * 4
    cols = x0[:, None] + np.arange(128)
    acc = np.zeros((len(ys0), 128), np.float32)
    for i in range(rows):
        acc = acc + slab[(y0 + i)[:, None], cols]
    if par is not None:
        first = np.arange(len(ys0)) % block_k == 0
        acc[first] = acc[first] + par[first, :1]
    acc[live:] = 0
    return acc


def _wild_workload():
    """The workload's slab and shapes with origins in and around the slab,
    columns not aligned: every clamp binds somewhere."""
    wl = WP.workload("cpu")
    rng = np.random.default_rng(7)
    k = wl["ys0"].shape[0]
    wl["ys0"] = torch.from_numpy(
        rng.integers(-100, WP.H + 100, k).astype(np.int32))
    wl["xs0"] = torch.from_numpy(
        rng.integers(-100, WP.W + 100, k).astype(np.int32))
    return wl


SETS = {"uniform": lambda: WP.workload("cpu"),
        "clustered": lambda: WP.clustered_workload("cpu"),
        "wild_origins": _wild_workload}


@pytest.mark.parametrize("with_par", [False, True])
@pytest.mark.parametrize("label", list(SETS))
def test_window_colsum_plain_is_row_ordered_float32(label, with_par):
    """The plain version equals a float32 numpy row-by-row accumulation bit
    for bit at the workload's shapes (what the strip kernels compute, so
    that they are held with torch.equal on the card)."""
    wl = SETS[label]()
    live = int(wl["count"])
    a = (wl["slab"], wl["ys0"], wl["xs0"], wl["rows"], wl["count"])
    if with_par:
        got = WP.window_colsum_plain(*a, wl["par"], 8,
                                     name="window_colsum_par")
    else:
        got = WP.window_colsum_plain(*a)
    want = _rowwise(wl["slab"].numpy(), wl["ys0"].numpy(), wl["xs0"].numpy(),
                    wl["rows"], live,
                    wl["par"].numpy() if with_par else None)
    assert np.array_equal(got.numpy(), want)


def _check_plan(plan, ys0, xs0, h, w, rows, strip_rows, chunk):
    geom, live, n = plan["geometry"], plan["live"], plan["n_items"]
    y0, x0 = WP.clamp_origins(ys0[:live], xs0[:live], h, w, rows)
    key = (y0 // strip_rows) * geom["tiles_x"] + x0 // 128
    items = plan["items"].long()
    assert items.shape == (n, 3) and n == int((-(-plan["bucket_count"].long()
                                                 // chunk)).sum())
    assert n <= -(-live // chunk) + geom["n_buckets"] <= geom["grid"]
    assert ((items[:, 2] >= 1) & (items[:, 2] <= chunk)).all()
    assert (items[1:, 0] >= items[:-1, 0]).all()            # key order
    assert int(plan["bucket_count"].sum()) == live
    # Every live window in exactly one item, of its own key, index order
    # inside a key, and inside the item's box.
    seen = torch.zeros(live, dtype=torch.int64)
    order = plan["order"].long()
    for (b, first, m), box, loads in zip(items.tolist(), plan["box"].tolist(),
                                        plan["loads"].tolist()):
        win = order[first:first + m]
        seen[win] += 1
        assert (key[win] == b).all() and (win[1:] > win[:-1]).all()
        assert torch.equal(plan["origin"][first:first + m].long(),
                           torch.stack([y0[win], x0[win]], 1))
        ymin, xmin, box_rows, box_cols = box
        assert ymin == int(y0[win].min()) and xmin == int(x0[win].min())
        assert ymin + box_rows == int(y0[win].max()) + rows <= h
        assert xmin + box_cols == int(x0[win].max()) + 128 <= w
        assert box_rows <= strip_rows + rows - 1 and box_cols <= 252
        # One buffer load holds load_rows rows of the box, and the loads
        # cover it.
        load_rows = min(box_rows, geom["buf_rows"] * 128 // box_cols)
        assert 1 <= load_rows and load_rows * box_cols <= geom["buf_rows"] * 128
        assert loads == -(-box_rows // load_rows)
    assert (seen == 1).all()
    return items


@pytest.mark.parametrize("point", WP.STRIP_SWEEP,
                         ids=[f"T{t}_C{c}_W{w}" for t, c, w in WP.STRIP_SWEEP])
def test_strip_plan_partitions_the_workload(point):
    """At every sweep point: each live window in exactly one item, items
    within their bound, every box of 128-aligned origins one buffer load of
    at most strip_rows + rows - 1 rows x 128 columns."""
    t, c, nw = point
    wl = WP.workload("cpu")
    plan = WP.strip_plan(wl["ys0"], wl["xs0"], wl["count"], WP.H, WP.W,
                         wl["rows"], t, c, nw)
    _check_plan(plan, wl["ys0"], wl["xs0"], WP.H, WP.W, wl["rows"], t, c)
    assert (plan["loads"] == 1).all() and (plan["box"][:, 3] == 128).all()
    assert plan["geometry"]["smem_bytes"] <= WP.BLOCK_SMEM_MAX


@pytest.mark.parametrize("label", ["clustered", "wild_origins",
                                   "out_of_contract", "none_live",
                                   "all_live", "tiny_slab"])
def test_strip_plan_on_other_sets(label):
    """The clustered set (2 keys of 540 windows: many items per key),
    unaligned out-of-range origins, windows taller than the buffer
    (several loads), no live window, every window live, and a slab one
    window high and wide."""
    t, c, nw = WP.STRIP_DEFAULT
    h, w = WP.H, WP.W
    if label == "out_of_contract":
        wl = WP.out_of_contract_workload("cpu")
    elif label == "tiny_slab":
        rng = np.random.default_rng(5)
        h, w = 24, 128
        wl = dict(ys0=torch.from_numpy(rng.integers(-9, 30, 37).astype(
            np.int32)), xs0=torch.from_numpy(rng.integers(-9, 9, 37).astype(
                np.int32)), rows=24, count=30)
    else:
        wl = SETS.get(label, SETS["uniform"])()
    count = {"none_live": 0, "all_live": wl["ys0"].shape[0]}.get(
        label, wl["count"])
    plan = WP.strip_plan(wl["ys0"], wl["xs0"], count, h, w, wl["rows"], t,
                         c, nw)
    items = _check_plan(plan, wl["ys0"], wl["xs0"], h, w, wl["rows"], t, c)
    if label == "clustered":
        assert plan["n_items"] == 2 * -(-540 // c)
        assert set(items[:, 0].tolist()) == {2, 10}
        assert (plan["loads"] == 1).all()
    if label == "out_of_contract":
        assert plan["geometry"]["buf_rows"] == 453 < t + wl["rows"] - 1
        assert int(plan["loads"].max()) >= 2
    if label == "none_live":
        assert plan["n_items"] == 0 and plan["order"].numel() == 0


def test_strip_geometry_arithmetic():
    """Host-side arithmetic of the strip design, exactly: keys, grid,
    buffer rows, shared memory of both blocks and the scratch words, as
    csrc/window_proto.cu computes them; and the arguments it refuses."""
    g = WP.strip_geometry(5000, 1536, 1024, 72, 64, 8, 4)
    assert g == dict(
        design="strip_owner", strip_rows=64, chunk=8, warps=4, tiles_x=8,
        n_buckets=23 * 8, max_items=625 + 184, grid=809, buf_rows=135,
        smem_bytes=135 * 512 + 20 * 8 + 16, bucket_grid=184,
        bucket_threads=256, bucket_smem_bytes=4 * (64 + 3 * 5000 + 184 + 34),
        scratch_words=4 * 809 + 4 + 2 * 184 + 3 * 5000)
    assert g["smem_bytes"] == 69296 and 3 * g["smem_bytes"] < 228 * 1024
    assert WP.strip_geometry(5000, 1536, 1024, 72, 128, 16, 8)[
        "smem_bytes"] == 199 * 512 + 336
    # Windows taller than the buffer: as many rows as fit beside the
    # metadata.
    assert WP.strip_geometry(5000, 1536, 1024, 440, 64, 8, 8)[
        "buf_rows"] == (227 * 1024 - 176) // 512
    assert WP.strip_geometry(1, 1, 128, 1, 1, 1, 1)["buf_rows"] == 2
    # A bucket block's shared memory grows with keys and windows (too
    # many windows are refused below).
    assert WP.strip_geometry(5000, 4096, 2048, 8, 32, 8, 8)[
        "bucket_smem_bytes"] == 4 * (64 + 3 * 5000 + 128 * 16 + 34)
    src = (WP.build.CSRC / "window_proto.cu").read_text()
    for text in ("#define WP_SMEM_MAX (227 * 1024)",
                 f"#define STRIP_META {WP.STRIP_META}\n",
                 f"#define STRIP_MAXM {WP.STRIP_MAXM}\n",
                 f"#define BUCKET_WARPS {WP.BUCKET_WARPS}\n",
                 "return buf_rows * RING_ROW_BYTES + STRIP_META * chunk + 16;",
                 "int r = strip_rows + rows - 1;",
                 f"#define BUCKET_WARPS {WP.BUCKET_WARPS}\n",
                 "4ll * (64 + 3ll * k_cap + n_buckets + 2 + 32);",
                 "g->max_items = (k_cap + chunk - 1) / chunk + g->n_buckets;"):
        assert text in src
    for bad in (dict(chunk=0), dict(chunk=17), dict(warps=0),
                dict(warps=33), dict(strip_rows=0), dict(w=1022),
                dict(w=64), dict(rows=2000), dict(k=20000)):
        args = {**dict(k=5000, h=1536, w=1024, rows=72, strip_rows=64,
                       chunk=8, warps=8), **bad}
        with pytest.raises(ValueError):
            WP.strip_geometry(**args)


def test_plan_views_and_plan_matches():
    """The scratch layout the launch reads back (``plan_views``) holds the
    plan ``strip_plan`` computes, and ``plan_matches`` sees one changed
    window."""
    wl = WP.workload("cpu")
    plan = WP.strip_plan(wl["ys0"], wl["xs0"], wl["count"], WP.H, WP.W,
                         wl["rows"], *WP.STRIP_DEFAULT)
    g, k, n, live = plan["geometry"], 5000, plan["n_items"], plan["live"]
    scratch = torch.full((g["scratch_words"],), -7, dtype=torch.int32)
    v = WP.plan_views(scratch, g, k)
    v["items"][:n, :3] = plan["items"]
    v["n_items"].fill_(n)
    v["bucket_count"][:] = plan["bucket_count"]
    v["bucket_start"][:] = plan["bucket_start"]
    v["order"][:live] = plan["order"]
    v["origin"][:live] = plan["origin"]
    assert v["order"].shape == (k,) and v["items"].shape == (g["max_items"], 4)
    assert v["origin"].shape == (k, 2)
    # As a launch fills its ``plan`` argument: the views and the geometry.
    assert WP.plan_matches(dict(WP.plan_views(scratch, g, k), geometry=g),
                           plan)
    v["order"][3] += 1
    assert not WP.plan_matches(v, plan)


def test_strip_wrappers_contract():
    """The strip kernels' wrappers refuse CPU tensors and bad geometry; the
    dispatchers take the plain version on the CPU and launch nothing."""
    slab, ys0, xs0, par, rows, live = _proto_inputs()
    t = torch.from_numpy
    for fn in (lambda: WP.window_colsum_static_cuda(t(slab), t(ys0), t(xs0),
                                                    rows, live),
               lambda: WP.window_colsum_par_cuda(t(slab), t(ys0), t(xs0),
                                                 t(par), rows, live,
                                                 chunk=4, warps=4),
               lambda: WP.window_colsum_par(t(slab), t(ys0), t(xs0), t(par),
                                            rows, live, impl="cuda")):
        with pytest.raises(ValueError):
            fn()
    launched = dict(WP.launches)
    before = WP.plain_calls["window_colsum_static"]
    got = WP.window_colsum_static(t(slab), t(ys0), t(xs0), rows, live)
    assert WP.plain_calls["window_colsum_static"] == before + 1
    assert WP.launches == launched
    assert np.array_equal(got.numpy(), _rowwise(slab, ys0, xs0, rows, live))
    assert WP.STRIP_DEFAULT in WP.STRIP_SWEEP and len(WP.STRIP_SWEEP) == 13


def test_window_ablation_patches_apply(tmp_path):
    """Every ablation variant of the strip kernels patches the source it
    names (the substitutions still match the kernel)."""
    from sift_tpu_torch.perf import window_ablation as WA
    kept = (WA.build.CSRC / "window_proto.cu").read_text()
    for name in WA.VARIANTS:
        src = (WA.variant_source(name, tmp_path / name)
               / "window_proto.cu").read_text()
        assert (src == kept) == (name == "kept")
    assert "sift_wp_prof" in (tmp_path / "phase_counters" / "csrc"
                              / "window_proto.cu").read_text()
