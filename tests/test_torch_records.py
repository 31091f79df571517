"""PyTorch port vs the JAX package: the record field (plain version of the
detect kernel), stream compaction, candidates, the Newton walk and its
finalize.  The port runs on the CPU; inputs are numpy arrays handed to
both packages — in particular the JAX package's own pyramid.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from sift_tpu.ops import compact as jcompact
from sift_tpu.ops import records as jrec
from sift_tpu.ops.pyramid import gaussian_pyramid as jax_gaussian_pyramid
from sift_tpu_torch.config import SIFT_IMG_BORDER
from sift_tpu_torch.kernels import fused_detect as FD
from sift_tpu_torch.ops import records as trec
from sift_tpu_torch.ops.compact import stream_compact


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pyr(test_image):
    """The JAX package's own pyramid of the 320x240 test frame, numpy,
    and its record fields.  Both jitted, as the JAX detector runs them:
    one compile per octave shape instead of one per eager op (the
    pyramid is bit-equal to the eager one; the records differ from eager
    ones on a few pixels of octave 0, which the walk and candidate tests
    take as input on both sides)."""
    h, w = test_image.shape
    jcfg = sift_tpu.SiftConfig(width=w, height=h)
    jplan = sift_tpu.build_plan(jcfg)
    gauss = [np.array(g) for g in jax.jit(
        lambda im: jax_gaussian_pyramid(jplan, im))(jnp.asarray(test_image))]
    records = jax.jit(lambda g: jrec.records_jnp(g, jcfg).values)
    jrecs = [jrec.OctaveRecords(values=records(jnp.asarray(g)),
                                h=g.shape[1], w=g.shape[2]) for g in gauss]
    return jcfg, jplan, gauss, jrecs


def _plain(g, cfg):
    return FD.detect_records_plain(
        [torch.from_numpy(g)], float(cfg.peak_threshold), SIFT_IMG_BORDER,
        float(cfg.edge_threshold), float(cfg.contrast_threshold),
        cfg.num_octave_layers)[0]


def _hold_records(ref, got, o):
    """A port record field ``got`` [3, L, h, w] against a JAX one, with the
    limits of tests/test_records.py:44-66."""
    ho, wo = ref.h, ref.w
    a = np.asarray(ref.values[:, :, 1:ho - 1, 1:wo - 1],
                   np.float64).astype(np.int64)
    b = got[:, :, 1:ho - 1, 1:wo - 1].numpy().astype(np.float64) \
        .astype(np.int64)
    # All five decision bits of A (conv, div, edge, peak, contrast_ok)
    # agree exactly: same f32 expressions in both packages.
    np.testing.assert_array_equal(a[0] % 32, b[0] % 32,
                                  err_msg=f"octave {o} flag bits")
    # Payloads sit one round() away from raw f32 values: Cramer-ratio
    # cancellation noise (XLA may fuse/contract differently from eager
    # PyTorch) can flip a quantisation step on rare ill-conditioned
    # pixels, always by one quantum.
    n = a[0].size
    assert (a[0] != b[0]).sum() <= max(3, n // 100_000)
    assert (a[1] != b[1]).sum() <= max(30, n // 5_000)
    assert (a[2] != b[2]).sum() <= max(80, n // 2_000)
    conv = (a[0] % 2).astype(bool)
    for ch, quanta in ((1, (1, 2047, 2048, 2049)),
                       (2, (1, 1023, 1024, 1025))):
        d = np.abs(np.where(conv, a[ch] - b[ch], 0))
        bad = d[d > 0]
        assert np.isin(bad, quanta).all() or bad.size == 0, \
            f"octave {o} ch {ch}: non-unit quant diffs on conv"
    # The peak bit is masked to the border interior in both packages, so
    # it agrees on the rim too.
    full_a = np.asarray(ref.values[0, :, :ho, :wo]).astype(np.int64)
    full_b = got[0].numpy().astype(np.int64)
    np.testing.assert_array_equal((full_a >> 3) & 1, (full_b >> 3) & 1)


# Octave 0 (240x320), octave 2 (60x80: under the 64 rows / 128 columns
# below which the JAX package never runs its kernel), octave 4 (15x20).
@pytest.mark.parametrize("o", [0, 2, 4])
def test_detect_records_plain_matches_records_jnp(pyr, o):
    """Against records_jnp run eagerly, op by op as PyTorch runs the plain
    version (the jitted field of ``pyr`` fuses differently)."""
    jcfg, _, gauss, _ = pyr
    tcfg = stt.SiftConfig(width=jcfg.width, height=jcfg.height)
    ref = jrec.records_jnp(jnp.asarray(gauss[o]), jcfg)
    ho, wo = ref.h, ref.w
    got = _plain(gauss[o], tcfg)
    assert tuple(got.shape) == (3, tcfg.num_octave_layers, ho, wo)
    assert torch.isfinite(got).all()
    _hold_records(ref, got, o)


@pytest.fixture(scope="module")
def small_pyr():
    """The JAX package's pyramid of a 64x48 frame: six octaves, down to
    1x2."""
    from conftest import synthetic_image
    img = synthetic_image(height=48, width=64, seed=5, n_blobs=6)
    jcfg = sift_tpu.SiftConfig(width=64, height=48)
    gauss = [np.array(g) for g in jax_gaussian_pyramid(
        sift_tpu.build_plan(jcfg), jnp.asarray(img))]
    return jcfg, gauss


def test_detect_records_pyramid_plain_equals_per_octave_and_jax(small_pyr):
    """The pyramid-wide entry point (ONE plain call for all octaves)
    equals the per-octave calls bit for bit on every octave, rim included,
    and the JAX package's records_jnp / detect_records("pallas_interpret")
    under the limits of tests/test_records.py:44-54."""
    jcfg, gauss = small_pyr
    tcfg = stt.SiftConfig(width=64, height=48)
    tg = [torch.from_numpy(g) for g in gauss]
    # Jitted: one compile per octave shape instead of one per eager op.
    # Below 64 rows the JAX entry point falls back to records_jnp, so it is
    # held on octave 0 only.
    jnp_ref = jax.jit(lambda g: jrec.records_jnp(g, jcfg).values)
    entry_ref = jax.jit(lambda g: jrec.detect_records(
        g, jcfg, "pallas_interpret").values)
    assert [tuple(g.shape[1:]) for g in tg][-1] == (1, 2)
    calls = FD.plain_calls["detect_records"]
    recs = trec.detect_records_pyramid(tg, tcfg)       # CPU -> plain
    assert FD.plain_calls["detect_records"] == calls + 1
    assert len(recs) == len(tg)
    for o, (g, rec) in enumerate(zip(tg, recs)):
        assert (rec.h, rec.w) == tuple(g.shape[1:])
        one = trec.detect_records(g, tcfg)
        assert torch.equal(rec.values, one.values), f"octave {o}"
        assert torch.isfinite(rec.values).all()
        for ref in (jnp_ref, entry_ref)[:2 if o == 0 else 1]:
            _hold_records(jrec.OctaveRecords(ref(jnp.asarray(gauss[o])),
                                             rec.h, rec.w), rec.values, o)
    assert FD.plain_calls["detect_records"] == calls + 1 + len(tg)


@pytest.mark.parametrize("shapes", [
    ((480, 752), (240, 376), (120, 188), (60, 94), (30, 47), (15, 23),
     (7, 11), (3, 5), (1, 2)),         # the flagship pyramid
    ((1, 2),), ((2, 1),), ((1, 1),),
    ((1, 2), (2, 1), (9, 33), (8, 32)),  # not in size order
    ((8, 32), (8, 32), (16, 1)),         # ties keep list order
])
def test_octave_table_layout(shapes):
    """The kernel's block table: largest octave first (ties in list
    order), each octave owns ceil(w/32) * ceil(h/8) consecutive blocks,
    and the ranges tile [0, total) exactly."""
    rows, total = FD.octave_table(shapes)
    assert sorted(r[0] for r in rows) == list(range(len(shapes)))
    tiles = {o: -(-w // FD.TILE_W) * -(-h // FD.TILE_H)
             for o, (h, w) in enumerate(shapes)}
    order = [r[0] for r in rows]
    assert order == sorted(range(len(shapes)), key=lambda o: -tiles[o])
    nxt = 0
    for o, first, tx in rows:
        assert first == nxt and tx == -(-shapes[o][1] // FD.TILE_W)
        nxt += tiles[o]
    assert total == nxt == sum(tiles.values())
    with pytest.raises(ValueError):
        FD.octave_table(tuple(shapes) + ((0, 4),))


@pytest.mark.parametrize("h,w", [(7, 11), (3, 5), (1, 2), (12, 12)])
def test_detect_records_plain_tiny_octaves(h, w):
    """Octaves with no interior (the 5-px border leaves nothing): every
    peak bit is 0, the field is finite and of natural shape."""
    rng = np.random.default_rng(h * 100 + w)
    g = rng.uniform(0, 255, (6, h, w)).astype(np.float32)
    cfg = stt.SiftConfig(width=320, height=240)
    got = _plain(g, cfg)
    assert tuple(got.shape) == (3, 3, h, w) and torch.isfinite(got).all()
    peak = (got[0].numpy().astype(np.int64) >> 3) & 1
    if h <= 10 or w <= 10:
        assert peak.sum() == 0
    rec = trec.records_torch(torch.from_numpy(g), cfg)
    x, y, l, v = trec.candidates_from_records(rec, 16)
    assert int(v.sum()) == int(peak.sum()) or int(v.sum()) == 16


def test_pack_decode_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    n = 4000
    x = [rng.normal(0, s, n).astype(np.float32) for s in (0.4, 0.4, 0.3)]
    x[0][:50] *= 200.0                         # saturating steps
    # exact halves pin the rounding mode (half to EVEN in both packages
    # and in the CUDA kernel's rintf; half-up would give 1, 2, 3, ...)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 4.5],
                      np.float32)
    for v in x:
        v[50:58] = halves
    contrast = rng.uniform(0, 0.3, n).astype(np.float32)
    flags = rng.integers(0, 8, n).astype(np.float32)
    peak = rng.uniform(size=n) < 0.1
    cok = rng.uniform(size=n) < 0.5
    ja = jrec.pack_record_channels(*[jnp.asarray(v) for v in x],
                                   jnp.asarray(contrast), jnp.asarray(flags),
                                   jnp.asarray(peak), jnp.asarray(cok))
    ta = trec.pack_record_channels(*[torch.from_numpy(v) for v in x],
                                   torch.from_numpy(contrast),
                                   torch.from_numpy(flags),
                                   torch.from_numpy(peak),
                                   torch.from_numpy(cok))
    for j, t in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    sx = trec.decode_steps(ta[0])[2][0].numpy()[50:58]
    np.testing.assert_array_equal(sx, [0, 2, 2, 0, -2, -2, 4, 4])
    jc, jd, js = jrec.decode_steps(ja[0])
    tc, td, ts = trec.decode_steps(ta[0])
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    for j, t in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    for j, t in zip(jrec.decode_final(*ja), trec.decode_final(*ta)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("n,cap,p,seed", [
    (100, 16, 0.3, 0),       # n <= 128: the JAX single-block path
    (128, 200, 1.0, 1),      # cap > count, all set
    (100, 16, 0.0, 2),       # none set
    (5000, 256, 0.05, 3),    # n not a multiple of 2048
    (5000, 256, 0.9, 4),     # more set bits than cap
    (4096, 512, 0.5, 5),     # exact multiple of the JAX superblock
    (70000, 1000, 0.01, 6),
])
def test_stream_compact_equals_jax(n, cap, p, seed):
    """Exact: ``valid`` everywhere, ``idx`` on the valid slots (dead
    slots are unspecified in the JAX package, 0 in the port)."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=n) < p
    ji, jv = jcompact.stream_compact(jnp.asarray(mask), cap)
    ti, tv = stream_compact(torch.from_numpy(mask), cap)
    assert ti.dtype == torch.int32 and tv.dtype == torch.bool
    assert tuple(ti.shape) == (cap,)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy()[jv], np.asarray(ji)[jv])
    assert (ti.numpy()[~jv] == 0).all()
    assert int(jv.sum()) == min(int(mask.sum()), cap)


def _port_records(jrecs, padded=False):
    """The JAX record fields as port OctaveRecords: cropped to the
    natural shape (the port's layout) or left padded (addressed through
    the strides)."""
    out = []
    for r in jrecs:
        v = np.asarray(r.values)
        if not padded:
            v = np.ascontiguousarray(v[:, :, :r.h, :r.w])
        out.append(trec.OctaveRecords(values=torch.from_numpy(v.copy()),
                                      h=r.h, w=r.w))
    return out


def test_candidates_from_records_exact(pyr):
    jcfg, jplan, gauss, jrecs = pyr
    tcfg = stt.SiftConfig(width=jcfg.width, height=jcfg.height)
    total = 0
    for o in range(4):
        cap = jplan.octaves[o].cand_cap
        ref = jrec.candidates_from_records(jrecs[o], cap)
        # from the port's OWN plain record field of the same pyramid
        own = trec.records_torch(torch.from_numpy(gauss[o]), tcfg)
        for rec in (own, _port_records(jrecs)[o],
                    _port_records(jrecs, padded=True)[o]):
            got = trec.candidates_from_records(rec, cap)
            m = np.asarray(ref[3])
            np.testing.assert_array_equal(got[3].numpy(), m)
            for name, a, b in zip("xyl", ref[:3], got[:3]):
                np.testing.assert_array_equal(
                    np.asarray(a)[m], b.numpy()[m],
                    err_msg=f"octave {o} {name}")
        total += int(m.sum())
    assert total > 50


def _walk_both(jcfg, jplan, jrecs, num_features, padded=False):
    jc = sift_tpu.SiftConfig(width=jcfg.width, height=jcfg.height,
                             num_features=num_features)
    tc = stt.SiftConfig(width=jcfg.width, height=jcfg.height,
                        num_features=num_features)
    no = jcfg.num_octaves
    jcands = [jrec.candidates_from_records(jrecs[o],
                                           jplan.octaves[o].cand_cap)
              for o in range(no)]
    trecs = _port_records(jrecs, padded)
    tcands = [trec.candidates_from_records(trecs[o],
                                           jplan.octaves[o].cand_cap)
              for o in range(no)]
    jst, jflat = jrec.walk_records_positions(jrecs, jcands, jc)
    tst, tflat = trec.walk_records_positions(trecs, tcands, tc)
    n_valid = int(sum(np.asarray(c[3]).sum() for c in jcands))
    total_cap = sum(c[0].shape[0] for c in jcands)
    return jc, tc, jst, jflat, tst, tflat, jcands, n_valid, total_cap


@pytest.mark.parametrize("padded", [False, True])
def test_walk_positions_exact_and_finalize(pyr, padded):
    jcfg, jplan, gauss, jrecs = pyr
    jc, tc, jst, jflat, tst, tflat, jcands, n_valid, total_cap = \
        _walk_both(jcfg, jplan, jrecs, 5000, padded)
    assert total_cap <= 2 * 5000               # no global cap here
    live = np.concatenate([np.asarray(c[3]) for c in jcands])
    # Walk decisions are exact; positions are compared on live candidates
    # (a dead slot's start position is unspecified in the JAX package).
    np.testing.assert_array_equal(tst.ok.numpy(), np.asarray(jst.ok))
    np.testing.assert_array_equal(tst.octv.numpy(), np.asarray(jst.octv))
    for f in ("l", "r", "c"):
        np.testing.assert_array_equal(getattr(tst, f).numpy()[live],
                                      np.asarray(getattr(jst, f))[live],
                                      err_msg=f)
    assert int(tst.ok.sum()) > 30

    jref, joct = jrec.finalize_walk(jflat, jst, jst.ok, jc)
    tref, toct = trec.finalize_walk(tflat, tst, tst.ok, tc)
    m = np.asarray(jref.valid)
    np.testing.assert_array_equal(tref.valid.numpy(), m)
    np.testing.assert_array_equal(toct.numpy()[m], np.asarray(joct)[m])
    # The tolerances of tests/test_records.py:107-118 (packing quanta:
    # x0/x1 at 1/2000 px in octave coords, x2 at 1/1000, response at
    # 1/8191); both packages decode the same planes, so these are loose.
    scale = 2.0 ** np.asarray(joct, np.float64)[m]
    tol = {"x": scale * 6e-4, "y": scale * 6e-4, "layer": 0.0, "xi": 6e-4,
           "response": 7e-5}
    for f, t in tol.items():
        d = np.abs(np.asarray(getattr(jref, f), np.float64)[m]
                   - getattr(tref, f).numpy().astype(np.float64)[m])
        assert (d <= t + 1e-9).all(), (f, d.max())
    # size goes through pow(2, .): rtol 2e-4 as in test_records.py:117.
    np.testing.assert_allclose(tref.size.numpy()[m],
                               np.asarray(jref.size)[m], rtol=2e-4)


def test_walk_global_candidate_cap_branch(pyr):
    """num_features small enough that the summed candidate capacity
    exceeds 2*num_features: both packages compact candidates first."""
    jcfg, jplan, gauss, jrecs = pyr
    jc, tc, jst, jflat, tst, tflat, jcands, n_valid, total_cap = \
        _walk_both(jcfg, jplan, jrecs, 96)
    gcap = 2 * 96
    assert total_cap > gcap, "cap branch not exercised"
    assert tuple(tst.ok.shape) == (gcap,) == tuple(jst.ok.shape)
    np.testing.assert_array_equal(tst.ok.numpy(), np.asarray(jst.ok))
    live = np.arange(gcap) < min(n_valid, gcap)   # compaction: valid-first
    for f in ("l", "r", "c", "octv"):
        np.testing.assert_array_equal(getattr(tst, f).numpy()[live],
                                      np.asarray(getattr(jst, f))[live],
                                      err_msg=f)
    assert int(tst.ok.sum()) > 10
    tref, _ = trec.walk_records_all(
        _port_records(jrecs),
        [trec.candidates_from_records(r, jplan.octaves[o].cand_cap)
         for o, r in enumerate(_port_records(jrecs))], tc)
    jref, _ = jrec.walk_records_all(jrecs, jcands, jc)
    np.testing.assert_array_equal(tref.valid.numpy(), np.asarray(jref.valid))


def test_detect_records_dispatch_by_device():
    g = torch.zeros((6, 16, 16))
    cfg = stt.SiftConfig(width=16, height=16)
    before = dict(FD.plain_calls), dict(FD.launches)
    rec = trec.detect_records(g, cfg, "auto")      # CPU tensor -> plain
    assert rec.values.shape == (3, 3, 16, 16)
    assert FD.plain_calls["detect_records"] == \
        before[0]["detect_records"] + 1
    assert FD.launches == before[1]                # no kernel was launched
    with pytest.raises(ValueError):
        trec.detect_records(g, cfg, "cuda")        # never a silent fallback
    with pytest.raises(ValueError):
        trec.detect_records_pyramid([g, g[:, :8, :8]], cfg, "cuda")
    for octaves in ([g], [g, g[:, :4, :2].contiguous()]):
        with pytest.raises(ValueError):            # the list form too
            FD.detect_records_cuda(octaves, 1.0, 5, 10.0, 0.04, 3)
    with pytest.raises(ValueError):                # mixed layer counts
        FD.detect_records_plain([g, g[:5]], 1.0, 5, 10.0, 0.04, 3)
    assert FD.launches == before[1]
