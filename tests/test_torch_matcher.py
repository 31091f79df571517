"""PyTorch port vs the JAX package: brute-force matching, on the same numpy
descriptors and end to end on a warped image pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q, S = 300, 400


@pytest.fixture(scope="module")
def descs():
    """uint8 descriptors with structure: a third of the queries are noisy
    copies of train rows (true matches), some are exact duplicates of
    each other and of train rows (ties), the rest are unrelated."""
    rng = np.random.default_rng(0)
    train = rng.integers(0, 120, (S, 128)).astype(np.uint8)
    query = rng.integers(0, 120, (Q, 128)).astype(np.uint8)
    src = rng.permutation(S)[:100]
    noisy = train[src].astype(np.int32) + rng.integers(-6, 7, (100, 128))
    query[:100] = np.clip(noisy, 0, 255).astype(np.uint8)
    train[5] = train[6]                    # duplicate train rows: a tie
    query[100] = train[5]
    query[101] = query[102] = train[50]    # duplicate queries
    qv = rng.uniform(size=Q) > 0.1
    tv = rng.uniform(size=S) > 0.1
    return query, train, qv, tv


def _both(query, train, qv=None, tv=None, ratio=0.8):
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.from_numpy(a)
    mj = np.asarray(sift_tpu.match_brute_force(j(query), j(train), j(qv),
                                               j(tv), ratio=ratio))
    mt = stt.match_brute_force(t(query), t(train), t(qv), t(tv),
                               ratio=ratio)
    assert mt.dtype == torch.int32 and tuple(mt.shape) == (len(query),)
    return mj, mt.numpy()


@pytest.mark.parametrize("masks", ["none", "both", "query", "train"])
def test_match_uint8_identical_to_jax(descs, masks):
    """uint8 path: every distance is an exact integer below 2^24 in both
    packages, so the indices are IDENTICAL, ties included (both argmins
    return the first minimum)."""
    query, train, qv, tv = descs
    qv = qv if masks in ("both", "query") else None
    tv = tv if masks in ("both", "train") else None
    mj, mt = _both(query, train, qv, tv)
    np.testing.assert_array_equal(mt, mj)
    assert (mt >= 0).sum() > 50
    if qv is not None:
        assert (mt[~qv] == -1).all()
    if tv is not None:
        assert tv[mt[mt >= 0]].all()


@pytest.mark.parametrize("ratio", [0.6, 0.8, 1.0])
def test_match_float_identical_to_jax(descs, ratio):
    """float path on integer-valued float32 descriptors (what the
    detector stores with descriptor_dtype="float32"): after the 0.25
    pre-scale every product is a multiple of 1/16 below 2^24/16 — exact
    in f32 — so the indices are identical here too."""
    query, train, qv, tv = descs
    mj, mt = _both(query.astype(np.float32), train.astype(np.float32),
                   qv, tv, ratio=ratio)
    np.testing.assert_array_equal(mt, mj)
    mu, _ = _both(query, train, qv, tv, ratio=ratio)
    np.testing.assert_array_equal(mt, mu)       # same answer as uint8


def test_match_all_train_invalid_and_pairs(descs):
    query, train, qv, tv = descs
    none = stt.match_brute_force(torch.from_numpy(query),
                                 torch.from_numpy(train),
                                 t_valid=torch.zeros(S, dtype=torch.bool))
    assert (none == -1).all()
    qi, ti = stt.match_pairs(torch.from_numpy(query),
                             torch.from_numpy(train), cross_check=True)
    jq, jt = sift_tpu.match_pairs(jnp.asarray(query), jnp.asarray(train),
                                  cross_check=True)
    np.testing.assert_array_equal(qi, jq)
    np.testing.assert_array_equal(ti, jt)
    assert len(qi) > 50
    qi2, ti2 = stt.match_pairs(torch.from_numpy(query),
                               torch.from_numpy(train))
    assert len(qi2) >= len(qi)


def test_match_end_to_end_on_image_pair(test_image_pair):
    """The port's matches on the port's own descriptors of two views
    agree with sift_tpu.match_brute_force on the same arrays for 100 % of
    queries, and match more than 20 of them."""
    a, b, _ = test_image_pair
    h, w = a.shape
    det = stt.SiftDetector(stt.SiftConfig(width=w, height=h,
                                          num_features=512), device="cpu")
    ra = det.detect_and_compute(a)
    rb = det.detect_and_compute(b)
    assert det.prev_descriptors is ra.descriptors
    mt = stt.match_brute_force(rb.descriptors, ra.descriptors,
                               rb.keypoints.valid, ra.keypoints.valid)
    mj = sift_tpu.match_brute_force(
        jnp.asarray(rb.descriptors.numpy()),
        jnp.asarray(ra.descriptors.numpy()),
        jnp.asarray(rb.keypoints.valid.numpy()),
        jnp.asarray(ra.keypoints.valid.numpy()))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int((mt >= 0).sum()) > 20
    # matched keypoints really are the same scene points: the warp is a
    # 5-degree rotation about the centre with a small shift (the disc
    # scene repeats itself, so a share of ratio-test matches is false).
    import cv2
    m = cv2.getRotationMatrix2D((w / 2, h / 2), 5.0, 1.02)
    m[:, 2] += (3.0, -2.0)
    q = np.nonzero(mt.numpy() >= 0)[0]
    t = mt.numpy()[q]
    pa = np.stack([ra.keypoints.x.numpy()[t], ra.keypoints.y.numpy()[t],
                   np.ones(len(t))], 1) @ m.T
    pb = np.stack([rb.keypoints.x.numpy()[q], rb.keypoints.y.numpy()[q]], 1)
    assert (np.linalg.norm(pa - pb, axis=1) < 3.0).mean() > 0.5


def test_bench_image_is_deterministic_and_textured():
    from sift_tpu_torch.perf.benchimg import bench_image
    a = bench_image(120, 160, seed=0)
    b = bench_image(120, 160, seed=0)
    c = bench_image(120, 160, seed=1)
    assert a.dtype == np.float32 and a.shape == (120, 160)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() == 0.0 and abs(a.max() - 255.0) < 1e-3
    det = stt.SiftDetector(stt.SiftConfig(width=160, height=120,
                                          num_features=256), device="cpu")
    assert int(det.detect_and_compute(a).count) > 30


@pytest.mark.parametrize("route", ["f32", "tensor_cores"])
def test_gram_routes_exact_on_uint8_extremes(route):
    """The Gram helper's routes are exact float32 products of integer
    descriptors: on all-255 rows (the largest value, 128 * 255^2 =
    8,323,200, which a bfloat16 RESULT would round to 8,323,072) and on
    mixed extremes, equal to the int64 product.  On the CPU the
    tensor-core route runs its arithmetic (bf16 operands, f32 result) as
    an f32 product of the bf16 values."""
    from sift_tpu_torch.pipeline.matcher import gram_u8
    rng = np.random.default_rng(3)
    q = rng.choice([0, 1, 127, 128, 254, 255], (64, 128)).astype(np.uint8)
    t = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    q[:8] = 255
    t[:8] = 255
    want = q.astype(np.int64) @ t.astype(np.int64).T
    got = gram_u8(torch.from_numpy(q), torch.from_numpy(t), route)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert want[0, 0] == 128 * 255 * 255
    # what a bfloat16 result loses at that size
    assert float(torch.tensor(float(want[0, 0])).to(torch.bfloat16)) \
        != want[0, 0]
    # batched train axis
    tt = np.stack([t, t[::-1]])
    gb = gram_u8(torch.from_numpy(q), torch.from_numpy(tt), route)
    np.testing.assert_array_equal(gb[1].numpy().astype(np.int64),
                                  want[:, ::-1])
    with pytest.raises(ValueError):
        gram_u8(torch.from_numpy(q), torch.from_numpy(t), "bf16")


def test_match_batched_train_axis_equals_loop_and_jax_vmap(descs):
    """One query set against a [C, S, 128] stack of train sets (the loop
    closure's call): equal to a Python loop of single calls, and to the
    JAX package's jax.vmap(match_brute_force, in_axes=(None, 0, None, 0)),
    zero-padded candidates included."""
    import functools

    import jax
    query, train, qv, tv = descs
    rng = np.random.default_rng(4)
    stack = np.stack([train, train[rng.permutation(S)],
                      np.zeros_like(train)])
    tvs = np.stack([tv, tv[rng.permutation(S)], np.zeros(S, bool)])
    mt = stt.match_brute_force(torch.from_numpy(query),
                               torch.from_numpy(stack),
                               torch.from_numpy(qv), torch.from_numpy(tvs))
    assert tuple(mt.shape) == (3, Q) and mt.dtype == torch.int32
    for c in range(3):
        one = stt.match_brute_force(torch.from_numpy(query),
                                    torch.from_numpy(stack[c]),
                                    torch.from_numpy(qv),
                                    torch.from_numpy(tvs[c]))
        assert torch.equal(mt[c], one)
    assert (mt[2] == -1).all() and (mt[0] >= 0).sum() > 50
    mj = jax.vmap(functools.partial(sift_tpu.match_brute_force, ratio=0.8),
                  in_axes=(None, 0, None, 0))(
        jnp.asarray(query), jnp.asarray(stack), jnp.asarray(qv),
        jnp.asarray(tvs))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # float descriptors take the same batched path
    mf = stt.match_brute_force(torch.from_numpy(query.astype(np.float32)),
                               torch.from_numpy(stack.astype(np.float32)),
                               torch.from_numpy(qv), torch.from_numpy(tvs))
    assert torch.equal(mf, mt)


# -- the kernel's contract, held on its plain version ----------------------

def _exact(query, train, qv=None, tv=None, ratio=0.8):
    """Reference semantics in float64 numpy: masked train rows at 1e9,
    min1 at its first column, min2 the smallest over the other columns,
    the test in float32, -1 where it fails or the query is masked."""
    q = query.astype(np.float64)
    t = train.astype(np.float64)
    d = (q * q).sum(-1)[:, None] + (t * t).sum(-1)[None, :] - 2.0 * q @ t.T
    if tv is not None:
        d = np.where(tv[None, :], d, 1e9)
    i1 = d.argmin(-1)
    rows = np.arange(len(q))
    m1 = d[rows, i1]
    d[rows, i1] = 1e9
    m2 = d.min(-1)
    ok = m1.astype(np.float32) < np.float32(ratio) * m2.astype(np.float32)
    if qv is not None:
        ok &= qv
    return np.where(ok, i1, -1)


def _plain(query, train, qv=None, tv=None, ratio=0.8):
    from sift_tpu_torch.kernels.match import match_u8_plain
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = match_u8_plain(t(query), t(train), t(qv), t(tv), ratio).numpy()
    # the matcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        stt.match_brute_force(t(query), t(train), t(qv), t(tv), ratio)
        .numpy(), out)
    return out


def _rows(n, seed, hi=120):
    return np.random.default_rng(seed).integers(0, hi, (n, 128)) \
        .astype(np.uint8)


@pytest.mark.parametrize("ratio", [0.8, 1.0, 1.5])
def test_plain_tie_for_the_nearest_row(ratio):
    """Two equal train rows nearest to the query: min2 == min1, so the
    test fails at a ratio up to 1; above it the first of the two columns
    matches."""
    train = _rows(40, 1)
    train[7] = train[23]
    query = np.stack([train[23], train[5]])
    query[0, :3] += 2                     # min1 == min2 == 12, not 0
    got = _plain(query, train, ratio=ratio)
    np.testing.assert_array_equal(got, _exact(query, train, ratio=ratio))
    assert got[0] == (7 if ratio > 1.0 else -1) and got[1] == 5


@pytest.mark.parametrize("valid", ["none", "one", "one_of_one"])
def test_plain_masked_train_rows(valid):
    """All train rows masked: min1 == min2 == 1e9 and nothing matches.
    Exactly one valid row (of 50, or S = 1): min2 is the 1e9 sentinel, so
    every valid query matches that row, however far it is."""
    train = _rows(50, 2)
    query = _rows(30, 3)
    tv = np.zeros(50, bool)
    if valid == "one":
        tv[17] = True
    elif valid == "one_of_one":
        train, tv = train[17:18], np.ones(1, bool)
    qv = np.arange(30) % 4 != 0
    got = _plain(query, train, qv, tv)
    np.testing.assert_array_equal(got, _exact(query, train, qv, tv))
    if valid == "none":
        assert (got == -1).all()
    else:
        want = 0 if valid == "one_of_one" else 17
        np.testing.assert_array_equal(got, np.where(qv, want, -1))


@pytest.mark.parametrize("masked", [False, True])
def test_plain_single_train_row(masked):
    """S = 1: min2 is the sentinel; a masked row matches nothing."""
    train = _rows(1, 4)
    query = np.concatenate([train, _rows(9, 5)])
    tv = np.array([not masked])
    got = _plain(query, train, None, tv)
    np.testing.assert_array_equal(got, _exact(query, train, None, tv))
    np.testing.assert_array_equal(got, np.full(10, -1 if masked else 0))


def test_plain_largest_distance():
    """All-0 queries against all-255 rows reach 128 * 255^2 = 8,323,200,
    exact in float32; one nearer row beats it, a tie of two does not."""
    train = np.full((6, 128), 255, np.uint8)
    query = np.zeros((3, 128), np.uint8)
    query[1] = 255
    train[4, :64] = 0                     # distance 64 * 255^2 from query 0
    got = _plain(query, train)
    np.testing.assert_array_equal(got, _exact(query, train))
    assert got[0] == 4                    # 4,161,600 < 0.8 * 8,323,200
    assert got[1] == -1                   # five rows at distance 0
    d = (query[2].astype(np.int64) - train[0].astype(np.int64)) ** 2
    assert d.sum() == 128 * 255 * 255 and got[2] == 4


def test_plain_query_broadcast_over_a_stack_equals_a_loop():
    """One [Q, 128] query set against a [3, S, 128] stack with [3, S]
    masks: each slice equals a single call and the float64 reference."""
    query = _rows(60, 6)
    stack = np.stack([_rows(70, 7), _rows(70, 8), _rows(70, 9)])
    stack[1, :30] = query[:30]
    rng = np.random.default_rng(10)
    tvs = rng.uniform(size=(3, 70)) < 0.7
    qv = rng.uniform(size=60) < 0.9
    from sift_tpu_torch.kernels.match import match_u8_plain
    out = match_u8_plain(torch.from_numpy(query), torch.from_numpy(stack),
                         torch.from_numpy(qv), torch.from_numpy(tvs))
    assert tuple(out.shape) == (3, 60) and out.dtype == torch.int32
    for c in range(3):
        np.testing.assert_array_equal(
            out[c].numpy(), _plain(query, stack[c], qv, tvs[c]))
        np.testing.assert_array_equal(
            out[c].numpy(), _exact(query, stack[c], qv, tvs[c]))
    assert (out[1] >= 0).sum() > 10


@pytest.mark.parametrize("shape", ["q", "sets_q"])
def test_plain_query_mask_shapes(shape):
    """q_valid as [Q] (shared by every set) and as [..., Q] (one row of
    the mask a set), with [2, Q, 128] queries against [2, S, 128] sets."""
    queries = np.stack([_rows(40, 11), _rows(40, 12)])
    sets = np.stack([_rows(50, 13), _rows(50, 14)])
    sets[0, :20] = queries[0, :20]
    sets[1, 10:30] = queries[1, :20]
    rng = np.random.default_rng(15)
    qv = rng.uniform(size=(2, 40)) < 0.6
    if shape == "q":
        qv = qv[0]
    from sift_tpu_torch.kernels.match import match_u8_plain
    out = match_u8_plain(torch.from_numpy(queries), torch.from_numpy(sets),
                         torch.from_numpy(qv)).numpy()
    for c in range(2):
        m = qv if shape == "q" else qv[c]
        np.testing.assert_array_equal(out[c],
                                      _exact(queries[c], sets[c], m))
        assert (out[c][~m] == -1).all() and (out[c] >= 0).sum() > 5


@pytest.mark.parametrize("shapes", [
    [(), (3,), (1,)], [(2, 1), (5,)], [(4, 1, 3), (1, 6, 1), ()],
    [(1,), (1,)], [(0,), (1,)]])
def test_kernel_wrapper_broadcast_equals_torch(shapes):
    """The wrapper's set axes: the broadcast of the query's, the train
    set's and the masks' leading shapes, as torch.broadcast_shapes gives
    it (without that function's first-call import)."""
    from sift_tpu_torch.kernels.match import _broadcast
    assert _broadcast(*shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_kernel_wrapper_sets_and_refusals():
    """``_sets`` lays a tensor out as sets a stride apart (0: one copy
    serves every set), and ``match_u8_cuda`` refuses what the kernel does
    not take: CPU tensors, other dtypes, another width, unbroadcastable
    set axes."""
    from sift_tpu_torch.kernels.match import _broadcast, _sets, match_u8_cuda
    q = torch.arange(2 * 3 * 128).reshape(2, 3, 128).to(torch.uint8)
    x, stride = _sets(q[0], (2,), (3, 128))
    assert stride == 0 and x.shape == (3, 128)
    x, stride = _sets(q, (2,), (3, 128))
    assert stride == 3 * 128 and x.data_ptr() == q.data_ptr()
    x, stride = _sets(q[:1], (4,), (3, 128))
    assert stride == 0 and torch.equal(x, q[0])
    x, stride = _sets(q[None], (5, 2), (3, 128))
    assert stride == 3 * 128 and x.shape == (5, 2, 3, 128)
    assert torch.equal(x[4, 1], q[1])
    with pytest.raises(ValueError):
        _broadcast((2,), (3,))
    for bad in (q, q.to(torch.int32), q[..., :64]):
        with pytest.raises(ValueError):
            match_u8_cuda(bad, bad)
