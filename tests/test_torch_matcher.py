"""PyTorch port vs the JAX package: brute-force matching, on the same numpy
descriptors and end to end on a warped image pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt

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
