"""PyTorch port vs the JAX package: the compaction variants of
``ops/compact.py`` (``mask_compact``, ``topk_compact``,
``gather_keypoint_fields``) on the same seeded numpy inputs, held EXACTLY
(indices and validity equal, slot for slot): ``lax.top_k`` breaks ties by
lowest index and the port's stable descending sort does the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sift_tpu.core.types import Keypoints as JKeypoints
from sift_tpu.ops import compact as JC
from sift_tpu_torch.core.convert import keypoints_from_numpy
from sift_tpu_torch.ops import compact as TC


def _both(jout, tout):
    """Every slot equal, dead ones included (both sides put the lowest
    unselected indices there)."""
    ji, jv = (np.asarray(a) for a in jout)
    ti, tv = (a.numpy() for a in tout)
    assert ti.dtype == np.int32 and tv.dtype == np.bool_
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    return ti, tv


@pytest.mark.parametrize("n,cap,p,seed", [
    (100, 16, 0.3, 0),
    (100, 16, 0.0, 1),
    (100, 200, 1.0, 2),
    (3000, 128, 0.1, 7),
    (5000, 256, 0.9, 4),
])
def test_mask_compact_matches_stream_compact_and_jax(n, cap, p, seed):
    mask = np.random.default_rng(seed).uniform(size=n) < p
    ti, tv = _both(JC.mask_compact(jnp.asarray(mask), cap),
                   TC.mask_compact(torch.from_numpy(mask), cap))
    si, sv = TC.stream_compact(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(sv.numpy(), tv)
    np.testing.assert_array_equal(si.numpy()[sv.numpy()], ti[tv])


def test_topk_compact_small():
    score = np.array([5.0, 1.0, 3.0, 9.0, 2.0], np.float32)
    valid = np.array([True, True, False, True, True])
    ti, tv = _both(JC.topk_compact(jnp.asarray(score), jnp.asarray(valid), 3),
                   TC.topk_compact(torch.from_numpy(score),
                                   torch.from_numpy(valid), 3))
    assert tv.all()
    np.testing.assert_array_equal(ti, [3, 0, 4])


@pytest.mark.parametrize("n,cap,p,seed", [(20000, 64, 0.5, 8),
                                          (9000, 100, 0.02, 9)])
def test_topk_compact_large(n, cap, p, seed):
    """The tiled path (n > 4 * max(tile, cap)): equal to JAX slot for
    slot, and — no tile holding more than ``per_tile`` of the winners —
    the selected set is the exact top ``cap``."""
    rng = np.random.default_rng(seed)
    score = rng.standard_normal(n).astype(np.float32)
    valid = rng.uniform(size=n) < p
    ti, tv = _both(JC.topk_compact(jnp.asarray(score), jnp.asarray(valid),
                                   cap),
                   TC.topk_compact(torch.from_numpy(score),
                                   torch.from_numpy(valid), cap))
    ref = np.argsort(-np.where(valid, score, -np.inf), kind="stable")[:cap]
    np.testing.assert_array_equal(np.sort(ti[tv]), np.sort(ref))


@pytest.mark.parametrize("n,cap,tile,per_tile", [
    (50, 20, 1024, 32),        # one exact top-k
    (6000, 100, 1024, 32),     # tiled, ties across and within tiles
    (6000, 100, 512, 8),       # tiled, tiles saturated by ties
])
def test_topk_compact_ties_like_lax_top_k(n, cap, tile, per_tile):
    """Scores drawn from 5 values: equal scores come out lowest index
    first, as lax.top_k gives them (torch.topk does not promise it)."""
    rng = np.random.default_rng(n + cap)
    score = rng.integers(0, 5, n).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    ti, tv = _both(JC.topk_compact(jnp.asarray(score), jnp.asarray(valid),
                                   cap, tile=tile, per_tile=per_tile),
                   TC.topk_compact(torch.from_numpy(score),
                                   torch.from_numpy(valid), cap, tile=tile,
                                   per_tile=per_tile))
    sel = ti[tv]
    s = score[sel]
    assert (np.diff(s) <= 0).all()
    for v in np.unique(s):                 # within one score: index order
        assert (np.diff(sel[s == v]) > 0).all()


def test_gather_keypoint_fields_matches_jax():
    rng = np.random.default_rng(11)
    n, k = 300, 64
    fields = dict(
        x=rng.uniform(0, 300, n).astype(np.float32),
        y=rng.uniform(0, 200, n).astype(np.float32),
        layer=rng.integers(1, 4, n).astype(np.int32),
        octave=rng.integers(-1, 5, n).astype(np.int32),
        xi=rng.uniform(-0.5, 0.5, n).astype(np.float32),
        size=rng.uniform(2, 30, n).astype(np.float32),
        response=rng.uniform(0, 1, n).astype(np.float32),
        angle=rng.uniform(0, 360, n).astype(np.float32),
        valid=rng.uniform(size=n) < 0.6)
    idx, valid = TC.mask_compact(torch.from_numpy(fields["valid"]), k)
    jidx, jvalid = JC.mask_compact(jnp.asarray(fields["valid"]), k)
    jtree = JKeypoints(**{f: jnp.asarray(v) for f, v in fields.items()})
    jg, jv = JC.gather_keypoint_fields(jtree, jidx, jvalid)
    tg, tv = TC.gather_keypoint_fields(keypoints_from_numpy(fields), idx,
                                       valid)
    assert type(tg).__name__ == "Keypoints" and tv is valid
    for f in fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    # dicts and lists of tensors gather the same way
    d, _ = TC.gather_keypoint_fields(
        {"a": torch.arange(n), "b": [torch.arange(n) * 2]}, idx, valid)
    np.testing.assert_array_equal(d["a"].numpy(), idx.numpy())
    np.testing.assert_array_equal(d["b"][0].numpy(), 2 * idx.numpy())
