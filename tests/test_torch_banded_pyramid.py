"""PyTorch port vs the JAX package: the band-blocked padded pyramid that the
detector builds (core/gaussian.banded_blocks_multi, the plan's tiled
fields, ops/blur.blur_tiled, ops/pyramid.gaussian_pyramid_padded,
ops/records.detect_records_padded) and the detector built on it.

The port runs with ``device="cpu"`` (the record-field kernel's plain
version); inputs are numpy arrays made from a seed and handed to both
packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import sift_tpu
import sift_tpu_torch as stt
from conftest import synthetic_image
from sift_tpu.core import gaussian as jgauss
from sift_tpu.kernels.fused_detect import \
    pad_octave_for_detect as jax_pad_octave
from sift_tpu.ops import blur as jblur
from sift_tpu.ops import pyramid as jpyr
from sift_tpu.ops import records as jrec
from sift_tpu_torch.core import convert
from sift_tpu_torch.core import gaussian as tgauss
from sift_tpu_torch.core.types import HALO, padded_shape
from sift_tpu_torch.kernels import fused_detect as FD
from sift_tpu_torch.ops import blur as tblur
from sift_tpu_torch.ops import pyramid as tpyr
from sift_tpu_torch.ops import records as trec
from sift_tpu_torch.pipeline import detector as tdet
from test_torch_detector import _jax_result, _port_result
from test_torch_records import _hold_records

CONFIGS = {
    "default_320x240": dict(width=320, height=240, num_features=512),
    "upscale_160x120": dict(width=160, height=120, num_features=512,
                            upscale=True),
    "bilinear_200x150": dict(width=200, height=150, num_features=300,
                             downsample="bilinear"),
}
TILED = ("tiled_v", "tiled_h", "init_tiled", "carry_tiled")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off
    the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Exact equality of nested tuples of numpy arrays (dtype included)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def plans(request):
    kw = CONFIGS[request.param]
    return (kw, sift_tpu.build_plan(sift_tpu.SiftConfig(**kw)),
            stt.build_plan(stt.SiftConfig(**kw)))


def _image(h, w, seed=7):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(
        np.float32)


def test_plan_band_blocks_equal_jax_exactly(plans):
    """The four tiled fields of the plan, and banded_blocks_multi itself
    on the same float64 operators, are bit-equal to the JAX package's."""
    _, jplan, tplan = plans
    for f in TILED:
        assert _same(getattr(jplan, f), getattr(tplan, f)), f
    o = 1
    h, w = tplan.octaves[o].height, tplan.octaves[o].width
    k = jgauss.gaussian_kernel_1d(1.9)
    ops = [jgauss.blur_operator(h, k, np.float64),
           jgauss.blur_operator(h, k, np.float64) @ jgauss.blur_operator(
               h, k, np.float64)]
    for args in ((128, HALO, padded_shape(h, w)[0]), (128, 0, 128)):
        assert _same(jgauss.banded_blocks_multi(ops, *args),
                     tgauss.banded_blocks_multi(ops, *args)), args


def test_plan_from_numpy_cuts_the_same_band_blocks(plans):
    """A plan over the JAX package's float32 operators cuts its band
    blocks from them: the same blocks as the JAX plan's."""
    _, jplan, _ = plans
    names = ("blur_v", "blur_h", "carry_v", "carry_h")
    arrays = {n: [np.asarray(a) for a in getattr(jplan, n)] for n in names}
    arrays.update(init_v=jplan.init_v, init_h=jplan.init_h,
                  up_v=jplan.up_v, up_h=jplan.up_h)
    cplan = convert.plan_from_numpy(dataclasses.asdict(jplan.config), arrays)
    for f in TILED:
        assert _same(getattr(jplan, f), getattr(cplan, f)), f


def test_blur_tiled_matches_jax(plans):
    """One octave's layer stack and one carry through the band blocks:
    atol 1e-5 on 0..255 inputs (the two libraries sum the band's products
    in different orders)."""
    kw, _, tplan = plans
    o = 1
    h0, w0 = tplan.octaves[0].height, tplan.octaves[0].width
    h1, w1 = tplan.octaves[o].height, tplan.octaves[o].width
    for pair, (hi, wi) in (((tplan.tiled_v[o], tplan.tiled_h[o]), (h1, w1)),
                           (tplan.carry_tiled[o], (h0, w0))):
        base = _image(hi, wi)
        (vb, vo), (hb, ho) = pair
        want = np.asarray(jblur.blur_tiled(jnp.asarray(base),
                                           jnp.asarray(vb), vo,
                                           jnp.asarray(hb), ho))
        got = tblur.blur_tiled(torch.from_numpy(base),
                               tblur.tiled_operator(pair)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _DeviceOps(TorchDispatchMode):
    """Records every operator that computes (not a view)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        view = any(r.alias_info is not None for r in func._schema.returns) \
            or func.__name__ == "_unsafe_view.default"
        # An allocation launches nothing; a bmm into ``out=`` aliases its
        # output but computes.
        if func.__name__.startswith("bmm") or not (
                view or func.__name__.startswith("empty")):
            self.ops.append(func.__name__)
        return out


@pytest.mark.parametrize("size", [(96, 128), (600, 800)])
def test_blur_tiled_issues_at_most_six_device_operations(size):
    """At most five operations whatever the tile counts (a 1 x 1 grid of
    tiles and a 6 x 7 one): one row gather, two batched products, one
    column gather and one copy into batch order — no product per tile, no
    copy of the result into place."""
    h, w = size
    plan = stt.build_plan(stt.SiftConfig(width=w, height=h))
    op = tblur.tiled_operator((plan.tiled_v[0], plan.tiled_h[0]))
    with _DeviceOps() as rec:
        out = tblur.blur_tiled(torch.from_numpy(_image(h, w)), op)
    assert tuple(out.shape[1:]) == padded_shape(h, w)
    assert len(rec.ops) <= 6, rec.ops
    # (One column tile and one row tile need no copy into batch order.)
    assert sorted(op for op in rec.ops if op != "clone.default") == [
        "bmm.default", "bmm.out", "index_select.default",
        "index_select.default"], rec.ops


@pytest.mark.parametrize("blur_impl", ["matmul", "conv"])
def test_padded_pyramid_matches_jax(blur_impl):
    """gaussian_pyramid_padded against the JAX function: the same padded
    shapes, the content within atol 2e-4 (tests/test_pyramid.py:106), the
    padding exactly 0; its content views are the natural-shape octaves."""
    kw = dict(CONFIGS["default_320x240"] if blur_impl == "matmul"
              else dict(width=128, height=96), blur_impl=blur_impl)
    jplan = sift_tpu.build_plan(sift_tpu.SiftConfig(**kw))
    tplan = stt.build_plan(stt.SiftConfig(**kw))
    img = _image(kw["height"], kw["width"], seed=11)
    jg = jax.jit(lambda im: jpyr.gaussian_pyramid_padded(jplan, im))(
        jnp.asarray(img))
    tg = tpyr.gaussian_pyramid_padded(tplan, torch.from_numpy(img))
    views = tpyr.padded_content_views(tplan, tg)
    assert len(tg) == len(jg) == tplan.config.num_octaves
    for o, (a, b, v) in enumerate(zip(jg, tg, views)):
        op = tplan.octaves[o]
        assert tuple(b.shape) == tuple(a.shape) == (
            tplan.config.num_gauss_layers,) + padded_shape(op.height,
                                                           op.width)
        b = b.numpy()
        c = (slice(None), slice(HALO, HALO + op.height),
             slice(0, op.width))
        np.testing.assert_allclose(b[c], np.asarray(a)[c], atol=2e-4,
                                   rtol=0, err_msg=f"octave {o}")
        pad = np.ones(b.shape, bool)
        pad[c] = False
        assert not b[pad].any(), f"octave {o}: padding not zero"
        assert np.array_equal(v.numpy(), b[c])


def test_padded_pyramid_matches_the_dense_one():
    """The detector's pyramid against the dense operators' (golden capture
    and replay keep those) at the JAX test's tolerance, upscaled."""
    plan = stt.build_plan(stt.SiftConfig(**CONFIGS["upscale_160x120"]))
    img = torch.from_numpy(_image(120, 160, seed=3))
    dense = tpyr.gaussian_pyramid(plan, img)
    views = tpyr.padded_content_views(
        plan, tpyr.gaussian_pyramid_padded(plan, img))
    for o, (a, b) in enumerate(zip(dense, views)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-4, rtol=0,
                                   err_msg=f"octave {o}")


@pytest.fixture(scope="module")
def padded_320(test_image):
    """The JAX package's padded pyramid of the 320x240 test frame."""
    h, w = test_image.shape
    jcfg = sift_tpu.SiftConfig(width=w, height=h)
    jplan = sift_tpu.build_plan(jcfg)
    gp = [np.array(g) for g in
          jpyr.gaussian_pyramid_padded(jplan, jnp.asarray(test_image))]
    return jcfg, jplan, gp


@pytest.mark.parametrize("o", [0, 2, 4])
def test_detect_records_padded_matches_jax(padded_320, o):
    """The record field read off a padded octave (the plain version on the
    content view) against the JAX function's jnp route on the same octave,
    at tests/test_records.py:44-54's limits."""
    jcfg, jplan, gp = padded_320
    h, w = jplan.octaves[o].height, jplan.octaves[o].width
    ref = jax.jit(jrec.detect_records_padded, static_argnums=(1, 2, 3, 4))(
        jnp.asarray(gp[o]), h, w, jcfg, "xla")
    got = trec.detect_records_padded(torch.from_numpy(gp[o]), h, w,
                                     convert.config_from_dict(
                                         dataclasses.asdict(jcfg)))
    assert (got.h, got.w) == (h, w)
    assert tuple(got.values.shape[2:]) == (h, w)
    _hold_records(ref, got.values, o)


def test_detect_records_padded_pyramid_is_one_call(padded_320):
    """The pyramid-wide form: one call of the plain version over every
    padded octave, bit-equal to the natural-shape octaves' records; and
    pad_octave_for_detect equals the JAX function."""
    jcfg, jplan, gp = padded_320
    tplan = stt.build_plan(convert.config_from_dict(
        dataclasses.asdict(jcfg)))
    t = [torch.from_numpy(g) for g in gp]
    before = FD.plain_calls["detect_records"]
    recs = trec.detect_records_padded_pyramid(tplan, t, "torch")
    assert FD.plain_calls["detect_records"] == before + 1
    natural = [v.contiguous() for v in tpyr.padded_content_views(tplan, t)]
    want = trec.detect_records_pyramid(natural, tplan.config, "torch")
    for a, b in zip(recs, want):
        assert torch.equal(a.values, b.values)
    for o in (0, 3):
        h = tplan.octaves[o].height
        padded = FD.pad_octave_for_detect(natural[o], h)
        assert np.array_equal(padded.numpy(), np.asarray(
            jax_pad_octave(jnp.asarray(natural[o].numpy()), h)))
        assert trec.detect_records_padded(
            padded, h, natural[o].shape[2], tplan.config, "torch"
        ).values.equal(want[o].values)


def test_kernel_reads_padded_octaves_through_their_strides():
    """The record-field kernel's wrapper takes a padded octave's content
    view as it is (layer stride, row pitch) and refuses what its loads
    cannot read: a column stride other than 1, a row pitch below the
    width."""
    plan = stt.build_plan(stt.SiftConfig(width=200, height=150))
    gp = tpyr.gaussian_pyramid_padded(plan, torch.from_numpy(
        _image(150, 200)))
    for g, v in zip(gp, tpyr.padded_content_views(plan, gp)):
        assert FD.octave_strides(v) == g.stride()[:2]
    v = tpyr.padded_content_views(plan, gp)[0]
    with pytest.raises(ValueError, match="unit column stride"):
        FD.octave_strides(v.transpose(1, 2))
    with pytest.raises(ValueError, match="row pitch"):
        FD.octave_strides(torch.zeros(6, 1, 8).expand(6, 5, 8))


def test_detector_builds_the_padded_pyramid_and_matches_jax(monkeypatch):
    """The whole detector at 160x120 against the JAX detector (whose
    pyramid is the same padded one; its jnp route): counts equal, x within
    1e-4, descriptors within 1.  The port's frame builds its pyramid with
    gaussian_pyramid_padded, once, and moves no dense operator."""
    calls = []
    real = tdet.gaussian_pyramid_padded

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tdet, "gaussian_pyramid_padded", counted)
    img = synthetic_image(height=120, width=160, seed=3, n_blobs=25)
    a = _jax_result(img, "xla")
    b = _port_result(img)
    assert len(calls) == 1
    assert a["count"] == b["count"] > 30
    from sift_tpu_torch.perf.compare import pair_keypoints
    ia, ib = pair_keypoints(a, b, pos_tol=1e-3, angle_tol=0.5)
    assert len(ia) == a["count"]
    np.testing.assert_allclose(b["x"][ib], a["x"][ia], atol=1e-4, rtol=0)
    np.testing.assert_allclose(b["y"][ib], a["y"][ia], atol=1e-4, rtol=0)
    dd = np.abs(a["descriptors"][ia].astype(np.int32)
                - b["descriptors"][ib].astype(np.int32))
    assert dd.max() <= 1
    plan = stt.build_plan(stt.SiftConfig(width=160, height=120))
    ops = tpyr.plan_operators(plan, "cpu")
    assert ops.blur_v == () and ops.init_v is None
    assert len(ops.tiled) == len(ops.carry_tiled) == plan.config.num_octaves
