"""PyTorch port vs the JAX package: the conv blur and the sequential conv
pyramid (``blur_impl="conv"``), the direct bilinear resize and the patch
helpers, on the same seeded numpy inputs.

Tolerances: the conv blur and pyramid atol 2e-4 on 0..255 images (the
pyramid limit of tests/test_pyramid.py:106 — the two packages' convolutions
sum the same float32 products in another order); conv against matmul
pyramid atol 2e-2 (tests/test_pyramid.py:72-81); resize and patches atol
1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from sift_tpu.ops import blur as JB
from sift_tpu.ops import patches as JP
from sift_tpu.ops import pyramid as JPY
from sift_tpu.ops import resize as JR
from sift_tpu_torch.core import convert
from sift_tpu_torch.ops import blur as TB
from sift_tpu_torch.ops import patches as TP
from sift_tpu_torch.ops import pyramid as TPY
from sift_tpu_torch.ops import resize as TR


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The images here are small: one intra-op thread keeps this file off the cores of the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,sigma", [
    ((48, 64), 1.6),
    ((3, 40, 56), 2.5),
    ((2, 6, 9), 3.2),          # kernel wider than the image: reflect-101
])
def test_blur_conv_matches_jax(shape, sigma):
    from sift_tpu_torch.core.gaussian import gaussian_kernel_1d
    img = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    k = gaussian_kernel_1d(sigma, 8.0).astype(np.float32)
    a = np.asarray(JB.blur_conv(jnp.asarray(img), jnp.asarray(k)))
    b = TB.blur_conv(torch.from_numpy(img), torch.from_numpy(k))
    assert tuple(b.shape) == shape and b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a, atol=2e-4, rtol=0)
    # and against the banded-operator form of the same blur
    from sift_tpu_torch.core.gaussian import blur_operator
    ov = torch.from_numpy(blur_operator(shape[-2], k).astype(np.float32))
    oh = torch.from_numpy(blur_operator(shape[-1], k).astype(np.float32))
    np.testing.assert_allclose(
        TB.blur_matmul(torch.from_numpy(img), ov, oh).numpy(), b.numpy(),
        atol=2e-4, rtol=0)


@pytest.fixture(scope="module", params=[False, True], ids=["base", "upscale"])
def conv_pyramids(request, test_image):
    h, w = test_image.shape
    kw = dict(width=w, height=h, blur_impl="conv", downsample="nearest",
              upscale=request.param)
    jp = JPY.gaussian_pyramid(sift_tpu.build_plan(sift_tpu.SiftConfig(**kw)),
                              jnp.asarray(test_image))
    tplan = stt.build_plan(stt.SiftConfig(**kw))
    tp = TPY.gaussian_pyramid(tplan, torch.from_numpy(test_image))
    return kw, jp, tp


def test_conv_pyramid_matches_jax(conv_pyramids):
    _, jp, tp = conv_pyramids
    assert len(tp) == len(jp)
    for o, (a, b) in enumerate(zip(jp, tp)):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-4,
                                   rtol=0, err_msg=f"octave {o}")


def test_conv_pyramid_close_to_matmul(conv_pyramids, test_image):
    kw, _, tp = conv_pyramids
    cfg = stt.SiftConfig(**{**kw, "blur_impl": "matmul"})
    pm = TPY.gaussian_pyramid(stt.build_plan(cfg),
                              torch.from_numpy(test_image))
    for o in range(3):
        np.testing.assert_allclose(tp[o].numpy(), pm[o].numpy(), atol=2e-2,
                                   rtol=0, err_msg=f"octave {o}")


def test_conv_plan_without_kernels_raises(test_image):
    """A plan built from the matmul operators alone has no 1-D kernels:
    the conv pyramid refuses it instead of falling back to matmul."""
    h, w = test_image.shape
    jcfg = sift_tpu.SiftConfig(width=w, height=h, blur_impl="conv")
    jplan = sift_tpu.build_plan(jcfg)
    arrays = {n: [np.asarray(a) for a in getattr(jplan, n)]
              for n in ("blur_v", "blur_h", "carry_v", "carry_h")}
    arrays.update(init_v=jplan.init_v, init_h=jplan.init_h, up_v=None,
                  up_h=None)
    plan = convert.plan_from_numpy(dataclasses.asdict(jcfg), arrays)
    with pytest.raises(ValueError, match="kernels_1d"):
        TPY.gaussian_pyramid(plan, torch.from_numpy(test_image))
    with pytest.raises(ValueError, match="kernels_1d"):
        stt.SiftDetector(plan.config, device="cpu", plan=plan)


@pytest.mark.parametrize("upscale", [False, True])
def test_conv_pyramid_builds_no_pad_index_per_frame(upscale, monkeypatch):
    """plan_operators moves every reflect-101 pad index the conv pyramid
    uses to the device once; a frame builds (and so copies) none."""
    cfg = stt.SiftConfig(width=64, height=48, blur_impl="conv",
                         upscale=upscale)
    plan = stt.build_plan(cfg)
    ops = TPY.plan_operators(plan, "cpu")
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (48, 64)).astype(np.float32))
    want = TPY.gaussian_pyramid(plan, img, ops)

    def refuse(*args, **kwargs):
        raise AssertionError("a pad index was built during the frame")

    monkeypatch.setattr(TB, "reflect_pad_index", refuse)
    got = TPY.gaussian_pyramid(plan, img, ops)
    assert len(got) == cfg.num_octaves
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,out", [
    ((37, 53), (74, 106)),         # 2x up
    ((2, 3, 40, 64), (20, 32)),    # 2x down, two batch axes
    ((5, 31, 29), (17, 45)),       # arbitrary ratios
])
def test_resize_bilinear_matches_jax(shape, out):
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    a = np.asarray(JR.resize_bilinear(jnp.asarray(img), *out))
    b = TR.resize_bilinear(torch.from_numpy(img), *out)
    assert tuple(b.shape) == shape[:-2] + out
    np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [5, 16])
def test_gather_patches_and_gradients_match_jax(size):
    rng = np.random.default_rng(size)
    block = rng.uniform(0, 255, (4, 30, 41)).astype(np.float32)
    k = 50
    layer = rng.integers(-1, 6, k).astype(np.int32)     # clamped too
    cy = rng.integers(-3, 34, k).astype(np.int32)
    cx = rng.integers(-3, 45, k).astype(np.int32)
    ja, jdy, jdx = JP.gather_patches(jnp.asarray(block), jnp.asarray(layer),
                                     jnp.asarray(cy), jnp.asarray(cx), size)
    ta, tdy, tdx = TP.gather_patches(torch.from_numpy(block),
                                     torch.from_numpy(layer),
                                     torch.from_numpy(cy),
                                     torch.from_numpy(cx), size)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tdy.numpy(), np.asarray(jdy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))
    for a, b in zip(JP.patch_gradients(ja), TP.patch_gradients(ta)):
        assert tuple(b.shape) == (k, size - 2, size - 2)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=0)
