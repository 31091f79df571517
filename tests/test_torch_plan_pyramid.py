"""PyTorch port (sift_tpu_torch) vs the JAX package: static plan, state
conversion, Gaussian pyramid, and the import rule.

The port runs with ``device="cpu"``; inputs are numpy arrays handed to both
packages.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from sift_tpu.ops.pyramid import gaussian_pyramid as jax_gaussian_pyramid
from sift_tpu_torch.core import convert
from sift_tpu_torch.ops.pyramid import dog_pyramid, gaussian_pyramid


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = {
    "default_320x240": dict(width=320, height=240, num_features=512),
    "upscale_160x120": dict(width=160, height=120, num_features=512,
                            upscale=True),
    "bilinear_truncate6_200x150": dict(width=200, height=150,
                                       num_features=300,
                                       downsample="bilinear",
                                       kernel_truncate=6.0),
}


def _plan_arrays(jplan):
    """The JAX plan's operators as a plain dict of numpy arrays."""
    names = ("blur_v", "blur_h", "carry_v", "carry_h", "down_v", "down_h",
             "kernels_1d")
    arrays = {n: [np.asarray(a) for a in getattr(jplan, n)] for n in names}
    for n in ("init_v", "init_h", "up_v", "up_h", "init_kernel_1d"):
        a = getattr(jplan, n)
        arrays[n] = None if a is None else np.asarray(a)
    return arrays


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def plans(request):
    kw = CONFIGS[request.param]
    jplan = sift_tpu.build_plan(sift_tpu.SiftConfig(**kw))
    tplan = stt.build_plan(stt.SiftConfig(**kw))
    return kw, jplan, tplan


def test_build_plan_reproduces_jax_operators_exactly(plans):
    """Same numpy/f64 construction in both packages: every operator is
    bit-equal (np.array_equal), not merely close."""
    _, jplan, tplan = plans
    ja = _plan_arrays(jplan)
    for name, jv in ja.items():
        tv = getattr(tplan, name)
        if jv is None:
            assert tv is None, name
        elif isinstance(jv, list):
            assert len(jv) == len(tv), name
            for o, (a, b) in enumerate(zip(jv, tv)):
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, o)
        else:
            assert jv.dtype == tv.dtype and np.array_equal(jv, tv), name


def test_build_plan_same_geometry_and_capacities(plans):
    _, jplan, tplan = plans
    assert len(jplan.octaves) == len(tplan.octaves)
    for a, b in zip(jplan.octaves, tplan.octaves):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    jc, tc = jplan.config, tplan.config
    for f in ("num_octaves", "base_width", "base_height", "num_gauss_layers",
              "num_dog_layers", "peak_threshold"):
        assert getattr(jc, f) == getattr(tc, f), f


def test_plan_from_numpy_carries_the_jax_plan(plans):
    """core/convert.plan_from_numpy: the port runs on the JAX package's
    own operators (config as a plain dict, arrays as numpy)."""
    kw, jplan, tplan = plans
    cfg_dict = dataclasses.asdict(jplan.config)
    assert "gather_impl" in cfg_dict       # the TPU-only knob is dropped
    cplan = convert.plan_from_numpy(cfg_dict, _plan_arrays(jplan))
    assert cplan.config == stt.SiftConfig(**kw)
    assert cplan.octaves == tplan.octaves
    for o in range(len(tplan.octaves)):
        assert np.array_equal(cplan.blur_v[o], tplan.blur_v[o])
        assert np.array_equal(cplan.carry_h[o], tplan.carry_h[o])
    with pytest.raises(ValueError):
        bad = _plan_arrays(jplan)
        bad["blur_v"] = bad["blur_v"][:-1]
        convert.plan_from_numpy(cfg_dict, bad)


def test_gaussian_pyramid_matches_jax(plans, test_image):
    """atol 2e-4 on 0..255 images — the limit tests/test_pyramid.py:106
    holds the JAX matmul path to against its conv path: the two sgemm
    implementations sum the same f32 products in different orders."""
    kw, jplan, tplan = plans
    rng = np.random.default_rng(5)
    h, w = kw["height"], kw["width"]
    img = test_image[:h, :w] if test_image.shape[0] >= h \
        and test_image.shape[1] >= w else None
    if img is None or img.shape != (h, w):
        img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    img = np.ascontiguousarray(img, np.float32)
    jg = jax_gaussian_pyramid(jplan, jnp.asarray(img))
    cplan = convert.plan_from_numpy(dataclasses.asdict(jplan.config),
                                    _plan_arrays(jplan))
    for plan in (tplan, cplan):
        tg = gaussian_pyramid(plan, torch.from_numpy(img))
        assert len(tg) == len(jg)
        for o, (a, b) in enumerate(zip(jg, tg)):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-4,
                                       rtol=0, err_msg=f"octave {o}")
    dog = dog_pyramid(tg)
    assert all(d.shape[0] == g.shape[0] - 1 for d, g in zip(dog, tg))


def test_conv_blur_is_refused_not_substituted():
    """blur_impl="conv" runs the conv pyramid (not the matmul one), and a
    plan without the 1-D kernels it needs is refused, not run as matmul."""
    cfg = stt.SiftConfig(width=64, height=48, blur_impl="conv")
    plan = stt.build_plan(cfg)
    img = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (48, 64)).astype(np.float32))
    conv = gaussian_pyramid(plan, img)
    mat = gaussian_pyramid(stt.build_plan(
        dataclasses.replace(cfg, blur_impl="matmul")), img)
    assert not torch.equal(conv[0], mat[0])          # another computation
    np.testing.assert_allclose(conv[0].numpy(), mat[0].numpy(), atol=2e-2)
    with pytest.raises(ValueError, match="kernels_1d"):
        gaussian_pyramid(dataclasses.replace(plan, kernels_1d=()), img)


def test_config_fields_track_the_jax_config():
    """Every field of the JAX config exists in the port with the same
    default, except the TPU knob ``gather_impl`` -> ``kernel_impl``."""
    jf = {f.name: f.default for f in dataclasses.fields(sift_tpu.SiftConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(stt.SiftConfig)}
    assert jf.pop("gather_impl") == "auto" and tf.pop("kernel_impl") == "auto"
    assert jf == tf
    for bad in (dict(kernel_impl="pallas"), dict(width=0),
                dict(descriptor_dtype="int8")):
        with pytest.raises(ValueError):
            stt.SiftConfig(**{**dict(width=8, height=8), **bad})


def test_keypoint_tree_roundtrip_and_packed_octave():
    rng = np.random.default_rng(2)
    n = 37
    fields = dict(
        x=rng.uniform(0, 300, n).astype(np.float32),
        y=rng.uniform(0, 200, n).astype(np.float32),
        layer=rng.integers(1, 4, n).astype(np.int32),
        octave=rng.integers(-1, 5, n).astype(np.int32),
        xi=rng.uniform(-0.5, 0.5, n).astype(np.float32),
        size=rng.uniform(2, 30, n).astype(np.float32),
        response=rng.uniform(0, 1, n).astype(np.float32),
        angle=rng.uniform(0, 360, n).astype(np.float32),
        valid=rng.uniform(0, 1, n) > 0.3)
    kp = convert.keypoints_from_numpy(fields, device="cpu")
    assert kp.capacity == n and int(kp.count()) == int(fields["valid"].sum())
    jkp = sift_tpu.Keypoints(**{k: jnp.asarray(v) for k, v in fields.items()})
    np.testing.assert_array_equal(kp.packed_octave().numpy(),
                                  np.asarray(jkp.packed_octave()))
    res = stt.SiftResult(keypoints=kp,
                         descriptors=torch.zeros((n, 128), dtype=torch.uint8),
                         count=kp.count(), raw_count=torch.tensor(3))
    out = convert.result_to_numpy(res)
    for k, v in fields.items():
        np.testing.assert_array_equal(out[k], v)
    assert out["count"] == int(fields["valid"].sum())
    assert out["raw_count"] == 3
    assert stt.Keypoints.empty(5).valid.sum() == 0


_IMPORT_RULE = r"""
import importlib, pkgutil, sys
import sift_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sift_tpu_torch.__path__,
                                               "sift_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 20, names
geometry = ["sift_tpu_torch.geometry." + m for m in
            ("se3", "twoview", "pnp", "ba", "posegraph", "trajectory",
             "odometry")]
others = ["sift_tpu_torch.io.image", "sift_tpu_torch.io.native",
          "sift_tpu_torch.perf.telemetry", "sift_tpu_torch.tools.odometry",
          "sift_tpu_torch.tools.reconstruct", "sift_tpu_torch.tools.detect",
          "sift_tpu_torch.tools.extract_and_match",
          "sift_tpu_torch.ops.patches", "sift_tpu_torch.parallel",
          "sift_tpu_torch.parallel.batched", "sift_tpu_torch.parallel.dba",
          "sift_tpu_torch.parallel.multihost",
          "sift_tpu_torch.tools.scale_bench",
          "sift_tpu_torch.tools.benchmark", "sift_tpu_torch.perf.timing",
          "sift_tpu_torch.perf.stage_bench",
          "sift_tpu_torch.perf.kernel_bench",
          "sift_tpu_torch.perf.mem_analysis"]
missing = sorted(set(geometry + others) - set(names))
assert not missing, missing
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "sift_tpu" or m.startswith("sift_tpu.")
       or m == "cv2" or m == "triton"]
assert not bad, bad
print("OK", len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports sift_tpu_torch and every sub-module;
    neither jax nor sift_tpu (nor cv2, nor triton) may come along."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _IMPORT_RULE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("OK")


def test_chip_smoke_imports_only_the_port_and_fails_without_a_gpu():
    """chip_smoke.py needs a CUDA device: here it must exit non-zero
    and print no result line."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "chip_smoke.py")).read()
    assert "import jax" not in src and "sift_tpu." not in src \
        and "from sift_tpu " not in src
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: covered by running "
                    "chip_smoke.py itself")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_every_port_test_file_pins_one_torch_thread():
    """ROADMAP's test budget: every tests/test_torch_*.py module defines
    the module-scoped autouse fixture ``_one_torch_thread``, whose body
    reads the thread count, sets one intra-op thread, yields and restores
    the count — read from each module's source, nothing imported."""
    import ast
    import glob
    import os
    want = ["n = torch.get_num_threads()", "torch.set_num_threads(1)",
            "yield", "torch.set_num_threads(n)"]
    here = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(here, "test_torch_*.py")))
    assert len(files) >= 25
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        fix = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name == "_one_torch_thread"]
        ok = len(fix) == 1
        if ok:
            dec = [ast.unparse(d) for d in fix[0].decorator_list]
            body = [ast.unparse(s) for s in fix[0].body
                    if not (isinstance(s, ast.Expr)
                            and isinstance(s.value, ast.Constant))]
            ok = (dec == ["pytest.fixture(scope='module', autouse=True)"]
                  and body == want)
        if not ok:
            bad.append(os.path.basename(path))
    assert not bad, bad
