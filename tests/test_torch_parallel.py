"""PyTorch port vs the JAX package: the keyframe-sharded pipeline
(``parallel/batched.py``) and ``tools/scale_bench.py``.

The JAX side runs ``make_sharded_pipeline(make_mesh(8))`` on the 8 virtual
CPU devices of tests/conftest.py; the port runs a mesh of 8 CPU shards
(``make_mesh(8, device="cpu")``) with the plain versions of the kernels.
Sizes are tests/test_parallel.py's (64x64, ``num_features=128``,
``max_candidates_per_octave=256``).  Its 8 noise frames hold no keypoint
in either package, so the same comparison also runs on 8 textured frames
(``perf/benchimg.bench_image`` at 64x64: 6-17 keypoints a frame).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sift_tpu
from sift_tpu.parallel import batched as jpar
from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.core.types import build_plan
from sift_tpu_torch.parallel import batched as tpar
from sift_tpu_torch.perf.benchimg import bench_image

H = W = 64
KW = dict(width=W, height=H, num_features=128, max_candidates_per_octave=256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are tiny: one intra-op thread keeps this file off
    the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noise_frames():
    rng = np.random.default_rng(0)
    f = np.zeros((8, H, W), np.float32)
    for b in range(8):
        f[b] = np.clip(rng.normal(128, 30, (H, W)), 0, 255)
    return f


def textured_frames():
    return np.stack([bench_image(H, W, seed=i)
                     for i in range(8)]).astype(np.float32)


FRAMES = {"noise": noise_frames, "textured": textured_frames}


@pytest.fixture(scope="module")
def plan():
    return build_plan(SiftConfig(**KW))


@pytest.fixture(scope="module")
def jax_sharded():
    fn, shard = jpar.make_sharded_pipeline(
        sift_tpu.build_plan(sift_tpu.SiftConfig(**KW)), jpar.make_mesh(8))
    return lambda frames: jax.block_until_ready(fn(shard(frames)))


@pytest.fixture(scope="module")
def port_runs(plan):
    """Per frame set: the port's 8-shard CPU pipeline (gathered) and its
    unsharded batch + sequential_match."""
    fn, shard = tpar.make_sharded_pipeline(
        plan, tpar.make_mesh(8, device="cpu"))
    batched = tpar.batched_detect_fn(plan, device="cpu")
    out = {}
    for name, make in FRAMES.items():
        frames = make()
        sharded = fn(shard(frames))
        assert len(sharded.results) == 8
        res_u = batched(torch.as_tensor(frames))
        out[name] = (sharded.gather(), (res_u, tpar.sequential_match(
            res_u.descriptors, res_u.keypoints.valid)))
    return out


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_sharded_pipeline_matches_jax(name, port_runs, jax_sharded):
    """Counts equal, keypoint x within 1e-4 px, uint8 descriptors within
    1, match indices equal, row 0 all -1."""
    (res, matches), _ = port_runs[name]
    jres, jm = jax_sharded(FRAMES[name]())
    count = res.count.numpy()
    np.testing.assert_array_equal(count, np.asarray(jres.count))
    assert res.descriptors.shape == (8, 128, 128)
    jx = np.asarray(jres.keypoints.x)
    jd = np.asarray(jres.descriptors).astype(np.int32)
    d = res.descriptors.numpy().astype(np.int32)
    for b, n in enumerate(count):
        np.testing.assert_allclose(res.keypoints.x[b, :n].numpy(),
                                   jx[b, :n], atol=1e-4, rtol=0)
        assert np.abs(d[b, :n] - jd[b, :n]).max(initial=0) <= 1
    np.testing.assert_array_equal(matches.numpy(), np.asarray(jm))
    assert (matches[0] == -1).all()
    if name == "textured":
        assert count.min() > 4 and (matches[1:] >= 0).sum() > 0


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_sharded_pipeline_equals_unsharded_bit_for_bit(name, port_runs):
    (res_s, m_s), (res_u, m_u) = port_runs[name]
    for a, b in zip(res_s.keypoints, res_u.keypoints):
        assert torch.equal(a, b)
    assert torch.equal(res_s.descriptors, res_u.descriptors)
    assert torch.equal(res_s.count, res_u.count)
    assert torch.equal(m_s, m_u)


def test_sequential_match_equals_jax():
    """Random descriptor stacks with invalid rows through both packages'
    sequential_match: the same indices."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (40, 128))
    d = np.stack([np.clip(base + rng.integers(-6, 7, base.shape), 0, 255)
                  for _ in range(5)]).astype(np.uint8)
    d[2, :10] = rng.integers(0, 256, (10, 128))        # unmatched rows
    valid = rng.uniform(size=(5, 40)) > 0.15
    got = tpar.sequential_match(torch.as_tensor(d), torch.as_tensor(valid))
    want = jpar.sequential_match(jnp.asarray(d), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0] == -1).all() and (got[1:] >= 0).sum() > 60


def test_sequential_match_self(plan):
    """Identical consecutive frames match themselves heavily."""
    frame = textured_frames()[0]
    res = tpar.batched_detect_fn(plan, device="cpu")(
        torch.as_tensor(np.stack([frame] * 4)))
    m = tpar.sequential_match(res.descriptors, res.keypoints.valid)
    n = int(res.count[0])
    assert n > 4
    assert int((m[1, :n] >= 0).sum()) >= 0.5 * n
    assert (m[1, :n] == torch.arange(n)).float().mean() >= 0.5


def test_shard_rejects_indivisible_batch(plan):
    _, shard = tpar.make_sharded_pipeline(plan,
                                          tpar.make_mesh(3, device="cpu"))
    with pytest.raises(ValueError, match="do not split"):
        shard(np.zeros((4, H, W), np.float32))


def test_scale_bench_cli(capsys):
    """The scaling benchmark runs end to end on 8 CPU shards: one JSON
    point per device count (efficiency means something only on distinct
    GPUs; here it gates the machinery)."""
    from sift_tpu_torch.tools import scale_bench

    scale_bench.main(["--width", "64", "--height", "64",
                      "--num-features", "32", "--frames-per-device", "1",
                      "--iters", "1", "--cpu-mesh", "8"])
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert all(r["metric"] == "scaling" and r["frames_per_s"] > 0
               for r in rows)
    assert rows[0]["efficiency_vs_1"] == 1.0


def test_make_mesh_needs_cuda_unless_asked_for_the_cpu():
    mesh = tpar.make_mesh(4, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == 4
    if torch.cuda.is_available():
        assert all(d.type == "cuda" and d.index is not None
                   for d in tpar.make_mesh().devices)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh(1, device="cuda")
