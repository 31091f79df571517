"""The PyTorch port across processes: 2 processes x 2 CPU shards (gloo,
``file://`` rendezvous) must give what one process gives on a 4-shard
mesh — the counterpart of tests/test_multihost.py.  The frame pipeline is
compared bit for bit (no sum crosses a process); BA at rtol / atol 1e-5,
because its observation sums meet in another order ((s0 + s1) + (s2 + s3)
across the two processes, ((s0 + s1) + s2) + s3 in one).

The cluster runs in subprocesses (tests/torch_multihost_worker.py,
tests/torch_elastic_worker.py); the single-process reference runs
in-test, and is itself held against the JAX package's 4-device
``make_sharded_pipeline`` and ``make_distributed_lm`` on the same frames
and problem (tests/test_torch_parallel.py's and tests/test_dba.py's
tolerances).  At 64x64 this file stays in Tier-1; the 752x480 version (the
JAX test's size) is marked slow, as tests/test_multihost.py is.
"""
import json
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
from torch_multihost_worker import det_frames, finish, spawn  # noqa: E402

import sift_tpu  # noqa: E402
from sift_tpu.parallel import batched as jpar  # noqa: E402
from sift_tpu.parallel.dba import make_distributed_lm as jax_dlm  # noqa: E402
from sift_tpu_torch.config import SiftConfig  # noqa: E402
from sift_tpu_torch.core.types import build_plan  # noqa: E402
from sift_tpu_torch.parallel.batched import (make_mesh,  # noqa: E402
                                             make_sharded_pipeline)
from sift_tpu_torch.parallel.dba import (make_distributed_lm,  # noqa: E402
                                         make_lm_stepper)
from sift_tpu_torch.perf.scenes import synthetic_ba  # noqa: E402
from tests.test_ba import synthetic_ba as jax_synthetic_ba  # noqa: E402

TIMEOUT = 600


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def url(tmp_path, name):
    return "file://" + str(tmp_path / name)


SIZES = {"64x64": (64, 64, 128),
         "752x480": (752, 480, 512)}
# jax_pipeline_check's limits by size: descriptors (uint8 steps) and the
# share of valid queries whose match may flip across the ratio test.
CHECK_LIMITS = {"64x64": dict(desc_atol=1, flip_share=0.0),
                "752x480": dict(desc_atol=3, flip_share=0.01)}


def single_process_reference(w, h, nf):
    """The port's 4-shard pipeline in one process on the CPU over the
    workers' 8 frames: (frames, result, matches, mesh)."""
    cfg = SiftConfig(width=w, height=h, num_features=nf)
    mesh = make_mesh(4, device="cpu")
    fn, shard = make_sharded_pipeline(build_plan(cfg), mesh)
    frames = det_frames(8, h, w)
    res, matches = fn(shard(frames)).gather()
    return frames, res, matches, mesh


def jax_pipeline_gaps(frames, w, h, nf, res, matches):
    """The single-process reference against the JAX package's 4-device
    ``make_sharded_pipeline`` on the same frames: whether the counts are
    equal, the largest x and descriptor differences, the valid queries
    and the queries whose match differs, whether each of those is a flip
    across the ratio test (matched on one side, -1 on the other) on a
    query whose descriptor row differs, and whether the port's matcher on
    the JAX package's descriptors gives the JAX package's matches."""
    from sift_tpu_torch.parallel.batched import sequential_match

    jfn, jshard = jpar.make_sharded_pipeline(
        sift_tpu.build_plan(sift_tpu.SiftConfig(width=w, height=h,
                                                num_features=nf)),
        jpar.make_mesh(4))
    jres, jm = jax.block_until_ready(jfn(jshard(frames)))
    count, jcount = res.count.numpy(), np.asarray(jres.count)
    d = res.descriptors.numpy().astype(np.int32)
    jd = np.asarray(jres.descriptors).astype(np.int32)
    x, jx = res.keypoints.x.numpy(), np.asarray(jres.keypoints.x)
    n = np.minimum(count, jcount)
    m, jm = matches.numpy(), np.asarray(jm)
    differ = np.argwhere(m != jm)
    on_jax = sequential_match(
        torch.from_numpy(np.array(jres.descriptors)),
        torch.from_numpy(np.array(jres.keypoints.valid)),
        ratio=SiftConfig(width=w, height=h).match_ratio).numpy()
    return {
        "counts_equal": bool(np.array_equal(count, jcount)),
        "max_dx": max(float(np.abs(x[b, :k] - jx[b, :k]).max(initial=0))
                      for b, k in enumerate(n)),
        "max_desc_diff": max(int(np.abs(d[b, :k] - jd[b, :k]).max(
            initial=0)) for b, k in enumerate(n)),
        "valid_queries": int(count[1:].sum()),
        "matches_differing": len(differ),
        "flips_only": all(min(m[b, q], jm[b, q]) == -1 for b, q in differ),
        "differing_have_desc_diff": all((d[b, q] != jd[b, q]).any()
                                        for b, q in differ),
        "matcher_on_jax_descriptors_equal": bool(np.array_equal(on_jax,
                                                                jm))}


def jax_pipeline_check(frames, w, h, nf, res, matches, desc_atol,
                       flip_share):
    """``jax_pipeline_gaps`` held with tests/test_torch_parallel.py's
    tolerances: counts equal, x within 1e-4 (measured on the 8 frames at
    752x480: 9.5e-7, 1 float32 step, on one keypoint; 0 elsewhere),
    descriptors within ``desc_atol``.

    On the CPU the JAX package runs its flat descriptor path, which misses
    its own fused path by up to 3 at 752x480 (ROADMAP C5); the port
    follows the fused path.  So at 752x480 descriptors are held within 3
    (measured: 3 on one frame, 2 on the others), at 64x64 within 1.
    Matches: the port's matcher on the JAX package's descriptors gives the
    JAX package's matches exactly, so a query whose match differs differs
    through the descriptors.  Each such query must be a flip across the
    ratio test (never two targets) with a descriptor row that differs,
    and at most ``flip_share`` of the valid queries may flip (measured at
    752x480: 25 of 3517, 0.71 %; at 64x64 none).  The measured values:
    ``python tests/test_torch_multihost.py 752x480``."""
    g = jax_pipeline_gaps(frames, w, h, nf, res, matches)
    assert g["counts_equal"], g
    assert g["max_dx"] <= 1e-4, g
    assert g["max_desc_diff"] <= desc_atol, g
    assert g["matcher_on_jax_descriptors_equal"], g
    assert g["flips_only"] and g["differing_have_desc_diff"], g
    assert g["matches_differing"] <= flip_share * g["valid_queries"], g


@pytest.mark.parametrize("size", [
    "64x64", pytest.param("752x480", marks=pytest.mark.slow)])
def test_two_process_cluster_matches_single_process(tmp_path, size):
    w, h, nf = SIZES[size]
    procs = spawn("torch_multihost_worker.py", 2, url(tmp_path, "rv"),
                  tmp_path, "--width", w, "--height", h, "--num-features",
                  nf, "--frames", 8, "--shards", 2)
    logs = finish(procs, TIMEOUT)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = np.load(tmp_path / "multihost_out.npz")
    for pid in range(2):
        with open(tmp_path / f"launches_{pid}.json") as fh:
            counts = json.load(fh)
        assert not any(counts["launches"].values())   # CPU: plain versions
        assert set(counts["plain_calls"].values()) == {4}

    frames, res, matches, mesh = single_process_reference(w, h, nf)
    jax_pipeline_check(frames, w, h, nf, res, matches, **CHECK_LIMITS[size])

    assert int(np.sum(got["count"])) > 0
    np.testing.assert_array_equal(got["count"], res.count.numpy())
    np.testing.assert_allclose(got["x"], res.keypoints.x.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got["desc"], res.descriptors.numpy())
    np.testing.assert_array_equal(got["matches"], matches.numpy())
    assert (got["matches"][0] == -1).all() and (got["matches"] >= 0).any()

    jprob, *_ = jax_synthetic_ba(seed=0, n_cams=5, n_pts=96)
    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    lm, place = make_distributed_lm(mesh, iterations=10)
    state = lm(place(prob))
    jfn, jplace = jax_dlm(jpar.make_mesh(4), iterations=10)
    jstate = jax.block_until_ready(jfn(jplace(jprob)))
    np.testing.assert_allclose(state.cost.numpy(), np.asarray(jstate.cost),
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(state.rotations.numpy(),
                               np.asarray(jstate.rotations), atol=1e-4)
    np.testing.assert_allclose(float(got["ba_cost"]), float(state.cost),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["ba_rot"], state.rotations.numpy(),
                               atol=1e-5)


def test_worker_loss_resume_from_checkpoint(tmp_path):
    """Elastic recovery: a 2-process distributed LM loses worker 1 after
    chunk 1's checkpoint is durable (os._exit(17)); the supervisor — this
    test — sees the exit, kills the survivor and starts a fresh cluster
    that resumes from the checkpoint and completes.  The final state
    matches one process running the same chunked schedule (cost rtol
    1e-5, rotations atol 1e-5: the scale gauge is free, see
    tests/test_multihost.py)."""
    procs = spawn("torch_elastic_worker.py", 2, url(tmp_path, "rv1"),
                  tmp_path, 1)
    try:
        out1, _ = procs[1].communicate(timeout=TIMEOUT)
        assert procs[1].returncode == 17, out1.decode(errors="replace")
        time.sleep(1.0)
    finally:
        procs[0].kill()
        finish(procs, 60)
    ckpt = np.load(tmp_path / "ba_ckpt.npz")
    assert int(ckpt["iteration"]) == 10
    assert not (tmp_path / "elastic_final.npz").exists()

    procs = spawn("torch_elastic_worker.py", 2, url(tmp_path, "rv2"),
                  tmp_path, -1)
    logs = finish(procs, TIMEOUT)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert "resuming at iteration 10" in logs[0]
    got = np.load(tmp_path / "elastic_final.npz")

    init, step, place = make_lm_stepper(make_mesh(4, device="cpu"), chunk=5)
    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96)
    placed = place(prob)
    state = init(placed)
    for _ in range(3):
        state = step(placed, state)
    np.testing.assert_allclose(got["cost"], state.cost.numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(got["rotations"], state.rotations.numpy(),
                               atol=1e-5)


_TORCHRUN_CHILD = """
import torch, torch.distributed as dist
from sift_tpu_torch.parallel import multihost as M
M.initialize(backend="gloo")
M.warmup_collectives()
mesh = M.global_mesh(devices=["cpu", "cpu"])
print(mesh.size, mesh.rank, dist.get_world_size(),
      M.allgather([torch.ones(2), torch.zeros(1)]).tolist())
dist.destroy_process_group()
"""


def test_initialize_reads_the_torchrun_environment():
    """With no address, initialize() joins through torchrun's variables
    (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT: env://)."""
    import socket
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # env:// needs a TCP port: a free one is picked, released and handed
    # to the child, so another process may take it in between; that case
    # (and only that) is tried again on a new port.
    for _ in range(3):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
                   LOCAL_RANK="0", GLOO_SOCKET_IFNAME="lo")
        out = subprocess.run([sys.executable, "-c", _TORCHRUN_CHILD],
                             env=env, cwd=root, capture_output=True,
                             text=True, timeout=120)
        if "address already in use" not in out.stderr.lower():
            break
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["2", "0", "1", "[1.0,", "1.0,", "0.0]"]


def test_initialize_needs_cuda_unless_asked_for_gloo():
    """No backend given means NCCL, which needs CUDA: nothing switches to
    gloo quietly."""
    from sift_tpu_torch.parallel import multihost
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: covered on the card")
    with pytest.raises(RuntimeError, match="gloo"):
        multihost.initialize("file:///nonexistent", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.global_mesh()


if __name__ == "__main__":
    # The measured gaps behind CHECK_LIMITS, one JSON line per size given
    # (default 752x480): python tests/test_torch_multihost.py [64x64 ...]
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    for size in sys.argv[1:] or ["752x480"]:
        w, h, nf = SIZES[size]
        frames, res, matches, _ = single_process_reference(w, h, nf)
        print(json.dumps({"size": size, **jax_pipeline_gaps(
            frames, w, h, nf, res, matches)}), flush=True)
