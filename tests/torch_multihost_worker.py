"""One process of a multi-process cluster of the PyTorch port.

Counterpart of ``tests/multihost_worker.py``: joins the process group
(``parallel/multihost.initialize``), runs the keyframe-sharded
detect+match pipeline and the distributed BA over the GLOBAL mesh (this
process's ``--shards`` positions, rank-major), and (process 0) writes the
all-gathered results for the caller to compare with one process.  Every
process writes its frame kernels' launch counts to
``OUTDIR/launches_<PID>.json``.  Imports ``torch``, ``numpy`` and
``sift_tpu_torch`` only, so ``chip_smoke.py`` runs it on the card too.

Usage: python tests/torch_multihost_worker.py PID NPROC INIT_URL OUTDIR
           [--device cpu|cuda:0] [--shards 2] [--backend gloo]
           [--width 64] [--height 64] [--num-features 128] [--frames 8]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def det_frames(b, h, w):
    """Textured frames, a distinct seed per keyframe (noise frames hold
    almost no keypoint: perf/benchimg.py)."""
    from sift_tpu_torch.perf.benchimg import bench_image
    return np.stack([bench_image(h, w, seed=i)
                     for i in range(b)]).astype(np.float32)


def spawn(script, nproc, init_url, outdir, *extra):
    """Start ``nproc`` processes of ``tests/<script>`` (ranks 0..nproc-1),
    output piped; ``extra`` follows the four positional arguments."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep \
        + env.get("PYTHONPATH", "")
    # Every process runs on this host: the collectives' sockets use the
    # loopback interface.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), str(pid), str(nproc),
         init_url, str(outdir), *map(str, extra)],
        env=env, cwd=os.path.dirname(HERE), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(nproc)]


def finish(procs, timeout):
    """Wait for every process (``timeout`` seconds in all); kill them all
    if one overruns.  Returns their outputs."""
    import time
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1))
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs


def worker_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pid", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("init_url")
    p.add_argument("outdir")
    p.add_argument("--device", default="cpu")
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--num-features", type=int, default=128)
    p.add_argument("--frames", type=int, default=8)
    return p.parse_args(argv)


def join(args):
    """Join the cluster; returns its global mesh."""
    from sift_tpu_torch.parallel.multihost import (global_mesh, initialize,
                                                   warmup_collectives)
    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize(args.init_url, args.nproc, args.pid, backend=args.backend)
    warmup_collectives()
    mesh = global_mesh(devices=[args.device] * args.shards)
    assert mesh.size == args.shards * args.nproc
    return mesh


def main():
    args = worker_args()
    mesh = join(args)

    import torch.distributed as dist

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.core.types import build_plan
    from sift_tpu_torch.kernels import expand as EX
    from sift_tpu_torch.kernels import fused_detect as FD
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.parallel.batched import make_sharded_pipeline
    from sift_tpu_torch.parallel.dba import make_distributed_lm
    from sift_tpu_torch.parallel.multihost import (allgather, barrier,
                                                   shard_from_local)
    from sift_tpu_torch.perf.scenes import synthetic_ba

    # --- keyframe-sharded detect + sequential match over the global mesh
    cfg = SiftConfig(width=args.width, height=args.height,
                     num_features=args.num_features)
    fn, _ = make_sharded_pipeline(build_plan(cfg), mesh)
    b_local = args.frames // args.nproc
    frames = det_frames(args.frames, cfg.height, cfg.width)
    local = frames[args.pid * b_local:(args.pid + 1) * b_local]
    blocks = shard_from_local(mesh, local)
    for m in (FD, EX, FS):
        for d in (m.launches, m.plain_calls):
            d.update(dict.fromkeys(d, 0))
    barrier()
    out = fn(blocks)
    res = {
        "x": allgather([r.keypoints.x for r in out.results]),
        "desc": allgather([r.descriptors for r in out.results]),
        "count": allgather([r.count for r in out.results]),
        "matches": allgather(out.matches),
    }
    with open(os.path.join(args.outdir, f"launches_{args.pid}.json"),
              "w") as fh:
        json.dump({"launches": {**FD.launches, **EX.launches, **FS.launches},
                   "plain_calls": {**FD.plain_calls, **EX.plain_calls,
                                   **FS.plain_calls}}, fh)

    # --- distributed BA over the same global mesh
    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    lm, place = make_distributed_lm(mesh, iterations=10)
    state = lm(place(prob))
    # The BA state is replicated: every process holds the same bits.
    res["ba_cost"] = state.cost.cpu().numpy()
    res["ba_rot"] = state.rotations.cpu().numpy()
    if args.pid == 0:
        np.savez(os.path.join(args.outdir, "multihost_out.npz"), **res)
    barrier()
    dist.destroy_process_group()
    print(f"worker {args.pid} done", flush=True)


if __name__ == "__main__":
    main()
