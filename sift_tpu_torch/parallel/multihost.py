"""Multi-process execution over ``torch.distributed``.

Counterpart of ``sift_tpu/parallel/multihost.py``.  One process per GPU is
the layout that scales: a frame is host-bound (one Python thread issues its
~1,100 small launches), so a single process that issues several GPUs'
kernels cannot keep more than one of them busy.  So:

* ``initialize`` joins the process group: with no arguments it reads
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
  ``MASTER_PORT``), as ``jax.distributed.initialize`` detects its cluster;
* ``global_mesh`` spans every process's local shard devices, rank-major —
  by default one GPU per process, ``cuda:LOCAL_RANK``
  (``torchrun --nproc-per-node N``, NCCL);
* the same pipeline and LM code as in one process
  (``parallel/batched.py``, ``parallel/dba.py``) then adds two collectives:
  an all-gather of each process's last frame at the sequential-match
  boundary, and an ``all_reduce`` after the process-local fixed-order sum
  of every observation sum.

Backends: ``"nccl"`` for CUDA tensors (the default when CUDA is
available), ``"gloo"`` for CPU tensors — and for processes that share one
GPU, which NCCL refuses ("Duplicate GPU detected"): such processes pass
``backend="gloo"`` themselves; nothing switches backend quietly.  With
gloo every collective runs on CPU copies (gloo's CUDA support covers
``broadcast`` and ``all_reduce`` only), staged here by backend.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# How long a collective may wait for its peers before it raises (a lost
# peer must fail the survivors, not hang them).
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join (or create) the process group.

    With no arguments, reads ``torchrun``'s environment (``env://``).
    Otherwise ``coordinator_address`` is ``"host:port"`` (TCP) or an init
    URL (``tcp://...``, ``file:///path``), with the world size and this
    process's rank.  ``backend=None`` means ``"nccl"``, and raises without
    CUDA: CPU shards ask for ``"gloo"`` explicitly."""
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the default backend is nccl; pass "
                "backend='gloo' to run the processes on CPU tensors")
        backend = "nccl"
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    if backend == "nccl":
        torch.cuda.set_device(_local_gpu(process_id))
    # -1: taken from the environment (env://)
    dist.init_process_group(
        backend, init_method=url,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, timeout=TIMEOUT)


def _local_gpu(rank: Optional[int] = None) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() \
            else int(os.environ.get("RANK", 0))
    return rank % torch.cuda.device_count()


def _stage(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` where ``group``'s backend takes it: on this
    process's GPU under NCCL, on the CPU under gloo."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    return t.detach().to(dev, copy=True).contiguous()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over the processes of ``group``, on ``t``'s device.
    Every process receives the same bits."""
    s = _stage(t, group)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return s.to(t.device)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every process's ``t`` (same shape everywhere) concatenated along
    axis 0 in rank order, on ``t``'s device."""
    s = _stage(t, group)
    out = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, s, group=group)
    return torch.cat(out).to(t.device)


def warmup_collectives() -> None:
    """Open the collective transport with one tiny all-gather while the
    processes are still in step from ``initialize`` — for the same reason
    as in the JAX package: a first collective reached with large skew (one
    process building kernels, the other not) trips the transport's
    connect timeout."""
    all_gather_cat(torch.zeros(1), dist.group.WORLD)


def barrier() -> None:
    """Every process waits here for the others (the counterpart of
    ``multihost_utils.sync_global_devices``)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def global_mesh(axis: str = "data",
                devices: Optional[Sequence] = None):
    """1-D mesh over every process's shard devices, rank-major: process r
    holds positions ``r * L .. r * L + L - 1``.  ``devices``: this
    process's L shard devices (default one GPU, ``cuda:LOCAL_RANK``;
    repeated entries are virtual shards on one device).  Every process
    must hold the same number."""
    from sift_tpu_torch.parallel.batched import Mesh

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device; pass the "
                               "local shard devices, e.g. ['cpu']")
        devices = [torch.device("cuda", _local_gpu())]
    mesh = Mesh(devices=tuple(torch.device(d) for d in devices), axis=axis,
                group=dist.group.WORLD)
    sizes = all_gather_cat(torch.tensor([len(mesh.devices)]), mesh.group)
    if len(set(sizes.tolist())) != 1:
        raise ValueError(f"processes hold different shard counts: "
                         f"{sizes.tolist()}")
    return mesh


def shard_from_local(mesh, local_batch) -> list:
    """This process's frames ``[B_local, H, W]`` as the blocks of its mesh
    positions (float32, each on its device); the global batch is
    ``[B_local * num_processes, H, W]``."""
    from sift_tpu_torch.parallel.batched import split_blocks
    return split_blocks(mesh, local_batch)


def allgather(x) -> np.ndarray:
    """The global value of a sharded result as host numpy: ``x`` is this
    process's part (a tensor with a leading axis, or a list of per-position
    tensors), concatenated along axis 0 over the positions, then over the
    processes in rank order (the cross-process readback for verification
    and I/O)."""
    if isinstance(x, (list, tuple)):
        x = torch.cat([t.to(x[0].device) for t in x])
    if dist.is_initialized():
        x = all_gather_cat(x, dist.group.WORLD)
    return x.detach().cpu().numpy()
