"""Multi-frame batching and multi-device sharding of the SIFT pipeline.

Counterpart of ``sift_tpu/parallel/batched.py``.  The keyframe axis is the
parallel axis:

* ``batched_detect_fn`` — the single-frame pipeline run once per frame of
  ``[B, H, W]`` (as the JAX package's ``lax.map``; no vmap, so every frame
  keeps its one launch per kernel);
* ``make_sharded_pipeline`` — the frame axis split in contiguous blocks
  over a ``Mesh`` of devices; each block runs on its device, and each
  block's first frame is matched against the previous block's last frame,
  whose descriptors are copied across (the JAX package's batch-axis roll,
  lowered there to a ``ppermute``).

A ``Mesh`` is an ordered list of devices.  Repeated entries are virtual
shards on one device (the counterpart of JAX's virtual CPU devices): four
``cuda:0`` shards run the sharded code paths on one card.  Across
processes (``parallel/multihost.global_mesh``) a mesh also carries the
process group; the boundary frame then crosses processes by an all-gather.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sift_tpu_torch.core.types import Keypoints, SiftPlan, SiftResult
from sift_tpu_torch.ops.pyramid import plan_operators
from sift_tpu_torch.pipeline.detector import build_detect_fn
from sift_tpu_torch.pipeline.matcher import match_brute_force


class Mesh(NamedTuple):
    """1-D device mesh: this process's shard devices in mesh order, the
    axis name, and the process group the mesh spans (None: one process)."""

    devices: Tuple[torch.device, ...]
    axis: str = "data"
    group: object = None

    @property
    def rank(self) -> int:
        import torch.distributed as dist
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def processes(self) -> int:
        import torch.distributed as dist
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Mesh positions over all processes."""
        return len(self.devices) * self.processes

    @property
    def first_position(self) -> int:
        """The global position of this process's first device."""
        return self.rank * len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (``cuda:0``,
    ``cuda:1``, ...; all of them by default); raises without CUDA or when
    ``n_devices`` exceeds the count.  ``device="cpu"`` gives ``n_devices``
    CPU shards (default 1)."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices={n}")
        return Mesh(devices=(torch.device("cpu"),) * n, axis=axis)
    if kind != "cuda":
        raise ValueError(f"make_mesh: device type {kind!r} not in "
                         "('cuda', 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no CUDA device is available; pass device='cpu' "
            "for a mesh of CPU shards")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n}: {count} CUDA device(s) here")
    return Mesh(devices=tuple(torch.device("cuda", i) for i in range(n)),
                axis=axis)


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (streams, new tensors)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def stack_results(results: Sequence[SiftResult], op=torch.stack
                  ) -> SiftResult:
    """Per-frame (``op=torch.stack``) or per-block (``torch.cat``) results
    as one SiftResult along a leading frame axis."""
    kps = Keypoints(*[op([r.keypoints[i] for r in results])
                      for i in range(len(Keypoints._fields))])
    return SiftResult(keypoints=kps,
                      descriptors=op([r.descriptors for r in results]),
                      count=op([r.count for r in results]),
                      raw_count=op([torch.as_tensor(r.raw_count)
                                    for r in results]))


def _map_frames(detect, frames: torch.Tensor) -> SiftResult:
    return stack_results([detect(f) for f in frames])


def batched_detect_fn(plan: SiftPlan, quant_mode: str = "opencv",
                      device=None):
    """Returns frames [B, H, W] -> SiftResult with a leading B axis on
    every leaf: the single-frame function once per frame (the JAX
    package's ``lax.map``).  ``device=None`` means the GPU."""
    single = build_detect_fn(plan, quant_mode, device=device)
    return lambda frames: _map_frames(single, frames)


def _match_prev(descriptors, valid, prev_d, prev_v, ratio):
    """Frame b of a block against frame b-1, with ``prev_d`` / ``prev_v``
    standing in before frame 0."""
    pd = torch.cat([prev_d[None], descriptors[:-1]])
    pv = torch.cat([prev_v[None], valid[:-1]])
    return match_brute_force(descriptors, pd, valid, pv, ratio=ratio)


def sequential_match(descriptors: torch.Tensor, valid: torch.Tensor,
                     ratio: float = 0.8) -> torch.Tensor:
    """Match frame b's descriptors against frame b-1's for every b.

    descriptors: [B, N, 128]; valid: [B, N].  Returns [B, N] int32 match
    indices into frame b-1 (row 0 is all -1)."""
    m = _match_prev(descriptors, valid, descriptors[-1], valid[-1], ratio)
    m[0] = -1
    return m


def split_blocks(mesh: Mesh, batch) -> List[torch.Tensor]:
    """``batch`` [B, ...] split into ``len(mesh.devices)`` contiguous
    blocks, float32, each on its position's device."""
    x = torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch, dtype=torch.float32)
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} frames do not split over {n} "
                         "mesh positions")
    return [blk.to(dev) for blk, dev in zip(x.chunk(n), mesh.devices)]


class ShardedOutput(NamedTuple):
    """The sharded pipeline's result: one SiftResult (leading axis = the
    block's frames) and one ``[b, N]`` match array per position of this
    process, each on its device."""

    results: List[SiftResult]
    matches: List[torch.Tensor]
    mesh: Mesh

    def gather(self) -> Tuple[SiftResult, torch.Tensor]:
        """(SiftResult [B, ...], matches [B, N]) over the whole mesh, on
        this process's first device — the counterpart of an all-gather;
        across processes it is one."""
        home = self.mesh.devices[0]
        res = stack_results([_to(r, home) for r in self.results], torch.cat)
        m = torch.cat([x.to(home) for x in self.matches])
        if self.mesh.group is not None:
            from sift_tpu_torch.parallel.multihost import all_gather_cat
            g = lambda t: all_gather_cat(t, self.mesh.group)
            res = SiftResult(keypoints=Keypoints(*map(g, res.keypoints)),
                             descriptors=g(res.descriptors),
                             count=g(res.count), raw_count=g(res.raw_count))
            m = g(m)
        return res, m


def _to(r: SiftResult, dev) -> SiftResult:
    return SiftResult(keypoints=Keypoints(*[t.to(dev) for t in r.keypoints]),
                      descriptors=r.descriptors.to(dev),
                      count=r.count.to(dev), raw_count=r.raw_count.to(dev))


def make_sharded_pipeline(plan: SiftPlan, mesh: Mesh, axis: str = "data",
                          quant_mode: str = "opencv"):
    """Returns (fn, shard).  ``shard(x)`` splits a host ``[B, H, W]``
    batch (the global one) into contiguous per-position blocks and keeps
    this process's, each on its device; B must divide by the mesh size.
    ``fn(blocks)`` runs each block on its device and returns a
    ``ShardedOutput`` (``.gather()`` for the whole batch).

    The plan's operators are moved once per distinct device.  Nothing
    synchronises with the host between positions: each block's frames are
    enqueued on its device and the boundary frame is copied device to
    device (across processes: one all-gather of each process's last
    frame)."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's axis is {mesh.axis!r}")
    detect = {}
    for dev in mesh.devices:
        if dev not in detect:
            detect[dev] = build_detect_fn(plan, quant_mode, device=dev,
                                          ops=plan_operators(plan, dev))
    ratio = plan.config.match_ratio

    def shard(x) -> List[torch.Tensor]:
        x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} frames do not split over "
                             f"{mesh.size} mesh positions")
        b = x.shape[0] // mesh.size
        lo = mesh.first_position * b
        return split_blocks(mesh, x[lo:lo + b * len(mesh.devices)])

    def fn(blocks: Sequence[torch.Tensor]) -> ShardedOutput:
        if len(blocks) != len(mesh.devices):
            raise ValueError(f"{len(blocks)} blocks for "
                             f"{len(mesh.devices)} local positions")
        results = []
        for dev, blk in zip(mesh.devices, blocks):
            with _on(dev):
                results.append(_map_frames(detect[dev], blk))
        # The frame before each block's first: the previous position's
        # last frame (the last process's last frame wraps to position 0,
        # whose row 0 is then cleared, as the roll in the JAX package).
        last_d = results[-1].descriptors[-1]
        last_v = results[-1].keypoints.valid[-1]
        if mesh.group is not None:
            from sift_tpu_torch.parallel.multihost import all_gather_cat
            last_d = all_gather_cat(last_d[None], mesh.group)[mesh.rank - 1]
            last_v = all_gather_cat(last_v[None], mesh.group)[mesh.rank - 1]
        matches = []
        for i, (dev, r) in enumerate(zip(mesh.devices, results)):
            if i:
                last_d = results[i - 1].descriptors[-1]
                last_v = results[i - 1].keypoints.valid[-1]
            with _on(dev):
                m = _match_prev(r.descriptors, r.keypoints.valid,
                                last_d.to(dev), last_v.to(dev), ratio)
                if mesh.first_position + i == 0:
                    m[0] = -1
            matches.append(m)
        return ShardedOutput(results=results, matches=matches, mesh=mesh)

    return fn, shard
