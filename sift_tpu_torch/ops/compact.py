"""Fixed-capacity compaction.

Counterpart of ``sift_tpu/ops/compact.py``.  ``stream_compact``: indices of
the first ``cap`` set bits of a mask, in index order — the semantics of the
reference's prefix-sum + scatter (``collectKpts``, SiftOps.cu:210-235,
capacity-capped in index order).  On a GPU the prefix sum and the scatter
are the natural formulation: one cumsum, one scatter into ``cap`` slots plus
a sink.  ``topk_compact`` / ``mask_compact`` select by score; the JAX
package's ``lax.top_k`` breaks ties by lowest index, which ``torch.topk``
does not promise, so both run a stable descending sort.  No ``nonzero``, no
host synchronisation, static output shapes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def stream_compact(valid: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """valid: [n] bool.  Returns (indices [cap] int32, out_valid [cap]
    bool): slot j holds the index of the j-th set bit for j < min(count,
    cap); other slots hold 0 and are marked invalid."""
    n = valid.shape[0]
    dev = valid.device
    c = torch.cumsum(valid.to(torch.int32), 0)
    pos = c.to(torch.int64) - 1
    # Set bits past the capacity and unset bits all land in the sink slot.
    dest = torch.where(valid & (pos < cap), pos,
                       torch.full_like(pos, cap))
    idx = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    idx.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    out_valid = torch.arange(cap, dtype=torch.int32, device=dev) < c[-1]
    return torch.where(out_valid, idx[:cap], 0), out_valid


# Score of an invalid entry (the JAX module's NEG).
NEG = -3.0e38


def _top_k(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``k`` largest values in
    descending order, equal values by lowest index first."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _place(top_s, top_i, cap: int, threshold: float):
    """The first ``k`` selections in slots [0, k) of ``cap``; the rest
    hold index 0 and are invalid."""
    k = top_s.shape[0]
    dev = top_s.device
    out_i = torch.zeros((cap,), dtype=torch.int32, device=dev)
    out_v = torch.zeros((cap,), dtype=torch.bool, device=dev)
    out_i[:k] = top_i.to(torch.int32)
    out_v[:k] = top_s > threshold
    return out_i, out_v


def topk_compact(score: torch.Tensor, valid: torch.Tensor, cap: int,
                 tile: int = 1024, per_tile: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``cap`` valid entries with the highest scores, in descending
    score order (ties: lowest index first).

    score: [N] float32; valid: [N] bool.  Returns (indices [cap] int32,
    out_valid [cap] bool).  For small N the selection is exact; otherwise
    each ``tile`` of entries keeps its ``per_tile`` best first (exact while
    no tile holds more than ``per_tile`` valid entries), as in the JAX
    module."""
    n = score.shape[0]
    neg = torch.full((), NEG, dtype=score.dtype, device=score.device)
    s = torch.where(valid, score, neg)
    if n <= max(4 * tile, 4 * cap):
        top_s, top_i = _top_k(s, min(cap, n))
        return _place(top_s, top_i, cap, NEG)

    pad = (-n) % tile
    if pad:
        s = torch.cat([s, neg.expand(pad)])
    nt = s.shape[0] // tile
    t_s, t_i = _top_k(s.reshape(nt, tile), min(per_tile, tile))
    base = (torch.arange(nt, dtype=torch.int64, device=s.device)
            * tile)[:, None]
    cand_i = (t_i + base).reshape(-1)
    cand_s = t_s.reshape(-1)
    top_s, top_j = _top_k(cand_s, min(cap, cand_s.shape[0]))
    return _place(top_s, cand_i[top_j], cap, NEG)


def mask_compact(valid: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compaction by index order only (``stream_compact``'s semantics):
    the JAX module's top-k over the 0/1 mask, ties by lowest index, so
    the slots past the count hold the first unset indices.  Returns
    (indices [cap] int32, out_valid [cap] bool)."""
    top_s, top_i = _top_k(valid.to(torch.float32),
                          min(cap, valid.shape[0]))
    return _place(top_s, top_i, cap, 0.5)


def gather_keypoint_fields(tree, idx: torch.Tensor, valid: torch.Tensor):
    """Every tensor leaf of a keypoint tree (a NamedTuple, dict, list or
    tuple of tensors) taken at ``idx`` along its first axis; ``valid`` is
    passed through.  Returns (gathered tree, valid)."""
    idx = idx.to(torch.int64)

    def take(node):
        if isinstance(node, torch.Tensor):
            return node.index_select(0, idx.to(node.device))
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[take(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)(take(v) for v in node)
        raise TypeError(f"not a keypoint tree leaf: {type(node)}")

    return take(tree), valid
