"""Fixed-capacity stream compaction.

Counterpart of ``sift_tpu/ops/compact.py`` (``stream_compact``): indices of
the first ``cap`` set bits of a mask, in index order — the semantics of the
reference's prefix-sum + scatter (``collectKpts``, SiftOps.cu:210-235,
capacity-capped in index order).  On a GPU the prefix sum and the scatter
are the natural formulation: one cumsum, one scatter into ``cap`` slots plus
a sink.  No ``nonzero``, no host synchronisation, static output shapes.
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
