"""Exact brute-force matching with Lowe's ratio test, in plain PyTorch.

The semantics the benchmark holds the port's matcher to: for each valid
query row, the squared L2 distance to every valid train row, computed
exactly (uint8 descriptors: float64 sums of integers stay far below
2^53); the nearest train row is the match when its distance is below
``ratio`` times the second smallest distance, the test made in float32
as the configuration states it (0.8 applied to squared distances).  A
tie for the nearest row never passes the test, so the answer does not
depend on how ties are broken.  Invalid or unmatched queries give -1.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 2048


def match_exact(query: torch.Tensor, train: torch.Tensor, q_valid,
                t_valid, ratio: float = 0.8) -> torch.Tensor:
    """query [Q, 128], train [S, 128] integer descriptors; ``q_valid``
    [Q], ``t_valid`` [S] bool.  Returns [Q] int64 indices into train, or
    -1.  Rows are taken in blocks so the distance matrix stays small."""
    t = train.to(torch.float64)
    tn = (t * t).sum(-1)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=t.device)
    tn = torch.where(t_valid, tn, inf)
    out = []
    for s in range(0, query.shape[0], ROW_BLOCK):
        q = query[s:s + ROW_BLOCK].to(torch.float64)
        d2 = (q * q).sum(-1, keepdim=True) + tn - 2.0 * (q @ t.T)
        if d2.shape[1] >= 2:
            two = torch.topk(d2, 2, dim=-1, largest=False)
            min1, min2 = two.values[:, 0], two.values[:, 1]
            idx = two.indices[:, 0]
        else:
            min1, idx = d2.min(-1)
            min2 = torch.full_like(min1, float("inf"))
        ok = min1.to(torch.float32) < ratio * min2.to(torch.float32)
        ok &= q_valid[s:s + ROW_BLOCK]
        out.append(torch.where(ok, idx, torch.full_like(idx, -1)))
    return torch.cat(out)
