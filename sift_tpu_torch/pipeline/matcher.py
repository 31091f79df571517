"""Brute-force 128-D descriptor matching with Lowe's ratio test.

Counterpart of ``sift_tpu/pipeline/matcher.py``: all-pairs squared L2 via
one Gram matrix product (||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b), per-query
top-2 minima, and the ratio test applied to the *squared* distances (min1 <
ratio * min2, as the reference hard-codes with 0.8, Match.cu:171-175).
Unmatched queries return -1.

The train set may carry leading batch axes (``[..., S, 128]``): one query
set is then matched against each train set of the stack, as the JAX
package's loop closure does with ``jax.vmap(match_brute_force,
in_axes=(None, 0, None, 0))``.
"""

from __future__ import annotations

import math

import torch

from sift_tpu_torch.kernels.match import (gram_u8,  # noqa: F401
                                          match_u8, match_u8_plain,
                                          ratio_select, tf32_off)
from sift_tpu_torch.perf import telemetry as T


def _is_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def match_brute_force(query: torch.Tensor, train: torch.Tensor,
                      q_valid=None, t_valid=None,
                      ratio: float = 0.8) -> torch.Tensor:
    """query: [Q, 128] or [..., Q, 128] (the train set's leading axes: one
    query set per train set, as ``parallel/batched.sequential_match``
    uses it); train: [..., S, 128] — uint8 (0..255 quantised storage,
    config.descriptor_dtype="uint8") or float (0..255/0..512 quantised);
    ``t_valid`` [..., S].  Returns [..., Q] int32: index into train, or
    -1.

    The input type picks the path: uint8 descriptors go to
    ``kernels/match.match_u8`` (on the card one hand-written kernel, in
    ``sift.match.fused``; on the CPU its plain version), other integer
    descriptors to that plain version, float descriptors to the float32
    chain below (``sift.match.gram`` and ``.select``)."""
    with T.span("sift.match"):
        if query.dtype == torch.uint8 and train.dtype == torch.uint8:
            out = match_u8(query, train, q_valid, t_valid, ratio)
        elif _is_int(query) and _is_int(train):
            out = match_u8_plain(query, train, q_valid, t_valid, ratio)
        else:
            with T.span("sift.match.gram"):
                q = query.to(torch.float32) * 0.25
                t = train.to(torch.float32) * 0.25
                qn = torch.sum(q * q, -1, keepdim=True)          # [Q, 1]
                tn = torch.sum(t * t, -1).unsqueeze(-2)          # [..., 1, S]
                with tf32_off():
                    g = torch.matmul(q, t.transpose(-1, -2))
            out = ratio_select(qn, tn, g, q_valid, t_valid, ratio)

        if T.tracing():
            with T.span("sift.match.count"):
                T.count("match.entries", out.numel() * train.shape[-2])
                T.count_device("match.live_entries", live_entries(
                    query, train, q_valid, t_valid))
    return out


def live_entries(query, train, q_valid=None, t_valid=None) -> torch.Tensor:
    """0-d int64 on the train set's device: the distance entries of a
    ``match_brute_force`` call that pair a live query row with a live
    train row, summed over the train sets (a missing mask: every row of
    that side is live)."""
    lead = torch.broadcast_shapes(query.shape[:-2], train.shape[:-2])
    nq = q_valid.sum(-1) if q_valid is not None else query.shape[-2]
    nt = t_valid.sum(-1) if t_valid is not None else train.shape[-2]
    per = nq * nt
    if torch.is_tensor(per):
        return torch.broadcast_to(per, lead).sum()
    return torch.full((), per * math.prod(lead), dtype=torch.int64,
                      device=train.device)


def match_pairs(query, train, q_valid=None, t_valid=None, ratio: float = 0.8,
                cross_check: bool = False):
    """Convenience wrapper returning (query_idx, train_idx) pairs as numpy
    arrays, with optional mutual-consistency check.  Copies to the host."""
    import numpy as np

    m = match_brute_force(query, train, q_valid, t_valid,
                          ratio=ratio).cpu().numpy()
    if cross_check:
        m2 = match_brute_force(train, query, t_valid, q_valid,
                               ratio=ratio).cpu().numpy()
        qi = np.nonzero(m >= 0)[0]
        qi = qi[m2[m[qi]] == qi]
    else:
        qi = np.nonzero(m >= 0)[0]
    return qi, m[qi]
