"""Brute-force 128-D descriptor matching with Lowe's ratio test.

Counterpart of ``sift_tpu/pipeline/matcher.py``: all-pairs squared L2 via
one Gram matrix product (||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b), per-query
top-2 minima, and the ratio test applied to the *squared* distances (min1 <
ratio * min2, as the reference hard-codes with 0.8, Match.cu:171-175).
Unmatched queries return -1.  The Gram product is a plain large matrix
product and goes to ``torch.matmul``.
"""

from __future__ import annotations

import torch


def _is_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


def match_brute_force(query: torch.Tensor, train: torch.Tensor,
                      q_valid=None, t_valid=None,
                      ratio: float = 0.8) -> torch.Tensor:
    """query: [Q, 128]; train: [S, 128] — uint8 (0..255 quantised storage,
    config.descriptor_dtype="uint8") or float (0..255/0..512 quantised).
    Returns [Q] int32: index into train, or -1."""
    if _is_int(query) and _is_int(train):
        # u8-quantised descriptors: 0..255 integers are exact in bf16 (8
        # significant bits) and every product/sum stays below 2^24
        # (128 * 255^2 < 2^24), so on a CUDA device the bf16 tensor-core
        # Gram product with f32 accumulation is BIT-IDENTICAL to the f32
        # one; on the CPU it simply runs in f32.  The ratio test is scale
        # invariant, so the reference's 0.25 pre-scale is dropped here.
        qf = query.to(torch.float32)
        tf = train.to(torch.float32)
        qn = torch.sum(qf * qf, -1, keepdim=True)       # [Q, 1]
        tn = torch.sum(tf * tf, -1, keepdim=True).T     # [1, S]
        if query.is_cuda:
            gram = torch.matmul(query.to(torch.bfloat16),
                                train.to(torch.bfloat16).T
                                ).to(torch.float32)
        else:
            gram = torch.matmul(qf, tf.T)
        d2 = qn + tn - 2.0 * gram                       # [Q, S]
    else:
        q = query.to(torch.float32) * 0.25
        t = train.to(torch.float32) * 0.25
        qn = torch.sum(q * q, -1, keepdim=True)         # [Q, 1]
        tn = torch.sum(t * t, -1, keepdim=True).T       # [1, S]
        d2 = qn + tn - 2.0 * torch.matmul(q, t.T)
    d2 = torch.clamp(d2, min=0.0)

    # Invalid-entry sentinel: must exceed any real distance (the unscaled
    # u8 path reaches 128*255^2 ~ 8.3e6).
    big = torch.full((), 1e9, dtype=torch.float32, device=d2.device)
    if t_valid is not None:
        d2 = torch.where(t_valid[None, :], d2, big)

    min1, idx1 = torch.min(d2, -1)
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    d2b = torch.where(cols == idx1[:, None], big, d2)
    min2 = torch.min(d2b, -1).values

    matched = min1 < ratio * min2
    if q_valid is not None:
        matched = matched & q_valid
    return torch.where(matched, idx1, -1).to(torch.int32)


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
