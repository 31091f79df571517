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

import contextlib
import math

import torch

from sift_tpu_torch.perf import telemetry as T

GRAM_ROUTES = ("f32", "tensor_cores")


def _is_int(t: torch.Tensor) -> bool:
    return not (t.is_floating_point() or t.is_complex())


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for the products inside, whatever the process set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gram_u8(query: torch.Tensor, train: torch.Tensor,
            route: str = "f32") -> torch.Tensor:
    """Exact float32 Gram product of integer descriptors (0..255).

    query [..., Q, D], train [..., S, D] -> [..., Q, S] float32.  Every
    product and partial sum is an integer below 2^24 (128 * 255^2), so
    both routes are exact:
      * ``"f32"``: float32 operands, TF32 off for the call;
      * ``"tensor_cores"``: bfloat16 operands (0..255 are exact in 8
        significant bits) with a float32 RESULT.  On the card this is one
        bf16 tensor-core product with f32 output (``out_dtype``); on the
        CPU the same arithmetic runs as a float32 product of the bf16
        values.  A bf16 result would keep only 8 significant bits of
        values up to 8.3e6 — never take one."""
    if route == "f32":
        with _tf32_off():
            return torch.matmul(query.to(torch.float32),
                                train.to(torch.float32).transpose(-1, -2))
    if route != "tensor_cores":
        raise ValueError(f"gram route {route!r} not in {GRAM_ROUTES}")
    qb = query.to(torch.bfloat16)
    tb = train.to(torch.bfloat16).transpose(-1, -2)
    if not qb.is_cuda:
        return torch.matmul(qb.to(torch.float32), tb.to(torch.float32))
    lead = torch.broadcast_shapes(qb.shape[:-2], tb.shape[:-2])
    q3 = qb.expand(*lead, *qb.shape[-2:]).reshape(-1, *qb.shape[-2:])
    t3 = tb.expand(*lead, *tb.shape[-2:]).reshape(-1, *tb.shape[-2:])
    out = torch.bmm(q3, t3, out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


def match_brute_force(query: torch.Tensor, train: torch.Tensor,
                      q_valid=None, t_valid=None,
                      ratio: float = 0.8) -> torch.Tensor:
    """query: [Q, 128] or [..., Q, 128] (the train set's leading axes: one
    query set per train set, as ``parallel/batched.sequential_match``
    uses it); train: [..., S, 128] — uint8 (0..255 quantised storage,
    config.descriptor_dtype="uint8") or float (0..255/0..512 quantised);
    ``t_valid`` [..., S].  Returns [..., Q] int32: index into train, or
    -1."""
    with T.span("sift.match"):
        with T.span("sift.match.gram"):
            if _is_int(query) and _is_int(train):
                # u8-quantised descriptors: the Gram product is exact in
                # float32 (gram_u8), as the JAX package's bf16 product with
                # preferred_element_type=float32 is.  The ratio test is
                # scale invariant, so the reference's 0.25 pre-scale is
                # dropped here.
                qf = query.to(torch.float32)
                tf = train.to(torch.float32)
                qn = torch.sum(qf * qf, -1, keepdim=True)        # [Q, 1]
                tn = torch.sum(tf * tf, -1).unsqueeze(-2)        # [..., 1, S]
                g = gram_u8(query, train)
            else:
                q = query.to(torch.float32) * 0.25
                t = train.to(torch.float32) * 0.25
                qn = torch.sum(q * q, -1, keepdim=True)          # [Q, 1]
                tn = torch.sum(t * t, -1).unsqueeze(-2)          # [..., 1, S]
                with _tf32_off():
                    g = torch.matmul(q, t.transpose(-1, -2))

        with T.span("sift.match.select"):
            # The product is let go before the clamp's output is made, so
            # the call holds at most three [..., Q, S] float32 temporaries.
            d2 = qn + tn
            d2 -= 2.0 * g
            del g
            d2 = torch.clamp(d2, min=0.0)                        # [..., Q, S]

            # Invalid-entry sentinel: must exceed any real distance (the
            # unscaled u8 path reaches 128*255^2 ~ 8.3e6).
            big = torch.full((), 1e9, dtype=torch.float32, device=d2.device)
            if t_valid is not None:
                d2 = torch.where(t_valid.unsqueeze(-2), d2, big)

            min1, idx1 = torch.min(d2, -1)
            cols = torch.arange(d2.shape[-1], device=d2.device)
            d2b = torch.where(cols == idx1.unsqueeze(-1), big, d2)
            min2 = torch.min(d2b, -1).values

            matched = min1 < ratio * min2
            if q_valid is not None:
                matched = matched & q_valid
            out = torch.where(matched, idx1, -1).to(torch.int32)

        if T.tracing():
            with T.span("sift.match.count"):
                T.count("match.entries", d2.numel())
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
