"""Brute-force matching of uint8 descriptors in one hand-written kernel.

Replaces no TPU kernel: the JAX package leaves its matcher to XLA.  The
CUDA kernel (``csrc/match_u8.cu``) replaces the port's PyTorch distance
chain: a float32 Gram product, then some twenty-five elementwise and
reduction kernels over ``[..., Q, S]`` float32 temporaries (4 GB each for
ten 10000-row sets).  It goes from the uint8 rows and masks straight to
the int32 indices: the Gram product on the int8 tensor cores, exact in
int32, and the distance, the top-2 and the ratio test in its epilogue, so
no ``[..., Q, S]`` tensor exists in device memory.  Its bound is int8
tensor-core operations (``bench_port/rooflines.match_work``); the source
says what its design does about that.

``match_u8_plain`` beside it is the same function in plain PyTorch (the
matcher's exact integer branch, which also serves other integer dtypes).
The wrapper ``match_u8_cuda`` launches the kernel on the current stream or
raises; ``match_u8`` takes the plain version for CPU tensors only.  The
Gram helper ``gram_u8`` and its two exact routes serve the plain version
and the tests.
"""

from __future__ import annotations

import contextlib
import math

import torch

from sift_tpu_torch.kernels import build
from sift_tpu_torch.perf import telemetry as T

DIM = 128
EPOCH = 128          # the kernel's column padding (csrc/match_u8.cu)
MAX_SETS = 65535     # the kernel's grid.y
GRAM_ROUTES = ("f32", "tensor_cores")

# Launch counts: ``launches`` rises by one where the wrapper launches the
# kernel (its two launches, the norms pre-pass and the matcher) and
# nowhere else.
launches = {"match_u8": 0}


@contextlib.contextmanager
def tf32_off():
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
        with tf32_off():
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


def ratio_select(qn, tn, g, q_valid, t_valid, ratio: float) -> torch.Tensor:
    """The plain distance chain: d2 = qn + tn - 2 g, masked train rows at
    1e9, per query the smallest distance and its (first) column, the
    smallest over the other columns, and Lowe's test on them in float32.
    Returns [..., Q] int32: the column, or -1."""
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
        return torch.where(matched, idx1, -1).to(torch.int32)


def match_u8_plain(query: torch.Tensor, train: torch.Tensor, q_valid=None,
                   t_valid=None, ratio: float = 0.8) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device, any integer
    dtype): the Gram product is exact in float32 (``gram_u8``), as the JAX
    package's bf16 product with preferred_element_type=float32 is.  The
    ratio test is scale invariant, so the reference's 0.25 pre-scale is
    dropped here."""
    with T.span("sift.match.gram"):
        qf = query.to(torch.float32)
        tf = train.to(torch.float32)
        qn = torch.sum(qf * qf, -1, keepdim=True)        # [Q, 1]
        tn = torch.sum(tf * tf, -1).unsqueeze(-2)        # [..., 1, S]
        g = gram_u8(query, train)
    return ratio_select(qn, tn, g, q_valid, t_valid, ratio)


def _broadcast(*shapes) -> tuple:
    """The broadcast of ``shapes`` by PyTorch's rule (what
    ``torch.broadcast_shapes`` gives, without its first call's import of
    the symbolic-shape machinery, seconds long)."""
    n = max(map(len, shapes))
    out = [1] * n
    for shape in shapes:
        for i, d in enumerate(shape, n - len(shape)):
            if d != 1:
                if out[i] != 1 and out[i] != d:
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _sets(x: torch.Tensor, lead, tail):
    """``x`` broadcast to ``[*lead, *tail]`` as (a contiguous tensor whose
    sets lie ``stride`` elements apart, stride): one copy shared by every
    set (stride 0) where ``x`` has no set axes of its own."""
    k = len(tail)
    if x.dim() == k or math.prod(x.shape[:-k]) == 1:
        return x.reshape(tail).contiguous(), 0
    if tuple(x.shape[:-k]) != lead:
        x = x.expand(*lead, *tail)
    return x.contiguous(), math.prod(tail)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _ptr(x):
    return None if x is None else x.data_ptr()


def match_u8_cuda(query: torch.Tensor, train: torch.Tensor, q_valid=None,
                  t_valid=None, ratio: float = 0.8) -> torch.Tensor:
    """Launch the kernel on ``train``'s device and current stream: query
    [Q, 128] or [..., Q, 128] uint8, train [..., S, 128] uint8, masks None,
    [Q] / [..., Q] and [S] / [..., S]; the leading axes broadcast.
    Returns [..., Q] int32.  Raises on anything the kernel does not take;
    never falls back."""
    for name, x in (("query", query), ("train", train)):
        if not x.is_cuda:
            raise ValueError(f"match_u8_cuda needs CUDA tensors, {name} is "
                             f"on {x.device}")
        if x.dtype != torch.uint8 or x.dim() < 2 or x.shape[-1] != DIM:
            raise ValueError(f"{name} must be [..., N, {DIM}] uint8, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if query.device != train.device:
        raise ValueError(f"query on {query.device}, train on {train.device}")
    nq, ns = query.shape[-2], train.shape[-2]
    if ns == 0:
        raise ValueError("match_u8_cuda needs at least one train row")
    masks = [m if m is None or m.dtype == torch.bool else m.to(torch.bool)
             for m in (q_valid, t_valid)]
    if any(m is not None and m.device != train.device for m in masks):
        raise ValueError(f"the masks must lie on {train.device}")
    lead = _broadcast(query.shape[:-2], train.shape[:-2],
                      *[m.shape[:-1] for m in masks if m is not None])
    nsets = math.prod(lead)
    if nsets > MAX_SETS:
        raise ValueError(f"{nsets} train sets exceed the kernel's grid")
    out = torch.empty((nsets, nq), dtype=torch.int32, device=train.device)
    if nsets == 0 or nq == 0:
        return out.reshape(*lead, nq)
    lib = build.load_library()
    with T.span("sift.match.fused"), torch.cuda.device(train.device):
        q, q_stride = _sets(query, lead, (nq, DIM))
        t, t_stride = _sets(train, lead, (ns, DIM))
        q, t = _aligned(q), _aligned(t)
        qv, qv_stride = _sets(masks[0], lead, (nq,)) if masks[0] is not None \
            else (None, 0)
        tv, tv_stride = _sets(masks[1], lead, (ns,)) if masks[1] is not None \
            else (None, 0)
        s_pad = -(-ns // EPOCH) * EPOCH
        cols = torch.empty((nsets, s_pad), dtype=torch.int32,
                           device=train.device)
        rc = lib.sift_match_u8(
            q.data_ptr(), q_stride, _ptr(qv), qv_stride, t.data_ptr(),
            t_stride, _ptr(tv), tv_stride, cols.data_ptr(), out.data_ptr(),
            nsets, nq, ns, float(ratio),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "sift_match_u8")
    launches["match_u8"] += 1
    T.count("match.kernel_calls", 1)
    return out.reshape(*lead, nq)


def match_u8(query: torch.Tensor, train: torch.Tensor, q_valid=None,
             t_valid=None, ratio: float = 0.8) -> torch.Tensor:
    """[..., Q] int32 indices into train, or -1: the kernel for CUDA
    tensors (or an error), the plain version for CPU tensors."""
    fn = match_u8_cuda if train.is_cuda else match_u8_plain
    return fn(query, train, q_valid, t_valid, ratio)
