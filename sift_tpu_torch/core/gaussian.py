"""Host-side Gaussian kernel and linear-operator construction.

Equivalent capability to the reference's ``GaussianUtils``
(sift_cuda/utils/GaussianUtils.cc:6-68) — 1-D/2-D Gaussian
kernels with size ``int(round(sigma*truncate + 1)) | 1`` and ``sum == 1``.

Counterpart of ``sift_tpu/core/gaussian.py`` (numpy only).  Instead of
running separable convolutions with these kernels, each blur is baked into
a **banded linear operator** (a [N, N] matrix applying the kernel with
BORDER_REFLECT_101 boundary handling, mirroring reflect101 in
image_func/Filter.cuh:52-66).  A separable 2-D blur of image ``I`` is then
``V @ I @ H.T`` — two matrix products, batched over pyramid layers.
Operator *composition* (matrix products, done here on the host in float64)
gives every pyramid layer directly from the octave base while remaining
numerically equivalent to the reference's sequential blur chain
(interface/Detector.cu:292-303).  ``banded_blocks_multi`` cuts such
operators into row tiles that each read only a band of input rows: the
detector's pyramid (ops/blur.blur_tiled) costs O(n * band * w) instead of
the dense operators' O(n^2 * w).
"""

from __future__ import annotations

import numpy as np


def kernel_size(sigma: float, truncate: float = 6.0) -> int:
    """size = int(round(sigma * truncate + 1)) | 1 (GaussianUtils.cc:8,40)."""
    return int(round(sigma * truncate + 1)) | 1


def gaussian_kernel_1d(sigma: float, truncate: float = 6.0,
                       dtype=np.float64) -> np.ndarray:
    """Normalized 1-D Gaussian, center = size // 2 (GaussianUtils.cc:39-68)."""
    size = kernel_size(sigma, truncate)
    mean = size // 2
    x = np.arange(size, dtype=np.float64) - mean
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(dtype)


def gaussian_kernel_2d(sigma: float, truncate: float = 6.0,
                       dtype=np.float64) -> np.ndarray:
    """Normalized 2-D Gaussian (GaussianUtils.cc:6-37).

    Note: not exactly the outer product of the 1-D kernel because the 2-D
    version normalizes over the full grid, matching the reference.
    """
    size = kernel_size(sigma, truncate)
    mean = size // 2
    x = np.arange(size, dtype=np.float64) - mean
    g = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    return g.astype(dtype)


def reflect101_index(idx: np.ndarray, length: int) -> np.ndarray:
    """BORDER_REFLECT_101 index map (image_func/Filter.cuh:52-66):
    ``dcb|abcdefgh|gfe`` — the border pixel is not repeated."""
    if length <= 1:
        return np.zeros_like(idx)
    idx = np.abs(idx)
    period = 2 * (length - 1)
    idx = idx % period
    return np.where(idx >= length, period - idx, idx)


def blur_operator(length: int, kernel: np.ndarray,
                  dtype=np.float32) -> np.ndarray:
    """[length, length] matrix M with (M @ x) == reflect-101 1-D convolution
    of x with ``kernel``.  Built in float64 for composition accuracy."""
    size = kernel.shape[0]
    half = size // 2
    m = np.zeros((length, length), dtype=np.float64)
    rows = np.arange(length)
    for t in range(size):
        # out[r] += kernel[t] * in[reflect101(r + t - half)], matching
        # apply1DFilterToPixel (image_func/Filter.cu:33-50).
        cols = reflect101_index(rows + (t - half), length)
        np.add.at(m, (rows, cols), kernel[t])
    return m.astype(dtype)


def banded_blocks_multi(ops, tile: int, pad_top: int, out_rows: int,
                        dtype=np.float32):
    """Band-blocked form of a stack of banded operators, for the tiled
    blur (ops/blur.blur_tiled).

    ops: list of [n_content, n_in] float64 operators sharing n_in (the
    per-layer composed blur chains).  Conceptually each is zero-padded to
    [out_rows, n_in] with its rows placed at [pad_top, pad_top +
    n_content) — the padded pyramid layout — then cut into out_rows //
    tile uniform row tiles.  Because the operators are banded, tile t only
    reads input columns [off[t], off[t] + band): the dense [n, n] @ [n, w]
    product (O(n^2 w)) becomes nT [tile, band] @ [band, w] products
    (O(n * band * w)).

    Columns whose largest tap is below 1e-9 of the operator's max are
    dropped from the band: the composed chains' tails decay to 1e-30
    while the f32 arithmetic floor is ~1e-7.  The band is rounded up to a
    multiple of 8 columns.

    Returns (blocks [nT, len(ops), tile, band] ``dtype``, offsets [nT]
    int64 numpy — each tile's first input row)."""
    n_c, n_in = ops[0].shape
    assert out_rows % tile == 0
    nt = out_rows // tile
    exts = []
    for t in range(nt):
        r0 = max(t * tile - pad_top, 0)
        r1 = min((t + 1) * tile - pad_top, n_c)
        if r0 >= r1:
            exts.append((0, 1))
            continue
        lo, hi = n_in, 0
        for op in ops:
            sub = np.abs(op[r0:r1])
            nz = np.nonzero(sub.max(axis=0) > 1e-9 * sub.max())[0]
            lo, hi = min(lo, int(nz[0])), max(hi, int(nz[-1]) + 1)
        exts.append((lo, hi))
    band = max(hi - lo for lo, hi in exts)
    band = min(-(-band // 8) * 8, n_in)
    blocks = np.zeros((nt, len(ops), tile, band), np.float64)
    offs = np.zeros((nt,), np.int64)
    for t, (lo, hi) in enumerate(exts):
        off = min(max(lo, 0), n_in - band)
        offs[t] = off
        r0 = max(t * tile - pad_top, 0)
        r1 = min((t + 1) * tile - pad_top, n_c)
        if r0 < r1:
            a = r0 + pad_top - t * tile
            for li, op in enumerate(ops):
                blocks[t, li, a:a + (r1 - r0)] = op[r0:r1, off:off + band]
    return blocks.astype(dtype), offs


def resize_operator(out_len: int, in_len: int,
                    dtype=np.float32) -> np.ndarray:
    """[out_len, in_len] bilinear-resize matrix with the reference's
    center-aligned coordinates and clamped edges (image_func/Resize.cu:26-63):
    ``coord = (i + 0.5) * in/out - 0.5``."""
    m = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        coord = (i + 0.5) * in_len / out_len - 0.5
        lo = int(np.floor(coord))
        frac = coord - lo
        # Reference clamps both taps into [0, in_len - 1]; when frac == 0 the
        # second tap is lo + 1 (clamped) with weight 0, so it is irrelevant.
        i1 = min(in_len - 1, max(0, lo))
        i2 = min(in_len - 1, max(0, lo + 1 if frac == 0 else int(np.ceil(coord))))
        m[i, i1] += 1.0 - frac
        m[i, i2] += frac
    return m.astype(dtype)


def decimation_operator(out_len: int, in_len: int,
                        dtype=np.float32) -> np.ndarray:
    """[out_len, in_len] nearest-neighbor 2x decimation matrix:
    out[i] = in[2*i] (OpenCV buildGaussianPyramid INTER_NEAREST halving,
    sx = floor(i * 2))."""
    m = np.zeros((out_len, in_len), dtype=dtype)
    idx = np.minimum(2 * np.arange(out_len), in_len - 1)
    m[np.arange(out_len), idx] = 1.0
    return m


def sigma_schedule(sigma: float, num_octave_layers: int) -> np.ndarray:
    """Per-layer incremental sigmas (interface/Detector.cu:63-71):
    sigmas[0] = sigma; sigmas[i] = sqrt(sig_total^2 - sig_prev^2) with
    k = 2^(1/L)."""
    n = num_octave_layers + 3
    sigmas = np.empty(n, dtype=np.float64)
    sigmas[0] = sigma
    k = 2.0 ** (1.0 / num_octave_layers)
    for i in range(1, n):
        sig_prev = (k ** (i - 1)) * sigma
        sig_total = sig_prev * k
        sigmas[i] = np.sqrt(sig_total * sig_total - sig_prev * sig_prev)
    return sigmas


def initial_sigma_diff(sigma: float, upscale: bool) -> float:
    """Base-image blur sigma (interface/Detector.cu:54-56):
    sqrt(max(sigma^2 - 4 * INIT_SIGMA^2, 0.01)).  The reference applies the
    same formula with and without upscaling."""
    from sift_tpu_torch.config import SIFT_INIT_SIGMA
    del upscale  # same formula either way, kept for call-site clarity
    return float(np.sqrt(max(sigma * sigma
                             - SIFT_INIT_SIGMA * SIFT_INIT_SIGMA * 4.0, 0.01)))
