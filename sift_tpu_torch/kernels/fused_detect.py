"""Record-field kernel: Gaussian octave -> DoG -> 3x3x3 extrema mask ->
Newton record field, one pass, every octave of a pyramid in one launch.

Counterpart of ``sift_tpu/kernels/fused_detect.py``
(``detect_records_pallas``).  The CUDA kernel is
``csrc/fused_detect.cu``; ``detect_records_plain`` beside it is the same
function in plain PyTorch (ops/peaks.peak_mask +
ops/refine_dense.record_fields + ops/records.pack_record_channels).  The
wrapper ``detect_records_cuda`` launches the kernel or raises; the plain
version serves CPU tensors and explicit ``kernel_impl="torch"`` runs.

Input: a list of octaves, each ``[NL, h_o, w_o]`` f32 at its natural
shape, any h, w >= 1, the same NL (one octave is the one-element case).
Output: a list of ``[3, NL-3, h_o, w_o]`` f32, PLANE-major (channels
A/B/C, then record layers 1..NL-3); the kernel's outputs are views of one
allocation.  Reads at x+-1 / y+-1 are clamped to the image in both
versions; the 1-px rim is unused by contract, and the peak bit is masked
to ``[border, size - border)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from sift_tpu_torch.kernels import build

# Output tile of one block of the kernel (csrc/fused_detect.cu BX, BY)
# and the most octaves one launch takes (MAX_OCTAVES).
TILE_W = 32
TILE_H = 8
MAX_OCTAVES = 16

# Launch counts: ``launches`` rises by one where the wrapper launches the
# CUDA kernel and nowhere else; ``plain_calls`` counts the plain version.
launches = {"detect_records": 0}
plain_calls = {"detect_records": 0}


@functools.lru_cache(maxsize=64)
def octave_table(shapes: Tuple[Tuple[int, int], ...]
                 ) -> Tuple[Tuple[Tuple[int, int, int], ...], int]:
    """Block layout of one launch over octaves of shapes ``(h, w)``.

    Returns ``(rows, total)``: one row ``(octave, first_block, tiles_x)``
    per octave in BLOCK order — the octave with the most tiles first (ties
    in list order), so the small octaves fill the tail of the large ones —
    and the total number of blocks.  Octave ``o`` owns blocks
    ``[first, first + tiles_x * tiles_y)``."""
    tiles = []
    for o, (h, w) in enumerate(shapes):
        if h < 1 or w < 1:
            raise ValueError(f"octave {o} has shape {h}x{w}")
        tx, ty = -(-w // TILE_W), -(-h // TILE_H)
        tiles.append((o, tx, tx * ty))
    rows, first = [], 0
    for o, tx, n in sorted(tiles, key=lambda t: -t[2]):
        rows.append((o, first, tx))
        first += n
    return tuple(rows), first


def _check_octaves(octaves: Sequence[torch.Tensor]) -> None:
    if len(octaves) == 0:
        raise ValueError("no octaves given")
    for g in octaves:
        if g.dtype != torch.float32 or g.dim() != 3:
            raise ValueError("each octave must be [NL, h, w] float32, got "
                             f"{tuple(g.shape)} {g.dtype}")
    nl, dev = octaves[0].shape[0], octaves[0].device
    if any(g.shape[0] != nl or g.device != dev for g in octaves):
        raise ValueError("all octaves must have the same layer count and "
                         "device")
    if nl < 4:
        raise ValueError(f"need at least 4 Gaussian layers, got {nl}")


def detect_records_plain(octaves: Sequence[torch.Tensor], threshold: float,
                         border: int, edge_threshold: float,
                         contrast_threshold: float,
                         octave_layers: int) -> List[torch.Tensor]:
    """Plain PyTorch version of the kernel (any device): one call covers
    all ``octaves``."""
    from sift_tpu_torch.ops.peaks import clamp_pad, peak_mask
    from sift_tpu_torch.ops.records import pack_record_channels
    from sift_tpu_torch.ops.refine_dense import record_fields

    _check_octaves(octaves)
    plain_calls["detect_records"] += 1
    out = []
    for g in octaves:
        dog = g[1:] - g[:-1]
        dogp = clamp_pad(dog)
        x0, x1, x2, contrast, flags = record_fields(dog, edge_threshold,
                                                    dogp)
        mask, _ = peak_mask(dog, threshold, border, dogp)
        cok = contrast * octave_layers >= contrast_threshold
        a, b, c = pack_record_channels(x0, x1, x2, contrast, flags, mask,
                                       cok)
        out.append(torch.stack([a, b, c], dim=0))      # [3, L, h, w]
    return out


def detect_records_cuda(octaves: Sequence[torch.Tensor], threshold: float,
                        border: int, edge_threshold: float,
                        contrast_threshold: float,
                        octave_layers: int) -> List[torch.Tensor]:
    """ONE launch of the CUDA kernel over all ``octaves``, on their device
    and current stream.  Raises on anything the kernel does not take;
    never falls back."""
    octaves = list(octaves)
    _check_octaves(octaves)
    dev = octaves[0].device
    if not octaves[0].is_cuda:
        raise ValueError(f"detect_records_cuda needs CUDA tensors, got {dev}")
    if len(octaves) > MAX_OCTAVES:
        raise ValueError(f"at most {MAX_OCTAVES} octaves per launch, got "
                         f"{len(octaves)}")
    if not all(g.is_contiguous() for g in octaves):
        raise ValueError("octaves must be contiguous")
    nl = octaves[0].shape[0]
    rows, blocks = octave_table(tuple((g.shape[1], g.shape[2])
                                      for g in octaves))
    sizes = [3 * (nl - 3) * g.shape[1] * g.shape[2] for g in octaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs, off = [], 0
    for g, n in zip(octaves, sizes):
        outs.append(flat[off:off + n].view(3, nl - 3, g.shape[1],
                                           g.shape[2]))
        off += n
    table = (ctypes.c_longlong * (6 * len(rows)))()
    for i, (o, first, tx) in enumerate(rows):
        g = octaves[o]
        table[6 * i:6 * i + 6] = [g.data_ptr(), outs[o].data_ptr(),
                                  g.shape[1], g.shape[2], first, tx]
    lib = build.load_library()
    et = float(edge_threshold)
    with torch.cuda.device(dev):
        rc = lib.sift_detect_records(
            table, len(rows), blocks, nl, float(threshold), int(border), et,
            (et + 1.0) * (et + 1.0), float(contrast_threshold),
            float(octave_layers), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "sift_detect_records")
    launches["detect_records"] += 1
    return outs


def detect_records(octaves: Sequence[torch.Tensor], threshold: float,
                   border: int, edge_threshold: float,
                   contrast_threshold: float, octave_layers: int,
                   impl: str = "auto") -> List[torch.Tensor]:
    """The kernel's wrapper: CUDA tensors launch the kernel once (or
    raise); the plain version is taken for CPU tensors, or on explicit
    ``impl="torch"``."""
    from sift_tpu_torch.ops.records import resolve_kernel_impl
    if len(octaves) == 0:
        raise ValueError("no octaves given")
    fn = detect_records_cuda \
        if resolve_kernel_impl(impl, octaves[0].device) == "cuda" \
        else detect_records_plain
    return fn(octaves, threshold, border, edge_threshold,
              contrast_threshold, octave_layers)
