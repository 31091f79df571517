"""Deterministic benchmark input image.

Counterpart of ``sift_tpu/perf/benchimg.py``: multi-octave value-noise
texture — photo-like spectrum yielding a realistic keypoint load.  White
noise yields almost none and would exercise an empty frame: the
per-keypoint kernels scale with the LIVE keypoint count, not the static
capacity.  The bicubic upsampling is ``torch.nn.functional.interpolate`` on
the CPU (no cv2 needed), so the image is deterministic from the seed but
not bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

# The flagship frame: what ``chip_smoke.py`` and ``perf/profile.py`` run.
FLAGSHIP_WIDTH, FLAGSHIP_HEIGHT, FLAGSHIP_FEATURES = 752, 480, 5000


def bench_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for s in (2, 4, 8, 16, 32, 64):
        n = rng.normal(0, 1, (h // s + 2, w // s + 2)).astype(np.float32)
        img += _resize_bicubic(n, h, w) * np.float32(s ** 0.4)
    img -= img.min()
    return img * np.float32(255.0 / max(float(img.max()), 1e-6))


def _resize_bicubic(a: np.ndarray, h: int, w: int) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a))[None, None]
    out = torch.nn.functional.interpolate(t, size=(h, w), mode="bicubic",
                                          align_corners=False)
    return out[0, 0].numpy()
