"""Comparing two detection results of the same frame.

Two implementations of the pipeline (this package against the JAX package,
or the CUDA kernels against their plain versions) emit the same keypoints
in possibly different order and with last-digit differences, so results are
compared after pairing keypoints by identity: same octave and layer, the
same position to a fraction of a pixel, and the same orientation peak.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def pair_keypoints(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                   pos_tol: float = 1e-3, angle_tol: float = 0.5
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """a, b: dicts of numpy keypoint fields (``x y octave layer angle
    valid``, e.g. from core/convert.result_to_numpy).  Pairs each valid
    keypoint of ``a`` with the first not yet taken valid keypoint of ``b`` of the same
    octave and layer whose position differs by at most ``pos_tol *
    2^octave`` pixels on both axes and whose angle differs by at most
    ``angle_tol`` degrees (mod 360; two orientation peaks of one point
    are >= 10 degrees apart).  Returns (indices into a, indices into b)."""
    ia = np.nonzero(np.asarray(a["valid"]))[0]
    ib = np.nonzero(np.asarray(b["valid"]))[0]
    if len(ia) == 0 or len(ib) == 0:
        return ia[:0], ib[:0]
    g = lambda d, f, i: np.asarray(d[f])[i]
    tol = pos_tol * np.exp2(np.maximum(g(a, "octave", ia), 0)
                            .astype(np.float64))[:, None]
    dang = np.abs(g(a, "angle", ia)[:, None].astype(np.float64)
                  - g(b, "angle", ib)[None, :])
    dang = np.minimum(dang, 360.0 - dang)
    ok = ((g(a, "octave", ia)[:, None] == g(b, "octave", ib)[None, :])
          & (g(a, "layer", ia)[:, None] == g(b, "layer", ib)[None, :])
          & (np.abs(g(a, "x", ia)[:, None].astype(np.float64)
                    - g(b, "x", ib)[None, :]) <= tol)
          & (np.abs(g(a, "y", ia)[:, None].astype(np.float64)
                    - g(b, "y", ib)[None, :]) <= tol)
          & (dang <= angle_tol))
    # Greedy one-to-one assignment in index order: two candidates that
    # converged onto the same point are genuine duplicates on both sides.
    used = np.zeros(len(ib), bool)
    pa, pb = [], []
    for i in range(len(ia)):
        free = np.nonzero(ok[i] & ~used)[0]
        if len(free):
            used[free[0]] = True
            pa.append(ia[i])
            pb.append(ib[free[0]])
    return np.asarray(pa, np.int64), np.asarray(pb, np.int64)
