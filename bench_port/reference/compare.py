"""How a detector's output is held against the reference's.

Two keypoints pair when they have the same octave and layer, positions
within ``pos_tol * 2^octave`` pixels on both axes, the same window centre
(the position rounded to a pixel of the octave, around which SIFT samples
the orientation and the descriptor), and angles within ``angle_tol``
degrees (mod 360; two orientation peaks of one point lie at least 10
degrees apart), one to one.  A keypoint within rounding of a half pixel
may round to another centre on either side: its windows then sample
other pixels, and it counts as unpaired.  So does a keypoint whose
orientation, refined by a parabola through a flat histogram peak, lies
more than ``angle_tol`` (0.1 degrees) from the reference's: the
descriptor's grid turns with it.  Rows that agree at the same index
pair first; the rest pair greedily in index order.  The numbers compared
are the share of keypoints left unpaired and the largest difference of a
paired descriptor entry.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("x", "y", "octave", "layer", "angle", "valid")


def _ok(a, b, ia, ib, pos_tol, angle_tol):
    """Agreement of keypoints a[ia] and b[ib], broadcast as the index
    arrays are (equal lengths: row by row; a column against a row: every
    pair)."""
    scale = np.exp2(np.maximum(a["octave"][ia], 0).astype(np.float64))
    dang = np.abs(a["angle"][ia].astype(np.float64) - b["angle"][ib])
    dang = np.minimum(dang, 360.0 - dang)
    ok = ((a["octave"][ia] == b["octave"][ib])
          & (a["layer"][ia] == b["layer"][ib]) & (dang <= angle_tol))
    for f in ("x", "y"):
        u = a[f][ia].astype(np.float64)
        v = np.asarray(b[f], np.float64)[ib]
        ok &= ((np.abs(u - v) <= pos_tol * scale)
               & (np.round(u / scale) == np.round(v / scale)))
    return ok


def pair_keypoints(a, b, pos_tol: float = 1e-3, angle_tol: float = 0.1):
    """a, b: dicts of numpy keypoint fields (``FIELDS``).  Returns
    (indices into a, indices into b) of the paired keypoints."""
    va, vb = np.asarray(a["valid"], bool), np.asarray(b["valid"], bool)
    n = min(len(va), len(vb))
    same = np.zeros(n, bool)
    both = np.nonzero(va[:n] & vb[:n])[0]
    same[both] = _ok(a, b, both, both, pos_tol, angle_tol)
    pa, pb = list(np.nonzero(same)[0]), list(np.nonzero(same)[0])
    used_a, used_b = np.zeros(len(va), bool), np.zeros(len(vb), bool)
    used_a[:n] |= same
    used_b[:n] |= same
    ra = np.nonzero(va & ~used_a)[0]
    rb = np.nonzero(vb & ~used_b)[0]
    if len(ra) and len(rb):
        ok = _ok(a, b, ra[:, None], rb[None, :], pos_tol, angle_tol)
        taken = np.zeros(len(rb), bool)
        for i in range(len(ra)):
            free = np.nonzero(ok[i] & ~taken)[0]
            if len(free):
                taken[free[0]] = True
                pa.append(ra[i])
                pb.append(rb[free[0]])
    return np.asarray(pa, np.int64), np.asarray(pb, np.int64)


def detector_gaps(a, desc_a, b, desc_b):
    """(share of keypoints unpaired, largest paired descriptor entry
    difference) of keypoints ``a`` with descriptors ``desc_a`` against
    ``b`` / ``desc_b``."""
    ia, ib = pair_keypoints(a, b)
    n = max(int(np.sum(a["valid"])), int(np.sum(b["valid"])))
    unpaired = 1.0 - len(ia) / n if n else 0.0
    diff = int(np.abs(desc_a[ia].astype(np.int32)
                      - desc_b[ib].astype(np.int32)).max()) if len(ia) else 0
    return unpaired, diff
