"""Window sizing shared by the per-keypoint stages.

Counterpart of ``sift_tpu/kernels/window_gather.py`` — ``window_rows``
only.  The batched window-copy kernel of that module serves the JAX
package's non-fused path and is not ported yet.
"""

from __future__ import annotations

SUBLANE = 8


def window_rows(radius: int) -> int:
    """Rows of a window that holds a patch of +-radius with a 1-px
    gradient halo; same value as the JAX package's (which adds 8-row
    alignment slack) so both packages size their windows alike."""
    need = 2 * (radius + 1) + 1 + (SUBLANE - 1)
    return -(-need // SUBLANE) * SUBLANE
