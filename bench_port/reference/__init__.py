"""The plain reference the benchmark holds the port to.

Plain PyTorch, run once a window has closed: ``PlainSift`` (a SIFT
detector written from the algorithm's definition, ``detector.py``) and
``match_exact`` (exact brute-force matching with the ratio test).  It
imports neither JAX nor the JAX package nor anything of the port, and it
takes nothing the port made: it works every result out again from the
inputs the benchmark generated.
"""

from .detector import PlainResult, PlainSift, octave_shapes
from .matcher import match_exact

__all__ = ["PlainResult", "PlainSift", "match_exact", "octave_shapes"]
