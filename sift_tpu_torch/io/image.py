"""Image IO + conversion helpers.

Counterpart of ``sift_tpu/io/image.py``: the host image type is a float32
numpy array; the adapters turn the port's ``SiftResult`` into cv2 types for
interop and visual checks.  ``cv2`` is imported inside the functions that
need it, never with the module (the machine with the card has none).

Directories of PGM/PPM frames decode through the native loader
(``io/native.py``); every other format goes through cv2.  Neither falls
back to the other: a PNM directory without the native library raises with
the build's error, and any other directory without cv2 raises the
ImportError.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

PNM_EXTENSIONS = {".pgm", ".ppm", ".pnm"}
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"} \
    | PNM_EXTENSIONS


def load_grayscale(path: str) -> np.ndarray:
    """Read an image as float32 grayscale (≙ cv::imread(...,
    IMREAD_GRAYSCALE) + cvMatToImage<float>).  PNM files decode through the
    native loader; other formats need cv2."""
    if os.path.splitext(path)[1].lower() in PNM_EXTENSIONS:
        return _native().read_pnm(path)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return img.astype(np.float32)


def to_cv_keypoints(result) -> List:
    """SiftResult -> list[cv2.KeyPoint] (incl. the packed-octave field)."""
    import cv2

    n = int(result.count)
    kp = result.keypoints
    host = lambda t: t.detach().cpu().numpy()[:n]
    x, y, size = host(kp.x), host(kp.y), host(kp.size)
    angle, resp = host(kp.angle), host(kp.response)
    packed = host(kp.packed_octave())
    return [cv2.KeyPoint(float(x[i]), float(y[i]), float(size[i]),
                         float(angle[i]), float(resp[i]), int(packed[i]))
            for i in range(n)]


def to_cv_descriptors(result) -> np.ndarray:
    """SiftResult -> [N, 128] float32 cv-compatible descriptor matrix."""
    n = int(result.count)
    return result.descriptors.detach().cpu().numpy()[:n].astype(np.float32)


def matches_to_cv_dmatches(match_idx) -> List:
    """[Q] match indices (-1 = none) -> list[cv2.DMatch]."""
    import cv2

    m = match_idx.detach().cpu().numpy() if hasattr(match_idx, "detach") \
        else np.asarray(match_idx)
    return [cv2.DMatch(int(q), int(t), 0.0)
            for q, t in enumerate(m) if t >= 0]


def _native():
    from sift_tpu_torch.io import native

    if not native.available():
        raise RuntimeError("PNM frames need the native loader: "
                           + str(native.build_error()))
    return native


def load_image_directory(path: str) -> Tuple[List[str], List[np.ndarray]]:
    """Sorted grayscale frames from a directory.  A directory of PNM files
    decodes through the native multithreaded loader (native/sift_io.cpp);
    everything else through cv2."""
    names = sorted(f for f in os.listdir(path)
                   if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS)
    paths = [os.path.join(path, f) for f in names]
    if names and all(os.path.splitext(f)[1].lower() in PNM_EXTENSIONS
                     for f in names):
        return names, list(_native().FrameLoader(paths, n_threads=4))
    return names, [load_grayscale(p) for p in paths]
