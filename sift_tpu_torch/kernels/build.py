"""Build and load the package's CUDA kernels.

The sources under ``sift_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface and loaded with
``ctypes``: every object file is compiled by its own ``nvcc`` process, all
started together, then linked.  The library goes to ``build/sift_tpu_torch/``
beside the package (override with ``SIFT_TPU_TORCH_BUILD_DIR``), named by a
hash of the sources and flags, so a second process finds it built.  Nothing
here runs at import time, and nothing is swallowed: a missing compiler or a
failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_detect.cu", "expand.cu", "orientation_hist.cu",
           "descriptor_hist.cu", "window_gather.cu", "window_proto.cu",
           "match_u8.cu")
HEADERS = ("common.cuh",)

# -fmad=false (and no fast-math): a*b+c is NOT contracted, divisions and
# square roots are IEEE, so the kernels round like their plain PyTorch
# versions (see csrc/common.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # None until built/loaded; 0.0 = cached
build_log: str = ""                     # compiler output (ptxas -v)


def build_dir() -> Path:
    env = os.environ.get("SIFT_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "sift_tpu_torch"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of sift_tpu_torch cannot be built on this machine")


def _source_hash(csrc: Path) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path, csrc: Path) -> str:
    """Compile ``csrc``'s sources into ``target``; returns the log."""
    nvcc = find_nvcc()
    out = target.parent
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    procs = []
    for name in SOURCES:
        obj = out / f"{tag}.{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(csrc / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== nvcc {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    objs = [str(obj) for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp = out / f"{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += f"\n== link\n{link.stdout}"
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, target)       # atomic: readers never see a partial
        (out / f"{target.stem}.log").write_text(log)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return log


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of every entry point the library
    exports (a library built from another tree may lack the newer ones)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    pll, pi = ctypes.POINTER(ll), ctypes.POINTER(i)
    # slab, hs, ws, ys0, xs0, par, npar, count (ptr, bytes, value),
    # start (ptr, bytes, value), out, K, rows, lanes, stream
    hist = [p, i, i, p, p, p, i, p, i, ll, p, i, ll, p, i, i, i, p]
    table = {
        "sift_detect_records": [ctypes.POINTER(ll), i, i, i, f, i, f, f, f,
                                f, p],
        "sift_expand_lane_copies": [p, p, i, i, i, i, p],
        "sift_orientation_hist": hist,
        "sift_orientation_hist_geometry": [i, i, i, pll, pi],
        "sift_descriptor_hist": hist,
        "sift_gather_windows": [p, p, p, p, p, i, i, i, i, i, i, p],
        # slab, ys0, xs0, [par,] count, out, scratch, k_cap, h, w, rows,
        # [block_k,] strip_rows, chunk, warps, stream
        "sift_window_colsum_static": [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      p],
        "sift_window_colsum_par": [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   i, p],
        # k_cap, h, w, rows, strip_rows, chunk, warps, par, out[8]
        "sift_window_colsum_strip_geometry": [i, i, i, i, i, i, i, i, pi],
        # slab, ys0, xs0, count, out, k_cap, h, w, rows, block_k, nbuf,
        # band_rows, grid, stream
        "sift_window_colsum_ring": [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                    p],
        "sift_window_colsum_ring_geometry": [i, i, i, pll, pi],
        # query, its set stride, q_valid, its stride, train, its stride,
        # t_valid, its stride, cols scratch, out, sets, Q, S, ratio, stream
        "sift_match_u8": [p, ll, p, ll, p, ll, p, ll, p, p, i, i, i, f, p],
    }
    for name, argtypes in table.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i


def build_library(csrc: Path, out_dir: Path):
    """Build (or find built) the sources of ``csrc`` into ``out_dir`` and
    load them: returns (library, seconds spent building, compiler log)."""
    target = Path(out_dir) / f"libsift_kernels_{_source_hash(Path(csrc))}.so"
    t0 = time.perf_counter()
    if target.exists():
        seconds = 0.0
        log = target.with_suffix(".log")
        log = log.read_text() if log.exists() else ""
    else:
        log = _build(target, Path(csrc))
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    _declare(lib)
    return lib, seconds, log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib, build_seconds, build_log
    if _lib is None:
        _lib, build_seconds, build_log = build_library(CSRC, build_dir())
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
