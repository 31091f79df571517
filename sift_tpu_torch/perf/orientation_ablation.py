"""Ablations of the orientation kernel (K2) on the card.

    python -m sift_tpu_torch.perf.orientation_ablation [--only NAME ...]
        [--parent TREE] [--out FILE.json]

Each variant is a copy of the package's ``csrc/`` with textual substitutions
applied to ``orientation_hist.cu`` (``VARIANTS``); ``--parent TREE`` adds
the kernel of another checkout (``TREE/sift_tpu_torch/csrc``) as variant
``parent``.  Every copy is built by ``kernels/build.build_library`` into
``build/ablation/<name>/`` and timed through the unchanged wrapper
(``kernels/fused_stages.orientation_hist_cuda``) on the main path's frame
inputs and on the synthetic set (``perf/stage_inputs``): the kernel's device
time from ``torch.profiler``, three repeats, variants in turns with the kept
kernel first and last.  The diagnostic variants (``no_*``) give wrong
histograms on purpose: they say what a part of the kernel costs.
``phase_counters`` adds ``clock64()`` counters (thread 0 of every block) and
reports cycles per block by phase.  Prints one JSON line per variant.
Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from sift_tpu_torch.kernels import build

_SRC = "orientation_hist.cu"

# Counters of thread 0 of every block: [0] set-up before the first
# keypoint, per keypoint [1] the next item's parameters and the wait for
# this patch, [2] the barrier after it, [3] the pixel loop, [4] the barrier
# after it, [5] staging the next patch and the reduction, [6] items; [7]
# the block's whole time, [8] the longest block's, [9] blocks.
_PHASES = ("setup", "next_and_wait", "barrier_in", "pixels", "barrier_out",
           "stage_and_reduce", "items", "block_total", "block_max", "blocks")
_PHASE_PATCH = [
    ("#define ORI_BINS 36\n",
     "#define ORI_BINS 36\n__device__ unsigned long long ori_prof[16];\n"
     "#define TICK(v) unsigned long long v = clock64()\n"
     "#define ACC(i, d) if (tid == 0) atomicAdd(&ori_prof[i], "
     "(unsigned long long)(d))\n"),
    ("  int lo, hi;\n  live_rows(count, start, K, &lo, &hi);\n",
     "  TICK(t_start);\n  int lo, hi;\n  live_rows(count, start, K, &lo, "
     "&hi);\n"),
    ("  while (cur.k >= 0) {\n",
     "  TICK(t_loop);\n  ACC(0, t_loop - t_start);\n  while (cur.k >= 0) {\n"
     "    TICK(ta);\n"),
    ("    __syncthreads();      // ... and every thread's, tables included\n",
     "    TICK(tb);\n    __syncthreads();\n    TICK(tc);\n"),
    ("    __syncthreads();  // the patch is free, every bin column written\n",
     "    TICK(td);\n    __syncthreads();\n    TICK(te);\n"),
    ("    cur = nx;\n  }\n}\n",
     "    TICK(tf);\n    ACC(1, tb - ta); ACC(2, tc - tb); ACC(3, td - tc);\n"
     "    ACC(4, te - td); ACC(5, tf - te); ACC(6, 1);\n    cur = nx;\n  }\n"
     "  TICK(t_end);\n  ACC(7, t_end - t_start);\n"
     "  if (tid == 0) atomicMax(&ori_prof[8], t_end - t_start);\n"
     "  ACC(9, 1);\n}\n"
     "SIFT_API int sift_ori_prof(unsigned long long* host) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(host, ori_prof, 128);\n"
     "  unsigned long long z[16] = {0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ori_prof, z, 128);\n"
     "  return (int)e;\n}\n"),
]
VARIANTS = {
    "kept": [],
    "threads_128": [("#define ORI_NT 64\n", "#define ORI_NT 128\n")],
    "threads_96": [("#define ORI_NT 64\n", "#define ORI_NT 96\n")],
    "no_atan2": [("const float ori = atan2_deg(dy, dx);",
                  "const float ori = dx;")],
    "no_pixels": [("for (int t = tid; t < n; t += ORI_NT) {",
                   "for (int t = tid; t < 0; t += ORI_NT) {")],
    "no_reduction": [("if (cur.chunk + 1 == cur.nchunks) {",
                      "if (cur.chunk + 1 == cur.nchunks && cur.k < 0) {")],
    "phase_counters": _PHASE_PATCH,
}


def variant_source(name: str, out: Path) -> Path:
    """A copy of the package's csrc/ under ``out`` with ``name``'s
    substitutions applied; raises if one of them does not match."""
    dst = out / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(build.CSRC, dst)
    src = (dst / _SRC).read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} not in {_SRC}")
        src = src.replace(old, new, 1)
    (dst / _SRC).write_text(src)
    return dst


def _registers(log: str) -> int | None:
    lines = log.splitlines()
    for j, ln in enumerate(lines):
        if "Compiling entry function" in ln and "orientation_hist_kernel" in ln:
            for nxt in lines[j + 1:j + 6]:
                if "Used" in nxt:
                    return int(nxt.split("Used")[1].split()[0])
    return None


def measure(lib, inputs, phases: bool) -> dict:
    """Device ms (three repeats), rel error against the plain version and
    bit-reproducibility of ``lib``'s kernel on each input set."""
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.perf.profile import device_ms

    saved = build._lib
    build._lib = lib                   # the wrapper launches this library
    try:
        res = {}
        for label, tap in inputs.items():
            a = (tap["values"], tap["ys0"], tap["xs0"], tap["par"],
                 tap["rows"], tap["lanes"])
            run = lambda: FS.orientation_hist_cuda(*a, count=tap["count"])
            ker, again = run(), run()
            pla = FS.orientation_hist_plain(*a, count=tap["count"])
            torch.cuda.synchronize()
            e = dict(rel_err=float(((ker - pla).abs() / (pla.abs() + 1e-3))
                                   .max()),
                     bit_reproducible=bool(torch.equal(ker, again)),
                     device_ms=[device_ms(run, calls=20,
                                          name="orientation_hist_kernel")
                                for _ in range(3)])
            if phases:
                buf = (ctypes.c_ulonglong * 16)()
                lib.sift_ori_prof(buf)            # reset
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
                lib.sift_ori_prof(buf)
                v = dict(zip(_PHASES, list(buf)))
                blocks = v.pop("blocks") or 1
                e["cycles_per_block"] = {
                    k: (c if k == "block_max" else c / blocks)
                    for k, c in v.items()}
            res[label] = e
        return res
    finally:
        build._lib = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="*", default=None,
                    help=f"variants to run (of {list(VARIANTS)})")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernel runs as variant 'parent'")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("orientation_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.perf.benchimg import (FLAGSHIP_FEATURES,
                                              FLAGSHIP_HEIGHT,
                                              FLAGSHIP_WIDTH, bench_image)
    from sift_tpu_torch.perf.stage_inputs import (frame_inputs, frame_slab,
                                                  synthetic_inputs)

    names = [n for n in VARIANTS if n != "kept"]
    if args.only is not None:
        names = [n for n in names if n in args.only]
    order = ["kept"] + names + (["parent"] if args.parent else []) + ["kept"]
    root = build.build_dir().parent / "ablation"
    libs = {}
    for name in dict.fromkeys(order):     # build each once
        if name == "parent":
            csrc = Path(args.parent) / "sift_tpu_torch" / "csrc"
        else:
            csrc = variant_source(name, root / name)
        libs[name] = build.build_library(csrc, root / name / "lib")

    det = SiftDetector(SiftConfig(width=FLAGSHIP_WIDTH,
                                  height=FLAGSHIP_HEIGHT,
                                  num_features=FLAGSHIP_FEATURES))
    frame = torch.as_tensor(bench_image(FLAGSHIP_HEIGHT, FLAGSHIP_WIDTH,
                                        seed=0), device=det.device)
    det.warm_up()
    res = det.detect_and_compute(frame)
    _, _, slab = frame_slab(det, frame)
    inputs = {"frame": frame_inputs(slab, res, det.config)[0],
              "synthetic": synthetic_inputs(det, slab)[0]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = []
    for name in order:
        lib, seconds, log = libs[name]
        line = dict(variant=name, card=card, registers=_registers(log),
                    **measure(lib, inputs, name == "phase_counters"))
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
