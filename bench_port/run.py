#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Loads the cell's files (``spec.py``), makes its inputs on the card from
the seed, builds and warms up the port (``sift_tpu_torch``; its kernels
build into ``build/sift_tpu_torch`` of this checkout on the first run),
measures for ``--seconds`` seconds, holds a sample of what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``, each number
compared beside its limit (also the last lines on standard error).

Exits non-zero and prints no result when CUDA is not available or has
fewer devices than the cell asks for, or when the process has loaded
JAX, Flax or the JAX package ``sift_tpu``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main(argv=None) -> int:
    # The process's start on perf_counter's clock (the interpreter's own
    # start-up included where /proc tells its age).
    age = process_age_s()
    t_start = time.perf_counter() - age if age else T_START
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The checkout holds the benchmark and the port; the port's kernel
    # library is built into a fixed directory inside it.
    sys.path.insert(0, str(ROOT))
    os.environ["SIFT_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build"
                                                 / "sift_tpu_torch")
    import torch

    import sift_tpu_torch  # noqa: F401  (the program: fails where absent)
    from bench_port import measure, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    out, phases = measure.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", t_start)
    print("seconds by phase: " + json.dumps(phases), file=sys.stderr)
    found = measure.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in measure.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
