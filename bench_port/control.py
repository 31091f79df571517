#!/usr/bin/env python3
"""Readings behind the limits of a cell's correctness check.

    python3 bench_port/control.py --workload <cell> --seeds S1 S2 ... \
        --control-seeds C1 C2 C3 [--seconds 2]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the numbers its check compares, first for what the
port produced (the lower readings), then, on ``--control-seeds``, for
each control put in the port's place (the upper readings): the plain
reference computed one step below a precision the configuration states.
``tf32``: the detector's blurs in TF32 (the configuration states float32
with TF32 off); ``int4_descriptors``: the reference's descriptors
reported at 16 levels (int4; the configuration states uint8);
``int4_match``: its uint8 descriptors reported, the matcher reading them
at 16 levels.  The exhaustive mix (no detector) takes ``int4_match``
alone.  One JSON line per seed and side on standard output.  Needs a
CUDA device; the benchmark's own runs do not run this.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def int4(desc):
    """uint8 descriptors kept at 4 bits: 16 levels over 0..255."""
    import torch
    return (torch.round(desc.to(torch.float32) / 17.0) * 17.0).to(
        torch.uint8)


def controls(cell) -> dict:
    """The cell's controls: name -> (precision of the plain detector, the
    descriptors reported as a function of its own, what the matcher reads
    of the reported ones)."""
    same = lambda d: d  # noqa: E731
    out = {"int4_match": ("float64", same, int4)}
    if cell.params["generator"] == "sequential":
        out["tf32"] = ("tf32", same, same)
        out["int4_descriptors"] = ("float64", int4, same)
    return out


def readings(cell, seed: int, seconds: float, control: bool, device,
             prog) -> list:
    from bench_port import engine, spec
    p = cell.params
    stream = spec.stream_class(cell)(cell, seed, device, prog)
    stream.build()
    stream.prefill()
    engine.run_window(stream, p, math.inf, seed, False,
                      units=int(p["warm_units"]))
    win = engine.run_window(stream, p, seconds, seed, False)
    stream.release()
    t0 = time.perf_counter()
    cache = {}
    out = {"seed": seed, "side": "program", "units": win.completed,
           "numbers": stream.check(win.samples, cache=cache)}
    out["check_s"] = time.perf_counter() - t0
    lines = [out]
    for name, ctl in (controls(cell).items() if control else ()):
        t0 = time.perf_counter()
        lines.append({"seed": seed, "side": f"control.{name}",
                      "numbers": stream.check(win.samples, control=ctl,
                                              cache=cache),
                      "check_s": time.perf_counter() - t0})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import sift_tpu_torch as prog
    from bench_port import spec

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = list(dict.fromkeys(list(args.seeds) + list(args.control_seeds)))
    for seed in seeds:
        for line in readings(cell, seed, args.seconds,
                             seed in args.control_seeds, "cuda", prog):
            line["workload"] = args.workload
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
