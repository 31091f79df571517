"""CLI: golden-checkpoint replay verification (the capability of the
reference's tool/perf.cu: load the checkpoint triple, run every per-stage
verification, print pass/fail).  Counterpart of ``sift_tpu/tools/perf.py``;
the checkpoint may come from either package.

Usage: python -m sift_tpu_torch.tools.perf CHECKPOINT_DIR [--stage NAME]
           [--oracle] [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU and without
that flag it fails.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", help="checkpoint directory (params/input/expected)")
    p.add_argument("--stage", default=None,
                   help="run only this stage (filter, resize, minus, "
                        "find_peaks, adjust_pts, orientation_hist, "
                        "descriptor)")
    p.add_argument("--oracle", action="store_true",
                   help="also gate a fresh pipeline run against the "
                        "recorded cv2.SIFT oracle (oracle.npz; the "
                        "INDEPENDENT parity check — golden replay alone "
                        "only catches regressions against ourselves)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the GPU (no CPU fallback)")
    args = p.parse_args(argv)

    from sift_tpu_torch.perf.checkpoint import load_golden
    from sift_tpu_torch.perf.replay import Replayer

    params, inputs, expected = load_golden(args.path)
    rep = Replayer(params, inputs, expected, device=args.device)

    stages = [args.stage] if args.stage else list(Replayer.ALL)
    all_ok = True
    for name in stages:
        ok, info = getattr(rep, f"run_{name}")()
        all_ok &= bool(ok)
        print(f"{'PASS' if ok else 'FAIL'}  {name:18s} {info}")

    if args.oracle:
        from sift_tpu_torch.perf.oracle import has_oracle, verify_oracle
        if not has_oracle(args.path):
            print("FAIL  oracle             {missing oracle.npz}")
            all_ok = False
        else:
            checks = verify_oracle(args.path, device=args.device)
            for name in ("recall", "precision", "descriptor"):
                c = checks[name]
                ok = c.pop("ok")
                all_ok &= ok
                print(f"{'PASS' if ok else 'FAIL'}  "
                      f"oracle_{name:11s} {c}")
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
