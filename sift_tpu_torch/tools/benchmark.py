"""CLI: the reference's published benchmark table on one device.

Counterpart of ``sift_tpu/tools/benchmark.py`` (same flags, metric names
and JSON keys, plus ``--device``).  Reproduces the reference's published
workload set (readme.md:9-16 — detect+compute at 752x480 / 1600x900 /
1920x1200 on the textured ``perf/benchimg.bench_image``, brute-force match
of 2000x2000 random uint8 descriptors, seed 0) and prints one JSON line per
metric:

    {"metric": "detect_compute_752x480", "value": ms, "unit": "ms",
     "keypoints": N, "vs_baseline": ms / reference_ms}

``--tiers`` adds ``detect_compute_WxH_tierN`` lines (the detect function
at internal keypoint capacity N, ``build_detect_fn(kpt_cap=N)``; the
keypoints reported are the full frame's), ``--batch B`` adds
``detect_compute_WxH_batchB`` lines (``parallel/batched.
batched_detect_fn`` over B copies of the frame, ms per frame), and the
last line is ``match_2000x2000``.  The first line of ``--quick`` is the
port's counterpart of ``bench.py``'s headline line.  ``BASELINES_MS`` are
the reference's own figures on an RTX 4070 Super (``BASELINE.md``).

Each value is ``perf/timing.measure_ms`` of the chained step: CUDA events
around 24 chained iterations, median of 3, on a CUDA device; on the CPU
(``--device cpu``, for the tests) the host clock around 2 iterations, once
— a CPU number is a test of the tool, not a measurement of the card.
Without ``--device`` the tool runs on the GPU and raises if there is none.

Usage: python -m sift_tpu_torch.tools.benchmark [--quick]
           [--sizes WxH ...] [--num-features N] [--batch B]
           [--tiers N ...] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json


BASELINES_MS = {
    "detect_compute_752x480": 0.95,
    "detect_compute_1600x900": 2.5,
    "detect_compute_1920x1200": 3.1,
    "match_2000x2000": 1.0,
}

def _line(metric, ms, base, unit="ms", keypoints=None):
    """Print and return one metric's JSON line (``base``: the reference's
    ms for the same workload, or None)."""
    out = {"metric": metric, "value": ms, "unit": unit}
    if keypoints is not None:
        out["keypoints"] = keypoints
    out["vs_baseline"] = ms / base if base else None
    print(json.dumps(out), flush=True)
    return out


def _probe(res):
    """A scalar that depends on the whole result (the JAX tool's)."""
    return res.descriptors.sum().to(res.keypoints.x.dtype) \
        + res.keypoints.x.sum()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="752x480 + match only")
    p.add_argument("--sizes", nargs="*", default=None,
                   help="override detect sizes, e.g. 752x480 1920x1200")
    p.add_argument("--num-features", type=int, default=5000)
    p.add_argument("--batch", type=int, default=0,
                   help="also measure the per-frame time of this many "
                        "frames through parallel/batched.batched_detect_fn")
    p.add_argument("--tiers", nargs="*", type=int, default=None,
                   help="also measure the detect function at these "
                        "internal keypoint capacities (capacity tiers)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; raises without "
                        "one)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.core.types import build_plan
    from sift_tpu_torch.ops.pyramid import plan_operators
    from sift_tpu_torch.parallel.batched import batched_detect_fn
    from sift_tpu_torch.perf.benchimg import bench_image
    from sift_tpu_torch.perf.timing import ITERATIONS, measure_ms
    from sift_tpu_torch.pipeline.detector import (build_detect_fn,
                                                  resolve_device)
    from sift_tpu_torch.pipeline.matcher import match_brute_force

    dev = resolve_device(args.device)
    timing = ITERATIONS[dev.type]
    rng = np.random.default_rng(0)
    sizes = args.sizes or (["752x480"] if args.quick
                           else ["752x480", "1600x900", "1920x1200"])
    lines = []

    for spec in sizes:
        w, h = (int(v) for v in spec.split("x"))
        cfg = SiftConfig(width=w, height=h, num_features=args.num_features)
        plan = build_plan(cfg)
        ops = plan_operators(plan, dev)
        img = torch.as_tensor(bench_image(h, w), device=dev)

        def timed(fn, x):
            return measure_ms(lambda im: (im, _probe(fn(im))), x, **timing)

        detect = build_detect_fn(plan, device=dev, ops=ops)
        count = int(detect(img).count)
        name = f"detect_compute_{w}x{h}"
        base = BASELINES_MS.get(name)
        lines.append(_line(name, timed(detect, img), base, keypoints=count))
        for tier in args.tiers or ():
            tfn = build_detect_fn(plan, kpt_cap=tier, device=dev, ops=ops)
            lines.append(_line(f"{name}_tier{tier}", timed(tfn, img), base,
                               keypoints=count))
        if args.batch:
            bfn = batched_detect_fn(plan, device=dev)
            batch = img.expand(args.batch, h, w)
            lines.append(_line(f"{name}_batch{args.batch}",
                               timed(bfn, batch) / args.batch, base,
                               unit="ms/frame"))

    # Brute-force matching (readme.md:11: 2000x2000 in < 1 ms), uint8
    # descriptors as the pipeline stores them.  The chained carry is f32
    # (its probe fold needs float), cast to uint8 in the step.
    q = torch.as_tensor(rng.integers(0, 256, (2000, 128)),
                        dtype=torch.float32, device=dev)
    t = torch.as_tensor(rng.integers(0, 256, (2000, 128)),
                        dtype=torch.uint8, device=dev)

    def match_step(qq):
        m = match_brute_force(qq.to(torch.uint8), t)
        return qq, m.sum().to(torch.float32)

    lines.append(_line("match_2000x2000",
                       measure_ms(match_step, q, **timing),
                       BASELINES_MS["match_2000x2000"]))
    return lines


if __name__ == "__main__":
    main()
