"""Per-stage latency breakdown of the detector on one device.

Counterpart of ``scripts/stage_bench.py``: times cumulative prefixes of the
detector's pipeline (``pipeline/detector.build_detect_fn``, fused branch)
with ``perf/timing.measure_ms`` on the textured ``perf/benchimg`` frame and
prints one line per stage — its cumulative time and the difference to the
prefix before it:

    stage 1 pyramid      cum    0.412 ms   delta    0.412 ms

Stage order (``STAGES``): 1 the padded band-blocked pyramid, 2 the record
field (one kernel launch over all octaves) and per-octave candidate
compaction, 3 the all-octave Newton walk, 4 the global compaction and
finalize, 5 the stacked slab of shifted copies, 6 the orientation kernel,
7 peaks and the orientation expansion, 8 the descriptor kernel.  A prefix
returns a scalar probe that depends on all of its work, as the JAX
script's does.  On a CUDA device the numbers are CUDA-event times; on the
CPU (``--device cpu``) they test the tool, nothing more.  Without
``--device`` it runs on the GPU and raises if there is none.

Usage: python -m sift_tpu_torch.perf.stage_bench [W H CAP] [--device D]
"""

from __future__ import annotations

import argparse

import torch

STAGES = ["pyramid", "records", "walk", "compact", "stackslab",
          "ori_hist", "peaks+expand", "descriptor"]


def build_prefix_fn(plan, n_stages: int, device):
    """image -> scalar probe after the first ``n_stages`` stages of the
    detector's fused branch, through the ops the detector itself calls
    (operators moved to ``device`` once)."""
    from sift_tpu_torch.kernels.fused_stages import (descriptor_hist,
                                                     orientation_hist)
    from sift_tpu_torch.kernels.window_gather import window_rows
    from sift_tpu_torch.ops import compact as C
    from sift_tpu_torch.ops import descriptor as D
    from sift_tpu_torch.ops import orientation as O
    from sift_tpu_torch.ops.flatpyr import stack_pyramid
    from sift_tpu_torch.ops.pyramid import (gaussian_pyramid_padded,
                                            padded_content_views,
                                            plan_operators)
    from sift_tpu_torch.ops.records import (WalkState,
                                            candidates_from_records,
                                            detect_records_padded_pyramid,
                                            finalize_walk,
                                            resolve_kernel_impl,
                                            walk_records_positions)
    from sift_tpu_torch.pipeline.detector import (FUSED_MAX_RADIUS,
                                                  full_precision_matmul,
                                                  slab_copies)

    cfg = plan.config
    kcap = cfg.num_features
    rmax = max(D.max_descr_radius(cfg), O.max_ori_radius(cfg))
    if rmax > FUSED_MAX_RADIUS or cfg.orientation_source != "gaussian":
        raise ValueError("stage_bench times the detector's fused branch "
                         "with orientation_source='gaussian'")
    impl = resolve_kernel_impl(cfg.kernel_impl, device)
    full_precision_matmul()
    ops = plan_operators(plan, device)
    nb = O._NB

    def fn(image):
        gp = gaussian_pyramid_padded(plan, image, ops)
        if n_stages == 1:
            return sum(g.sum() for g in gp)
        gauss = padded_content_views(plan, gp)
        recs = detect_records_padded_pyramid(plan, gp, impl)
        cands = [candidates_from_records(recs[o], plan.octaves[o].cand_cap)
                 for o in range(cfg.num_octaves)]
        if n_stages == 2:
            return sum(cx.sum() + cv.sum() for cx, _, _, cv in cands)
        st, rflat = walk_records_positions(recs, cands, cfg)
        if n_stages == 3:
            return st.c.sum() + st.ok.sum()
        idx, val = C.stream_compact(st.ok, kcap)
        idx = idx.to(torch.int64)
        stc = WalkState(*[f[idx] for f in st])
        ref, koct = finalize_walk(rflat, stc, val, cfg)
        if n_stages == 4:
            return ref.x.sum() + ref.size.sum()
        slab = stack_pyramid(gauss, extra_rows=window_rows(rmax),
                             copies=slab_copies(plan), layer_lo=1,
                             layer_hi=cfg.num_octave_layers + 1, impl=impl)
        if n_stages == 5:
            return slab.values[0].sum() + ref.x.sum()
        n_kp = val.to(torch.int32).sum()
        ys0, xs0, par, rows, lanes = O.orientation_params(
            slab, koct, ref.x, ref.y, ref.layer, ref.size, val, cfg)
        hist = orientation_hist(slab.values, ys0, xs0, par, rows, lanes,
                                count=n_kp, impl=impl)
        if n_stages == 6:
            return hist.sum() + ref.x.sum()
        angles, peaks = O.orientation_peaks(hist, val, cfg)
        eidx, evalid = C.stream_compact(peaks.reshape(-1), kcap)
        src = torch.div(eidx, nb, rounding_mode="floor").to(torch.int64)
        fx, fy, fsize = ref.x[src], ref.y[src], ref.size[src]
        flyr, foct = ref.layer[src], koct[src]
        fang = angles.reshape(-1)[eidx.to(torch.int64)]
        if n_stages == 7:
            return fang.sum() + fx.sum()
        ys0, xs0, par, rows, lanes = D.descriptor_params(
            slab, foct, fx, fy, flyr, fsize, fang, evalid, cfg)
        dhist = descriptor_hist(slab.values, ys0, xs0, par, rows, lanes,
                                count=evalid.to(torch.int32).sum(),
                                impl=impl)
        return dhist.sum() + fx.sum()

    return fn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("size", nargs="*", type=int, default=[752, 480, 5000],
                   help="W H CAP")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; raises without "
                        "one)")
    args = p.parse_args(argv)
    if len(args.size) != 3:
        p.error("give W H CAP, or nothing for 752 480 5000")
    w, h, cap = args.size

    from sift_tpu_torch.config import SiftConfig
    from sift_tpu_torch.core.types import build_plan
    from sift_tpu_torch.perf.benchimg import bench_image
    from sift_tpu_torch.perf.timing import ITERATIONS, measure_ms
    from sift_tpu_torch.pipeline.detector import resolve_device

    dev = resolve_device(args.device)
    plan = build_plan(SiftConfig(width=w, height=h, num_features=cap))
    img = torch.as_tensor(bench_image(h, w), device=dev)
    prev, rows = 0.0, []
    for i, name in enumerate(STAGES, 1):
        fn = build_prefix_fn(plan, i, dev)
        ms = measure_ms(lambda x, fn=fn: (x, fn(x).to(x.dtype)), img,
                        **ITERATIONS[dev.type])
        print(f"stage {i} {name:12s} cum {ms:8.3f} ms   "
              f"delta {ms - prev:8.3f} ms", flush=True)
        rows.append({"stage": i, "name": name, "cum_ms": ms,
                     "delta_ms": ms - prev})
        prev = ms
    return rows


if __name__ == "__main__":
    main()
