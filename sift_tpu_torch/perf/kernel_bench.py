"""Time the detector's four frame kernels on real pipeline state.

Counterpart of ``scripts/kernel_bench.py``.  Runs one frame of
``SiftDetector`` on the textured ``perf/benchimg`` frame at ``W H CAP``
(default 1600x900, 5000 features), rebuilds each kernel's inputs from it
with the ops the detector itself calls (``perf/stage_inputs``: the padded
pyramid's content views, the stacked slab, the orientation and descriptor
kernels' arguments for the frame's own keypoints), and times the CUDA
kernels K1 (record field, every octave in one launch), K5 (slab copies),
K2 (orientation) and K3 (descriptor) with ``perf/timing.measure_ms``.

The JAX script sweeps ``block_k`` / ``NBUF``, the Pallas kernels' ring
depth and keypoints per grid step.  The CUDA kernels take neither: K2's
block size and grid come from the occupancy query
(``kernels/fused_stages.orientation_geometry``), K3's from its fixed block
shape and the SM count, so there is nothing to sweep and this tool times
the kernels as the detector launches them.  Each timed step is one kernel
launch plus the chained carry's two scalar operations
(``perf/timing.chained_runner``).  Prints a header line and one line per
kernel:

    1600x900: 4512 kpts, 5000 descriptors
    kernel detect_records        0.0450 ms

Needs a CUDA device and raises without one.

Usage: python -m sift_tpu_torch.perf.kernel_bench [W H CAP]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("size", nargs="*", type=int, default=[1600, 900, 5000],
                   help="W H CAP")
    args = p.parse_args(argv)
    if len(args.size) != 3:
        p.error("give W H CAP, or nothing for 1600 900 5000")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench times the CUDA kernels and needs a "
                           "CUDA device; none is available")
    w, h, cap = args.size

    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.config import SIFT_IMG_BORDER
    from sift_tpu_torch.kernels import expand as EX
    from sift_tpu_torch.kernels import fused_detect as FD
    from sift_tpu_torch.kernels import fused_stages as FS
    from sift_tpu_torch.perf.benchimg import bench_image
    from sift_tpu_torch.perf.stage_inputs import frame_inputs, frame_slab
    from sift_tpu_torch.perf.timing import ITERATIONS, measure_ms

    cfg = SiftConfig(width=w, height=h, num_features=cap)
    det = SiftDetector(cfg)
    frame = torch.as_tensor(bench_image(h, w), device=det.device)
    res = det.detect_and_compute(frame)
    gauss, base, slab = frame_slab(det, frame)
    ori, desc = frame_inputs(slab, res, cfg)
    print(f"{w}x{h}: {int(res.raw_count)} kpts, {int(res.count)} "
          "descriptors", flush=True)
    rec_args = (float(cfg.peak_threshold), SIFT_IMG_BORDER,
                float(cfg.edge_threshold), float(cfg.contrast_threshold),
                cfg.num_octave_layers)
    kernels = {
        "detect_records": lambda: FD.detect_records_cuda(gauss,
                                                         *rec_args)[0],
        "expand_lane_copies": lambda: EX.expand_lane_copies_cuda(
            base, slab.copies),
        "orientation_hist": lambda: FS.orientation_hist_cuda(**ori),
        "descriptor_hist": lambda: FS.descriptor_hist_cuda(**desc),
    }
    carry = torch.zeros((), device=det.device)
    rows = {}
    for name, launch in kernels.items():
        ms = measure_ms(lambda c, launch=launch: (c, launch().view(-1)[0]),
                        carry, **ITERATIONS["cuda"])
        print(f"kernel {name:20s} {ms:8.4f} ms", flush=True)
        rows[name] = ms
    return rows


if __name__ == "__main__":
    main()
