"""Ablations of the strip kernels (K6 ``window_colsum_static``) on the card.

    python -m sift_tpu_torch.perf.window_ablation [--only NAME ...]
        [--out FILE.json]

Each variant is a copy of the package's ``csrc/`` with textual substitutions
applied to ``window_proto.cu`` (``VARIANTS``), built by
``kernels/build.build_library`` into ``build/ablation/<name>/`` and timed
through the unchanged wrapper (``perf/window_proto.window_colsum_static_cuda``)
on the experiment's uniform and clustered sets and with no live window
(what the launches cost by themselves): the device time of both
launches, of the bucket pass and of the strip kernel alone
(``torch.profiler``, three repeats), variants in turns with the kept kernel
first and last.  The diagnostic variants (``no_*``) give wrong sums on
purpose: they say what a part of the kernel costs.  ``phase_counters`` adds
``clock64()`` counters (thread 0 of every block) and ``%globaltimer``
stamps, and reports cycles per block by phase and the launches' spans in
ns.  Prints one JSON line per variant.  Needs a CUDA device and ``nvcc``.
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

_SRC = "window_proto.cu"

# Slots of the counters (thread 0 of every block), read and reset after
# every launch.  Strip kernel, per item: [0] its windows, box and ranks
# (warp 0) and the barrier after them, [1] the warp's windows, [2] issuing
# the copies, [3] waiting for them, [4] the sums and stores, [5] the
# closing barrier, [6] the item's whole time, [7] the longest item's, [8]
# items; blocks writing zero rows: [9] time, [10] blocks.  %globaltimer
# (ns): [11] first strip block's start, [12] last strip block's end, [13]
# first bucket block's start, [14] last bucket block's end, [15] last
# item's end.  Bucket blocks: [16] keys and counts, [17] the scan, [18]
# items, [19] the key's windows, [20] blocks.
_PHASES = ("item_meta", "warp_windows", "issue", "land", "sums_and_stores",
           "end_barrier", "item", "item_max", "items", "zero_block",
           "zero_blocks", "strip_start_ns", "strip_end_ns",
           "bucket_start_ns", "bucket_end_ns", "items_end_ns",
           "bucket_keys", "bucket_scan", "bucket_items", "bucket_compact",
           "bucket_blocks")
_PHASE_PATCH = [
    ("#define BUCKET_WARPS 8\n",
     "#define BUCKET_WARPS 8\n__device__ unsigned long long wp_prof[32];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "#define TICK(v) unsigned long long v = clock64()\n"
     "#define ACC(i, d) if (threadIdx.x == 0) atomicAdd(&wp_prof[i], "
     "(unsigned long long)(d))\n"
     "#define GMIN(i) if (threadIdx.x == 0) atomicMin(&wp_prof[i], gtime())\n"
     "#define GMAX(i) if (threadIdx.x == 0) atomicMax(&wp_prof[i], gtime())\n"),
    ("  for (int i = tid; i < n_buckets; i += blockDim.x) hist[i] = 0;\n",
     "  GMIN(13);\n  TICK(b0);\n"
     "  for (int i = tid; i < n_buckets; i += blockDim.x) hist[i] = 0;\n"),
    ("    atomicAdd(&hist[kb], 1);\n  }\n  __syncthreads();\n",
     "    atomicAdd(&hist[kb], 1);\n  }\n  __syncthreads();\n  TICK(b1);\n"),
    ("  const int first = mine[0], item0 = mine[1], n = hist[b];\n",
     "  TICK(b2);\n"
     "  const int first = mine[0], item0 = mine[1], n = hist[b];\n"),
    ("  // This key's windows, in index order.\n",
     "  TICK(b3);\n  // This key's windows, in index order.\n"),
    ("    __syncthreads();  // wtot is read before the next tile writes it\n"
     "  }\n}\n",
     "    __syncthreads();  // wtot is read before the next tile writes it\n"
     "  }\n  TICK(b4);\n"
     "  ACC(16, b1 - b0); ACC(17, b2 - b1); ACC(18, b3 - b2);\n"
     "  ACC(19, b4 - b3); ACC(20, 1);\n  GMAX(14);\n}\n"),
    ("  const int n = item.z;\n", "  TICK(t0);\n  const int n = item.z;\n"),
    ("  __syncthreads();\n  const int ymin = box[0], xmin = box[2];\n",
     "  __syncthreads();\n  TICK(t1);\n"
     "  const int ymin = box[0], xmin = box[2];\n"),
    ("  bool shared_cols = true;\n",
     "  TICK(t2);\n  unsigned long long t3 = 0, t4 = 0;\n"
     "  bool shared_cols = true;\n"),
    ("    cp_async_wait_all();\n",
     "    if (t3 == 0) t3 = clock64();\n    cp_async_wait_all();\n"),
    ("    __syncthreads();  // the load has landed, every thread's part\n",
     "    __syncthreads();  // the load has landed, every thread's part\n"
     "    if (t4 == 0) t4 = clock64();\n"),
    ("  __syncthreads();  // the buffer and the metadata are free again\n}\n",
     "  TICK(t5);\n  __syncthreads();\n  TICK(t6);\n"
     "  ACC(0, t1 - t0); ACC(1, t2 - t1); ACC(2, t3 - t2); ACC(3, t4 - t3);\n"
     "  ACC(4, t5 - t4); ACC(5, t6 - t5); ACC(6, t6 - t0); ACC(8, 1);\n"
     "  if (threadIdx.x == 0) atomicMax(&wp_prof[7], t6 - t0);\n"
     "  GMAX(15);\n}\n"),
    ("  const int n_items = *plan.n_items;\n",
     "  GMIN(11);\n  const int n_items = *plan.n_items;\n"),
    ("  const int zfirst = n_items < (int)gridDim.x ? n_items : 0;\n",
     "  TICK(tz);\n"
     "  const int zfirst = n_items < (int)gridDim.x ? n_items : 0;\n"),
    ("          make_float4(0.f, 0.f, 0.f, 0.f);\n  }\n}\n",
     "          make_float4(0.f, 0.f, 0.f, 0.f);\n"
     "    ACC(9, clock64() - tz); ACC(10, 1);\n  }\n  GMAX(12);\n}\n"
     "SIFT_API int sift_wp_prof(unsigned long long* host) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(host, wp_prof, 256);\n"
     "  unsigned long long z[32] = {0};\n"
     "  z[11] = z[13] = ~0ull;\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(wp_prof, z, 256);\n"
     "  return (int)e;\n}\n"),
]
VARIANTS = {
    "kept": [],
    "bucket_warps_4": [("#define BUCKET_WARPS 8\n", "#define BUCKET_WARPS 4\n")],
    "bucket_warps_32": [("#define BUCKET_WARPS 8\n",
                         "#define BUCKET_WARPS 32\n")],
    "no_sum": [("for (int r = r0; r < r1; ++r, p += q) acc[0] = add4(",
                "for (int r = r0; r < 0; ++r, p += q) acc[0] = add4("),
               ("        for (int r = r0; r < r1; ++r, p += q) {\n",
                "        for (int r = r0; r < 0; ++r, p += q) {\n"),
               ("for (int r = r0; r < r1; ++r, p += q) acc[i] = add4(",
                "for (int r = r0; r < 0; ++r, p += q) acc[i] = add4(")],
    "no_stage": [("for (int c = lane; c < q; c += 32) cp_async16(",
                  "for (int c = lane; c < 0; c += 32) cp_async16(")],
    # One wave on the card (3 strip blocks of 69 KB per SM, 132 SMs) that
    # walks the items, instead of one block per possible item.
    "grid_card": [("  kern<<<g.max_items, 32 * warps, g.smem, st>>>(",
                   "  kern<<<min(g.max_items, 132 * 3), 32 * warps, g.smem, "
                   "st>>>(")],
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


def _registers(log: str) -> dict:
    """Registers of the two strip launches' kernels in ``ptxas -v`` output."""
    out, lines = {}, log.splitlines()
    for j, ln in enumerate(lines):
        for name in ("colsum_bucket_kernel", "colsum_strip_kernelILb0"):
            if "Compiling entry function" in ln and name in ln:
                for nxt in lines[j + 1:j + 6]:
                    if "Used" in nxt:
                        out[name] = int(nxt.split("Used")[1].split()[0])
                        break
    return out


def measure(lib, sets, phases: bool) -> dict:
    """Device ms of both launches, of the bucket pass and of the strip
    kernel (three repeats each) and bit-exactness against the plain version
    of ``lib``'s static kernel on each set."""
    from sift_tpu_torch.perf import window_proto as WP
    from sift_tpu_torch.perf.profile import device_ms

    saved = build._lib
    build._lib = lib                   # the wrapper launches this library
    try:
        res = {}
        for label, s in sets.items():
            a = (s["slab"], s["ys0"], s["xs0"], s["rows"], s["count"])
            run = lambda: WP.window_colsum_static_cuda(*a)
            ker = run()
            pla = WP.window_colsum_plain(*a)
            torch.cuda.synchronize()
            e = dict(bit_exact=bool(torch.equal(ker, pla)))
            for key, name in (("device_ms", "colsum_"),
                              ("bucket_ms", "colsum_bucket"),
                              ("strip_ms", "colsum_strip")):
                e[key] = [device_ms(run, calls=20, name=name)
                          for _ in range(3)]
            if phases:
                buf = (ctypes.c_ulonglong * 32)()
                lib.sift_wp_prof(buf)             # reset
                tot, spans = [0] * 32, []
                for _ in range(10):
                    run()
                    torch.cuda.synchronize()
                    lib.sift_wp_prof(buf)         # read and reset
                    v = list(buf)
                    tot = [t + x for t, x in zip(tot, v)]
                    tot[7] = max(tot[7] - v[7], v[7])
                    spans.append(dict(bucket=v[14] - v[13],
                                      gap=v[11] - v[14],
                                      strip=v[12] - v[11],
                                      items=v[15] - v[11]))
                v = dict(zip(_PHASES, tot))
                items = v["items"] or 1
                e["cycles_per_item"] = {
                    key: v[key] / items for key in _PHASES[:7]}
                e["cycles_item_max"] = v["item_max"]
                e["items_per_launch"] = v["items"] / 10
                e["cycles_per_zero_block"] = (v["zero_block"]
                                              / (v["zero_blocks"] or 1))
                n = v["bucket_blocks"] or 1
                e["cycles_per_bucket_block"] = {
                    key: v[key] / n for key in _PHASES[16:20]}
                e["span_ns_median"] = {
                    key: sorted(sp[key] for sp in spans)[len(spans) // 2]
                    for key in spans[0]}
            res[label] = e
        return res
    finally:
        build._lib = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="*", default=None,
                    help=f"variants to run (of {list(VARIANTS)})")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_ablation: needs a CUDA device", file=sys.stderr)
        return 1
    from sift_tpu_torch.perf import window_proto as WP

    names = [n for n in VARIANTS if n != "kept"]
    if args.only is not None:
        names = [n for n in names if n in args.only]
    order = ["kept"] + names + ["kept"]
    root = build.build_dir().parent / "ablation"
    libs = {name: build.build_library(variant_source(name, root / name),
                                      root / name / "lib")
            for name in dict.fromkeys(order)}
    sets = dict(uniform=WP.workload("cuda"),
                clustered=WP.clustered_workload("cuda"),
                none_live=dict(WP.workload("cuda"),
                               count=torch.zeros(1, dtype=torch.int32,
                                                 device="cuda")))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = []
    for name in order:
        lib, seconds, log = libs[name]
        line = dict(variant=name, card=card, registers=_registers(log),
                    **measure(lib, sets, name == "phase_counters"))
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
