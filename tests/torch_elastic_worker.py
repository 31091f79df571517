"""One process of the PyTorch port's elastic-recovery cluster.

Counterpart of ``tests/elastic_worker.py``: runs a chunked distributed LM
(``parallel/dba.make_lm_stepper``) over the global mesh, process 0
checkpointing the replicated BAState after every chunk
(``perf/checkpoint.save_ba_state``), every process waiting at a barrier
until the checkpoint is durable.  If DIE_AFTER_CHUNK >= 0, process 1 exits
hard (``os._exit(17)``) right after that chunk's barrier — a worker lost
mid-optimisation.  A restarted cluster resumes from the checkpoint and
completes the remaining chunks.  Imports ``torch``, ``numpy`` and
``sift_tpu_torch`` only.

Usage: python tests/torch_elastic_worker.py PID NPROC INIT_URL OUTDIR
           DIE_AFTER_CHUNK [--device cpu|cuda:0] [--shards 2]
           [--backend gloo]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_multihost_worker import join, worker_args  # noqa: E402

TOTAL_ITERS = 15
CHUNK = 5


def main():
    die_after_chunk = int(sys.argv.pop(5))
    args = worker_args()
    mesh = join(args)

    import torch.distributed as dist

    from sift_tpu_torch.parallel.dba import make_lm_stepper
    from sift_tpu_torch.parallel.multihost import barrier
    from sift_tpu_torch.perf.checkpoint import load_ba_state, save_ba_state
    from sift_tpu_torch.perf.scenes import synthetic_ba

    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96)
    init, step, place = make_lm_stepper(mesh, chunk=CHUNK)
    placed = place(prob)

    ckpt = os.path.join(args.outdir, "ba_ckpt.npz")
    state, done = load_ba_state(ckpt)
    if state is None:
        state = init(placed)
    # A loaded state is on the host; step moves it to the home device.
    print(f"worker {args.pid}: resuming at iteration {done}", flush=True)

    for chunk_i in range(done // CHUNK, TOTAL_ITERS // CHUNK):
        state = step(placed, state)
        if args.pid == 0:
            save_ba_state(ckpt, state, iteration=(chunk_i + 1) * CHUNK)
        # The checkpoint is durable before anyone proceeds (or dies).
        barrier()
        if chunk_i == die_after_chunk and args.pid == 1:
            print(f"worker {args.pid}: simulating crash after chunk "
                  f"{chunk_i}", flush=True)
            os._exit(17)

    if args.pid == 0:
        np.savez(os.path.join(args.outdir, "elastic_final.npz"),
                 **{k: v.cpu().numpy() for k, v in state._asdict().items()})
    barrier()
    dist.destroy_process_group()
    print(f"worker {args.pid} done", flush=True)


if __name__ == "__main__":
    main()
