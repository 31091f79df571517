"""Multi-device scaling: keyframe-axis sharding and distributed BA."""

from sift_tpu_torch.parallel.batched import (batched_detect_fn, make_mesh,
                                             make_sharded_pipeline,
                                             sequential_match)
from sift_tpu_torch.parallel.dba import make_distributed_lm

__all__ = [
    "batched_detect_fn", "make_mesh", "make_sharded_pipeline",
    "sequential_match", "make_distributed_lm",
]
