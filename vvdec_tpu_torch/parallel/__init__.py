"""Parallel decode: host GOP parallelism.

The port's counterpart of vvdec_tpu/parallel: IRAP-segment parallel
decode across worker processes (the reference's P2, distributed form),
each worker a full parse + reconstruction pipeline with its own CUDA
context.  The reference package's device-mesh exports (row sharding with
halo exchange, frame-axis parallelism: parallel/sharding.py,
parallel/distributed.py, ops/sharded_chain.py) are not ported yet
(ROADMAP.md queue 1, item 14).
"""

from vvdec_tpu_torch.parallel.gop import (  # noqa: F401
    decode_annexb_parallel,
    make_worker_pool,
    split_irap_segments,
)
