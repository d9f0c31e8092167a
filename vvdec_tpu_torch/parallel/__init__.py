"""Parallel decode: device-mesh sharding + host GOP parallelism.

The port's counterpart of vvdec_tpu/parallel: row sharding with a halo
exchange (P3) and frame-axis data parallelism (P2) over a mesh of
devices that one process drives (sharding.py; the sharded filter chain
is ops/sharded_chain.py), IRAP-segment parallel decode across worker
processes (gop.py) and across the ranks of a torch.distributed job
(distributed.py), and the multi-device path held to the per-frame path
(dryrun.py).
"""

from vvdec_tpu_torch.parallel.gop import (  # noqa: F401
    decode_annexb_parallel,
    make_worker_pool,
    split_irap_segments,
)
from vvdec_tpu_torch.parallel.sharding import (  # noqa: F401
    frame_parallel,
    halo_map_rows,
    make_decode_mesh,
    vertical_121,
)
