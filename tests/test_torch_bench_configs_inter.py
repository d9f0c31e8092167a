"""bench.py's inter-LD 1920x1080 configuration as a small analog, on the
CPU: an IDR and 2 low-delay P pictures at 128x120 (the 1080p geometry: a
bottom CTU row of 56 rows) with bench.py's decisions (mv_range=32, so
motion vectors reach past the picture's edges), made by bench.py's
builder, decoded by the port on device="cpu" bit-equal to vvdec_tpu's
device path (use_jax=True) and its host golden, every picture on the
device.  Apart from tests/test_torch_bench_configs.py so that the JAX
device path's compiles of each spread over the workers."""

import bench
import vvdec_tpu_torch.streams as S
from tests.test_torch_bench_configs import BENCH_INTER_KW, check_analog


def test_inter_ld_analog_matches_jax_device_path_and_host_golden():
    kw = dict(S.INTER_LD_1080P_STREAM_KW, w=128, h=120, n=3)
    check_analog(bench._ld_stream(128, 120, 3, 5, BENCH_INTER_KW),
                 S.inter_ld_stream(**kw), 3, (128, 120))
