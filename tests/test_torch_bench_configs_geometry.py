"""bench.py's all-intra+SAO/ALF 1920x1080 configuration as a small
analog, on the CPU: 2 intra frames at 128x120 (the 1080p geometry: a
width of whole CTUs and a bottom CTU row of 56 rows, as 1080 = 16 * 64 +
56) with SAO, ALF (two APSs) and CC-ALF, made by bench.py's builder,
decoded by the port on device="cpu" bit-equal to vvdec_tpu's device path
(use_jax=True) and its host golden, every picture on the device."""

import bench
import vvdec_tpu_torch.streams as S
from tests.test_torch_bench_configs import check_analog


def test_sao_alf_analog_matches_jax_device_path_and_host_golden():
    kw = dict(S.SAO_ALF_1080P_STREAM_KW, w=128, h=120, n=2)
    check_analog(bench._intra_stream(128, 120, 2, 1, filters=True),
                 S.sao_alf_stream(**kw), 2, (128, 120))
