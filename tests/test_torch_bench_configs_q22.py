"""bench.py's "max-density q22 832x480 (conformance-load analog)"
(bench.py:231-235) at full size: the port's builder makes bench.py's
stream byte for byte, and its pin is the MD5 of vvdec_tpu's host golden
decode.  About 40 s, nearly all of it the two test encoders."""

from tests.test_torch_bench_configs import BENCH_MAX_DENSITY, check_full_size


def test_max_density_q22_bytes_and_pin():
    check_full_size("max-density q22", BENCH_MAX_DENSITY)
