"""bench.py's "all-intra dense q27 832x480" (bench.py:215-217) at full
size: the port's builder makes bench.py's stream byte for byte, and its
pin is the MD5 of vvdec_tpu's host golden decode.  About 40 s, nearly
all of it the two test encoders."""

from tests.test_torch_bench_configs import BENCH_DENSE, check_full_size


def test_dense_q27_bytes_and_pin():
    check_full_size("dense q27", BENCH_DENSE)
