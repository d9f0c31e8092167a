"""The pins of bench.py's two 1920x1080 configurations (bench.py:249-252):
SAO/ALF 1080p (4 all-intra frames with SAO, ALF and CC-ALF) and inter-LD
1080p (an IDR and 5 low-delay P pictures) are the MD5 of vvdec_tpu's host
golden decode of the streams the port's builders make (which equal
bench.py's: tests/test_torch_bench_configs.py, at a cut size).  About 25
to 35 s a stream, nearly all of it the test encoder."""

import hashlib

import pytest

import vvdec_tpu_torch.streams as S


@pytest.mark.parametrize("name", ["SAO/ALF 1080p", "inter-LD 1080p"])
def test_1080p_pin_is_host_golden(name):
    from vvdec_tpu.decoder import decode_to_yuv
    builder, n_frames, md5 = S.STREAMS[name]
    yuv = decode_to_yuv(builder())
    assert len(yuv) == n_frames * 1920 * 1080 * 3   # 4:2:0, two bytes
    assert hashlib.md5(yuv).hexdigest() == md5
