"""All eight frames of bench.py's tool-rich intra (bench.py:219-226) and
all-intra+SAO/ALF 832x480 (bench.py:245-246) configurations: the port's
builders make bench.py's streams byte for byte, their pins are the MD5 of
vvdec_tpu's host golden decode, and their first 4 pictures are the
4-frame streams that phases 11 and 12 of chip_smoke.py take from them
(whose pins, TOOL_RICH_MD5 and SAO_ALF_MD5, phase 13 checks on the first
4 frames of the 8-frame decodes).  About 45 s."""

import hashlib

import pytest

import bench
import tests.test_torch_bench_configs as T
import vvdec_tpu_torch.streams as S

# 8-frame stream -> the 4-frame stream of its first pictures
NAMES = {long: short for short, long in S.PREFIXES.items()}


@pytest.fixture(scope="module")
def streams():
    """{name: (port stream, bench.py's stream)}."""
    return {"tool-rich 8": (S.STREAMS["tool-rich 8"][0](),
                            T._generate(T.BENCH_TOOL_RICH)),
            "SAO/ALF 8": (S.STREAMS["SAO/ALF 8"][0](),
                          bench._intra_stream(832, 480, 8, 1, filters=True))}


@pytest.mark.parametrize("name", list(NAMES))
def test_8_frame_stream_bytes_match_bench(streams, name):
    port, ref = streams[name]
    assert len(port) > 150000
    assert port == ref


@pytest.mark.parametrize("name", list(NAMES))
def test_8_frame_pin_is_host_golden(streams, name):
    from vvdec_tpu.decoder import decode_to_yuv
    _, n_frames, md5 = S.STREAMS[name]
    yuv = decode_to_yuv(streams[name][1])
    assert len(yuv) == n_frames * 832 * 480 * 3
    assert hashlib.md5(yuv).hexdigest() == md5
    # the first 4 frames' YUV carries the 4-frame stream's pin
    four = 4 * 832 * 480 * 3
    assert hashlib.md5(yuv[:four]).hexdigest() == S.STREAMS[NAMES[name]][2]


@pytest.mark.parametrize("name", list(NAMES))
def test_first_4_pictures_are_the_4_frame_stream(streams, name):
    from vvdec_tpu_torch.parallel.dryrun import first_pictures
    assert first_pictures(streams[name][0], 4) == S.STREAMS[NAMES[name]][0]()
