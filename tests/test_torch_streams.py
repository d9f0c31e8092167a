"""The streams chip_smoke.py decodes on the card, held to the reference.

vvdec_tpu_torch/streams.py carries copies of the builders of bench.py's
tool-rich intra and SAO/ALF configurations and of tests/test_lmcs.py's
intra LMCS stream, made with the port's own test encoder.  Each must
equal, byte for byte, the stream the original builder makes with
vvdec_tpu.testenc, and each pinned MD5 must be the MD5 of the JAX host
golden decoder's YUV: chip_smoke.py checks the card's decode against
the pins without importing the JAX package.
"""

import hashlib

import pytest

import vvdec_tpu_torch.streams as S

# bench.py's tool-rich intra configuration (bench.py:219-226)
BENCH_TOOL_RICH = dict(
    width=832, height=480, ctu=64, n_frames=8, seed=3, qp=30,
    sps_kw=dict(mip_enabled=True, cclm_enabled=True,
                lfnst_enabled=True, mts_enabled=True,
                explicit_mts_intra=True),
    dec_kw=dict(split_prob=0.35, density=0.3, mip_prob=0.25))


def _reference(name):
    """The stream as the original builder makes it with vvdec_tpu."""
    if name == "tool-rich":
        from vvdec_tpu.testenc.encoder import generate_stream
        return generate_stream(**BENCH_TOOL_RICH)[0]
    if name == "SAO/ALF":
        import bench
        return bench._intra_stream(832, 480, 8, 1, filters=True)
    from tests.test_lmcs import _lmcs_stream
    return _lmcs_stream(31, 2, 2, {}, dict(split_prob=0.35, density=0.3),
                        True, ctu=64, wh=(832, 480))


NAMES = ["tool-rich", "SAO/ALF", "LMCS"]


@pytest.fixture(scope="module")
def streams():
    """{name: (port stream, reference stream)}."""
    return {name: (S.STREAMS[name][0](), _reference(name)) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_stream_bytes_match_reference_builder(streams, name):
    port, ref = streams[name]
    assert len(port) > 50000
    assert port == ref


@pytest.mark.parametrize("name", NAMES)
def test_md5_pin_is_host_golden(streams, name):
    from vvdec_tpu.decoder import decode_to_yuv
    _, n_frames, md5 = S.STREAMS[name]
    yuv = decode_to_yuv(streams[name][1])
    assert len(yuv) == n_frames * 832 * 480 * 3   # 4:2:0, two bytes
    assert hashlib.md5(yuv).hexdigest() == md5


def test_stream_parameters_match_bench():
    """The tool-rich parameters are bench.py's, and the streams table
    lists the headline stream with its pin."""
    assert S.TOOL_RICH_STREAM_KW == BENCH_TOOL_RICH
    assert S.STREAMS["headline"][2] == S.HEADLINE_MD5
    assert list(S.STREAMS) == ["headline"] + NAMES
