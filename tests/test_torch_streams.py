"""The streams chip_smoke.py decodes on the card, held to the reference.

vvdec_tpu_torch/streams.py carries copies of the builders of bench.py's
tool-rich intra, SAO/ALF and inter-LD configurations, of
tests/test_lmcs.py's intra LMCS stream and of the low-delay B stream of
tests/test_oracle.py::TestNativeMotionParity::test_full_toolset_ab at
832x480, made with the port's own test encoder.  Each must equal, byte
for byte, the stream the original builder makes with vvdec_tpu.testenc,
and each pinned MD5 must be the MD5 of the JAX host golden decoder's
YUV: chip_smoke.py checks the card's decode against the pins without
importing the JAX package.  The "inter-LDB tools" pin is the pure-Python
host golden's (VVDEC_TPU_NO_NATIVE_INTER=1; see
tests/test_torch_inter.py::test_native_inter_golden_fault_on_affine_bcw).
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
# bench.py's inter-LD decisions (bench.py:211-212, 247-248)
BENCH_INTER_KW = dict(split_prob=0.35, inter_prob=0.85, skip_prob=0.3,
                      mv_range=32)
# tests/test_oracle.py::TestNativeMotionParity::test_full_toolset_ab
FULL_TOOLSET_SPS = dict(affine_enabled=True, affine_6param=True,
                        temporal_mvp_enabled=True, sbtmvp_enabled=True,
                        mmvd_enabled=True, smvd_enabled=True,
                        gpm_enabled=True, ciip_enabled=True,
                        bcw_enabled=True, amvr_enabled=True,
                        dmvr_enabled=True, bdof_enabled=True)
FULL_TOOLSET_DEC = dict(split_prob=0.5, inter_prob=0.8, skip_prob=0.15,
                        mv_range=48, bi_prob=0.6, affine_prob=0.25,
                        affine_merge_prob=0.3, geo_prob=0.2, mmvd_prob=0.2,
                        ciip_prob=0.15, smvd_prob=0.2, bcw_prob=0.3,
                        amvr_prob=0.3)


def _full_toolset_ldb(w, h, n, seed):
    """test_full_toolset_ab's stream at w x h, CTU 64, n pictures, with
    PROF on, built with vvdec_tpu.testenc."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import B_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(w, h, ctu=64, prof_enabled=True, **FULL_TOOLSET_SPS)
    pps = E.make_pps(sps)
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    st += make_nal(NalUnitType.PPS, bw.bytes())
    for f in range(n):
        dec = RandomDecisions(seed=seed * 100 + f, **FULL_TOOLSET_DEC)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=False,
                                    slice_type=B_SLICE,
                                    ref_deltas=((1,), (1,)))
        st += nal
    return st


def _reference(name):
    """The stream as the original builder makes it with vvdec_tpu."""
    if name == "tool-rich":
        from vvdec_tpu.testenc.encoder import generate_stream
        return generate_stream(**dict(BENCH_TOOL_RICH, n_frames=4))[0]
    if name == "SAO/ALF":
        import bench
        return bench._intra_stream(832, 480, 4, 1, filters=True)
    if name == "inter-LD":
        import bench
        return bench._ld_stream(832, 480, 12, 5, BENCH_INTER_KW)
    if name == "inter-LDB tools":
        return _full_toolset_ldb(832, 480, 6, 0)
    from tests.test_lmcs import _lmcs_stream
    return _lmcs_stream(31, 2, 2, {}, dict(split_prob=0.35, density=0.3),
                        True, ctu=64, wh=(832, 480))


NAMES = ["tool-rich", "SAO/ALF", "LMCS", "inter-LD", "inter-LDB tools"]


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
def test_md5_pin_is_host_golden(streams, name, monkeypatch):
    from vvdec_tpu.decoder import decode_to_yuv
    _, n_frames, md5 = S.STREAMS[name]
    if name == "inter-LDB tools":
        monkeypatch.setenv("VVDEC_TPU_NO_NATIVE_INTER", "1")
    yuv = decode_to_yuv(streams[name][1])
    assert len(yuv) == n_frames * 832 * 480 * 3   # 4:2:0, two bytes
    assert hashlib.md5(yuv).hexdigest() == md5


def test_stream_parameters_match_bench():
    """The tool-rich (its first 4 frames) and inter-LD parameters are
    bench.py's, the inter-LDB tools ones test_full_toolset_ab's with
    PROF, and the streams table lists the headline stream with its
    pin, then the others in chip_smoke.py's order."""
    assert S.TOOL_RICH_STREAM_KW == dict(BENCH_TOOL_RICH, n_frames=4)
    assert S.SAO_ALF_STREAM_KW == dict(w=832, h=480, n=4, seed=1)
    assert S.INTER_LD_STREAM_KW == dict(w=832, h=480, n=12, seed=5,
                                        dec_kw=BENCH_INTER_KW)
    assert S.INTER_LDB_STREAM_KW == dict(
        w=832, h=480, n=6, seed=0,
        sps_kw=dict(FULL_TOOLSET_SPS, prof_enabled=True),
        dec_kw=FULL_TOOLSET_DEC)
    assert S.STREAMS["headline"][2] == S.HEADLINE_MD5
    # the RA and inter-LMCS streams: tests/test_torch_ra_stream.py and
    # tests/test_torch_fallback.py check their bytes and pins
    # and phase 13's streams (tests/test_torch_bench_configs*.py)
    assert list(S.STREAMS) == ["headline"] + NAMES + [
        "RA", "inter-LMCS"] + list(S.BENCH_STREAMS)
