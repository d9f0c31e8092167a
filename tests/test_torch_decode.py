"""Whole streams through the port's entry point, on the CPU.

Tolerance: bit-equal.  vvdec_tpu_torch.decoder.decode_annexb(s,
device="cpu") is held to the JAX package's host golden decode (cheap)
on the intra streams of tests/test_frame_device.py (planar, DC and
angular; MIP, CCLM, intra LMCS with and without chroma residual scaling;
SAO; and tests/test_device_pipeline.py's ALF + CC-ALF stream), and to
its device pipeline (`use_jax=True`) on two of them.  Pictures outside
the device pipeline's tool set are reconstructed on the host and counted
in the decoder's fallback census with their reason
(tests/test_torch_fallback.py holds them to the reference's census).
"""

import hashlib

import numpy as np
import pytest

import tests.test_frame_device as tfd
from vvdec_tpu.testenc.encoder import generate_stream

# the stream parameters of TestFrameDevice's all-intra tests (WH 128x96)
INTRA = {
    "all_intra_basic": dict(n_frames=3, seed=5, qp=30,
                            dec_kw=dict(split_prob=0.5, density=0.3)),
    "runs_on_device": dict(n_frames=2, seed=6, qp=30),
    "lfnst_mts": dict(n_frames=2, seed=7, qp=28,
                      sps_kw=dict(lfnst_enabled=True, mts_enabled=True,
                                  explicit_mts_intra=True),
                      dec_kw=dict(split_prob=0.5, density=0.4)),
    "dep_quant_off_high_density": dict(
        n_frames=2, seed=8, qp=24,
        dec_kw=dict(split_prob=0.6, density=0.7, max_level=200)),
    "dual_tree": dict(n_frames=2, seed=9, qp=30,
                      sps_kw=dict(dual_tree_intra=True, min_qt_size=[8, 8, 8],
                                  max_mtt_depth=[2, 2, 2],
                                  max_bt_size=[32, 32, 32],
                                  max_tt_size=[32, 32, 32]),
                      dec_kw=dict(split_prob=0.5, density=0.3)),
    "wpp_availability": dict(n_frames=2, seed=10, qp=30,
                             sps_kw=dict(entropy_coding_sync=True),
                             dec_kw=dict(split_prob=0.4, density=0.3)),
    "chroma_444": dict(n_frames=2, seed=11, qp=30,
                       sps_kw=dict(chroma_format=3),
                       dec_kw=dict(split_prob=0.4, density=0.3)),
}


def _stream(name):
    s, _ = generate_stream(width=tfd.WH[0], height=tfd.WH[1], ctu=32,
                           **INTRA[name])
    return s


def _assert_equal(want, got):
    assert len(want) == len(got)
    for fw, fg in zip(want, got):
        assert len(fw) == len(fg)
        for pw, pg in zip(fw, fg):
            assert pg.dtype == np.asarray(pw).dtype
            assert np.array_equal(np.asarray(pw), pg)


@pytest.mark.parametrize("name", list(INTRA))
def test_port_matches_host_golden(name):
    from vvdec_tpu.decoder import decode_annexb as golden
    from vvdec_tpu_torch.decoder import decode_annexb
    s = _stream(name)
    _assert_equal(golden(s), decode_annexb(s, device="cpu"))


def test_port_matches_jax_device_pipeline():
    from vvdec_tpu.decoder import decode_annexb as ref
    from vvdec_tpu_torch.decoder import decode_annexb
    s = _stream("all_intra_basic")
    _assert_equal(ref(s, use_jax=True), decode_annexb(s, device="cpu"))


def _lmcs(seed, chroma_scale, sps_kw=None, dec_kw=None, wh=tfd.WH):
    from tests.test_lmcs import _lmcs_stream
    return _lmcs_stream(seed, 2, 2, sps_kw or {},
                        dec_kw or dict(split_prob=0.5, density=0.4),
                        chroma_scale, ctu=32, wh=wh)


def _gen(**kw):
    return generate_stream(width=tfd.WH[0], height=tfd.WH[1], qp=30,
                           **kw)[0]


def _alf_ccalf():
    from tests.test_alf import _alf_stream
    return _alf_stream(2, 2, 2, {}, dict(split_prob=0.4, jccr_prob=0.2),
                       n_aps=3)


# the intra tool streams of tests/test_frame_device.py (TestFrameDevice,
# TestFrameDeviceLmcs, TestJccrDevice) and tests/test_device_pipeline.py
TOOLS = {
    "mip": lambda: _gen(ctu=32, n_frames=2, seed=13,
                        sps_kw=dict(mip_enabled=True),
                        dec_kw=dict(split_prob=0.4, density=0.3,
                                    mip_prob=0.9)),
    "mip_large_blocks": lambda: _gen(ctu=64, n_frames=2, seed=17,
                                     sps_kw=dict(mip_enabled=True),
                                     dec_kw=dict(split_prob=0.15,
                                                 density=0.3, mip_prob=1.0)),
    "cclm": lambda: _gen(ctu=32, n_frames=2, seed=51,
                         sps_kw=dict(cclm_enabled=True),
                         dec_kw=dict(split_prob=0.4, density=0.3)),
    "cclm_dual_tree_422": lambda: _gen(
        ctu=32, n_frames=2, seed=53,
        sps_kw=dict(chroma_format=2, cclm_enabled=True, dual_tree_intra=True,
                    min_qt_size=[8, 8, 8], max_mtt_depth=[2, 2, 2],
                    max_bt_size=[32, 32, 32], max_tt_size=[32, 32, 32]),
        dec_kw=dict(split_prob=0.4, density=0.3)),
    "sao": lambda: _gen(ctu=32, n_frames=2, seed=12,
                        sps_kw=dict(sao_enabled=True),
                        sh_kw=dict(sao_enabled_luma=True,
                                   sao_enabled_chroma=True),
                        dec_kw=dict(split_prob=0.4, density=0.3,
                                    sao_prob=0.6)),
    "lmcs_intra_31": lambda: _lmcs(31, False),
    "lmcs_intra_32": lambda: _lmcs(32, False),
    "lmcs_chroma_scaling_33": lambda: _lmcs(33, True),
    "lmcs_chroma_scaling_34": lambda: _lmcs(34, True),
    "jccr_with_lmcs": lambda: _lmcs(
        3, True, dict(joint_cbcr_enabled=True),
        dict(split_prob=0.5, jccr_prob=0.5, density=0.4), wh=(96, 64)),
    "alf_ccalf": lambda: _alf_ccalf(),
    "lmcs_mip_cclm_sao": lambda: _lmcs(
        36, True, dict(mip_enabled=True, cclm_enabled=True, sao_enabled=True),
        dict(split_prob=0.5, density=0.4, mip_prob=0.3, sao_prob=0.5)),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_stream_matches_host_golden(name):
    from vvdec_tpu.decoder import decode_annexb as golden
    from vvdec_tpu_torch.decoder import decode_annexb
    s = TOOLS[name]()
    _assert_equal(golden(s), decode_annexb(s, device="cpu"))


@pytest.mark.parametrize("name", ["alf_ccalf", "lmcs_chroma_scaling_33"])
def test_tool_stream_matches_jax_device_pipeline(name):
    from vvdec_tpu.decoder import decode_annexb as ref
    from vvdec_tpu_torch.decoder import decode_annexb
    s = TOOLS[name]()
    _assert_equal(ref(s, use_jax=True), decode_annexb(s, device="cpu"))


def _bi_refined_stream(tool):
    """tests/test_frame_device.py::TestFrameDeviceInter::
    test_dmvr_falls_back_bit_exact's layout (POC 0, 2, then a B picture
    at POC 1 between them, equal-distance bi-prediction) with
    `<tool>_enabled`: DMVR- or BDOF-eligible CUs."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import B_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(tfd.WH[0], tfd.WH[1], ctu=32, num_reorder_pics=[1],
                     **{f"{tool}_enabled": True})
    pps = E.make_pps(sps)
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    st += make_nal(NalUnitType.PPS, bw.bytes())
    dec = RandomDecisions(seed=41, split_prob=0.2)
    st += E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)[0]
    dec = RandomDecisions(seed=42, split_prob=0.2)
    st += E.encode_frame(sps, pps, dec, qp=32, poc=2, idr=False,
                         slice_type=1, ref_deltas=((2,), ()))[0]
    dec = RandomDecisions(seed=43, split_prob=0.2, inter_prob=0.9,
                          bi_prob=0.9, mv_range=24)
    st += E.encode_frame(sps, pps, dec, qp=32, poc=1, idr=False,
                         slice_type=B_SLICE, ref_deltas=((1,), (-1,)))[0]
    return st


def _rejected_streams():
    from tests.test_lmcs import _lmcs_stream

    def gen(**kw):
        return generate_stream(width=tfd.WH[0], height=tfd.WH[1], ctu=32,
                               n_frames=1, seed=kw.pop("seed"), qp=30,
                               **kw)[0]

    return {
        "isp": lambda: gen(seed=18, sps_kw=dict(isp_enabled=True),
                           dec_kw=dict(split_prob=0.4, density=0.3,
                                       isp_prob=0.8)),
        "dmvr": lambda: _bi_refined_stream("dmvr"),
        "bdof": lambda: _bi_refined_stream("bdof"),
        # TestFrameDeviceLmcs::test_lmcs_inter_falls_back_bit_exact
        "lmcs_inter": lambda: _lmcs_stream(
            35, 3, 0, {}, dict(split_prob=0.5, density=0.3, inter_prob=0.8),
            True, ctu=32, wh=tfd.WH),
    }


@pytest.mark.parametrize("reason", ["isp", "dmvr", "bdof", "lmcs_inter"])
def test_unported_tools_raise(reason):
    """The tools the port once rejected: an ISP or inter-LMCS picture is
    reconstructed on the host and counted under its reason, as the
    reference's census counts it; DMVR and BDOF pictures run the device
    refinement stage with nothing counted.  The output equals the host
    golden's either way, and no picture raises."""
    from vvdec_tpu.decoder import decode_annexb as golden
    from vvdec_tpu_torch.decoder import StreamDecoder
    s = _rejected_streams()[reason]()
    dec = StreamDecoder(device="cpu")
    pics = dec.push(s) + dec.flush()
    _assert_equal(golden(s), [p.planes for p in pics])
    rejected = {k: v for k, v in dec.fallback_census.items()
                if k.startswith("device_recon:")}
    if reason in ("dmvr", "bdof"):
        assert dict(dec.fallback_census) == {}
    else:
        assert set(rejected) == {f"device_recon:{reason}"}


def test_default_device_is_cuda_and_raises_without_it():
    import torch

    from vvdec_tpu_torch.decoder import StreamDecoder, decode_annexb
    from vvdec_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_annexb(_stream("runs_on_device"))
    with pytest.raises(RuntimeError):
        StreamDecoder()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.fixture(scope="module")
def headline():
    from vvdec_tpu_torch.streams import HEADLINE_STREAM_KW, headline_stream
    from vvdec_tpu.testenc.encoder import generate_stream as ref_gen
    return headline_stream(), ref_gen(**HEADLINE_STREAM_KW)[0]


def test_headline_stream_bytes_match_reference_encoder(headline):
    """The port's vendored test encoder makes the headline stream byte
    for byte as vvdec_tpu.testenc does (bench.py's all-intra 832x480)."""
    port, ref = headline
    assert len(port) == 169949
    assert port == ref


def test_headline_md5_is_host_golden(headline):
    """HEADLINE_MD5, which chip_smoke.py checks the card's decode
    against, is the MD5 of the JAX package's host golden YUV."""
    from vvdec_tpu.decoder import decode_to_yuv
    from vvdec_tpu_torch.streams import HEADLINE_MD5
    assert hashlib.md5(decode_to_yuv(headline[1])).hexdigest() == HEADLINE_MD5
