"""The host reconstruction of the pictures the device pipeline rejects,
with its census, on the CPU.

Tolerance: bit-equal, and the census equal key by key.  Each stream is
decoded by vvdec_tpu's api.Decoder with its device pipeline on (the
`use_jax=True` decode; its get_fallback_census() is the reference
census), by the JAX host golden, and by vvdec_tpu_torch's StreamDecoder
on the CPU, whose frames and `fallback_census` must equal the
reference's: the ISP stream of tests/test_frame_device.py (device_recon
rejects it), the inter LMCS stream at 128x96 (the IDR on the device, the
B pictures on the host, reading the IDR back), an inter stream with
virtual boundaries (the device filter chain rejects it too, so the host
filters run and the host planes enter the device DPB), and an ISP IDR
followed by P pictures without ISP (the host picture's planes serve the
device pictures).  The inter-LMCS 832x480 stream of
vvdec_tpu_torch/streams.py must equal its original builder's bytes,
and its MD5 and census pins the reference's.
"""

import hashlib

import numpy as np
import pytest

import tests.test_frame_device as tfd
from vvdec_tpu.testenc.encoder import generate_stream

WH = tfd.WH


def _isp_then_device_stream():
    """An IDR with ISP (rejected: the host reconstructs it), then three
    low-delay P pictures without ISP that decode on the device off the
    host picture's planes."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import P_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(WH[0], WH[1], ctu=32, num_reorder_pics=[0],
                     isp_enabled=True)
    pps = E.make_pps(sps)
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    st += make_nal(NalUnitType.PPS, bw.bytes())
    for f in range(4):
        if f == 0:
            dec = RandomDecisions(seed=1800, split_prob=0.4, density=0.3,
                                  isp_prob=0.8)
            st += E.encode_frame(sps, pps, dec, qp=30, poc=0, idr=True)[0]
        else:
            dec = RandomDecisions(seed=1800 + f, split_prob=0.4,
                                  inter_prob=0.8, skip_prob=0.3,
                                  mv_range=24, isp_prob=0.0)
            st += E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=False,
                                 slice_type=P_SLICE,
                                 ref_deltas=((1, 2) if f >= 2 else (1,),
                                             ()))[0]
    return st


def _streams():
    from tests.test_lmcs import _lmcs_stream
    from tests.test_virtual_boundaries import _vb_stream
    return {
        # TestFrameDevice::test_isp_falls_back_bit_exact (:131-138)
        "isp": lambda: generate_stream(
            width=WH[0], height=WH[1], ctu=32, n_frames=2, seed=18, qp=30,
            sps_kw=dict(isp_enabled=True),
            dec_kw=dict(split_prob=0.4, density=0.3, isp_prob=0.8))[0],
        # TestFrameDeviceLmcs::test_lmcs_inter_falls_back_bit_exact
        "lmcs_inter": lambda: _lmcs_stream(
            35, 3, 0, {}, dict(split_prob=0.5, density=0.3, inter_prob=0.8),
            True, ctu=32, wh=WH),
        # tests/test_virtual_boundaries.py::test_vb_inter's stream
        "virtual_boundaries": lambda: _vb_stream(9, n_frames=3, alf=True,
                                                 inter=True),
        "isp_idr_then_device": _isp_then_device_stream,
    }


# stream -> (census keys that must be there, pictures on the device)
EXPECT = {
    "isp": ({"device_recon:isp": 2}, 0),
    "lmcs_inter": ({"device_recon:lmcs_inter": 2}, 1),
    "virtual_boundaries": ({"device_recon:filter_virtual_boundaries": 3,
                            "device_filter:virtual_boundaries": 3}, 0),
    "isp_idr_then_device": ({"device_recon:isp": 1}, 3),
}


def _reference(s):
    """(frames, census) of vvdec_tpu's api.Decoder with its device
    pipeline on."""
    from vvdec_tpu.api import Decoder, DecoderParams
    d = Decoder(DecoderParams(use_device_pipeline=True))
    frames = d.decode(s)
    frames += d.flush()
    return [f.planes for f in frames], d.get_fallback_census()


def _port(s):
    """(frames, census, device pictures) of the port's CPU decode."""
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu_torch.decoder import StreamDecoder
    on_device = []
    with pytest.MonkeyPatch.context() as m:
        real = fd.reconstruct_frame_device

        def count(cs, *a, **k):
            on_device.append(cs.sh.poc)
            return real(cs, *a, **k)

        m.setattr(fd, "reconstruct_frame_device", count)
        dec = StreamDecoder(device="cpu")
        pics = dec.push(s) + dec.flush()
    return [p.planes for p in pics], dict(dec.fallback_census), on_device


@pytest.fixture(scope="module")
def decoded():
    """name -> (reference frames, reference census, host golden frames,
    port frames, port census, port device pictures); each decode runs
    once."""
    from vvdec_tpu.decoder import decode_annexb as golden
    out = {}
    for name, build in _streams().items():
        s = build()
        out[name] = (*_reference(s), golden(s), *_port(s))
    return out


def _assert_equal(want, got):
    assert len(want) == len(got)
    for fw, fg in zip(want, got):
        assert len(fw) == len(fg)
        for pw, pg in zip(fw, fg):
            np.testing.assert_array_equal(np.asarray(pw), np.asarray(pg))


@pytest.mark.parametrize("name", list(EXPECT))
def test_matches_the_jax_decode_and_its_census(decoded, name):
    ref_frames, ref_census, golden, port, census, _ = decoded[name]
    _assert_equal(ref_frames, port)
    _assert_equal(golden, port)
    assert census == ref_census


@pytest.mark.parametrize("name", list(EXPECT))
def test_census_names_the_host_pictures(decoded, name):
    """The census counts every rejected picture with its reason, and the
    other pictures ran the device pipeline."""
    _, _, _, port, census, on_device = decoded[name]
    keys, n_device = EXPECT[name]
    assert {k: census.get(k) for k in keys} == keys
    assert sum(v for k, v in census.items()
               if k.startswith("device_recon:")) == len(port) - n_device
    assert len(on_device) == n_device


def test_device_errors_are_not_fallbacks(monkeypatch):
    """A failure inside the device pipeline raises: only a reason from
    plan_frame_device sends a picture to the host."""
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu_torch.decoder import StreamDecoder

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(fd, "reconstruct_frame_device", broken)
    s = _streams()["isp_idr_then_device"]()
    dec = StreamDecoder(device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        dec.push(s)
        dec.flush()
    # the ISP IDR went to the host for its reason; the P picture raised
    assert {k: v for k, v in dec.fallback_census.items()
            if k.startswith("device_")} == {"device_recon:isp": 1}


def test_lmcs_inter_832x480_bytes_pin_and_census():
    """The inter-LMCS 832x480 stream equals its original builder's bytes
    (tests/test_lmcs.py's _lmcs_stream); its MD5 pin is the host
    golden's, its census pin the reference decoder's, and the port's CPU
    decode gives both."""
    import vvdec_tpu_torch.streams as S
    from tests.test_lmcs import _lmcs_stream
    from vvdec_tpu.decoder import decode_to_yuv
    build, n_frames, md5 = S.STREAMS["inter-LMCS"]
    s = build()
    assert s == _lmcs_stream(35, 3, 0, {}, dict(split_prob=0.5, density=0.3,
                                                inter_prob=0.8),
                             True, ctu=64, wh=(832, 480))
    yuv = decode_to_yuv(s)
    assert len(yuv) == n_frames * 832 * 480 * 3
    assert hashlib.md5(yuv).hexdigest() == md5 == S.LMCS_INTER_MD5
    ref_frames, ref_census = _reference(s)
    assert ref_census == S.LMCS_INTER_CENSUS
    port, census, on_device = _port(s)
    got = b"".join(p.astype("<u2").tobytes() for f in port for p in f)
    assert hashlib.md5(got).hexdigest() == md5
    assert census == S.LMCS_INTER_CENSUS
    assert on_device == [0]
