"""Random-access B pictures through the port's entry point, on the CPU:
the standalone-BDOF stream of tests/test_dmvr_device.py::TestDmvrDevice,
the stream of tests/test_frame_device.py::TestFrameDeviceInter::
test_dmvr_falls_back_bit_exact (a DMVR B picture the port once
rejected), and the RA 832x480 stream that chip_smoke.py decodes.

Tolerance: bit-equal.  The two small streams decode through
vvdec_tpu_torch's StreamDecoder on the CPU equal to the JAX device
pipeline and the host golden, with an empty fallback census and the JAX
decode's motion field after the fixups (tests/test_torch_ra.py holds
the helpers).  The RA stream of vvdec_tpu_torch/streams.py must equal,
byte for byte, the stream its original builder (tests/test_dmvr_bdof.py's
_bpyramid_stream, at 832x480 and CTU 64) makes with vvdec_tpu.testenc;
its pinned MD5 must be the host golden's, and the port's CPU decode
must give it with an empty census.
"""

import hashlib

import pytest

from tests.test_torch_ra import (COMBINED_DEC, COMBINED_SPS, check_frames,
                                 check_motion, decode_streams)

# stream -> the refinement stages it runs
NAMES = {"bdof_standalone": ("BDOF",), "dmvr_falls_back_bit_exact": ("DMVR",)}


@pytest.fixture(scope="module")
def decoded():
    """Each decode of this file's streams runs once."""
    return decode_streams(NAMES)


@pytest.mark.parametrize("name", list(NAMES))
def test_matches_jax_device_pipeline_and_host_golden(decoded, name):
    check_frames(decoded[name], NAMES[name])


@pytest.mark.parametrize("name", list(NAMES))
def test_refined_motion_field_matches_jax(decoded, name):
    # the BDOF-only stream refines no MV
    check_motion(decoded[name], refined="DMVR" in NAMES[name])


def _ra_reference():
    """The RA stream as the original builder makes it with vvdec_tpu:
    _bpyramid_stream's coding order and RPLs at 832x480, CTU 64, the
    SPS flags of test_dmvr_bdof_combined and test_dmvr_bdof_affine_sbtmvp
    together."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import B_SLICE, P_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps_kw = dict(COMBINED_SPS, affine_enabled=True, affine_6param=True,
                  prof_enabled=True, sbtmvp_enabled=True)
    dec_kw = dict(COMBINED_DEC, affine_prob=0.3, affine_merge_prob=0.3)
    sps = E.make_sps(832, 480, ctu=64, num_reorder_pics=[2], **sps_kw)
    pps = E.make_pps(sps)
    w = BitWriter()
    write_sps(w, sps)
    stream = make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    stream += make_nal(NalUnitType.PPS, w.bytes())
    coding = [
        (0, True, None, ((), ()), None),
        (4, False, P_SLICE, ((4,), ()), None),
        (2, False, B_SLICE, ((2,), (-2,)), [1, 1]),
        (1, False, B_SLICE, ((1, -3), (-1,)), [1, 1]),
        (3, False, B_SLICE, ((1, 3), (-1,)), [1, 1]),
    ]
    for i, (poc, idr, st, deltas, active) in enumerate(coding):
        dec = RandomDecisions(seed=3 * 100 + i, **dec_kw)
        if idr:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=poc, idr=True)
        else:
            sh_kw = dict(num_ref_idx_active=active) if active else None
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=poc, idr=False,
                                    slice_type=st, ref_deltas=deltas,
                                    sh_kw=sh_kw)
        stream += nal
    return stream


def test_ra_stream_bytes_and_pin_match_the_reference():
    """The RA stream equals its original builder's bytes; its pin is the
    host golden's MD5 (the native inter path and the pure-Python one
    agree on it), and the port's CPU decode gives it with an empty
    census, through both refinement stages."""
    import vvdec_tpu_torch.streams as S
    from vvdec_tpu.decoder import decode_to_yuv
    from vvdec_tpu_torch.decoder import StreamDecoder
    build, n_frames, md5 = S.STREAMS["RA"]
    assert S.RA_STREAM_KW == dict(
        w=832, h=480, seed=3,
        sps_kw=dict(COMBINED_SPS, affine_enabled=True, affine_6param=True,
                    prof_enabled=True, sbtmvp_enabled=True),
        dec_kw=dict(COMBINED_DEC, affine_prob=0.3, affine_merge_prob=0.3))
    s = build()
    assert s == _ra_reference()
    yuv = decode_to_yuv(s)
    assert len(yuv) == n_frames * 832 * 480 * 3
    assert hashlib.md5(yuv).hexdigest() == md5 == S.RA_MD5
    with pytest.MonkeyPatch.context() as m:
        from tests.test_torch_ra import _Tap
        tap = _Tap(m, "vvdec_tpu_torch")
        dec = StreamDecoder(device="cpu")
        pics = dec.push(s) + dec.flush()
    got = b"".join(p.astype("<u2").tobytes() for pic in pics
                   for p in pic.planes)
    assert hashlib.md5(got).hexdigest() == md5
    assert dict(dec.fallback_census) == {}
    assert tap.refined["DMVR"] > 0 and tap.refined["BDOF"] > 0, tap.refined
