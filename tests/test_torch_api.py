"""The port's public API, vvdec_tpu_torch.api, against vvdec_tpu.api on
the CPU.

The cases of tests/test_api.py, each run through both packages'
Decoder with the same parameters (the port's on device="cpu", the
reference's on its host golden path): streaming equals batch, per-AU
push, frame_unref, find_frame_sei with a decoded-picture hash, a hash
error counted when not strict, DPB bumping by POC, the IDR flush, film
grain applied and deterministic, the cancel flag, the external buffer
allocator, VUI/HRD on the frames; concealment through err_handling; and
the three 4:2:0 film-grain streams of tests/test_film_grain_oracle.py
(which there need the vvdecapp binary), whose output must equal the
reference Decoder's.  Tolerance: bit-equal planes, equal counters.
"""

import numpy as np
import pytest


def _stream(n_frames=3, seed=3):
    from vvdec_tpu.testenc.encoder import generate_stream
    return generate_stream(width=96, height=64, ctu=32, n_frames=n_frames,
                           seed=seed, qp=32,
                           dec_kw=dict(split_prob=0.3, density=0.1))[0]


def _decoders(**params):
    """(port Decoder, reference Decoder) with the same parameters."""
    import vvdec_tpu.api as R
    import vvdec_tpu_torch.api as T
    return (T.Decoder(T.DecoderParams(device="cpu", **params)),
            R.Decoder(R.DecoderParams(**params)))


def _planes(frames):
    return [[np.asarray(p).copy() for p in f.planes] for f in frames]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(p, q) for p, q in zip(x, y))
        for x, y in zip(a, b))


def _both(chunks, **params):
    """Feed the chunks to both decoders, then flush: (port frames,
    reference frames, port decoder, reference decoder)."""
    out = []
    decs = _decoders(**params)
    for d in decs:
        frames = []
        for c in chunks:
            frames.extend(d.decode(c))
        frames.extend(d.flush())
        out.append(frames)
    return out[0], out[1], decs[0], decs[1]


def test_streaming_decode_matches_batch():
    from vvdec_tpu_torch.decoder import decode_annexb
    stream = _stream(4)
    port, ref, _, _ = _both([stream])
    assert len(port) == 4
    assert _equal(_planes(port), _planes(ref))
    assert _equal(_planes(port), decode_annexb(stream, device="cpu"))
    assert [f.poc for f in port] == [f.poc for f in ref]


def test_streaming_per_au_push():
    import re
    stream = _stream(3)
    starts = [m.start() for m in re.finditer(b"\x00\x00\x01", stream)]
    chunks = [stream[a:b] for a, b in zip(starts, starts[1:] + [len(stream)])]
    port, ref, _, _ = _both(chunks)
    batch, _, _, _ = _both([stream])
    assert len(port) == 3
    assert _equal(_planes(port), _planes(ref))
    assert _equal(_planes(port), _planes(batch))


def test_frame_unref_releases_dpb():
    port, ref, dp, dr = _both([_stream(3)])
    assert all(f.picture.locked_by_application for f in port)
    for d, frames in ((dp, port), (dr, ref)):
        for f in frames:
            d.frame_unref(f)
        assert all(not p.locked_by_application
                   for p in d._core.plm.pictures())
        assert all(f.planes == [] and f.picture is None for f in frames)


def _with_dph(corrupt=False):
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.decoder import decode_annexb
    from vvdec_tpu.hls.sei import make_dph_sei, write_sei_nal
    from vvdec_tpu.testenc.encoder import make_nal
    stream = _stream(1)
    sei = make_dph_sei(decode_annexb(stream)[0], 10, 0)
    if corrupt:
        sei.payload = bytes(sei.payload[:-1]) \
            + bytes([sei.payload[-1] ^ 0xFF])
    return stream + make_nal(NalUnitType.SUFFIX_SEI, write_sei_nal([sei]))


def test_find_frame_sei_dph():
    from vvdec_tpu_torch.hls.sei import SEI_DECODED_PICTURE_HASH
    port, ref, dp, dr = _both([_with_dph()], verify_picture_hash=True)
    m = dp.find_frame_sei(port[0], SEI_DECODED_PICTURE_HASH)
    assert m is not None
    assert m.payload == dr.find_frame_sei(ref[0], m.payload_type).payload
    assert dp.get_hash_error_count() == dr.get_hash_error_count() == 0
    assert _equal(_planes(port), _planes(ref))


def test_hash_error_counted_when_not_strict():
    _, _, dp, dr = _both([_with_dph(corrupt=True)],
                         verify_picture_hash=False)
    assert dp.get_hash_error_count() == dr.get_hash_error_count() == 1


def test_hash_error_raises_when_strict():
    for d in _decoders(verify_picture_hash=True):
        with pytest.raises(ValueError, match="hash mismatch"):
            d.decode(_with_dph(corrupt=True))
            d.flush()


@pytest.mark.parametrize("pkg", ["vvdec_tpu_torch", "vvdec_tpu"])
def test_dpb_bumping_poc_order(pkg):
    import importlib
    dpb = importlib.import_module(f"{pkg}.dpb")
    plm = dpb.PicListManager()
    for poc in (0, 4, 2, 1, 3):
        plm.add(dpb.DecodedPicture(poc=poc, planes=[], is_idr=poc == 0))
    assert [p.poc for p in plm.drain(num_reorder=2)] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("pkg", ["vvdec_tpu_torch", "vvdec_tpu"])
def test_dpb_idr_flushes_prior_pictures(pkg):
    import importlib
    dpb = importlib.import_module(f"{pkg}.dpb")
    plm = dpb.PicListManager()
    plm.add(dpb.DecodedPicture(poc=0, planes=[], is_idr=True))
    plm.add(dpb.DecodedPicture(poc=1, planes=[]))
    plm.add(dpb.DecodedPicture(poc=0, planes=[], is_idr=True))
    got = []
    for _ in range(20):
        p = plm.get_next_output(num_reorder=4)
        if p is not None:
            got.append(p.poc)
        if len(got) == 2:
            break
    assert got == [0, 1]


def _fgc_sei(cancel=False, sigma=40):
    """tests/test_api.py's minimal FGC SEI: model 0, luma, one interval."""
    from vvdec_tpu.hls.sei import SEI_FILM_GRAIN_CHARACTERISTICS, SeiMessage
    from vvdec_tpu.testenc.bitwriter import BitWriter
    w = BitWriter()
    w.u(1 if cancel else 0, 1)
    if not cancel:
        w.u(0, 2)
        w.u(0, 1)
        w.u(0, 2)
        w.u(5, 4)
        w.u(1, 1)
        w.u(0, 1)
        w.u(0, 1)
        w.u(0, 8)
        w.u(2, 3)
        w.u(0, 8)
        w.u(255, 8)
        w.se(sigma)
        w.se(8)
        w.se(8)
        w.u(0, 1)
    w.u(1, 1)
    while w.bitpos % 8:
        w.u(0, 1)
    return SeiMessage(payload_type=SEI_FILM_GRAIN_CHARACTERISTICS,
                      payload=w.bytes())


def _sei_nal(sei):
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.sei import write_sei_nal
    from vvdec_tpu.testenc.encoder import make_nal
    return make_nal(NalUnitType.PREFIX_SEI, write_sei_nal([sei]))


def test_film_grain_applied_and_deterministic():
    from vvdec_tpu_torch.decoder import decode_annexb
    stream = _stream(1)
    plain = decode_annexb(stream, device="cpu")[0]
    data = _sei_nal(_fgc_sei()) + stream
    p1, r1, _, _ = _both([data], film_grain_synthesis=True)
    p2, _, _, _ = _both([data], film_grain_synthesis=True)
    assert any(not np.array_equal(p, q) for p, q in zip(p1[0].planes, plain))
    assert _equal(_planes(p1), _planes(p2))
    assert _equal(_planes(p1), _planes(r1))
    p3, r3, _, _ = _both([data], film_grain_synthesis=False)
    assert _equal(_planes(p3), [plain]) and _equal(_planes(r3), [plain])


def test_film_grain_cancel_flag():
    from vvdec_tpu_torch.decoder import decode_annexb
    stream = _stream(1)
    plain = decode_annexb(stream, device="cpu")[0]
    port, ref, _, _ = _both([_sei_nal(_fgc_sei(cancel=True)) + stream],
                            film_grain_synthesis=True)
    assert _equal(_planes(port), [plain]) and _equal(_planes(ref), [plain])


def test_external_buffer_allocator():
    """Output planes land in the application's buffers, released through
    frame_unref, in both packages alike."""
    import vvdec_tpu.api as R
    import vvdec_tpu_torch.api as T
    from vvdec_tpu.testenc.encoder import generate_stream
    stream, _ = generate_stream(width=64, height=64, n_frames=2, seed=3,
                                dec_kw=dict(split_prob=0.4))
    planes = []
    for api, kw in ((T, dict(device="cpu")), (R, {})):
        allocated, released = [], []

        def alloc(w, h, bd, fmt, allocated=allocated):
            bufs = [np.zeros((h, w), dtype=np.uint16),
                    np.zeros((h // 2, w // 2), dtype=np.uint16),
                    np.zeros((h // 2, w // 2), dtype=np.uint16)]
            allocated.append(bufs)
            return bufs

        d = api.Decoder(api.DecoderParams(
            buffer_allocator=alloc, buffer_unref=released.append, **kw))
        frames = d.decode(stream) + d.flush()
        assert len(allocated) == 2
        for f, bufs in zip(frames, allocated):
            assert f.planes is bufs and bufs[0].any()
        planes.append(_planes(frames))
        for f in frames:
            d.frame_unref(f)
        assert len(released) == 2
    assert _equal(*planes)


def test_decoder_info_and_version():
    from vvdec_tpu_torch import api
    d = api.Decoder(api.DecoderParams(device="cpu"))
    info = d.get_decoder_info()
    assert info.startswith("vvdec_tpu_torch ") and "KERNELS=" in info
    assert "RECON=cpu" in info and "FGS=1" in info
    assert api.version()
    from vvdec_tpu_torch import Decoder, DecoderParams, Frame
    assert Decoder is api.Decoder and DecoderParams is api.DecoderParams \
        and Frame is api.Frame


def test_decoder_needs_cuda_unless_cpu_is_asked():
    """The default device is CUDA: without a card the Decoder raises."""
    import torch

    from vvdec_tpu_torch.api import Decoder
    if torch.cuda.is_available():
        assert Decoder()._core.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Decoder()


def test_frame_exposes_vui_and_hrd():
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(64, 64)
    sps.vui_present = True
    sps.vui = {"progressive_source": True, "aspect_ratio_constant": True,
               "aspect_ratio_idc": 1, "colour_primaries": 9,
               "transfer_characteristics": 16, "matrix_coeffs": 9,
               "full_range": False}
    pps = E.make_pps(sps)
    w = BitWriter()
    write_sps(w, sps)
    stream = make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    stream += make_nal(NalUnitType.PPS, w.bytes())
    nal, _ = E.encode_frame(sps, pps, RandomDecisions(seed=1), qp=32,
                            poc=0, idr=True)
    stream += nal
    port, ref, _, _ = _both([stream])
    assert len(port) == 1
    assert port[0].vui == ref[0].vui and port[0].vui["sar_width"] == 1
    assert port[0].vui["colour_primaries"] == 9
    assert port[0].hrd is None and ref[0].hrd is None


def test_conceal_through_err_handling():
    """err_handling="conceal": a lost IDR gives the reference's frames
    (here its JAX device path's, which the host golden equals)."""
    from tests.test_torch_conceal import _inter_stream
    nals = _inter_stream(3)
    data = nals[0] + b"".join(nals[2:])
    port, ref, dp, dr = _both([data], err_handling="conceal")
    assert len(port) == 2 and _equal(_planes(port), _planes(ref))
    assert [f.picture.error for f in port] == [f.picture.error for f in ref]
    assert dp._core.error_pictures == dr._core.error_pictures == 1
    for d in _decoders(err_handling="strict"):
        with pytest.raises(ValueError, match="missing reference"):
            d.decode(data)
            d.flush()


def _fg_oracle_sei(model_id=0, log2_scale=5, luma=None, cb=None, cr=None,
                   persistence=True):
    """tests/test_film_grain_oracle.py's FGC SEI builder."""
    from vvdec_tpu.hls.sei import SEI_FILM_GRAIN_CHARACTERISTICS, SeiMessage
    from vvdec_tpu.testenc.bitwriter import BitWriter
    comps = [luma, cb, cr]
    w = BitWriter()
    w.u(0, 1)
    w.u(model_id, 2)
    w.u(0, 1)
    w.u(0, 2)
    w.u(log2_scale, 4)
    for c in range(3):
        w.u(1 if comps[c] else 0, 1)
    for c in range(3):
        if not comps[c]:
            continue
        n_vals = max(len(v[2]) for v in comps[c])
        w.u(len(comps[c]) - 1, 8)
        w.u(n_vals - 1, 3)
        for lo, hi, vals in comps[c]:
            w.u(lo, 8)
            w.u(hi, 8)
            for i in range(n_vals):
                w.se(vals[i] if i < len(vals) else 0)
    w.u(1 if persistence else 0, 1)
    w.u(1, 1)
    while w.bitpos % 8:
        w.u(0, 1)
    return SeiMessage(payload_type=SEI_FILM_GRAIN_CHARACTERISTICS,
                      payload=w.bytes())


def _grain_stream(seed, sei, n_frames=3, wh=(192, 96)):
    """tests/test_film_grain_oracle.py's IDR + FGC SEI + P frames."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.sei import write_sei_nal
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import P_SLICE, RandomDecisions, make_nal
    from vvdec_tpu.testenc.hls_writer import write_pps, write_sps
    sps = E.make_sps(wh[0], wh[1], chroma_format=1)
    pps = E.make_pps(sps)
    w = BitWriter()
    write_sps(w, sps)
    stream = make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    stream += make_nal(NalUnitType.PPS, w.bytes())
    stream += make_nal(NalUnitType.PREFIX_SEI, write_sei_nal([sei]))
    for f in range(n_frames):
        dec = RandomDecisions(seed=seed * 100 + f, split_prob=0.4,
                              density=0.15,
                              inter_prob=0.7 if f else 0.0, mv_range=24)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=30, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(sps, pps, dec, qp=30, poc=f, idr=False,
                                    slice_type=P_SLICE,
                                    ref_deltas=((1,), ()))
        stream += nal
    return stream


GRAIN_CASES = {
    "ff luma only seed 3": (3, dict(luma=[(0, 255, [40, 8, 8])])),
    "ff luma only seed 4": (4, dict(luma=[(0, 255, [40, 8, 8])])),
    "ff multi-interval chroma": (7, dict(
        log2_scale=6, luma=[(0, 127, [60, 8, 8]), (128, 255, [30, 12, 6])],
        cb=[(0, 255, [40, 8, 8])], cr=[(0, 255, [24, 10, 10])])),
    "ar model": (9, dict(model_id=1, log2_scale=7,
                         luma=[(0, 255, [48, 20, 0, 10, 128, 5])])),
}


@pytest.mark.parametrize("name", list(GRAIN_CASES))
def test_film_grain_stream_matches_reference(name):
    seed, kw = GRAIN_CASES[name]
    port, ref, _, _ = _both([_grain_stream(seed, _fg_oracle_sei(**kw))],
                            film_grain_synthesis=True)
    assert len(port) == 3
    got = b"".join(p.astype("<u2").tobytes() for f in port for p in f.planes)
    want = b"".join(p.astype("<u2").tobytes() for f in ref for p in f.planes)
    assert got == want
