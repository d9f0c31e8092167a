"""The device DPB's reference marking on a long GOP without IDRs.

A 40-picture low-delay P stream (an IDR, then 39 trailing pictures, no
IDR after the first) whose pictures name one to two references, one of
them inactive every fourth picture and active in the next.  The port
decodes it on the CPU; after each picture the device DPB (`_refs_dev`)
and its companions (`_refs_host`, `_ref_cols`, `_ref_pps`) hold only the
pictures the current picture's RPLs name plus the picture itself, never
more than the SPS's max_dec_pic_buffering, and the YUV is bit-equal to
vvdec_tpu's host golden decode.
"""

import numpy as np

N_PICTURES = 40


def _deltas(f: int):
    """(ref_deltas, sh_kw) of picture f >= 1: every fourth picture keeps
    POC f - 3 as an inactive entry that the next picture uses."""
    if f % 4 == 1:
        return ((1,), ()), {}
    if f % 4 == 2:
        return ((1, 2), ()), {}
    if f % 4 == 3:
        return ((1, 3), ()), dict(num_ref_idx_active=[1, 0])
    return ((1, 4), ()), {}


def _long_gop_stream() -> tuple[bytes, int]:
    from vvdec_tpu_torch.hls.params import P_SLICE
    from vvdec_tpu_torch.streams import _headers
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions
    sps = E.make_sps(64, 64, ctu=32, num_reorder_pics=[0])
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    for f in range(N_PICTURES):
        dec = RandomDecisions(seed=700 + f, split_prob=0.2, inter_prob=0.8,
                              skip_prob=0.3, mv_range=8, density=0.1)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=34, poc=0, idr=True)
        else:
            deltas, sh_kw = _deltas(f)
            nal, _ = E.encode_frame(sps, pps, dec, qp=34, poc=f, idr=False,
                                    slice_type=P_SLICE, ref_deltas=deltas,
                                    sh_kw=sh_kw)
        st += nal
    return st, sps.max_dec_pic_buffering[-1]


def test_long_gop_dpb_is_bounded_and_bit_equal():
    from vvdec_tpu.decoder import decode_to_yuv as decode_ref
    from vvdec_tpu_torch.decoder import StreamDecoder, u16_view
    stream, max_dpb = _long_gop_stream()
    dec = StreamDecoder(device="cpu")
    held = []
    inner = dec._reconstruct_inner

    def spy(f):
        inner(f)
        held.append((f.poc, sorted(dec._refs_dev)))
        assert sorted(dec._refs_dev) == sorted(dec._refs_host) \
            == sorted(dec._ref_cols) == sorted(dec._ref_pps)

    dec._reconstruct_inner = spy
    pics = dec.push(stream) + dec.flush()
    assert [p.poc for p in pics] == list(range(N_PICTURES))
    assert [poc for poc, _ in held] == list(range(N_PICTURES))
    for poc, dpb in held:
        assert len(dpb) <= max_dpb, (poc, dpb)
        if poc:
            deltas, _ = _deltas(poc)
            assert dpb == sorted({poc - d for d in deltas[0]} | {poc}), \
                (poc, dpb)
    # the inactive entry of POC 4k + 3 stays until POC 4k + 4 uses it
    assert dict(held)[7] == [4, 6, 7]
    yuv = b"".join(u16_view(np.asarray(p)).astype("<u2").tobytes()
                   for pic in pics for p in pic.planes)
    assert yuv == decode_ref(stream)
