"""The concealment streams chip_smoke.py decodes on the card, and their
pins, held to the reference.

vvdec_tpu_torch/streams.py derives each case of CONCEAL_CASES from the
inter-LD stream (bench.py's "inter-LD 832x480") with one fault: a lost
P picture, a broken P-picture slice, or the stream cut in the middle of
a picture.  Each derived stream must equal, byte for byte, the same
fault applied to the stream bench.py's own builder makes with
vvdec_tpu.testenc, and each pin (pictures out, error flags,
error_pictures, grey pictures, MD5) must be what vvdec_tpu's host golden
decoder gives with err_policy="conceal".  The headline's first frame has
a pin of its own, which chip_smoke.py checks after the concealment cases
to show that the CUDA context survived them.
"""

import hashlib

import numpy as np
import pytest

import vvdec_tpu_torch.streams as S

BENCH_INTER_KW = dict(split_prob=0.35, inter_prob=0.85, skip_prob=0.3,
                      mv_range=32)


def _reference_variant(stream, fault, poc):
    """The fault, applied with the reference's NAL splitter."""
    from vvdec_tpu.bitstream.nal import is_vcl, split_annexb
    units = [(off, size) for off, size in split_annexb(stream)
             if is_vcl(stream[off + 1] >> 3)]
    off, size = units[poc]
    start = off - 3
    if start > 0 and stream[start - 1] == 0:
        start -= 1      # a 4-byte start code
    end = off + size
    if fault == "lost":
        return stream[:start] + stream[end:]
    if fault == "broken":
        b = bytearray(stream)
        b[end - 8:end] = b"\xff" * 8
        return bytes(b)
    assert fault == "cut"
    return stream[:(start + end) // 2]


@pytest.fixture(scope="module")
def inter_ld():
    """(port's inter-LD stream, bench.py's)."""
    import bench
    return (S.inter_ld_stream(**S.INTER_LD_STREAM_KW),
            bench._ld_stream(832, 480, 12, 5, BENCH_INTER_KW))


@pytest.mark.parametrize("name", list(S.CONCEAL_CASES))
def test_conceal_stream_matches_reference_builder(inter_ld, name):
    fault, poc = S.CONCEAL_CASES[name][:2]
    port = S.conceal_variant(inter_ld[0], fault, poc)
    assert port == _reference_variant(inter_ld[1], fault, poc)
    assert port != inter_ld[0]


@pytest.mark.parametrize("name", list(S.CONCEAL_CASES))
def test_conceal_pins_are_host_golden(inter_ld, name):
    from vvdec_tpu.decoder import StreamDecoder
    fault, poc, n_out, err_pocs, n_err, n_grey, md5 = S.CONCEAL_CASES[name]
    dec = StreamDecoder(err_policy="conceal")
    pics = dec.push(_reference_variant(inter_ld[1], fault, poc))
    pics += dec.flush()
    assert len(pics) == n_out
    assert tuple(p.poc for p in pics if p.error) == err_pocs
    assert dec.error_pictures == n_err
    assert sum(all((p == 512).all() for p in pic.planes)
               for pic in pics) == n_grey
    yuv = b"".join(p.astype("<u2").tobytes() for pic in pics
                   for p in pic.planes)
    assert hashlib.md5(yuv).hexdigest() == md5
    # a strict decoder refuses every case
    with pytest.raises(Exception):
        dec = StreamDecoder()
        dec.push(_reference_variant(inter_ld[1], fault, poc))
        dec.flush()


def test_headline_first_frame_pin():
    """HEADLINE_FIRST_MD5 is the host golden's YUV of the headline's
    1-frame stream, and the first frame of the 8-frame decode."""
    from vvdec_tpu.decoder import decode_annexb, decode_to_yuv
    from vvdec_tpu.testenc.encoder import generate_stream
    one, _ = generate_stream(**dict(S.HEADLINE_STREAM_KW, n_frames=1))
    yuv = decode_to_yuv(one)
    assert len(yuv) == 832 * 480 * 3
    assert hashlib.md5(yuv).hexdigest() == S.HEADLINE_FIRST_MD5
    full, _ = generate_stream(**S.HEADLINE_STREAM_KW)
    first = decode_annexb(full)[0]
    assert hashlib.md5(b"".join(
        np.asarray(p).astype("<u2").tobytes() for p in first)
    ).hexdigest() == S.HEADLINE_FIRST_MD5
