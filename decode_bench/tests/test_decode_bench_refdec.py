"""refdec, the benchmark's plain reference decoder, on the pinned streams.

The pins are vvdec_tpu_torch/streams.py's, copied here as constants: the
MD5 of each stream's decoded YUV (10-bit samples as little-endian 16-bit
words, every picture's Y, Cb, Cr in output order), as the JAX package's
host golden decoder gives it.  The streams come from the benchmark's own
builders (gen/) with those streams' parameters, so each test holds both
the builder and refdec (Python and NumPy alone) to the pin.  The SAO/ALF
stream runs CC-ALF, the path of refdec's one repair.
"""

import hashlib

import pytest

import clips as clipmod
import reference as refmod

HEADLINE_MD5 = "064b05031ed6a06c4614f68d2b9aca96"
SAO_ALF_MD5 = "f70a3843453637ace35361b992e5e461"
MAX_DENSITY_Q22_MD5 = "135933e18788d7ea42a1f6ebe91c3eec"
INTER_LD_MD5 = "ef6588cfd3e09b6827d76475ed85bea4"

C832 = dict(width=832, height=480, ctu=64, bit_depth=10)

CASES = {
    "headline": ("intra", C832, dict(
        pictures_per_clip=8, qp=32,
        decisions=dict(split_prob=0.35, density=0.1)), 1, HEADLINE_MD5),
    "SAO/ALF": ("sao_alf", C832, dict(
        pictures_per_clip=4, qp=32, alf_apss=2,
        decisions=dict(split_prob=0.35, density=0.1, sao_prob=0.5)),
        1, SAO_ALF_MD5),
    "max-density q22": ("intra", C832, dict(
        pictures_per_clip=6, qp=22,
        decisions=dict(split_prob=0.4, density=0.85, max_level=120)),
        7, MAX_DENSITY_Q22_MD5),
    "inter-LD": ("inter_ld", dict(C832, reference_pictures=2), dict(
        pictures_per_clip=12, qp=32,
        decisions=dict(split_prob=0.35, inter_prob=0.85, skip_prob=0.3,
                       mv_range=32)), 5, INTER_LD_MD5),
}


def yuv_md5(pics) -> str:
    h = hashlib.md5()
    for planes in pics:
        for p in planes:
            h.update(p.astype("<u2").tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", list(CASES))
def test_refdec_decodes_the_pinned_stream(name):
    kind, config, traffic, seed, pin = CASES[name]
    stream, pocs = clipmod.build_clip(kind, config, traffic, seed)
    assert pocs == list(range(traffic["pictures_per_clip"]))
    (rc,) = refmod.decode_clips([stream], workers=2)
    assert sorted(rc.planes) == pocs
    assert yuv_md5(rc.planes[p] for p in pocs) == pin


def test_segments_decode_alone_as_the_whole_stream():
    """Cutting a clip at its IDRs gives each picture once, and the same
    picture as a decode of the whole stream."""
    from refdec.decoder import decode_annexb
    config = dict(width=128, height=64, ctu=64, bit_depth=10)
    traffic = dict(pictures_per_clip=3, qp=32, alf_apss=2,
                   decisions=dict(split_prob=0.35, density=0.1,
                                  sao_prob=0.5))
    stream, pocs = clipmod.build_clip("sao_alf", config, traffic, 9)
    pieces = refmod.segments(stream)
    assert len(pieces) == 3
    whole = {p.poc: refmod.planes_md5(p.planes)
             for p in decode_annexb(stream)}
    (rc,) = refmod.decode_clips([stream], workers=1)
    assert rc.md5 == whole
