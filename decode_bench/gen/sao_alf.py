"""All-intra clips with SAO, two ALF APSs, chroma ALF and CC-ALF on.

The builder of vvdec_tpu_torch/streams.py's `sao_alf_stream` (the
repository's bench.py "all-intra+SAO/ALF" configuration), with the
picture size and CTU from the configuration and the QP, the picture
count, the number of ALF APSs and the decision probabilities from the
traffic mix.  With seed 1 and 4 or 8 pictures at 832x480 and CTU 64 it
makes the "SAO/ALF" and "SAO/ALF 8" streams byte for byte.  A mix with
a `shape_seed` (clips.py) also keeps CC-ALF on in both chroma
components of every clip.
"""

from __future__ import annotations


def _sets(config: dict, traffic: dict, seed: int):
    """(SPS, PPS, {aps id: APS}, the APS NALs, the slice header's
    keywords) of a clip."""
    from refdec.testenc import encoder as E
    from refdec.testenc.encoder import make_alf_aps
    sps = E.make_sps(config["width"], config["height"], ctu=config["ctu"],
                     bit_depth=config["bit_depth"], sao_enabled=True,
                     alf_enabled=True, ccalf_enabled=True)
    pps = E.make_pps(sps)
    apss, nals = {}, b""
    for i in range(traffic["alf_apss"]):
        aps_seed = seed * 10 + i
        aps, nal = make_alf_aps(aps_seed, aps_id=i, cc=True)
        # with a shape, the slice's CC-ALF (APS 0's Cb filter, the last
        # APS's Cr filter) is on whatever the seed: the next draw of
        # the APS until both of its CC-ALF filters are there
        while "shape_seed" in traffic and not all(aps.cc_alf.new_filter):
            aps_seed += 1 << 32
            aps, nal = make_alf_aps(aps_seed, aps_id=i, cc=True)
        apss[i] = aps
        nals += nal
    last = traffic["alf_apss"] - 1
    sh_kw = dict(sao_enabled_luma=True, sao_enabled_chroma=True,
                 alf_enabled=[True, True, True],
                 num_alf_aps_ids_luma=len(apss),
                 alf_aps_ids_luma=list(apss), alf_aps_id_chroma=0,
                 ccalf_cb_enabled=apss[0].cc_alf.new_filter[0],
                 ccalf_cb_aps_id=0,
                 ccalf_cr_enabled=apss[last].cc_alf.new_filter[1],
                 ccalf_cr_aps_id=last)
    return sps, pps, apss, nals, sh_kw


def pocs(config: dict, traffic: dict) -> list:
    """The clip's POCs in coding order."""
    return list(range(traffic["pictures_per_clip"]))


def headers(config: dict, traffic: dict, seed: int) -> bytes:
    """The NAL units before the first picture: SPS, PPS, the ALF APSs."""
    from clips import parameter_sets
    sps, pps, _, nals, _ = _sets(config, traffic, seed)
    return parameter_sets(sps, pps) + nals


def picture(config: dict, traffic: dict, seed: int, f: int,
            shape: int | None = None) -> bytes:
    """The NAL unit of the clip's f-th picture (each an IDR)."""
    from clips import shaped_decisions
    from refdec.testenc import encoder as E
    sps, pps, apss, _, sh_kw = _sets(config, traffic, seed)
    dec = shaped_decisions(seed * 100 + f, shape, traffic["decisions"])
    nal, _ = E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=f,
                            idr=True, sh_kw=sh_kw, alf_apss=apss)
    return nal
