"""Low-delay P clips: an IDR, then P pictures on the previous pictures.

The builder of vvdec_tpu_torch/streams.py's `inter_ld_stream` (the
repository's bench.py "inter-LD" configurations): every P picture
references the previous `reference_pictures` pictures of the
configuration (fewer at the clip's start), with the picture size and
CTU from the configuration and the QP, the picture count and the
decision probabilities (inter, skip, motion-vector range) from the
traffic mix.  The test encoder writes syntax from seeded decisions and
reconstructs nothing, so each picture is made on its own.  With seed 5
it makes, at CTU 64 with two references, "inter-LD" (832x480, 12
pictures) and "inter-LD 1080p" (1920x1080, 6 pictures) byte for byte.
A mix's `shape_seed` fixes each picture's amount of work (clips.py);
the P pictures trade shapes, the IDR keeps its own.
"""

from __future__ import annotations


def _sets(config: dict):
    from refdec.testenc import encoder as E
    sps = E.make_sps(config["width"], config["height"], ctu=config["ctu"],
                     bit_depth=config["bit_depth"], num_reorder_pics=[0])
    return sps, E.make_pps(sps)


def pocs(config: dict, traffic: dict) -> list:
    """The clip's POCs in coding order."""
    return list(range(traffic["pictures_per_clip"]))


def headers(config: dict, traffic: dict, seed: int) -> bytes:
    """The NAL units before the first picture: SPS and PPS."""
    from clips import parameter_sets
    return parameter_sets(*_sets(config))


def picture(config: dict, traffic: dict, seed: int, f: int,
            shape: int | None = None) -> bytes:
    """The NAL unit of the clip's f-th picture: the IDR, or a P picture
    on the previous min(f, reference_pictures) pictures."""
    from clips import shaped_decisions
    from refdec.hls.params import P_SLICE
    from refdec.testenc import encoder as E
    sps, pps = _sets(config)
    dec = shaped_decisions(seed * 100 + f, shape, traffic["decisions"])
    if f == 0:
        nal, _ = E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=0,
                                idr=True)
    else:
        deltas = tuple(range(1, min(f, config["reference_pictures"]) + 1))
        nal, _ = E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=f,
                                idr=False, slice_type=P_SLICE,
                                ref_deltas=(deltas, ()))
    return nal
