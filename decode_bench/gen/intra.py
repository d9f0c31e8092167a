"""All-intra clips with deblocking on and no SAO or ALF.

The test encoder's `generate_stream` as vvdec_tpu_torch/streams.py's
`intra_stream` calls it (the repository's bench.py "all-intra",
"dense q27" and "max-density q22" configurations), one picture at a
time, with the picture size and CTU from the configuration and the QP,
the picture count and the decision probabilities from the traffic mix.
With seed 7, QP 22 and the max-density decisions at 832x480 and CTU 64
it makes "max-density q22" byte for byte; with seed 1 and the
headline's, the headline stream.  A mix's `shape_seed` fixes each
picture's amount of work (clips.py).
"""

from __future__ import annotations


def _sets(config: dict):
    from refdec.testenc import encoder as E
    sps = E.make_sps(config["width"], config["height"], ctu=config["ctu"],
                     bit_depth=config["bit_depth"])
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
    """The NAL unit of the clip's f-th picture (each an IDR)."""
    from clips import shaped_decisions
    from refdec.testenc import encoder as E
    sps, pps = _sets(config)
    dec = shaped_decisions(seed * 1000 + f, shape, traffic["decisions"])
    nal, _ = E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=f,
                            idr=True)
    return nal
