"""Shapes: with a mix's `shape_seed`, every seed gets the same work.

A picture's shape fixes its partition, each CU's kind and residual
flags, how many coefficients each block draws, and the CTUs' SAO and ALF
switches; the clip's seed changes only the values.  A run's clips take
a fixed set of shapes, the first picture of a clip keeping its own.
"""

import pytest

import clips as clipmod

SMALL = dict(width=384, height=256, ctu=128, bit_depth=10)

MIXES = {
    "intra": dict(kind="intra", clips=2, pictures_per_clip=3, qp=22,
                  shape_seed=1, decisions=dict(split_prob=0.4, density=0.85,
                                               max_level=120)),
    "sao_alf": dict(kind="sao_alf", clips=2, pictures_per_clip=3, qp=32,
                    alf_apss=2, shape_seed=1,
                    decisions=dict(split_prob=0.35, density=0.1,
                                   sao_prob=0.5)),
    "inter_ld": dict(kind="inter_ld", clips=1, pictures_per_clip=4, qp=32,
                     shape_seed=1,
                     decisions=dict(split_prob=0.35, inter_prob=0.85,
                                    skip_prob=0.3, mv_range=32)),
}


def _encode(kind, traffic, seed, f, shape):
    """(NAL, CodingStructure) of picture f of a clip of `seed`."""
    from refdec.hls.params import P_SLICE
    from refdec.testenc import encoder as E
    config = dict(SMALL, reference_pictures=4)
    dec = clipmod.shaped_decisions(seed, shape, traffic["decisions"])
    if kind == "sao_alf":
        b = clipmod.load_builder(kind)
        sps, pps, apss, _, sh_kw = b._sets(config, traffic, seed)
        return E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=f,
                              idr=True, sh_kw=sh_kw, alf_apss=apss)
    sps = E.make_sps(SMALL["width"], SMALL["height"], ctu=SMALL["ctu"],
                     bit_depth=10, num_reorder_pics=[0])
    pps = E.make_pps(sps)
    if f == 0:
        return E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=0,
                              idr=True)
    return E.encode_frame(sps, pps, dec, qp=traffic["qp"], poc=f, idr=False,
                          slice_type=P_SLICE,
                          ref_deltas=(tuple(range(1, f + 1)), ()))


def _shape_of(cs):
    """What a shape fixes: each CU's place, size, tree, kind, and its
    TUs' CBFs, and the CTUs' SAO modes and ALF switches."""
    cus = [(cu.x, cu.y, cu.w, cu.h, cu.ch_type, cu.pred_mode, cu.skip,
            cu.merge_flag, tuple(tuple(tu.cbf) for tu in cu.tus))
           for cu in cs.cus]
    sao = [ctu and tuple(c["mode"] for c in ctu)
           for ctu in list(cs.sao_params or [])]
    alf = [a and (tuple(a["enable"]), tuple(bool(c) for c in a["cc"]))
           for a in list(cs.alf_params or [])]
    return cus, sao, alf


@pytest.mark.parametrize("kind", list(MIXES))
def test_a_shape_gives_one_partition_whatever_the_seed(kind):
    traffic = MIXES[kind]
    f = 1 if kind == "inter_ld" else 0
    (nal_a, cs_a), (nal_b, cs_b) = (_encode(kind, traffic, s, f, 77)
                                    for s in (11, 12))
    assert nal_a != nal_b
    assert _shape_of(cs_a) == _shape_of(cs_b)
    assert len(cs_a.cus) > 4
    if kind == "inter_ld":
        assert {cu.skip for cu in cs_a.cus} == {False, True}
    # another shape, another partition
    _, cs_c = _encode(kind, traffic, 11, f, 78)
    assert _shape_of(cs_c)[0] != _shape_of(cs_a)[0]


def test_without_a_shape_the_seed_gives_the_partition():
    traffic = MIXES["intra"]
    a = _shape_of(_encode("intra", traffic, 11, 0, None)[1])[0]
    b = _shape_of(_encode("intra", traffic, 12, 0, None)[1])[0]
    assert a != b


@pytest.mark.parametrize("kinds", [["picture"] * 6, ["I"] + ["P"] * 5,
                                   ["I", "B", "P", "B", "P", "B"]])
def test_a_run_takes_a_fixed_set_of_shapes(kinds):
    traffic = dict(shape_seed=3)
    for clip in range(2):
        seen = [clipmod.picture_shapes(traffic, clip, s, kinds)
                for s in (1, 2, 3, 4, 2 ** 31 + 977)]
        first = seen[0]
        assert len({tuple(x) for x in seen}) > 1
        for x in seen:
            assert sorted(x) == sorted(first)
            assert x[0] == first[0]
            assert [kinds[first.index(v)] for v in x] == kinds
    assert not set(clipmod.picture_shapes(traffic, 0, 1, kinds)) & \
        set(clipmod.picture_shapes(traffic, 1, 1, kinds))
    assert clipmod.picture_shapes({}, 0, 1, kinds) == [None] * len(kinds)


def test_every_seed_of_a_mix_gets_the_same_partitions(tmp_path):
    """Whole clips by make_clips: the same multiset of CU counts a clip,
    and the same first picture's partition, for two run seeds."""
    from refdec.decoder import FrameParser, read_nal_units
    traffic = dict(MIXES["intra"], pictures_per_clip=2)

    def counts(seed):
        out = []
        for c in clipmod.make_clips(SMALL, traffic, seed, str(tmp_path)):
            parser, frames = FrameParser(), []
            for nal in read_nal_units(c.stream):
                frames += parser.feed_nal(nal)
            out.append([len(f.cs.cus) for f in frames])
        return out

    a, b = counts(5), counts(6)
    assert [sorted(x) for x in a] == [sorted(x) for x in b]
    assert [x[0] for x in a] == [x[0] for x in b]
