"""Two faults of the port, repaired, each held to the reference on the
CPU.

- Chroma ALF or CC-ALF on, no CTU with luma ALF: the device filter
  chain's parameter build (_alf_inputs) stacked an empty luma bank list
  and raised, as vvdec_tpu's still does.  It now stacks one zero bank
  that no CTU selects.  The port's decode equals vvdec_tpu's host golden,
  the port's row-sharded chain equals its whole-frame chain, and
  vvdec_tpu's device decode raises on the same stream.
- Concealment after reference marking: the port's decoder drops a
  picture from its device DPB once no RPL names it; vvdec_tpu keeps every
  picture until the next IDR, and a lost reference takes the closest of
  them.  A stream coded 0, 1, 8, 4, 2 (POC 8 names only POC 0, so
  marking drops POC 1) loses POC 4, which POC 2 names: vvdec_tpu
  substitutes POC 1, the closest decoded picture.  The port now picks
  the same from the pictures marking dropped, and its output equals
  vvdec_tpu's host golden with err_policy="conceal".
Tolerance: bit-equal.
"""

import numpy as np
import pytest

from vvdec_tpu_torch.state import to_numpy


def _alf_stream():
    from vvdec_tpu_torch.streams import sao_alf_stream
    return sao_alf_stream(w=64, h=64, n=1, seed=1)


def test_alf_stream_has_no_luma_alf_ctu():
    """The stream's picture enables ALF in its slice, yet no CTU turns
    luma ALF on while chroma ALF or CC-ALF is on somewhere."""
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.ops.device_pipeline import _alf_inputs
    cs = parse_annexb(_alf_stream())[0].cs
    alf = _alf_inputs(cs, cs.sps.bit_depth)
    any_luma, any_chroma, any_cc = alf["any"]
    assert not any_luma and (any_chroma or any_cc)
    en_y, banks_co = alf["arrays"][0], alf["arrays"][5]
    assert not en_y.any()
    assert banks_co.shape == (1, 4, 25, 13) and not banks_co.any()


def test_alf_without_luma_ctu_decodes_as_host_golden():
    from vvdec_tpu.decoder import decode_annexb as decode_ref
    from vvdec_tpu_torch.decoder import decode_annexb
    stream = _alf_stream()
    got = decode_annexb(stream, device="cpu")
    want = decode_ref(stream)
    assert len(got) == len(want) == 1
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    # the reference's device filter chain has the fault
    with pytest.raises(ValueError, match="reshape"):
        decode_ref(stream, use_jax=True)


@pytest.mark.parametrize("rows", [2, 3])
def test_alf_without_luma_ctu_sharded_matches_whole_frame(rows):
    import torch

    from vvdec_tpu_torch.ops.device_pipeline import filter_frame_device
    from vvdec_tpu_torch.ops.sharded_chain import filter_frames_sharded
    from vvdec_tpu_torch.parallel.dryrun import capture_filter_inputs
    from vvdec_tpu_torch.parallel.sharding import Mesh
    items = capture_filter_inputs(_alf_stream(), "cpu")
    mesh = Mesh(np.array([torch.device("cpu")] * rows), ("row",))
    out = filter_frames_sharded(items, mesh)
    for o, (cs, planes) in zip(out, items):
        want = filter_frame_device(cs, planes).resolve()
        assert all(np.array_equal(to_numpy(a), b) for a, b in zip(o, want))


def _marking_stream():
    """Coded 0 (IDR), 1 (P: 0), 8 (P: 0), 4 (B: 0 | 8), 2 (B: 0 | 4):
    POC 8's lists name only POC 0, so marking drops POC 1 before POC 4
    and POC 2 are decoded."""
    from vvdec_tpu_torch.hls.params import B_SLICE, P_SLICE
    from vvdec_tpu_torch.streams import _headers
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions
    sps = E.make_sps(64, 64, ctu=32, num_reorder_pics=[2])
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    coding = [(0, None, None), (1, P_SLICE, ((1,), ())),
              (8, P_SLICE, ((8,), ())), (4, B_SLICE, ((4,), (-4,))),
              (2, B_SLICE, ((2,), (-2,)))]
    for i, (poc, slice_type, deltas) in enumerate(coding):
        dec = RandomDecisions(seed=900 + i, split_prob=0.3, inter_prob=0.8,
                              skip_prob=0.3, mv_range=8, density=0.1)
        if slice_type is None:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=poc,
                                    idr=False, slice_type=slice_type,
                                    ref_deltas=deltas)
        st += nal
    return st


def test_conceal_picks_the_reference_decoders_picture(monkeypatch):
    from vvdec_tpu.decoder import StreamDecoder as RefDecoder
    from vvdec_tpu_torch.decoder import StreamDecoder
    from vvdec_tpu_torch.streams import conceal_variant
    # the fourth picture in coding order is POC 4
    stream = conceal_variant(_marking_stream(), "lost", 3)

    ref_picks = []
    ref_sub = RefDecoder._substitute_ref

    def ref_spy(self, poc, cs):
        planes, cols = ref_sub(self, poc, cs)
        ref_picks.append((poc, next(p for p in self._refs
                                    if self._ref_planes_of(p) is planes)))
        return planes, cols

    monkeypatch.setattr(RefDecoder, "_substitute_ref", ref_spy)
    ref = RefDecoder(err_policy="conceal")
    want = ref.push(stream) + ref.flush()

    picks, in_dpb = [], []
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    port_sub = dec._substitute_ref

    def spy(poc, cs):
        in_dpb.append(sorted(dec._refs_dev))
        picks.append((poc, port_sub(poc, cs)))
        return picks[-1][1]

    dec._substitute_ref = spy
    got = dec.push(stream) + dec.flush()
    assert ref_picks == [(4, 1)]
    assert picks == ref_picks
    # POC 1 had left the device DPB: the pick came from the pictures
    # marking dropped
    assert in_dpb == [[0, 8]]
    assert [p.poc for p in got] == [p.poc for p in want] == [0, 1, 2, 8]
    assert dec.error_pictures == ref.error_pictures == 1
    for a, b in zip(got, want):
        assert a.error == b.error
        assert all(np.array_equal(x, y) for x, y in zip(a.planes, b.planes))


def test_strict_decoder_keeps_no_dropped_pictures():
    """Only concealment reads the dropped pictures; a strict decoder
    holds none of them."""
    from vvdec_tpu_torch.decoder import StreamDecoder
    dec = StreamDecoder(device="cpu")
    dec.push(_marking_stream())
    dec.flush()
    assert dec._unused_refs == {}
    dec = StreamDecoder(device="cpu", err_policy="conceal")
    dec.push(_marking_stream())
    dec.flush()
    assert 1 in dec._unused_refs
