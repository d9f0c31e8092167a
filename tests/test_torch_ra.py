"""Random-access B pictures through the port's entry point, on the CPU.

Tolerance: bit-equal.  vvdec_tpu_torch.decoder.StreamDecoder(device=
"cpu") is held to the JAX package's device pipeline
(`decode_annexb(s, use_jax=True)`) and to its host golden on every
stream of tests/test_dmvr_device.py::TestDmvrDevice and on the stream
of tests/test_frame_device.py::TestFrameDeviceInter::
test_dmvr_falls_back_bit_exact (STREAMS): DMVR and BDOF CUs run the
port's device refinement stage, so every picture stays on the device
path (an empty fallback census), and the motion field after the
refined-MV fixups, which TMVP in later pictures reads, equals the JAX
decode's.  The JAX decodes compile for a minute or more per stream, so
three files share the streams, each near two minutes: this one the
DMVR and combined streams, tests/test_torch_ra_seeds.py the seeds and
device-residency streams, tests/test_torch_ra_stream.py the BDOF-only
and the former fallback stream, and the RA 832x480 stream's bytes and
pin.
"""

import numpy as np
import pytest

import tests.test_frame_device as tfd
from tests.test_dmvr_bdof import _bpyramid_stream

COMBINED_SPS = dict(dmvr_enabled=True, bdof_enabled=True,
                    temporal_mvp_enabled=True, mmvd_enabled=True,
                    amvr_enabled=True, bcw_enabled=True)
COMBINED_DEC = dict(split_prob=0.4, inter_prob=0.8, skip_prob=0.25,
                    mv_range=40, bi_prob=0.7, mmvd_prob=0.2, amvr_prob=0.3,
                    bcw_prob=0.3)
SEEDS_SPS = dict(dmvr_enabled=True, bdof_enabled=True)
SEEDS_DEC = dict(split_prob=0.35, inter_prob=0.85, skip_prob=0.2,
                 mv_range=48, bi_prob=0.9)


def _dmvr_fallback_stream():
    """TestFrameDeviceInter::test_dmvr_falls_back_bit_exact's stream:
    POC 0, 2, then a B picture at POC 1 with equal-distance bi-pred."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import B_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(tfd.WH[0], tfd.WH[1], ctu=32, num_reorder_pics=[1],
                     dmvr_enabled=True)
    pps = E.make_pps(sps)
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    st += make_nal(NalUnitType.PPS, bw.bytes())
    dec = RandomDecisions(seed=41, split_prob=0.2)
    st += E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)[0]
    dec = RandomDecisions(seed=42, split_prob=0.2)
    st += E.encode_frame(sps, pps, dec, qp=32, poc=2, idr=False,
                         slice_type=1, ref_deltas=((2,), ()))[0]
    dec = RandomDecisions(seed=43, split_prob=0.2, inter_prob=0.9,
                          bi_prob=0.9, mv_range=24)
    st += E.encode_frame(sps, pps, dec, qp=32, poc=1, idr=False,
                         slice_type=B_SLICE, ref_deltas=((1,), (-1,)))[0]
    return st


# tests/test_dmvr_device.py::TestDmvrDevice (:134-176)
STREAMS = {
    "bdof_standalone": lambda: _bpyramid_stream(
        1, dict(bdof_enabled=True),
        dict(split_prob=0.35, inter_prob=0.8, skip_prob=0.2, mv_range=40,
             bi_prob=0.8)),
    "dmvr": lambda: _bpyramid_stream(
        2, dict(dmvr_enabled=True),
        dict(split_prob=0.35, inter_prob=0.8, skip_prob=0.3, mv_range=40,
             bi_prob=0.8)),
    "dmvr_bdof_combined": lambda: _bpyramid_stream(3, COMBINED_SPS,
                                                   COMBINED_DEC),
    "dmvr_bdof_seed4": lambda: _bpyramid_stream(4, SEEDS_SPS, SEEDS_DEC),
    "dmvr_bdof_seed5": lambda: _bpyramid_stream(5, SEEDS_SPS, SEEDS_DEC),
    "stays_on_device": lambda: _bpyramid_stream(
        6, dict(dmvr_enabled=True, bdof_enabled=True),
        dict(split_prob=0.35, inter_prob=0.9, skip_prob=0.2, mv_range=40,
             bi_prob=0.9)),
    "dmvr_falls_back_bit_exact": _dmvr_fallback_stream,
}


class _Tap:
    """Records cs.mi_mv per POC as the decoder leaves it (ColMotion is
    built after the refined-MV fixups), and, for the port, as it was
    before them (at the filter chain, which derives the deblocking
    strengths from the merge MVs) and the DMVR subblocks and BDOF
    regions its refinement stages ran."""

    def __init__(self, monkeypatch, pkg):
        import importlib
        inter_np = importlib.import_module(f"{pkg}.frame.inter_np")
        self.after: dict = {}
        self.before: dict = {}
        self.refined = {"DMVR": 0, "BDOF": 0}
        col = inter_np.ColMotion

        def tap(cs, poc):
            self.after[poc] = cs.mi_mv.copy()
            return col(cs, poc)

        monkeypatch.setattr(inter_np, "ColMotion", tap)
        if pkg == "vvdec_tpu_torch":
            import vvdec_tpu_torch.ops.frame_device as fd
            chain = fd.filter_frame_device

            def filt(cs, planes):
                self.before[cs.sh.poc] = cs.mi_mv.copy()
                return chain(cs, planes)

            monkeypatch.setattr(fd, "filter_frame_device", filt)
            for fam in ("DMVR", "BDOF"):
                fn = f"run_{fam.lower()}_groups"

                def count(cs, plans, *a, _real=getattr(fd, fn), _fam=fam):
                    self.refined[_fam] += sum(p.n for p in plans)
                    return _real(cs, plans, *a)

                monkeypatch.setattr(fd, fn, count)


def decode_streams(names) -> dict:
    """name -> (JAX device frames, host golden frames, JAX motion field,
    port frames, port census, port motion field before and after the
    fixups, the port's DMVR subblocks and BDOF regions)."""
    from vvdec_tpu.decoder import decode_annexb as ref
    from vvdec_tpu_torch.decoder import StreamDecoder
    out = {}
    for name in names:
        s = STREAMS[name]()
        with pytest.MonkeyPatch.context() as m:
            tap_ref = _Tap(m, "vvdec_tpu")
            jax_frames = ref(s, use_jax=True)
        golden = ref(s)
        with pytest.MonkeyPatch.context() as m:
            tap = _Tap(m, "vvdec_tpu_torch")
            dec = StreamDecoder(device="cpu")
            pics = dec.push(s) + dec.flush()
        out[name] = (jax_frames, golden, tap_ref.after,
                     [p.planes for p in pics], dict(dec.fallback_census),
                     tap.before, tap.after, tap.refined)
    return out


def _assert_equal(want, got):
    assert len(want) == len(got)
    for fw, fg in zip(want, got):
        assert len(fw) == len(fg)
        for pw, pg in zip(fw, fg):
            np.testing.assert_array_equal(np.asarray(pw), np.asarray(pg))


def check_frames(entry, stages) -> None:
    """The port's frames equal the JAX device pipeline's and the host
    golden's, with an empty fallback census; the refinement stages in
    `stages` ran, the others did not."""
    jax_frames, golden, _, port, census, _, _, refined = entry
    _assert_equal(jax_frames, port)
    _assert_equal(golden, port)
    assert census == {}
    assert {k for k, n in refined.items() if n} == set(stages), refined


def check_motion(entry, refined: bool) -> None:
    """The motion field after the fixups equals the JAX decode's in every
    picture; with `refined`, DMVR moved at least one MV away from its
    merge MV (else none moved)."""
    _, _, ref_after, _, _, before, after, _ = entry
    assert sorted(after) == sorted(ref_after)
    for poc in after:
        np.testing.assert_array_equal(after[poc], ref_after[poc])
    moved = sum(int((before[p] != after[p]).any(-1).any(-1).sum())
                for p in after)
    assert (moved > 0) if refined else (moved == 0)


# stream -> the refinement stages it runs
NAMES = {"dmvr": ("DMVR",), "dmvr_bdof_combined": ("DMVR", "BDOF")}


@pytest.fixture(scope="module")
def decoded():
    """Each decode of this file's streams runs once."""
    return decode_streams(NAMES)


@pytest.mark.parametrize("name", list(NAMES))
def test_matches_jax_device_pipeline_and_host_golden(decoded, name):
    check_frames(decoded[name], NAMES[name])


@pytest.mark.parametrize("name", list(NAMES))
def test_refined_motion_field_matches_jax(decoded, name):
    check_motion(decoded[name], refined=True)
