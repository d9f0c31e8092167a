"""Inter pictures through the port's entry point, on the CPU.

Tolerance: bit-equal.  vvdec_tpu_torch.decoder.decode_annexb(s,
device="cpu") is held to the JAX package's host golden decode on the
streams of tests/test_frame_device.py::TestFrameDeviceInter (all but the
DMVR one, which tests/test_torch_ra_stream.py decodes) and on a
low-delay B stream with GPM, SbTMVP, affine + PROF, CIIP and BCW, and to
the JAX device pipeline (`use_jax=True`) on one stream.
"""

import numpy as np
import pytest

import tests.test_frame_device as tfd

IKW = tfd.TestFrameDeviceInter.IKW


def _wp_sh_kw(f):
    from vvdec_tpu.testenc.encoder import make_weight_table
    return None if f == 0 else dict(weight_table=make_weight_table(33 + f,
                                                                   2, 0))


# TestFrameDeviceInter's streams (tests/test_frame_device.py:188-261)
TOOL_STREAMS = {
    "ld_basic": lambda: tfd._ld_stream(6, 31, IKW),
    "bi_bcw": lambda: tfd._ld_stream(
        5, 32, dict(IKW, bi_prob=0.5, bcw_prob=0.5),
        sps_kw=dict(bcw_enabled=True)),
    "mmvd_smvd_amvr": lambda: tfd._ld_stream(
        5, 33, dict(IKW, mmvd_prob=0.3, amvr_prob=0.4),
        sps_kw=dict(mmvd_enabled=True, amvr_enabled=True)),
    "weighted_pred": lambda: tfd._ld_stream(
        4, 34, IKW, sps_kw=dict(weighted_pred=True),
        pps_kw=dict(weighted_pred=True), sh_kw_fn=_wp_sh_kw),
    "sbt_residuals": lambda: tfd._ld_stream(
        4, 35, dict(IKW, sbt_prob=0.5), sps_kw=dict(sbt_enabled=True)),
    "affine_prof": lambda: tfd._ld_stream(
        5, 36, dict(IKW, affine_prob=0.5, affine_merge_prob=0.5,
                    bi_prob=0.3),
        sps_kw=dict(affine_enabled=True, prof_enabled=True)),
    "gpm_flag_misnamed": lambda: tfd._ld_stream(
        5, 37, dict(IKW, geo_prob=0.5, bi_prob=0.3),
        sps_kw=dict(geo_enabled=True)),
    "sbtmvp": lambda: tfd._ld_stream(
        5, 38, dict(IKW, affine_merge_prob=0.6, bi_prob=0.3),
        sps_kw=dict(affine_enabled=True, sbtmvp_enabled=True,
                    temporal_mvp_enabled=True)),
    "ciip": lambda: tfd._ld_stream(
        5, 39, dict(IKW, ciip_prob=0.5, bi_prob=0.3),
        sps_kw=dict(ciip_enabled=True)),
    "mixed": lambda: tfd._ld_stream(
        5, 40, dict(IKW, ciip_prob=0.2, geo_prob=0.2, affine_prob=0.3,
                    bi_prob=0.3, bcw_prob=0.3, mmvd_prob=0.2),
        sps_kw=dict(ciip_enabled=True, geo_enabled=True, affine_enabled=True,
                    prof_enabled=True, bcw_enabled=True, mmvd_enabled=True)),
}


def ldb_stream(n_frames: int = 4) -> bytes:
    """128x96 low-delay B (both lists on the previous picture) with GPM
    under its real SPS name (gpm_enabled, 4 candidates), SbTMVP / TMVP,
    affine + PROF, CIIP and BCW."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import B_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(tfd.WH[0], tfd.WH[1], ctu=32, gpm_enabled=True,
                     max_num_gpm_cand=4, bcw_enabled=True,
                     affine_enabled=True, prof_enabled=True,
                     ciip_enabled=True, sbtmvp_enabled=True,
                     temporal_mvp_enabled=True)
    pps = E.make_pps(sps)
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    st += make_nal(NalUnitType.PPS, bw.bytes())
    for f in range(n_frames):
        dec = RandomDecisions(seed=100 + f, split_prob=0.4, inter_prob=0.85,
                              skip_prob=0.2, mv_range=24, bi_prob=0.5,
                              bcw_prob=0.3, geo_prob=0.3, affine_prob=0.25,
                              affine_merge_prob=0.4, ciip_prob=0.3)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=False,
                                    slice_type=B_SLICE,
                                    ref_deltas=((1,), (1,)))
        st += nal
    return st


def _assert_equal(want, got):
    assert len(want) == len(got)
    for fw, fg in zip(want, got):
        assert len(fw) == len(fg)
        for pw, pg in zip(fw, fg):
            assert pg.dtype == np.asarray(pw).dtype
            np.testing.assert_array_equal(np.asarray(pw), pg)


@pytest.mark.parametrize("name", list(TOOL_STREAMS))
def test_inter_stream_matches_host_golden(name):
    from vvdec_tpu.decoder import decode_annexb as golden
    from vvdec_tpu_torch.decoder import decode_annexb
    s = TOOL_STREAMS[name]()
    _assert_equal(golden(s), decode_annexb(s, device="cpu"))


def test_ldb_stream_holds_the_tools_and_matches_host_golden(monkeypatch):
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu.decoder import decode_annexb as golden
    from vvdec_tpu_torch.decoder import decode_annexb
    tools = set()
    plan = fd.plan_frame_device

    def census(cs):
        out = plan(cs)
        for cu in cs.cus:
            if cu.pred_mode != 1:
                tools.update(t for t, on in (
                    ("geo", cu.geo_flag), ("sbtmvp", cu.merge_type == 1),
                    ("affine", cu.affine_flag and cu.merge_type != 1),
                    ("ciip", cu.ciip_flag), ("bi", cu.inter_dir == 3),
                    ("bcw", cu.bcw_idx != 0)) if on)
        return out

    monkeypatch.setattr(fd, "plan_frame_device", census)
    s = ldb_stream()
    _assert_equal(golden(s), decode_annexb(s, device="cpu"))
    assert {"geo", "sbtmvp", "affine", "ciip", "bi", "bcw"} <= tools, tools


def test_inter_stream_matches_jax_device_pipeline():
    from vvdec_tpu.decoder import decode_annexb as ref
    from vvdec_tpu_torch.decoder import decode_annexb
    s = tfd._ld_stream(3, 40, dict(IKW, ciip_prob=0.2, affine_prob=0.3,
                                   mmvd_prob=0.2),
                       sps_kw=dict(ciip_enabled=True, affine_enabled=True,
                                   prof_enabled=True, mmvd_enabled=True))
    _assert_equal(ref(s, use_jax=True), decode_annexb(s, device="cpu"))


def test_missing_reference_raises():
    """A picture whose reference is not in the DPB raises ValueError, as
    the reference's strict mode does: POC 2 references POC 1, which the
    stream lacks."""
    from vvdec_tpu.hls.params import P_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu_torch.decoder import decode_annexb
    full = tfd._ld_stream(1, 31, IKW)
    sps = E.make_sps(tfd.WH[0], tfd.WH[1], ctu=32, num_reorder_pics=[0])
    pps = E.make_pps(sps)
    nal, _ = E.encode_frame(sps, pps, RandomDecisions(seed=7, **IKW), qp=32,
                            poc=2, idr=False, slice_type=P_SLICE,
                            ref_deltas=((1,), ()))
    with pytest.raises(ValueError, match="missing reference POC 1"):
        decode_annexb(full + nal, device="cpu")


def test_native_inter_golden_fault_on_affine_bcw(monkeypatch):
    """Reference fault: the JAX package's host decode with its native
    inter path (walk9.c, the default) does not write the BCW index it
    derives for a merge CU back to the CU, and affine_np's constructed
    affine-merge candidates read the neighbour's bcw_idx from the CU
    (affine_np.py:531,539).  So on the first three pictures of the
    "inter-LDB tools" stream it inherits BCW 0 where the pure-Python host
    decode, the JAX device path and the VVC rule (the neighbour CU's
    BcwIdx) inherit the derived one.  The port follows the pure-Python
    host golden."""
    import vvdec_tpu_torch.streams as S
    from vvdec_tpu.decoder import decode_annexb as golden
    from vvdec_tpu_torch.decoder import decode_annexb
    s = S.inter_ldb_stream(**dict(S.INTER_LDB_STREAM_KW, n=3))
    native = golden(s)
    port = decode_annexb(s, device="cpu")
    monkeypatch.setenv("VVDEC_TPU_NO_NATIVE_INTER", "1")
    _assert_equal(golden(s), port)
    assert not np.array_equal(native[2][0], port[2][0])
    _assert_equal(native[:2], port[:2])
