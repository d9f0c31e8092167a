"""The streams chip_smoke.py decodes, and their pinned outputs.

Each builder makes its stream with the port's own test encoder, with the
parameters of a configuration of the repository's bench.py (or, for
LMCS, of tests/test_lmcs.py), so a decode on the card can be held to the
reference without importing it.  Each *_MD5 is the MD5 of the stream's
decoded YUV (vvdecapp format) from vvdec_tpu's host golden decoder
(for inter-LDB tools, with its native inter path off: that path
inherits a wrong BCW index in affine merge, see ROADMAP.md queue 3);
tests/test_torch_decode.py and tests/test_torch_streams.py check the
bytes and the pins against the JAX package.

- headline: bench.py "all-intra 832x480": 8 all-intra Main10 frames,
  CTU 64, QP 32, deblocking on, no SAO or ALF.
- tool-rich: bench.py "tool-rich intra (MIP/CCLM/LFNST/MTS) 832x480":
  the intra tools real encoders turn on, QP 30; its first 4 of 8
  frames, which are the first 4 pictures of "tool-rich 8" byte for
  byte.
- SAO/ALF: bench.py "all-intra+SAO/ALF 832x480": the headline's
  decisions with SAO, ALF (two APSs, luma and chroma) and CC-ALF on;
  its first 4 of 8 frames, likewise the start of "SAO/ALF 8".
- LMCS: the intra LMCS stream of tests/test_lmcs.py at 832x480, CTU 64,
  with chroma residual scaling, 2 frames.
- inter-LD: bench.py "inter-LD 832x480": an IDR and 11 low-delay P
  pictures (references: the previous two), CTU 64, QP 32.
- inter-LDB tools: 832x480, CTU 64, an IDR and 5 low-delay B pictures
  whose two lists both hold the previous picture (VTM's low-delay
  shape), with the SPS flags and decisions of
  tests/test_oracle.py::TestNativeMotionParity::test_full_toolset_ab
  (seed 0) and PROF: affine, SbTMVP / TMVP, MMVD, GPM, CIIP, BCW, AMVR.
  DMVR, BDOF and SMVD cannot fire with both lists on one past picture.
- RA: 832x480, CTU 64, a hierarchical-B random-access GOP of 5 pictures
  (I0, P4, B2, B1, B3 in coding order; tests/test_dmvr_bdof.py's
  _bpyramid_stream) with the union of the SPS flags of its
  test_dmvr_bdof_combined and test_dmvr_bdof_affine_sbtmvp: DMVR, BDOF,
  TMVP, MMVD, AMVR, BCW, 6-parameter affine with PROF, SbTMVP; seed 3,
  QP 32.  The shape of VTM's random-access configuration, which turns
  DMVR and BDOF on; every picture decodes on the device.
- inter-LMCS: tests/test_frame_device.py's inter LMCS stream at 832x480,
  CTU 64 (_lmcs_stream(35, 3, 0, ...)): an IDR and two B pictures with
  LMCS and chroma residual scaling.  The device pipeline rejects inter
  LMCS, so the B pictures take the host reconstruction and the device
  filter chain (LMCS_INTER_CENSUS); they read the IDR back from the
  device and enter the device DPB.

Phase 13 decodes the rest of bench.py's configurations
(BENCH_STREAMS, their sizes by picture_size; PREFIXES names the 4-frame
streams that start them; tests/test_torch_bench_configs*.py check their
bytes and pins):
- tool-rich 8, SAO/ALF 8: all eight frames of the two above.
- dense q27: bench.py "all-intra dense q27 832x480": the headline's
  splits at QP 27 with residual density 0.5, 8 frames.
- max-density q22: bench.py "max-density q22 832x480 (conformance-load
  analog)": QP 22, density 0.85, levels up to 120, 6 frames; the
  heaviest residual load the test encoder makes.
- SAO/ALF 1080p: bench.py "all-intra+SAO/ALF 1920x1080", 4 frames; 1080
  rows are 16 CTU rows and a bottom row of 56.
- inter-LD 1080p: bench.py "inter-LD 1920x1080": an IDR and 5 low-delay
  P pictures with bench.py's motion vector differences of up to +-32
  (mv_range), so that references are read past the picture's edges.

- vb (phase 12): tests/test_virtual_boundaries.py's _vb_stream at
  832x480 (its CTU 32 and QP 30): intra, SAO, ALF (two APSs) and
  CC-ALF, one vertical and one horizontal virtual boundary (x = 416,
  y = 256), 2 pictures.  The device filter chain rejects virtual
  boundaries.
- tiles-ALF (phase 12): tests/test_alf.py's
  TestAlfAcrossBoundaries._stream at 832x480, CTU 64: a 2x2 tile grid
  (7 + 6 CTU columns, 4 + 4 CTU rows), one rectangular slice per tile,
  loop filtering across tiles and slices off, ALF and CC-ALF, 2 intra
  pictures.  The device filter chain rejects it (the ALF clamp windows
  and the per-slice deblocking offsets).

The concealment cases (CONCEAL_CASES) are the inter-LD stream with one
fault each, for err_policy="conceal": "conceal-lost" drops the NAL of
the P picture POC 5, so POC 6 substitutes the closest decoded picture
for it; "conceal-broken" overwrites the last 8 bytes of POC 6's slice,
which the parse rejects, so POC 6 is grey-filled and kept as a
reference; "cut-<POC>" ends the stream in the middle of that picture's
slice, which is then grey.  Their pins are vvdec_tpu's host golden
decoder's with err_policy="conceal" (tests/test_torch_conceal_streams.py).
"""

from __future__ import annotations

HEADLINE_STREAM_KW = dict(width=832, height=480, ctu=64, n_frames=8, seed=1,
                          qp=32, dec_kw=dict(split_prob=0.35, density=0.1))
HEADLINE_MD5 = "064b05031ed6a06c4614f68d2b9aca96"

TOOL_RICH_STREAM_KW = dict(
    width=832, height=480, ctu=64, n_frames=4, seed=3, qp=30,
    sps_kw=dict(mip_enabled=True, cclm_enabled=True, lfnst_enabled=True,
                mts_enabled=True, explicit_mts_intra=True),
    dec_kw=dict(split_prob=0.35, density=0.3, mip_prob=0.25))
TOOL_RICH_MD5 = "bd363866f3c753c0ad020d2a7a5deb33"

SAO_ALF_STREAM_KW = dict(w=832, h=480, n=4, seed=1)
SAO_ALF_MD5 = "f70a3843453637ace35361b992e5e461"

# the rest of bench.py's configurations (bench.py:211-252): all eight
# frames of tool-rich and SAO/ALF, dense q27, max-density q22, and the
# two 1920x1080 streams; pins as above
TOOL_RICH_8_STREAM_KW = dict(TOOL_RICH_STREAM_KW, n_frames=8)
TOOL_RICH_8_MD5 = "648bf11d9b6e818b7afd4af000c75d38"
SAO_ALF_8_STREAM_KW = dict(SAO_ALF_STREAM_KW, n=8)
SAO_ALF_8_MD5 = "750868ab632906394322184cf4f7cf15"
DENSE_Q27_STREAM_KW = dict(width=832, height=480, ctu=64, n_frames=8, seed=3,
                           qp=27, dec_kw=dict(split_prob=0.35, density=0.5))
DENSE_Q27_MD5 = "cd84945dcec4a25f3f3110f2bd5e8358"
MAX_DENSITY_Q22_STREAM_KW = dict(
    width=832, height=480, ctu=64, n_frames=6, seed=7, qp=22,
    dec_kw=dict(split_prob=0.4, density=0.85, max_level=120))
MAX_DENSITY_Q22_MD5 = "135933e18788d7ea42a1f6ebe91c3eec"
SAO_ALF_1080P_STREAM_KW = dict(w=1920, h=1080, n=4, seed=1)
SAO_ALF_1080P_MD5 = "7e549eeea1c7d7b1e72e34bb6c0fad2e"

LMCS_STREAM_KW = dict(seed=31, n_frames=2,
                      dec_kw=dict(split_prob=0.35, density=0.3),
                      chroma_scale=True, ctu=64, wh=(832, 480))
LMCS_MD5 = "99ca41844f24a15cb38d29a3eb259a07"

INTER_LD_STREAM_KW = dict(w=832, h=480, n=12, seed=5,
                          dec_kw=dict(split_prob=0.35, inter_prob=0.85,
                                      skip_prob=0.3, mv_range=32))
INTER_LD_MD5 = "ef6588cfd3e09b6827d76475ed85bea4"
INTER_LD_1080P_STREAM_KW = dict(INTER_LD_STREAM_KW, w=1920, h=1080, n=6)
INTER_LD_1080P_MD5 = "8bb5a027f37ffc44543de62802281bf5"

INTER_LDB_STREAM_KW = dict(
    w=832, h=480, n=6, seed=0,
    sps_kw=dict(affine_enabled=True, affine_6param=True,
                temporal_mvp_enabled=True, sbtmvp_enabled=True,
                mmvd_enabled=True, smvd_enabled=True, gpm_enabled=True,
                ciip_enabled=True, bcw_enabled=True, amvr_enabled=True,
                dmvr_enabled=True, bdof_enabled=True, prof_enabled=True),
    dec_kw=dict(split_prob=0.5, inter_prob=0.8, skip_prob=0.15, mv_range=48,
                bi_prob=0.6, affine_prob=0.25, affine_merge_prob=0.3,
                geo_prob=0.2, mmvd_prob=0.2, ciip_prob=0.15, smvd_prob=0.2,
                bcw_prob=0.3, amvr_prob=0.3))
INTER_LDB_MD5 = "52f3504d2a4d4fbba74abb1d207e7c45"

RA_STREAM_KW = dict(
    w=832, h=480, seed=3,
    sps_kw=dict(dmvr_enabled=True, bdof_enabled=True,
                temporal_mvp_enabled=True, mmvd_enabled=True,
                amvr_enabled=True, bcw_enabled=True, affine_enabled=True,
                affine_6param=True, prof_enabled=True, sbtmvp_enabled=True),
    dec_kw=dict(split_prob=0.4, inter_prob=0.8, skip_prob=0.25, mv_range=40,
                bi_prob=0.7, mmvd_prob=0.2, amvr_prob=0.3, bcw_prob=0.3,
                affine_prob=0.3, affine_merge_prob=0.3))
RA_FRAMES = 5
RA_MD5 = "d9e3a0d8985cbe5eb23a2e96a91b7ee2"

LMCS_INTER_STREAM_KW = dict(seed=35, n_frames=3,
                            dec_kw=dict(split_prob=0.5, density=0.3,
                                        inter_prob=0.8),
                            chroma_scale=True, ctu=64, wh=(832, 480),
                            slice_type=0)
LMCS_INTER_MD5 = "a41c28eea9099960a03bcf1f8c2b4761"
# StreamDecoder.fallback_census after a decode: the IDR on the device,
# both B pictures reconstructed on the host (Python TUs: LMCS keeps the
# C paths off) and filtered on the device
LMCS_INTER_CENSUS = {"device_recon:lmcs_inter": 2, "inter_c:lmcs": 2,
                     "intra_c:lmcs": 2, "tu_python": 1938, "tu_native": 0}


# the headline stream's first frame alone (its 1-frame stream)
HEADLINE_FIRST_MD5 = "836c38dbff68403b7f4001a24b57a573"

VB_STREAM_KW = dict(seed=3, n_frames=2, wh=(832, 480), vbx=(416,),
                    vby=(256,))
TILES_ALF_STREAM_KW = dict(seed=1, n_frames=2, wh=(832, 480), ctu=64,
                           pps_kw=dict(
                               no_pic_partition=False, num_exp_tile_cols=2,
                               num_exp_tile_rows=2, tile_col_widths=[7, 6],
                               tile_row_heights=[4, 4], rect_slice=True,
                               single_slice_per_subpic=False,
                               num_slices_in_pic=4,
                               slice_top_left_tile_idx=[0, 1, 2, 3],
                               slice_width_in_tiles=[1, 1, 1, 1],
                               slice_height_in_tiles=[1, 1, 1, 1],
                               loop_filter_across_tiles=False,
                               loop_filter_across_slices=False))

# name -> (fault, POC of the faulty picture, pictures output, the POCs
# output with DecodedPicture.error set, StreamDecoder.error_pictures,
# grey-filled pictures, MD5 of the YUV)
CONCEAL_CASES = {
    "conceal-lost": ("lost", 5, 11, (6,), 1, 0,
                     "887ee90baabaa2ec53e70c6b564dc0f2"),
    "conceal-broken": ("broken", 6, 12, (6,), 1, 1,
                       "60275778017e83afa0e21648d0106e68"),
    "cut-3": ("cut", 3, 4, (3,), 1, 1, "fc09d6822290bc5d6aff627799f15e6c"),
    "cut-6": ("cut", 6, 7, (6,), 1, 1, "cb39571919da059d06045ab9ee7df67f"),
    "cut-9": ("cut", 9, 10, (9,), 1, 1, "22a9bf87e69daeddbe39399e3d2a0adb"),
    "cut-11": ("cut", 11, 12, (11,), 1, 1,
               "813b3d5255d745e60326e5999645bb12"),
}


def conceal_variant(stream: bytes, fault: str, poc: int) -> bytes:
    """`stream` (one single-slice picture per VCL NAL, in POC order, as
    inter_ld_stream makes it) with one fault at picture `poc`: "lost"
    drops its NAL, "broken" sets its last 8 bytes to 0xff, "cut" ends
    the stream in the middle of it."""
    from vvdec_tpu_torch.bitstream.nal import is_vcl, split_annexb
    vcl = [(off, off + size) for off, size in split_annexb(stream)
           if is_vcl(stream[off + 1] >> 3)]
    # a NAL runs from its start code (3 or 4 bytes) to the next one
    a = vcl[poc][0] - (4 if stream[vcl[poc][0] - 4:vcl[poc][0]]
                       == b"\x00\x00\x00\x01" else 3)
    b = vcl[poc][1]
    if fault == "lost":
        return stream[:a] + stream[b:]
    if fault == "broken":
        return stream[:b - 8] + b"\xff" * 8 + stream[b:]
    if fault == "cut":
        return stream[:(a + b) // 2]
    raise ValueError(f"unknown fault {fault!r}")


def headline_stream() -> bytes:
    """The headline Annex-B stream, made by the port's own test encoder."""
    return intra_stream(**HEADLINE_STREAM_KW)


def tool_rich_stream() -> bytes:
    """The tool-rich intra stream (MIP, CCLM, LFNST, explicit MTS)."""
    return intra_stream(**TOOL_RICH_STREAM_KW)


def intra_stream(**kw) -> bytes:
    """generate_stream(**kw) of the port's own test encoder: all-intra
    pictures, deblocking on, no SAO or ALF."""
    from vvdec_tpu_torch.testenc.encoder import generate_stream

    s, _ = generate_stream(**kw)
    return s


def _headers(sps, pps) -> bytes:
    from vvdec_tpu_torch.bitstream.nal import NalUnitType
    from vvdec_tpu_torch.testenc.bitwriter import BitWriter
    from vvdec_tpu_torch.testenc.hls_writer import (make_nal, write_pps,
                                                    write_sps)
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    return st + make_nal(NalUnitType.PPS, bw.bytes())


def sao_alf_stream(w: int, h: int, n: int, seed: int) -> bytes:
    """bench.py's _intra_stream(w, h, n, seed, filters=True): all-intra
    with SAO, ALF (two APSs with CC-ALF filters) and CC-ALF on."""
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions, make_alf_aps
    sps = E.make_sps(w, h, ctu=64, sao_enabled=True, alf_enabled=True,
                     ccalf_enabled=True)
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    apss = {}
    for i in range(2):
        aps, nal = make_alf_aps(seed * 10 + i, aps_id=i, cc=True)
        apss[i] = aps
        st += nal
    sh_kw = dict(sao_enabled_luma=True, sao_enabled_chroma=True,
                 alf_enabled=[True, True, True],
                 num_alf_aps_ids_luma=2, alf_aps_ids_luma=[0, 1],
                 alf_aps_id_chroma=0,
                 ccalf_cb_enabled=apss[0].cc_alf.new_filter[0],
                 ccalf_cb_aps_id=0,
                 ccalf_cr_enabled=apss[1].cc_alf.new_filter[1],
                 ccalf_cr_aps_id=1)
    for f in range(n):
        dec = RandomDecisions(seed=seed * 100 + f, split_prob=0.35,
                              density=0.1, sao_prob=0.5)
        nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=True,
                                sh_kw=sh_kw, alf_apss=apss)
        st += nal
    return st


def lmcs_stream(seed: int, n_frames: int, dec_kw: dict, chroma_scale: bool,
                ctu: int, wh: tuple, slice_type: int = 2) -> bytes:
    """tests/test_lmcs.py's _lmcs_stream with no extra SPS flags, LMCS on
    in every picture: with slice_type 2 every frame is an IDR; otherwise
    an IDR, then pictures of that slice type that reference the previous
    one or two (both lists for B)."""
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions, make_lmcs_aps
    sps = E.make_sps(wh[0], wh[1], ctu=ctu, lmcs_enabled=True)
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    _, aps_nal = make_lmcs_aps(seed)
    st += aps_nal
    ph_kw = dict(lmcs_enabled=True, lmcs_aps_id=0,
                 chroma_residual_scale=chroma_scale)
    for f in range(n_frames):
        dec = RandomDecisions(seed=seed * 100 + f, **dec_kw)
        if f == 0 or slice_type == 2:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=True,
                                    ph_kw=ph_kw)
        else:
            d = tuple(range(1, min(f, 2) + 1))
            nal, _ = E.encode_frame(
                sps, pps, dec, qp=32, poc=f, idr=False,
                slice_type=slice_type, ph_kw=ph_kw,
                ref_deltas=(d, d if slice_type == 0 else ()))
        st += nal
    return st


def inter_ld_stream(w: int, h: int, n: int, seed: int, dec_kw: dict
                    ) -> bytes:
    """bench.py's _ld_stream: an IDR, then low-delay P pictures that
    reference the previous two (one for the first)."""
    from vvdec_tpu_torch.hls.params import P_SLICE
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions
    sps = E.make_sps(w, h, ctu=64, num_reorder_pics=[0])
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    for f in range(n):
        dec = RandomDecisions(seed=seed * 100 + f, **dec_kw)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(
                sps, pps, dec, qp=32, poc=f, idr=False, slice_type=P_SLICE,
                ref_deltas=((1, 2) if f >= 2 else (1,), ()))
        st += nal
    return st


def inter_ldb_stream(w: int, h: int, n: int, seed: int, sps_kw: dict,
                     dec_kw: dict) -> bytes:
    """An IDR, then low-delay B pictures with both lists on the previous
    picture, CTU 64, QP 32."""
    from vvdec_tpu_torch.hls.params import B_SLICE
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions
    sps = E.make_sps(w, h, ctu=64, **sps_kw)
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    for f in range(n):
        dec = RandomDecisions(seed=seed * 100 + f, **dec_kw)
        if f == 0:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=0, idr=True)
        else:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=f, idr=False,
                                    slice_type=B_SLICE,
                                    ref_deltas=((1,), (1,)))
        st += nal
    return st


def ra_stream(w: int, h: int, seed: int, sps_kw: dict, dec_kw: dict
              ) -> bytes:
    """A hierarchical-B random-access GOP (tests/test_dmvr_bdof.py's
    _bpyramid_stream): I0, P4 (ref 0), then B2 (0, 4), B1 (0, 2) and
    B3 (2, 4), coded in that order; each B picture has one past and one
    future reference at equal distances, so DMVR and BDOF fire.  CTU 64,
    QP 32, two pictures of reorder delay."""
    from vvdec_tpu_torch.hls.params import B_SLICE, P_SLICE
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions
    sps = E.make_sps(w, h, ctu=64, num_reorder_pics=[2], **sps_kw)
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    # extra RPL entries beyond the active count keep DPB pictures alive
    coding = [
        (0, True, None, ((), ()), None),
        (4, False, P_SLICE, ((4,), ()), None),
        (2, False, B_SLICE, ((2,), (-2,)), [1, 1]),
        (1, False, B_SLICE, ((1, -3), (-1,)), [1, 1]),
        (3, False, B_SLICE, ((1, 3), (-1,)), [1, 1]),
    ]
    for i, (poc, idr, slice_type, deltas, active) in enumerate(coding):
        dec = RandomDecisions(seed=seed * 100 + i, **dec_kw)
        if idr:
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=poc, idr=True)
        else:
            sh_kw = dict(num_ref_idx_active=active) if active else None
            nal, _ = E.encode_frame(sps, pps, dec, qp=32, poc=poc, idr=False,
                                    slice_type=slice_type,
                                    ref_deltas=deltas, sh_kw=sh_kw)
        st += nal
    return st



def vb_stream(seed: int, n_frames: int = 2, wh: tuple = (96, 64),
              vbx: tuple = (48,), vby: tuple = (32,)) -> bytes:
    """tests/test_virtual_boundaries.py's _vb_stream(seed, n_frames,
    alf=True, wh=wh, vbx=vbx, vby=vby): intra pictures with virtual
    boundaries at the positions vbx / vby, SAO, ALF (two APSs) and
    CC-ALF."""
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import RandomDecisions, make_alf_aps
    sps = E.make_sps(wh[0], wh[1], sao_enabled=True, alf_enabled=True,
                     ccalf_enabled=True,
                     virtual_boundaries_enabled=True,
                     virtual_boundaries_present=True,
                     virtual_boundary_pos_x=list(vbx),
                     virtual_boundary_pos_y=list(vby))
    pps = E.make_pps(sps)
    st = _headers(sps, pps)
    apss = {}
    for i in range(2):
        aps, nal = make_alf_aps(seed * 10 + i, aps_id=i, cc=True)
        apss[i] = aps
        st += nal
    sh_kw = dict(sao_enabled_luma=True, sao_enabled_chroma=True,
                 alf_enabled=[True, True, True], num_alf_aps_ids_luma=2,
                 alf_aps_ids_luma=[0, 1], alf_aps_id_chroma=0)
    if apss[0].cc_alf.new_filter[0]:
        sh_kw.update(ccalf_cb_enabled=True, ccalf_cb_aps_id=0)
    for f in range(n_frames):
        dec = RandomDecisions(seed=seed * 100 + f, split_prob=0.4,
                              density=0.15, inter_prob=0.0, mv_range=32)
        nal, _ = E.encode_frame(sps, pps, dec, qp=30, poc=f, idr=True,
                                sh_kw=sh_kw, alf_apss=apss)
        st += nal
    return st


def tiles_alf_stream(seed: int, pps_kw: dict, n_frames: int = 2,
                     wh: tuple = (96, 64), ctu: int = 32) -> bytes:
    """tests/test_alf.py's TestAlfAcrossBoundaries._stream with several
    slices: intra pictures with ALF (two APSs) and CC-ALF under the PPS
    partitioning `pps_kw` (num_slices_in_pic > 1 rectangular slices),
    each slice with decisions of its own."""
    from vvdec_tpu_torch.testenc import encoder as E
    from vvdec_tpu_torch.testenc.encoder import (RandomDecisions,
                                                 encode_picture, make_alf_aps)
    sps = E.make_sps(wh[0], wh[1], ctu=ctu, alf_enabled=True,
                     ccalf_enabled=True, entry_point_offsets_present=True)
    sps.ptl.level_idc = 83
    pps = E.make_pps(sps, **pps_kw)
    st = _headers(sps, pps)
    apss = {}
    for i in range(2):
        aps, nal = make_alf_aps(seed * 10 + i, aps_id=i, cc=True)
        apss[i] = aps
        st += nal
    sh_kw = dict(alf_enabled=[True, True, True], num_alf_aps_ids_luma=2,
                 alf_aps_ids_luma=[0, 1], alf_aps_id_chroma=0)
    if apss[0].cc_alf.new_filter[0]:
        sh_kw.update(ccalf_cb_enabled=True, ccalf_cb_aps_id=0)
    if apss[1].cc_alf.new_filter[1]:
        sh_kw.update(ccalf_cr_enabled=True, ccalf_cr_aps_id=1)
    for f in range(n_frames):
        slices = [dict(decisions=RandomDecisions(
                           seed=seed * 100 + f * 10 + i, split_prob=0.4),
                       slice_type=2, sh_kw=dict(sh_kw))
                  for i in range(pps_kw["num_slices_in_pic"])]
        nal, _ = encode_picture(sps, pps, poc=f, idr=True, slices=slices,
                                alf_apss=apss)
        st += nal
    return st

# name -> (builder, frames, pinned MD5), in chip_smoke.py's order
STREAMS = {
    "headline": (headline_stream, HEADLINE_STREAM_KW["n_frames"],
                 HEADLINE_MD5),
    "tool-rich": (tool_rich_stream, TOOL_RICH_STREAM_KW["n_frames"],
                  TOOL_RICH_MD5),
    "SAO/ALF": (lambda: sao_alf_stream(**SAO_ALF_STREAM_KW),
                SAO_ALF_STREAM_KW["n"], SAO_ALF_MD5),
    "LMCS": (lambda: lmcs_stream(**LMCS_STREAM_KW),
             LMCS_STREAM_KW["n_frames"], LMCS_MD5),
    "inter-LD": (lambda: inter_ld_stream(**INTER_LD_STREAM_KW),
                 INTER_LD_STREAM_KW["n"], INTER_LD_MD5),
    "inter-LDB tools": (lambda: inter_ldb_stream(**INTER_LDB_STREAM_KW),
                        INTER_LDB_STREAM_KW["n"], INTER_LDB_MD5),
    "RA": (lambda: ra_stream(**RA_STREAM_KW), RA_FRAMES, RA_MD5),
    "inter-LMCS": (lambda: lmcs_stream(**LMCS_INTER_STREAM_KW),
                   LMCS_INTER_STREAM_KW["n_frames"], LMCS_INTER_MD5),
    # phase 13: the rest of bench.py's configurations
    "dense q27": (lambda: intra_stream(**DENSE_Q27_STREAM_KW),
                  DENSE_Q27_STREAM_KW["n_frames"], DENSE_Q27_MD5),
    "max-density q22": (lambda: intra_stream(**MAX_DENSITY_Q22_STREAM_KW),
                        MAX_DENSITY_Q22_STREAM_KW["n_frames"],
                        MAX_DENSITY_Q22_MD5),
    "tool-rich 8": (lambda: intra_stream(**TOOL_RICH_8_STREAM_KW),
                    TOOL_RICH_8_STREAM_KW["n_frames"], TOOL_RICH_8_MD5),
    "SAO/ALF 8": (lambda: sao_alf_stream(**SAO_ALF_8_STREAM_KW),
                  SAO_ALF_8_STREAM_KW["n"], SAO_ALF_8_MD5),
    "SAO/ALF 1080p": (lambda: sao_alf_stream(**SAO_ALF_1080P_STREAM_KW),
                      SAO_ALF_1080P_STREAM_KW["n"], SAO_ALF_1080P_MD5),
    "inter-LD 1080p": (lambda: inter_ld_stream(**INTER_LD_1080P_STREAM_KW),
                       INTER_LD_1080P_STREAM_KW["n"], INTER_LD_1080P_MD5),
}
# the streams of phase 13, in its order, and their builders' keywords
BENCH_STREAMS = {"dense q27": DENSE_Q27_STREAM_KW,
                 "max-density q22": MAX_DENSITY_Q22_STREAM_KW,
                 "tool-rich 8": TOOL_RICH_8_STREAM_KW,
                 "SAO/ALF 8": SAO_ALF_8_STREAM_KW,
                 "SAO/ALF 1080p": SAO_ALF_1080P_STREAM_KW,
                 "inter-LD 1080p": INTER_LD_1080P_STREAM_KW}
# the 4-frame streams that are, byte for byte, the first pictures of an
# 8-frame one of BENCH_STREAMS, and so carry that decode's prefix pin
PREFIXES = {"tool-rich": "tool-rich 8", "SAO/ALF": "SAO/ALF 8"}


def picture_size(kw: dict) -> tuple[int, int]:
    """(width, height) of the pictures a builder makes from `kw`, whichever
    of the builders' spellings (width/height, w/h, wh) it uses."""
    if "wh" in kw:
        return tuple(kw["wh"])
    if "width" in kw:
        return kw["width"], kw["height"]
    return kw["w"], kw["h"]
