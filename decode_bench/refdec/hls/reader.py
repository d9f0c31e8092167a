"""High-level syntax (HLS) parser: SPS / PPS / PicHeader / SliceHeader.

Implements the H.266 clause 7.3 syntax.  Behavioral parity target: vvdec
HLSyntaxReader (source/Lib/DecoderLib/HLSyntaxReader.cpp:205 parsePPS, :1421
parseSPS, :2694 parsePictureHeader, :3438 parseSliceHeader, :112 parseRefPicList,
:4273 parseProfileTierLevel, :4167 parseConstraintInfo, :1373 dpb_parameters).
"""

from __future__ import annotations

import math

from refdec.bitstream.reader import BitReader
from refdec.hls.params import (
    CHROMA_400,
    CHROMA_420,
    CHROMA_444,
    AFFINE_MRG_MAX_NUM_CANDS,
    IBC_MRG_MAX_NUM_CANDS,
    I_SLICE,
    MAX_NUM_REF_PICS,
    MRG_MAX_NUM_CANDS,
    ChromaQpTable,
    ConstraintInfo,
    DCI,
    VPS,
    PicHeader,
    PPS,
    ProfileTierLevel,
    RefPicEntry,
    RefPicList,
    SliceHeader,
    SPS,
    sub_wh,
)


class HlsError(ValueError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise HlsError(msg)


_GCI_FLAG_NAMES_1 = [  # after the 3 general flags + 2 codes
    "no_mixed_nalu_types_in_pic", "no_trail", "no_stsa", "no_rasl", "no_radl",
    "no_idr", "no_cra", "no_gdr", "no_aps", "no_idr_rpl",
    "one_tile_per_pic", "pic_header_in_slice_header", "one_slice_per_pic",
    "no_rectangular_slice", "one_slice_per_subpic", "no_subpic_info",
]
_GCI_FLAG_NAMES_2 = [
    "no_partition_constraints_override", "no_mtt", "no_qtbtt_dual_tree_intra",
    "no_palette", "no_ibc", "no_isp", "no_mrl", "no_mip", "no_cclm",
    "no_ref_pic_resampling", "no_res_change_in_clvs", "no_weighted_prediction",
    "no_ref_wraparound", "no_temporal_mvp", "no_sbtmvp", "no_amvr", "no_bdof",
    "no_smvd", "no_dmvr", "no_mmvd", "no_affine_motion", "no_prof", "no_bcw",
    "no_ciip", "no_gpm", "no_luma_transform_size_64", "no_transform_skip",
    "no_bdpcm", "no_mts", "no_lfnst", "no_joint_cbcr", "no_sbt", "no_act",
    "no_explicit_scaling_list", "no_dep_quant", "no_sign_data_hiding",
    "no_cu_qp_delta", "no_chroma_qp_offset", "no_sao", "no_alf", "no_ccalf",
    "no_lmcs", "no_ladf", "no_virtual_boundaries",
]


def parse_constraint_info(r: BitReader) -> ConstraintInfo:
    ci = ConstraintInfo()
    ci.gci_present_flag = r.flag()
    if ci.gci_present_flag:
        ci.flags["intra_only"] = r.flag()
        ci.flags["all_layers_independent"] = r.flag()
        ci.flags["one_au_only"] = r.flag()
        ci.flags["max_bitdepth_idc"] = r.u(4)
        ci.flags["max_chroma_format_idc"] = r.u(2)
        for name in _GCI_FLAG_NAMES_1:
            ci.flags[name] = r.flag()
        ci.flags["max_log2_ctu_size_idc"] = r.u(2)
        for name in _GCI_FLAG_NAMES_2:
            ci.flags[name] = r.flag()
        num_reserved = r.u(8)
        for _ in range(num_reserved):
            _check(r.u(1) == 0, "gci_reserved_zero_bit != 0")
    while not r.byte_aligned():
        _check(r.u(1) == 0, "gci_alignment_zero_bit != 0")
    return ci


def parse_profile_tier_level(r: BitReader, profile_tier_present: bool,
                             max_sublayers_minus1: int) -> ProfileTierLevel:
    ptl = ProfileTierLevel()
    if profile_tier_present:
        ptl.profile_idc = r.u(7)
        ptl.tier_flag = r.u(1)
    ptl.level_idc = r.u(8)
    ptl.frame_only_constraint_flag = r.flag()
    ptl.multilayer_enabled_flag = r.flag()
    _check(not ptl.multilayer_enabled_flag, "multilayer profiles not supported")
    if profile_tier_present:
        ptl.constraint_info = parse_constraint_info(r)
    ptl.sub_layer_level_present = [False] * max_sublayers_minus1
    for i in range(max_sublayers_minus1 - 1, -1, -1):
        ptl.sub_layer_level_present[i] = r.flag()
    while not r.byte_aligned():
        r.u(1)  # ptl_reserved_zero_bit
    ptl.sub_layer_level_idc = [0] * (max_sublayers_minus1 + 1)
    ptl.sub_layer_level_idc[max_sublayers_minus1] = ptl.level_idc
    for i in range(max_sublayers_minus1 - 1, -1, -1):
        if ptl.sub_layer_level_present[i]:
            ptl.sub_layer_level_idc[i] = r.u(8)
        else:
            ptl.sub_layer_level_idc[i] = ptl.sub_layer_level_idc[i + 1]
    if profile_tier_present:
        ptl.num_sub_profiles = r.u(8)
        ptl.sub_profile_idc = [r.u(32) for _ in range(ptl.num_sub_profiles)]
    return ptl


def parse_dci(rbsp: bytes) -> DCI:
    """Decoding capability information (parseDCI, HLSyntaxReader.cpp:2318)."""
    r = BitReader(rbsp, pos=16)
    r.u(4)  # dci_reserved_zero_4bits
    num_ptls = r.u(4) + 1
    dci = DCI()
    for _ in range(num_ptls):
        dci.ptls.append(parse_profile_tier_level(r, True, 0))
    if r.flag():  # dci_extension_flag
        while r.more_rbsp_data():
            r.u(1)
    _check(r.u(1) == 1, "rbsp_stop_one_bit missing after DCI")
    return dci


def parse_vps(rbsp: bytes) -> VPS:
    """Video parameter set head (H.266 7.3.2.3).  Parses the layer/OLS
    structure and PTL list; multilayer-only payload tails (DPB / OLS HRD
    tables) are not needed because dependent layers are rejected at slice
    activation, matching the reference's stance (DecLibParser.cpp:476
    "Decoding of dependent layers not implemented"; its parseVPS is
    compiled out entirely, HLSyntaxReader.cpp:2349)."""
    r = BitReader(rbsp, pos=16)
    vps = VPS()
    vps.vps_id = r.u(4)
    _check(vps.vps_id != 0, "vps_video_parameter_set_id 0 is reserved")
    vps.max_layers = r.u(6) + 1
    vps.max_sublayers = r.u(3) + 1
    _check(vps.max_sublayers <= 7, "vps_max_sublayers_minus1 out of range")
    if vps.max_layers > 1 and vps.max_sublayers > 1:
        all_same_sublayers = r.flag()  # vps_default_ptl_dpb_hrd_max_tid_flag
    else:
        all_same_sublayers = True
    vps.all_independent_layers = True
    if vps.max_layers > 1:
        vps.all_independent_layers = r.flag()
    vps.each_layer_is_an_ols = vps.max_layers == 1 \
        or vps.all_independent_layers
    vps.independent_layer = [True] * vps.max_layers
    vps.layer_id = [0] * vps.max_layers
    for i in range(vps.max_layers):
        vps.layer_id[i] = r.u(6)
        if i > 0 and not vps.all_independent_layers:
            vps.independent_layer[i] = r.flag()
            if not vps.independent_layer[i]:
                max_tid_ref_present = r.flag()
                n_direct = 0
                for _j in range(i):
                    if r.flag():  # vps_direct_ref_layer_flag[i][j]
                        n_direct += 1
                        if max_tid_ref_present:
                            r.u(3)  # vps_max_tid_il_ref_pics_plus1
                _check(n_direct > 0,
                       "dependent layer with no direct reference layer")
    num_ptls = 1
    if vps.max_layers > 1:
        if vps.all_independent_layers:
            vps.each_layer_is_an_ols = r.flag()
            if not vps.each_layer_is_an_ols:
                vps.ols_mode_idc = 2
        if not vps.each_layer_is_an_ols:
            if not vps.all_independent_layers:
                vps.ols_mode_idc = r.u(2)
                _check(vps.ols_mode_idc <= 2, "vps_ols_mode_idc > 2")
            if vps.ols_mode_idc == 2:
                n_ols = r.u(8) + 2
                for _i in range(1, n_ols):
                    for _j in range(vps.max_layers):
                        r.flag()  # vps_ols_output_layer_flag
        num_ptls = r.u(8) + 1
    pt_present = [True] + [False] * (num_ptls - 1)
    ptl_max_tid = [vps.max_sublayers - 1] * num_ptls
    for i in range(num_ptls):
        if i > 0:
            pt_present[i] = r.flag()
        if not all_same_sublayers:
            ptl_max_tid[i] = r.u(3)
    cnt = 0
    while not r.byte_aligned():
        _check(r.u(1) == 0, "vps_ptl_alignment_zero_bit != 0")
        cnt += 1
    _check(cnt < 8, "more than 8 VPS PTL alignment bits")
    for i in range(num_ptls):
        vps.ptls.append(
            parse_profile_tier_level(r, pt_present[i], ptl_max_tid[i]))
    return vps


def parse_ref_pic_list(r: BitReader, sps: SPS, rpl_idx: int) -> RefPicList:
    """ref_pic_list_struct(); rpl_idx == -1 when called from a PH/SH."""
    rpl = RefPicList()
    num_ref_entries = r.ue()
    _check(num_ref_entries <= MAX_NUM_REF_PICS, "num_ref_entries out of range")
    if sps.long_term_ref_pics and num_ref_entries > 0 and rpl_idx != -1:
        rpl.ltrp_in_header_flag = r.flag()
    elif sps.long_term_ref_pics:
        rpl.ltrp_in_header_flag = True
    rpl.inter_layer_present = sps.inter_layer_prediction

    prev_delta = 0
    for ii in range(num_ref_entries):
        if rpl.inter_layer_present and r.flag():  # inter_layer_ref_pic_flag
            ilrp_idx = r.ue()
            rpl.entries.append(RefPicEntry(is_long_term=True, is_inter_layer=True,
                                           value=ilrp_idx))
            continue
        is_long_term = False
        if sps.long_term_ref_pics:
            is_long_term = not r.flag()  # st_ref_pic_flag
        if not is_long_term:
            abs_delta = r.ue()
            delta = abs_delta
            if (not sps.weighted_pred and not sps.weighted_bipred) or ii == 0:
                delta += 1
            if delta > 0 and r.flag():  # strp_entry_sign_flag
                delta = -delta
            delta += prev_delta
            prev_delta = delta
            rpl.entries.append(RefPicEntry(value=delta))
        else:
            if not rpl.ltrp_in_header_flag:
                poc_lsb_lt = r.u(sps.log2_max_poc_lsb)
                rpl.entries.append(RefPicEntry(is_long_term=True, value=poc_lsb_lt))
            else:
                rpl.entries.append(RefPicEntry(is_long_term=True, value=0))
    return rpl


def _dpb_parameters(r: BitReader, sps: SPS, max_sublayers_minus1: int,
                    sublayer_info: bool) -> None:
    n = max_sublayers_minus1 + 1
    sps.max_dec_pic_buffering = [0] * n
    sps.num_reorder_pics = [0] * n
    sps.max_latency_increase_plus1 = [0] * n
    for i in range(0 if sublayer_info else max_sublayers_minus1, n):
        sps.max_dec_pic_buffering[i] = r.ue() + 1
        sps.num_reorder_pics[i] = r.ue()
        _check(sps.num_reorder_pics[i] <= sps.max_dec_pic_buffering[i] - 1,
               "dpb_max_num_reorder_pics out of range")
        sps.max_latency_increase_plus1[i] = r.ue()


def _read_general_timing_hrd(r) -> dict:
    """general_timing_hrd_parameters() (spec 7.3.5.1; reference
    HLSyntaxReader::parseGeneralHrdParameters)."""
    hrd = {
        "num_units_in_tick": r.u(32),
        "time_scale": r.u(32),
        "nal_hrd": r.flag(),
        "vcl_hrd": r.flag(),
    }
    _check(hrd["num_units_in_tick"] > 0, "num_units_in_tick must be > 0")
    _check(hrd["time_scale"] > 0, "time_scale must be > 0")
    hrd["du_hrd"] = False
    if hrd["nal_hrd"] or hrd["vcl_hrd"]:
        hrd["same_pic_timing_in_all_ols"] = r.flag()
        hrd["du_hrd"] = r.flag()
        if hrd["du_hrd"]:
            hrd["tick_divisor"] = r.u(8) + 2
        hrd["bit_rate_scale"] = r.u(4)
        hrd["cpb_size_scale"] = r.u(4)
        if hrd["du_hrd"]:
            hrd["cpb_size_du_scale"] = r.u(4)
        hrd["cpb_cnt"] = r.ue() + 1
        _check(hrd["cpb_cnt"] <= 32, "hrd_cpb_cnt_minus1 out of range")
    return hrd


def _read_sublayer_hrd(r, hrd: dict) -> list[dict]:
    """sublayer_hrd_parameters() (spec 7.3.5.3)."""
    out = []
    for _ in range(hrd.get("cpb_cnt", 1)):
        e = {"bit_rate_value": r.ue() + 1, "cpb_size_value": r.ue() + 1}
        if out:
            _check(e["bit_rate_value"] > out[-1]["bit_rate_value"],
                   "bit_rate_value_minus1 must increase with j")
            _check(e["cpb_size_value"] <= out[-1]["cpb_size_value"],
                   "cpb_size_value_minus1 must not increase with j")
        if hrd["du_hrd"]:
            e["cpb_size_du_value"] = r.ue() + 1
            e["bit_rate_du_value"] = r.ue() + 1
        e["cbr"] = r.flag()
        out.append(e)
    return out


def _read_ols_timing_hrd(r, hrd: dict, first: int, last: int) -> dict:
    """ols_timing_hrd_parameters() (spec 7.3.5.2; reference
    HLSyntaxReader::parseOlsHrdParameters)."""
    ols: dict = {"sublayers": {}}
    for i in range(first, last + 1):
        sl: dict = {}
        sl["fixed_pic_rate_general"] = r.flag()
        if sl["fixed_pic_rate_general"]:
            sl["fixed_pic_rate_within_cvs"] = True
        else:
            sl["fixed_pic_rate_within_cvs"] = r.flag()
        if sl["fixed_pic_rate_within_cvs"]:
            sl["elemental_duration_in_tc"] = r.ue() + 1
            _check(sl["elemental_duration_in_tc"] <= 2048,
                   "elemental_duration_in_tc_minus1 out of range")
        elif (hrd["nal_hrd"] or hrd["vcl_hrd"]) and hrd["cpb_cnt"] == 1:
            # present only with signalled HRD and a single CPB
            # (HLSyntaxReader.cpp:1288-1293); inferred 0 otherwise
            sl["low_delay_hrd"] = r.flag()
        if hrd["nal_hrd"]:
            sl["nal"] = _read_sublayer_hrd(r, hrd)
        if hrd["vcl_hrd"]:
            sl["vcl"] = _read_sublayer_hrd(r, hrd)
        ols["sublayers"][i] = sl
    return ols


# fixed sample-aspect-ratio table (H.273 / reference SARFixedRatios)
_SAR_FIXED = ((1, 1), (12, 11), (10, 11), (16, 11), (40, 33), (24, 11),
              (20, 11), (32, 11), (80, 33), (18, 11), (15, 11), (64, 33),
              (160, 99), (4, 3), (3, 2), (2, 1))


def parse_vui(payload: bytes) -> dict:
    """vui_parameters() from the byte-aligned VUI payload
    (spec 7.3.6; reference HLSyntaxReader::parseVUI HLSyntaxReader.cpp:1082)."""
    r = BitReader(payload)
    v: dict = {
        "progressive_source": r.flag(),
        "interlaced_source": r.flag(),
        "non_packed_constraint": r.flag(),
        "non_projected_constraint": r.flag(),
    }
    if r.flag():  # aspect_ratio_info_present
        v["aspect_ratio_constant"] = r.flag()
        idc = r.u(8)
        v["aspect_ratio_idc"] = idc
        if idc == 255:
            v["sar_width"] = r.u(16)
            v["sar_height"] = r.u(16)
        elif 0 < idc <= len(_SAR_FIXED):
            v["sar_width"], v["sar_height"] = _SAR_FIXED[idc - 1]
    if r.flag():  # overscan_info_present
        v["overscan_appropriate"] = r.flag()
    if r.flag():  # colour_description_present
        v["colour_primaries"] = r.u(8)
        v["transfer_characteristics"] = r.u(8)
        v["matrix_coeffs"] = r.u(8)
        v["full_range"] = r.flag()
    if r.flag():  # chroma_loc_info_present
        if v["progressive_source"] and not v["interlaced_source"]:
            v["chroma_sample_loc_type"] = r.ue()
            _check(v["chroma_sample_loc_type"] <= 6,
                   "vui_chroma_sample_loc_type_frame out of range")
        else:
            v["chroma_sample_loc_type_top"] = r.ue()
            v["chroma_sample_loc_type_bottom"] = r.ue()
            _check(v["chroma_sample_loc_type_top"] <= 6
                   and v["chroma_sample_loc_type_bottom"] <= 6,
                   "vui_chroma_sample_loc_type field out of range")
    # trailing payload-extension / alignment bits are tolerated
    return v


def parse_sps(rbsp: bytes) -> SPS:
    r = BitReader(rbsp, pos=16)  # skip 2-byte NAL header
    sps = SPS()
    sps.sps_id = r.u(4)
    sps.vps_id = r.u(4)
    sps.max_sublayers = r.u(3) + 1
    _check(sps.max_sublayers <= 7, "sps_max_sublayers_minus1 out of range")
    sps.chroma_format_idc = r.u(2)
    log2_ctu = r.u(2) + 5
    _check(log2_ctu <= 7, "sps_log2_ctu_size out of range")
    sps.ctu_size = 1 << log2_ctu
    sps.ptl_dpb_hrd_params_present = r.flag()
    _check(sps.vps_id != 0 or sps.ptl_dpb_hrd_params_present,
           "ptl_dpb_hrd_params must be present when vps_id == 0")
    if sps.ptl_dpb_hrd_params_present:
        sps.ptl = parse_profile_tier_level(r, True, sps.max_sublayers - 1)
    sps.gdr_enabled = r.flag()
    sps.rpr_enabled = r.flag()
    if sps.rpr_enabled:
        sps.res_change_in_clvs_allowed = r.flag()
    sps.pic_width_max = r.ue()
    sps.pic_height_max = r.ue()
    if r.flag():  # sps_conformance_window_flag
        sps.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())

    ctb = sps.ctu_size
    w_ctbs = (sps.pic_width_max + ctb - 1) // ctb
    h_ctbs = (sps.pic_height_max + ctb - 1) // ctb

    sps.subpic_info_present = r.flag()
    if sps.subpic_info_present:
        sps.num_subpics = r.ue() + 1
        if sps.num_subpics == 1:
            sps.subpic_ctu_top_left = [(0, 0)]
            sps.subpic_size_ctus = [(w_ctbs, h_ctbs)]
            sps.independent_subpics = True
            sps.subpic_treated_as_pic = [True]
            sps.loop_filter_across_subpic = [False]
        else:
            sps.independent_subpics = r.flag()
            same_size = r.flag()
            cl2w = max(1, math.ceil(math.log2(w_ctbs))) if w_ctbs > 1 else 0
            cl2h = max(1, math.ceil(math.log2(h_ctbs))) if h_ctbs > 1 else 0
            sps.subpic_ctu_top_left = []
            sps.subpic_size_ctus = []
            sps.subpic_treated_as_pic = []
            sps.loop_filter_across_subpic = []
            for i in range(sps.num_subpics):
                if not same_size or i == 0:
                    x = r.u(cl2w) if (i > 0 and sps.pic_width_max > ctb) else 0
                    y = r.u(cl2h) if (i > 0 and sps.pic_height_max > ctb) else 0
                    w = (r.u(cl2w) + 1 if (i < sps.num_subpics - 1 and sps.pic_width_max > ctb)
                         else w_ctbs - x)
                    h = (r.u(cl2h) + 1 if (i < sps.num_subpics - 1 and sps.pic_height_max > ctb)
                         else h_ctbs - y)
                else:
                    w0, h0 = sps.subpic_size_ctus[0]
                    cols = w_ctbs // w0
                    x = (i % cols) * w0
                    y = (i // cols) * h0
                    w, h = w0, h0
                sps.subpic_ctu_top_left.append((x, y))
                sps.subpic_size_ctus.append((w, h))
                if not sps.independent_subpics:
                    sps.subpic_treated_as_pic.append(r.flag())
                    sps.loop_filter_across_subpic.append(r.flag())
                else:
                    sps.subpic_treated_as_pic.append(True)
                    sps.loop_filter_across_subpic.append(False)
        sps.subpic_id_len = r.ue() + 1
        _check(sps.subpic_id_len <= 16, "sps_subpic_id_len out of range")
        sps.subpic_id_mapping_explicit = r.flag()
        if sps.subpic_id_mapping_explicit:
            sps.subpic_id_mapping_present = r.flag()
            if sps.subpic_id_mapping_present:
                sps.subpic_ids = [r.u(sps.subpic_id_len) for _ in range(sps.num_subpics)]
    else:
        sps.num_subpics = 1
        sps.subpic_ctu_top_left = [(0, 0)]
        sps.subpic_size_ctus = [(w_ctbs, h_ctbs)]
        sps.subpic_treated_as_pic = [True]
        sps.loop_filter_across_subpic = [False]
    if not sps.subpic_id_mapping_explicit or not sps.subpic_id_mapping_present:
        sps.subpic_ids = list(range(sps.num_subpics))

    bitdepth_minus8 = r.ue()
    _check(bitdepth_minus8 <= 8, "sps_bitdepth out of range")
    sps.bit_depth = 8 + bitdepth_minus8
    sps.entropy_coding_sync_enabled = r.flag()
    sps.entry_point_offsets_present = r.flag()
    sps.log2_max_poc_lsb = r.u(4) + 4
    _check(sps.log2_max_poc_lsb <= 16, "sps_log2_max_pic_order_cnt_lsb out of range")
    sps.poc_msb_cycle_flag = r.flag()
    if sps.poc_msb_cycle_flag:
        sps.poc_msb_cycle_len = r.ue() + 1

    num_extra_ph_bytes = r.u(2)
    sps.extra_ph_bit_present = [r.flag() for _ in range(8 * num_extra_ph_bytes)]
    num_extra_sh_bytes = r.u(2)
    sps.extra_sh_bit_present = [r.flag() for _ in range(8 * num_extra_sh_bytes)]

    if sps.ptl_dpb_hrd_params_present:
        if sps.max_sublayers > 1:
            sps.sublayer_dpb_params = r.flag()
        _dpb_parameters(r, sps, sps.max_sublayers - 1, sps.sublayer_dpb_params)

    sps.log2_min_cb_size = r.ue() + 2
    _check(sps.log2_min_cb_size <= min(6, log2_ctu), "invalid log2_min_cb_size")
    min_cb_log2 = sps.log2_min_cb_size

    sps.partition_constraints_override_enabled = r.flag()

    # intra luma partition constraints
    d = r.ue()
    min_qt_log2_intra = d + min_cb_log2
    max_mtt_intra = r.ue()
    min_qt = [1 << min_qt_log2_intra, 0, 0]
    max_btd = [max_mtt_intra, 0, 0]
    max_bt = [1 << min_qt_log2_intra, 0, 0]
    max_tt = [1 << min_qt_log2_intra, 0, 0]
    if max_mtt_intra != 0:
        max_bt[0] <<= r.ue()
        max_tt[0] <<= r.ue()
        _check(max_tt[0] <= 64, "max TT size intra > 64")

    if sps.chroma_format_idc != CHROMA_400:
        sps.dual_tree_intra = r.flag()
    if sps.dual_tree_intra:
        min_qt_log2_intra_c = r.ue() + min_cb_log2
        max_btd[2] = r.ue()
        min_qt[2] = 1 << min_qt_log2_intra_c
        max_tt[2] = max_bt[2] = min_qt[2]
        if max_btd[2] != 0:
            max_bt[2] <<= r.ue()
            max_tt[2] <<= r.ue()
            _check(max_tt[2] <= 64 and max_bt[2] <= 64, "max BT/TT chroma > 64")

    min_qt_log2_inter = r.ue() + min_cb_log2
    max_btd[1] = r.ue()
    min_qt[1] = 1 << min_qt_log2_inter
    max_tt[1] = max_bt[1] = min_qt[1]
    if max_btd[1] != 0:
        max_bt[1] <<= r.ue()
        max_tt[1] <<= r.ue()

    sps.min_qt_size, sps.max_mtt_depth = min_qt, max_btd
    sps.max_bt_size, sps.max_tt_size = max_bt, max_tt

    if sps.ctu_size > 32:
        sps.log2_max_tb_size = 5 + r.u(1)
    else:
        sps.log2_max_tb_size = 5

    sps.transform_skip_enabled = r.flag()
    if sps.transform_skip_enabled:
        sps.log2_max_ts_size = r.ue() + 2
        _check(sps.log2_max_ts_size <= 5, "log2_transform_skip_max_size out of range")
        sps.bdpcm_enabled = r.flag()
    sps.mts_enabled = r.flag()
    if sps.mts_enabled:
        sps.explicit_mts_intra = r.flag()
        sps.explicit_mts_inter = r.flag()
    sps.lfnst_enabled = r.flag()

    if sps.chroma_format_idc != CHROMA_400:
        sps.joint_cbcr_enabled = r.flag()
        same_qp_table = r.flag()
        num_tables = 1 if same_qp_table else (3 if sps.joint_cbcr_enabled else 2)
        tab = ChromaQpTable(same_qp_table_for_chroma=same_qp_table,
                            num_qp_tables=num_tables, qp_bd_offset=sps.qp_bd_offset)
        for _ in range(num_tables):
            start = r.se()
            _check(-26 - sps.qp_bd_offset <= start <= 36, "qp_table_start out of range")
            tab.qp_table_start_minus26.append(start)
            npts = r.ue() + 1
            din, dout = [], []
            for _ in range(npts):
                d_in = r.ue()
                d_diff = r.ue()
                din.append(d_in)
                dout.append(d_diff ^ d_in)
            tab.delta_qp_in_val_minus1.append(din)
            tab.delta_qp_out_val.append(dout)
        tab.derive()
        sps.chroma_qp_table = tab
    else:
        sps.chroma_qp_table = ChromaQpTable.default(sps.qp_bd_offset)

    sps.sao_enabled = r.flag()
    sps.alf_enabled = r.flag()
    if sps.alf_enabled and sps.chroma_format_idc != CHROMA_400:
        sps.ccalf_enabled = r.flag()
    sps.lmcs_enabled = r.flag()
    sps.weighted_pred = r.flag()
    sps.weighted_bipred = r.flag()
    sps.long_term_ref_pics = r.flag()
    if sps.vps_id > 0:
        sps.inter_layer_prediction = r.flag()
    sps.idr_rpl_present = r.flag()
    sps.rpl1_same_as_rpl0 = r.flag()
    rpl_lists: tuple[list[RefPicList], list[RefPicList]] = ([], [])
    for i in range(1 if sps.rpl1_same_as_rpl0 else 2):
        n = r.ue()
        _check(n <= 64, "sps_num_ref_pic_lists out of range")
        for j in range(n):
            rpl_lists[i].append(parse_ref_pic_list(r, sps, j))
    if sps.rpl1_same_as_rpl0:
        for rpl in rpl_lists[0]:
            c = rpl.copy()
            if not sps.long_term_ref_pics:
                c.entries = [e for e in c.entries if not e.is_long_term]
            rpl_lists[1].append(c)
    sps.rpl_lists = rpl_lists

    sps.ref_wraparound_enabled = r.flag()
    sps.temporal_mvp_enabled = r.flag()
    if sps.temporal_mvp_enabled:
        sps.sbtmvp_enabled = r.flag()
    sps.amvr_enabled = r.flag()
    sps.bdof_enabled = r.flag()
    if sps.bdof_enabled:
        sps.bdof_control_present_in_ph = r.flag()
    sps.smvd_enabled = r.flag()
    sps.dmvr_enabled = r.flag()
    if sps.dmvr_enabled:
        sps.dmvr_control_present_in_ph = r.flag()
    sps.mmvd_enabled = r.flag()
    if sps.mmvd_enabled:
        sps.mmvd_fullpel_only = r.flag()
    six_minus = r.ue()
    _check(six_minus <= 5, "six_minus_max_num_merge_cand out of range")
    sps.max_num_merge_cand = MRG_MAX_NUM_CANDS - six_minus
    sps.sbt_enabled = r.flag()
    sps.affine_enabled = r.flag()
    if sps.affine_enabled:
        sps.max_num_affine_merge_cand = AFFINE_MRG_MAX_NUM_CANDS - r.ue()
        sps.affine_6param = r.flag()
        if sps.amvr_enabled:
            sps.affine_amvr = r.flag()
        sps.prof_enabled = r.flag()
        if sps.prof_enabled:
            sps.prof_control_present_in_ph = r.flag()
    sps.bcw_enabled = r.flag()
    sps.ciip_enabled = r.flag()
    if sps.max_num_merge_cand >= 2:
        sps.gpm_enabled = r.flag()
        if sps.gpm_enabled and sps.max_num_merge_cand >= 3:
            sps.max_num_gpm_cand = sps.max_num_merge_cand - r.ue()
        elif sps.gpm_enabled:
            sps.max_num_gpm_cand = 2
    sps.log2_parallel_merge_level = r.ue() + 2
    sps.isp_enabled = r.flag()
    sps.mrl_enabled = r.flag()
    sps.mip_enabled = r.flag()
    if sps.chroma_format_idc != CHROMA_400:
        sps.cclm_enabled = r.flag()
    if sps.chroma_format_idc == CHROMA_420:
        sps.chroma_hor_collocated = r.flag()
        sps.chroma_ver_collocated = r.flag()
    sps.palette_enabled = r.flag()
    _check(not sps.palette_enabled, "palette mode is not supported")
    if sps.chroma_format_idc == CHROMA_444 and sps.log2_max_tb_size != 6:
        sps.act_enabled = r.flag()
    if sps.transform_skip_enabled or sps.palette_enabled:
        sps.internal_minus_input_bit_depth = r.ue()
    sps.ibc_enabled = r.flag()
    if sps.ibc_enabled:
        sps.max_num_ibc_merge_cand = IBC_MRG_MAX_NUM_CANDS - r.ue()
    sps.ladf_enabled = r.flag()
    if sps.ladf_enabled:
        num_intervals = r.u(2) + 2
        r.se()  # lowest interval qp offset
        for _ in range(num_intervals - 1):
            r.se()
            r.ue()
    sps.explicit_scaling_list_enabled = r.flag()
    if sps.lfnst_enabled and sps.explicit_scaling_list_enabled:
        sps.scaling_matrix_for_lfnst_disabled = r.flag()
    if sps.act_enabled and sps.explicit_scaling_list_enabled:
        sps.scaling_matrix_for_alt_cs_disabled = r.flag()
        if sps.scaling_matrix_for_alt_cs_disabled:
            sps.scaling_matrix_designated_cs = r.flag()
    sps.dep_quant_enabled = r.flag()
    sps.sign_data_hiding_enabled = r.flag()
    sps.virtual_boundaries_enabled = r.flag()
    if sps.virtual_boundaries_enabled:
        sps.virtual_boundaries_present = r.flag()
        if sps.virtual_boundaries_present:
            sps.num_ver_virtual_boundaries = r.ue()
            sps.virtual_boundary_pos_x = [(r.ue() + 1) << 3
                                          for _ in range(sps.num_ver_virtual_boundaries)]
            sps.num_hor_virtual_boundaries = r.ue()
            sps.virtual_boundary_pos_y = [(r.ue() + 1) << 3
                                          for _ in range(sps.num_hor_virtual_boundaries)]
    if sps.ptl_dpb_hrd_params_present:
        sps.timing_hrd_params_present = r.flag()
        if sps.timing_hrd_params_present:
            hrd = _read_general_timing_hrd(r)
            sublayer_cpb = False
            if sps.max_sublayers > 1:
                sublayer_cpb = r.flag()
            first = 0 if sublayer_cpb else sps.max_sublayers - 1
            hrd["ols"] = _read_ols_timing_hrd(r, hrd, first,
                                              sps.max_sublayers - 1)
            sps.hrd_params = hrd
    sps.field_seq_flag = r.flag()
    sps.vui_present = r.flag()
    if sps.vui_present:
        vui_size = r.ue() + 1
        _check(vui_size <= 1024, "vui payload too large")
        r.align()
        sps.vui_payload = r.read_bytes(vui_size)
        sps.vui = parse_vui(sps.vui_payload)
    if r.flag():  # sps_extension_present_flag
        while r.more_rbsp_data():
            r.u(1)
    _read_rbsp_trailing_bits(r)
    return sps


def _read_rbsp_trailing_bits(r: BitReader) -> None:
    _check(r.u(1) == 1, "rbsp_stop_one_bit != 1")
    while not r.byte_aligned():
        _check(r.u(1) == 0, "rbsp_alignment_zero_bit != 0")


def parse_pps(rbsp: bytes, sps_getter) -> PPS:
    r = BitReader(rbsp, pos=16)
    pps = PPS()
    pps.pps_id = r.u(6)
    pps.sps_id = r.u(4)
    sps: SPS = sps_getter(pps.sps_id)
    _check(sps is not None, f"SPS {pps.sps_id} missing")
    sub_w, sub_h = sub_wh(sps.chroma_format_idc)
    pps.mixed_nalu_types = r.flag()
    pps.pic_width = r.ue()
    pps.pic_height = r.ue()
    _check(1 <= pps.pic_width <= sps.pic_width_max, "pps_pic_width out of range")
    _check(1 <= pps.pic_height <= sps.pic_height_max, "pps_pic_height out of range")
    pps.conformance_window_present = r.flag()
    if pps.conformance_window_present:
        pps.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    scaling_win_explicit = r.flag()
    if scaling_win_explicit:
        pps.scaling_win = (r.se(), r.se(), r.se(), r.se())
    else:
        pps.scaling_win = pps.conf_win
    pps.output_flag_present = r.flag()
    pps.no_pic_partition = r.flag()
    pps.subpic_id_mapping_present = r.flag()
    if pps.subpic_id_mapping_present:
        if not pps.no_pic_partition:
            pps.num_subpics = r.ue() + 1
        else:
            pps.num_subpics = 1
        pps.subpic_id_len = r.ue() + 1
        pps.subpic_ids = [r.u(pps.subpic_id_len) for _ in range(pps.num_subpics)]
    else:
        pps.num_subpics = sps.num_subpics
        pps.subpic_ids = list(sps.subpic_ids) if sps.subpic_id_mapping_explicit \
            else list(range(max(1, sps.num_subpics)))

    ctb = sps.ctu_size
    pic_w_ctbs = (pps.pic_width + ctb - 1) // ctb
    pic_h_ctbs = (pps.pic_height + ctb - 1) // ctb

    if not pps.no_pic_partition:
        pps.log2_ctu_size = r.u(2) + 5
        _check(pps.log2_ctu_size == sps.ctu_log2, "pps/sps CTU size mismatch")
        pps.num_exp_tile_cols = r.ue() + 1
        pps.num_exp_tile_rows = r.ue() + 1
        pps.tile_col_widths = [r.ue() + 1 for _ in range(pps.num_exp_tile_cols)]
        pps.tile_row_heights = [r.ue() + 1 for _ in range(pps.num_exp_tile_rows)]
        # derive full tile grid now to know num_tiles
        pps.finalize_partial = True
        # temporary finalize of tiles only:
        pps.pic_width_in_ctu = pic_w_ctbs
        pps.pic_height_in_ctu = pic_h_ctbs
        _derive_tiles(pps)
        if pps.num_tiles > 1:
            pps.loop_filter_across_tiles = r.flag()
            pps.rect_slice = r.flag()
        else:
            pps.loop_filter_across_tiles = False
            pps.rect_slice = True
        if pps.rect_slice:
            pps.single_slice_per_subpic = r.flag()
        if pps.rect_slice and not pps.single_slice_per_subpic:
            pps.num_slices_in_pic = r.ue() + 1
            if pps.num_slices_in_pic - 1 > 1:
                pps.tile_idx_delta_present = r.flag()
            n = pps.num_slices_in_pic
            pps.slice_top_left_tile_idx = [0] * n
            pps.slice_width_in_tiles = [1] * n
            pps.slice_height_in_tiles = [1] * n
            pps.num_slices_in_tile = [1] * n
            pps.slice_height_in_ctu = [0] * n
            tile_idx = 0
            s = 0
            while s < n - 1:
                pps.slice_top_left_tile_idx[s] = tile_idx
                if tile_idx % pps.num_tile_cols != pps.num_tile_cols - 1:
                    pps.slice_width_in_tiles[s] = r.ue() + 1
                else:
                    pps.slice_width_in_tiles[s] = 1
                if (tile_idx // pps.num_tile_cols != pps.num_tile_rows - 1
                        and (pps.tile_idx_delta_present
                             or tile_idx % pps.num_tile_cols == 0)):
                    pps.slice_height_in_tiles[s] = r.ue() + 1
                elif tile_idx // pps.num_tile_cols == pps.num_tile_rows - 1:
                    pps.slice_height_in_tiles[s] = 1
                else:
                    pps.slice_height_in_tiles[s] = pps.slice_height_in_tiles[s - 1]
                if pps.slice_width_in_tiles[s] == 1 and pps.slice_height_in_tiles[s] == 1:
                    row_h = pps.tile_row_heights[tile_idx // pps.num_tile_cols]
                    if row_h > 1:
                        num_exp = r.ue()
                        if num_exp == 0:
                            pps.num_slices_in_tile[s] = 1
                            pps.slice_height_in_ctu[s] = row_h
                        else:
                            rem = row_h
                            last = 0
                            j = 0
                            for j in range(num_exp):
                                h = r.ue() + 1
                                pps.slice_height_in_ctu[s + j] = h
                                rem -= h
                                last = h
                            j = num_exp
                            uniform = last
                            while rem >= uniform:
                                pps.slice_height_in_ctu[s + j] = uniform
                                rem -= uniform
                                j += 1
                            if rem > 0:
                                pps.slice_height_in_ctu[s + j] = rem
                                j += 1
                            for k in range(j):
                                pps.num_slices_in_tile[s + k] = j
                                pps.slice_width_in_tiles[s + k] = 1
                                pps.slice_height_in_tiles[s + k] = 1
                                pps.slice_top_left_tile_idx[s + k] = tile_idx
                            s += j - 1
                    else:
                        pps.num_slices_in_tile[s] = 1
                        pps.slice_height_in_ctu[s] = row_h
                if s < n - 1:
                    if pps.tile_idx_delta_present:
                        delta = r.se()
                        _check(delta != 0, "pps_tile_idx_delta_val == 0")
                        tile_idx += delta
                        _check(0 <= tile_idx < pps.num_tiles, "invalid tile_idx_delta")
                    else:
                        tile_idx += pps.slice_width_in_tiles[s]
                        if tile_idx % pps.num_tile_cols == 0:
                            tile_idx += (pps.slice_height_in_tiles[s] - 1) * pps.num_tile_cols
                s += 1
            pps.slice_top_left_tile_idx[n - 1] = tile_idx
            # last slice: width/height inferred as the remaining rectangle
            # to the bottom-right tile corner (spec 7.4.3.4 inference for
            # i == pps_num_slices_in_pic_minus1), unless it continues a
            # sub-tile split (same tile as the previous slice)
            if not (n >= 2 and pps.slice_top_left_tile_idx[n - 2] == tile_idx):
                pps.slice_width_in_tiles[n - 1] = \
                    pps.num_tile_cols - tile_idx % pps.num_tile_cols
                pps.slice_height_in_tiles[n - 1] = \
                    pps.num_tile_rows - tile_idx // pps.num_tile_cols
            else:
                ty = tile_idx // pps.num_tile_cols
                row_h = pps.tile_row_bd[ty + 1] - pps.tile_row_bd[ty]
                used = sum(pps.slice_height_in_ctu[k]
                           for k in range(n - 1)
                           if pps.slice_top_left_tile_idx[k] == tile_idx)
                pps.slice_height_in_ctu[n - 1] = row_h - used
                pps.num_slices_in_tile[n - 1] = 2  # >1: sub-tile slice
        if (not pps.rect_slice or pps.single_slice_per_subpic
                or pps.num_slices_in_pic > 1):
            pps.loop_filter_across_slices = r.flag()
    else:
        pps.single_slice_per_subpic = True

    pps.cabac_init_present = r.flag()
    pps.num_ref_idx_default_active = (r.ue() + 1, r.ue() + 1)
    pps.rpl1_idx_present = r.flag()
    pps.weighted_pred = r.flag()
    pps.weighted_bipred = r.flag()
    pps.ref_wraparound_enabled = r.flag()
    if pps.ref_wraparound_enabled:
        pps.pic_width_minus_wraparound_offset = r.ue()
    pps.init_qp = 26 + r.se()
    pps.cu_qp_delta_enabled = r.flag()
    pps.chroma_tool_offsets_present = r.flag()
    if pps.chroma_tool_offsets_present:
        pps.cb_qp_offset = r.se()
        pps.cr_qp_offset = r.se()
        pps.joint_cbcr_qp_offset_present = r.flag()
        if pps.joint_cbcr_qp_offset_present:
            pps.joint_cbcr_qp_offset = r.se()
        pps.slice_chroma_qp_offsets_present = r.flag()
        pps.cu_chroma_qp_offset_list_enabled = r.flag()
        if pps.cu_chroma_qp_offset_list_enabled:
            n = r.ue() + 1
            for _ in range(n):
                cb = r.se()
                cr = r.se()
                jj = r.se() if pps.joint_cbcr_qp_offset_present else 0
                pps.chroma_qp_offset_list.append((cb, cr, jj))
    pps.deblocking_filter_control_present = r.flag()
    if pps.deblocking_filter_control_present:
        pps.deblocking_filter_override_enabled = r.flag()
        pps.deblocking_filter_disabled = r.flag()
        if not pps.no_pic_partition and pps.deblocking_filter_override_enabled:
            pps.dbf_info_in_ph = r.flag()
        if not pps.deblocking_filter_disabled:
            pps.beta_offset_div2 = r.se()
            pps.tc_offset_div2 = r.se()
            if pps.chroma_tool_offsets_present:
                pps.cb_beta_offset_div2 = r.se()
                pps.cb_tc_offset_div2 = r.se()
                pps.cr_beta_offset_div2 = r.se()
                pps.cr_tc_offset_div2 = r.se()
            else:
                pps.cb_beta_offset_div2 = pps.cr_beta_offset_div2 = pps.beta_offset_div2
                pps.cb_tc_offset_div2 = pps.cr_tc_offset_div2 = pps.tc_offset_div2
    if not pps.no_pic_partition:
        pps.rpl_info_in_ph = r.flag()
        pps.sao_info_in_ph = r.flag()
        pps.alf_info_in_ph = r.flag()
        if (pps.weighted_pred or pps.weighted_bipred) and pps.rpl_info_in_ph:
            pps.wp_info_in_ph = r.flag()
        pps.qp_delta_info_in_ph = r.flag()
    pps.picture_header_extension_present = r.flag()
    pps.slice_header_extension_present = r.flag()
    if r.flag():
        while r.more_rbsp_data():
            r.u(1)
    _read_rbsp_trailing_bits(r)

    pps.finalize(sps)
    # wraparound offset in luma samples
    if pps.ref_wraparound_enabled:
        min_cb = 1 << sps.log2_min_cb_size
        pps.wraparound_offset = min_cb * (pps.pic_width // min_cb
                                          - pps.pic_width_minus_wraparound_offset)
    return pps


def _derive_tiles(pps: PPS) -> None:
    """Uniform-fill tile derivation (same rule as PPS.finalize, needed early
    because later PPS syntax depends on num_tiles)."""
    for sizes, total in ((pps.tile_col_widths, pps.pic_width_in_ctu),
                         (pps.tile_row_heights, pps.pic_height_in_ctu)):
        rem = total - sum(sizes)
        _check(rem >= 0, "explicit tile sizes exceed picture")
        uniform = sizes[-1]
        while rem > 0:
            uniform = min(rem, uniform)
            sizes.append(uniform)
            rem -= uniform
    pps.num_tile_cols = len(pps.tile_col_widths)
    pps.num_tile_rows = len(pps.tile_row_heights)
    pps.tile_col_bd = [0]
    for w in pps.tile_col_widths:
        pps.tile_col_bd.append(pps.tile_col_bd[-1] + w)
    pps.tile_row_bd = [0]
    for h in pps.tile_row_heights:
        pps.tile_row_bd.append(pps.tile_row_bd[-1] + h)


def parse_pic_or_slice_header_rpl(r: BitReader, header, sps: SPS, pps: PPS) -> None:
    """ref_pic_lists() in PH or SH."""
    rpl_sps_flag = [False, False]
    for list_idx in (0, 1):
        n_sps = sps.num_rpl(list_idx)
        if n_sps > 0 and (list_idx == 0 or pps.rpl1_idx_present):
            rpl_sps_flag[list_idx] = r.flag()
        elif n_sps == 0:
            rpl_sps_flag[list_idx] = False
        else:
            rpl_sps_flag[list_idx] = rpl_sps_flag[0]

        if rpl_sps_flag[list_idx]:
            idx = 0
            if n_sps == 1:
                idx = 0
            elif list_idx == 1 and not pps.rpl1_idx_present:
                idx = header.rpl_idx[0]
            if n_sps > 1 and (list_idx == 0 or pps.rpl1_idx_present):
                nbits = math.ceil(math.log2(n_sps))
                idx = r.u(nbits)
            _check(0 <= idx < n_sps, "rpl_idx out of range")
            header.rpl[list_idx] = sps.rpl_lists[list_idx][idx].copy()
            header.rpl_idx[list_idx] = idx
        else:
            header.rpl[list_idx] = parse_ref_pic_list(r, sps, -1)
            header.rpl_idx[list_idx] = -1

        rpl = header.rpl[list_idx]
        for e in rpl.entries:
            if not e.is_long_term or e.is_inter_layer:
                continue
            if rpl.ltrp_in_header_flag:
                e.value = r.u(sps.log2_max_poc_lsb)
            e.delta_poc_msb_present = r.flag()
            if e.delta_poc_msb_present:
                e.delta_poc_msb_cycle = r.ue()


def parse_aps(rbsp: bytes):
    """APS NAL parse (HLSyntaxReader::parseAPS, HLSyntaxReader.cpp:855).
    Payloads: LMCS (parseLmcsAps :1014); ALF/scaling-list arrive with their
    subsystems."""
    from refdec.hls.params import (
        ALF_APS, APS, LMCS_APS, LmcsInfo, PIC_CODE_CW_BINS, SCALING_LIST_APS,
    )
    r = BitReader(rbsp, pos=16)
    aps = APS()
    aps.aps_type = r.u(3)
    aps.aps_id = r.u(5)
    aps.chroma_present = bool(r.flag())
    if aps.aps_type == LMCS_APS:
        _check(aps.aps_id <= 3, "LMCS APS id out of range")
        info = LmcsInfo()
        info.min_bin_idx = r.ue()
        _check(info.min_bin_idx <= 15, "lmcs_min_bin_idx out of range")
        delta_max = r.ue()
        _check(delta_max <= 15, "lmcs_delta_max_bin_idx out of range")
        info.max_bin_idx = PIC_CODE_CW_BINS - 1 - delta_max
        _check(info.max_bin_idx >= info.min_bin_idx,
               "LmcsMaxBinIdx < lmcs_min_bin_idx")
        info.delta_cw_prec = r.ue() + 1
        _check(info.delta_cw_prec <= 15, "lmcs_delta_cw_prec out of range")
        for i in range(info.min_bin_idx, info.max_bin_idx + 1):
            v = r.u(info.delta_cw_prec)
            if v and r.flag():
                v = -v
            info.cw_delta[i] = v
        if aps.chroma_present:
            v = r.u(3)
            if v and r.flag():
                v = -v
            info.crs_offset = v
        aps.lmcs = info
    elif aps.aps_type == ALF_APS:
        _check(aps.aps_id <= 7, "ALF APS id out of range")
        from refdec.hls.alf_aps import parse_alf_aps
        parse_alf_aps(r, aps)
    elif aps.aps_type == SCALING_LIST_APS:
        _check(aps.aps_id <= 7, "scaling-list APS id out of range")
        from refdec.hls.scaling_list import parse_scaling_list
        aps.scaling_list = parse_scaling_list(r, aps.chroma_present)
    return aps


def parse_picture_header(r: BitReader, psman, read_trailing: bool = True) -> PicHeader:
    ph = PicHeader()
    ph.gdr_or_irap_pic = r.flag()
    ph.non_ref_pic = r.flag()
    if ph.gdr_or_irap_pic:
        ph.gdr_pic = r.flag()
    ph.inter_slice_allowed = r.flag()
    if ph.inter_slice_allowed:
        ph.intra_slice_allowed = r.flag()
    else:
        ph.intra_slice_allowed = True
    _check(ph.inter_slice_allowed or ph.intra_slice_allowed,
           "picture with neither intra nor inter slices")
    ph.pps_id = r.ue()
    pps: PPS = psman.get_pps(ph.pps_id)
    _check(pps is not None, "PPS missing")
    sps: SPS = psman.get_sps(pps.sps_id)
    _check(sps is not None, "SPS missing")

    ph.poc_lsb = r.u(sps.log2_max_poc_lsb)
    if ph.gdr_pic:
        ph.recovery_poc_cnt = r.ue()
    for present in sps.extra_ph_bit_present:
        if present:
            r.u(1)
    if sps.poc_msb_cycle_flag:
        ph.poc_msb_present = r.flag()
        if ph.poc_msb_present:
            ph.poc_msb_val = r.u(sps.poc_msb_cycle_len)

    if sps.alf_enabled and pps.alf_info_in_ph:
        ph.alf_enabled[0] = r.flag()
        if ph.alf_enabled[0]:
            ph.num_alf_aps_ids_luma = r.u(3)
            ph.alf_aps_ids_luma = [r.u(3) for _ in range(ph.num_alf_aps_ids_luma)]
            if sps.chroma_format_idc != CHROMA_400:
                ph.alf_enabled[1] = r.flag()
                ph.alf_enabled[2] = r.flag()
            if ph.alf_enabled[1] or ph.alf_enabled[2]:
                ph.alf_aps_id_chroma = r.u(3)
            if sps.ccalf_enabled:
                ph.ccalf_cb_enabled = r.flag()
                if ph.ccalf_cb_enabled:
                    ph.ccalf_cb_aps_id = r.u(3)
                ph.ccalf_cr_enabled = r.flag()
                if ph.ccalf_cr_enabled:
                    ph.ccalf_cr_aps_id = r.u(3)

    if sps.lmcs_enabled:
        ph.lmcs_enabled = r.flag()
        if ph.lmcs_enabled:
            ph.lmcs_aps_id = r.u(2)
            if sps.chroma_format_idc != CHROMA_400:
                ph.chroma_residual_scale = r.flag()
    if sps.explicit_scaling_list_enabled:
        ph.explicit_scaling_list_enabled = r.flag()
        if ph.explicit_scaling_list_enabled:
            ph.scaling_list_aps_id = r.u(3)

    if sps.virtual_boundaries_enabled and not sps.virtual_boundaries_present:
        ph.virtual_boundaries_present = r.flag()
        if ph.virtual_boundaries_present:
            ph.num_ver_virtual_boundaries = r.ue()
            ph.virtual_boundary_pos_x = [(r.ue() + 1) << 3
                                         for _ in range(ph.num_ver_virtual_boundaries)]
            ph.num_hor_virtual_boundaries = r.ue()
            ph.virtual_boundary_pos_y = [(r.ue() + 1) << 3
                                         for _ in range(ph.num_hor_virtual_boundaries)]
    elif sps.virtual_boundaries_present:
        ph.virtual_boundaries_present = True
        ph.num_ver_virtual_boundaries = sps.num_ver_virtual_boundaries
        ph.num_hor_virtual_boundaries = sps.num_hor_virtual_boundaries
        ph.virtual_boundary_pos_x = list(sps.virtual_boundary_pos_x)
        ph.virtual_boundary_pos_y = list(sps.virtual_boundary_pos_y)

    if pps.output_flag_present and not ph.non_ref_pic:
        ph.pic_output_flag = r.flag()
    if pps.rpl_info_in_ph:
        parse_pic_or_slice_header_rpl(r, ph, sps, pps)

    if sps.partition_constraints_override_enabled:
        ph.split_cons_override = r.flag()
    ph.min_qt_size = list(sps.min_qt_size)
    ph.max_mtt_depth = list(sps.max_mtt_depth)
    ph.max_bt_size = list(sps.max_bt_size)
    ph.max_tt_size = list(sps.max_tt_size)
    min_cb_log2 = sps.log2_min_cb_size

    if ph.intra_slice_allowed:
        min_qt_log2_intra = ph.min_qt_size[0].bit_length() - 1
        if ph.split_cons_override:
            d = r.ue()
            min_qt_log2_intra = d + min_cb_log2
            ph.min_qt_size[0] = 1 << min_qt_log2_intra
            ph.max_mtt_depth[0] = r.ue()
            ph.max_tt_size[0] = ph.max_bt_size[0] = ph.min_qt_size[0]
            if ph.max_mtt_depth[0] != 0:
                ph.max_bt_size[0] <<= r.ue()
                ph.max_tt_size[0] <<= r.ue()
            if sps.dual_tree_intra:
                ph.min_qt_size[2] = 1 << (r.ue() + min_cb_log2)
                ph.max_mtt_depth[2] = r.ue()
                ph.max_tt_size[2] = ph.max_bt_size[2] = ph.min_qt_size[2]
                if ph.max_mtt_depth[2] != 0:
                    ph.max_bt_size[2] <<= r.ue()
                    ph.max_tt_size[2] <<= r.ue()
        if pps.cu_qp_delta_enabled:
            ph.cu_qp_delta_subdiv_intra = r.ue()
        if pps.cu_chroma_qp_offset_list_enabled:
            ph.cu_chroma_qp_offset_subdiv_intra = r.ue()

    if ph.inter_slice_allowed:
        if ph.split_cons_override:
            min_qt_log2_inter = r.ue() + min_cb_log2
            ph.min_qt_size[1] = 1 << min_qt_log2_inter
            ph.max_mtt_depth[1] = r.ue()
            ph.max_tt_size[1] = ph.max_bt_size[1] = ph.min_qt_size[1]
            if ph.max_mtt_depth[1] != 0:
                ph.max_bt_size[1] <<= r.ue()
                ph.max_tt_size[1] <<= r.ue()
        if pps.cu_qp_delta_enabled:
            ph.cu_qp_delta_subdiv_inter = r.ue()
        if pps.cu_chroma_qp_offset_list_enabled:
            ph.cu_chroma_qp_offset_subdiv_inter = r.ue()
        if sps.temporal_mvp_enabled:
            ph.temporal_mvp_enabled = r.flag()
            if ph.temporal_mvp_enabled and pps.rpl_info_in_ph:
                if ph.rpl[1].num_ref_entries > 0:
                    ph.collocated_from_l0 = r.flag()
                else:
                    ph.collocated_from_l0 = True
                nrefs = (ph.rpl[0] if ph.collocated_from_l0 else ph.rpl[1]).num_ref_entries
                if nrefs > 1:
                    ph.collocated_ref_idx = r.ue()
        if sps.affine_enabled:
            ph.max_num_affine_merge_cand = sps.max_num_affine_merge_cand
        else:
            ph.max_num_affine_merge_cand = int(sps.sbtmvp_enabled and ph.temporal_mvp_enabled)
        if sps.mmvd_fullpel_only:
            ph.fpel_mmvd = r.flag()
        presence = (not pps.rpl_info_in_ph) or ph.rpl[1].num_ref_entries > 0
        ph.bdof_disabled = (1 - sps.bdof_enabled) if not sps.bdof_control_present_in_ph else True
        ph.dmvr_disabled = (1 - sps.dmvr_enabled) if not sps.dmvr_control_present_in_ph else True
        if presence:
            ph.mvd_l1_zero = r.flag()
            if sps.bdof_control_present_in_ph:
                ph.bdof_disabled = r.flag()
            if sps.dmvr_control_present_in_ph:
                ph.dmvr_disabled = r.flag()
        if sps.prof_control_present_in_ph:
            ph.prof_disabled = r.flag()
        else:
            ph.prof_disabled = not sps.prof_enabled
        if (pps.weighted_pred or pps.weighted_bipred) and pps.wp_info_in_ph:
            from refdec.hls.weight_table import parse_pred_weight_table
            ph.weight_table = parse_pred_weight_table(r, sps, pps, None, ph)

    if pps.qp_delta_info_in_ph:
        ph.qp_delta = r.se()
        qp_y = 26 + (pps.init_qp - 26) + ph.qp_delta
        _check(-sps.qp_bd_offset <= qp_y <= 63, "SliceQpY out of range")
    if sps.joint_cbcr_enabled:
        ph.joint_cbcr_sign = r.flag()
    if sps.sao_enabled and pps.sao_info_in_ph:
        ph.sao_enabled_luma = r.flag()
        if sps.chroma_format_idc != CHROMA_400:
            ph.sao_enabled_chroma = r.flag()

    if pps.dbf_info_in_ph:
        ph.deblocking_override = r.flag()
    if pps.deblocking_filter_disabled and ph.deblocking_override:
        ph.deblocking_disabled = False
    else:
        ph.deblocking_disabled = pps.deblocking_filter_disabled
    ph.beta_offset_div2 = pps.beta_offset_div2
    ph.tc_offset_div2 = pps.tc_offset_div2
    if ph.deblocking_override:
        if not pps.deblocking_filter_disabled:
            ph.deblocking_disabled = r.flag()
        if not ph.deblocking_disabled:
            ph.beta_offset_div2 = r.se()
            ph.tc_offset_div2 = r.se()
    if ph.deblocking_override and not ph.deblocking_disabled and pps.chroma_tool_offsets_present:
        ph.cb_beta_offset_div2 = r.se()
        ph.cb_tc_offset_div2 = r.se()
        ph.cr_beta_offset_div2 = r.se()
        ph.cr_tc_offset_div2 = r.se()
    else:
        if pps.chroma_tool_offsets_present:
            ph.cb_beta_offset_div2 = pps.cb_beta_offset_div2
            ph.cb_tc_offset_div2 = pps.cb_tc_offset_div2
            ph.cr_beta_offset_div2 = pps.cr_beta_offset_div2
            ph.cr_tc_offset_div2 = pps.cr_tc_offset_div2
        else:
            ph.cb_beta_offset_div2 = ph.cr_beta_offset_div2 = ph.beta_offset_div2
            ph.cb_tc_offset_div2 = ph.cr_tc_offset_div2 = ph.tc_offset_div2

    if pps.picture_header_extension_present:
        n = r.ue()
        for _ in range(n):
            r.u(8)
    if read_trailing:
        _read_rbsp_trailing_bits(r)
    return ph


def parse_slice_header(r: BitReader, psman, nal_type: int, temporal_id: int,
                       prev_tid0_poc: int, ph: PicHeader | None) -> tuple[SliceHeader, PicHeader]:
    from refdec.bitstream.nal import NalUnitType

    sh = SliceHeader()
    sh.nal_type = nal_type
    sh.temporal_id = temporal_id
    sh.picture_header_in_slice_header = r.flag()
    if sh.picture_header_in_slice_header:
        ph = parse_picture_header(r, psman, read_trailing=False)
    _check(ph is not None, "picture header missing")

    pps: PPS = psman.get_pps(ph.pps_id)
    sps: SPS = psman.get_sps(pps.sps_id)
    chroma = sps.chroma_format_idc != CHROMA_400

    # POC derivation (H.266 clause 8.3.1)
    idr = nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)
    max_poc_lsb = sps.max_poc_lsb
    if idr:
        msb = ph.poc_msb_val * max_poc_lsb if ph.poc_msb_present else 0
        sh.poc = msb + ph.poc_lsb
    else:
        prev_lsb = prev_tid0_poc & (max_poc_lsb - 1)
        prev_msb = prev_tid0_poc - prev_lsb
        if ph.poc_msb_present:
            msb = ph.poc_msb_val * max_poc_lsb
        elif ph.poc_lsb < prev_lsb and prev_lsb - ph.poc_lsb >= max_poc_lsb // 2:
            msb = prev_msb + max_poc_lsb
        elif ph.poc_lsb > prev_lsb and ph.poc_lsb - prev_lsb > max_poc_lsb // 2:
            msb = prev_msb - max_poc_lsb
        else:
            msb = prev_msb
        sh.poc = msb + ph.poc_lsb

    sh.subpic_idx = 0
    if sps.subpic_info_present:  # sh_subpic_id (always signalled then)
        sh.subpic_id = r.u(sps.subpic_id_len)
        ids = pps.subpic_ids if pps.subpic_ids else sps.subpic_ids
        _check(sh.subpic_id in ids, "sh_subpic_id not in subpic id list")
        sh.subpic_idx = ids.index(sh.subpic_id)

    num_tiles = pps.num_tiles
    slice_addr = 0
    if not pps.rect_slice:
        if num_tiles > 1:
            bits = math.ceil(math.log2(num_tiles))
            slice_addr = r.u(bits)
    else:
        # sh_slice_address indexes slices within the current subpicture
        # (NumSlicesInSubpic, spec 7.4.8.1; multi-slice subpics supported)
        in_subpic = pps.slices_of_subpic[sh.subpic_idx] \
            if sh.subpic_idx < len(pps.slices_of_subpic) else []
        num_slices_in_subpic = len(in_subpic)
        if num_slices_in_subpic > 1:
            bits = math.ceil(math.log2(num_slices_in_subpic))
            slice_addr = r.u(bits)
    sh.slice_address = slice_addr

    for present in sps.extra_sh_bit_present:
        if present:
            r.u(1)

    num_tiles_in_slice = 1
    if not pps.rect_slice and num_tiles - slice_addr > 1:
        num_tiles_in_slice = r.ue() + 1
    sh.num_tiles_in_slice = num_tiles_in_slice

    # build CTU map for this slice
    if not pps.rect_slice:
        sh.ctu_addrs = []
        for tile_idx in range(slice_addr, slice_addr + num_tiles_in_slice):
            tx = tile_idx % pps.num_tile_cols
            ty = tile_idx // pps.num_tile_cols
            sh.ctu_addrs.extend(pps.tile_ctus(pps.tile_col_bd[tx], pps.tile_col_bd[tx + 1],
                                              pps.tile_row_bd[ty], pps.tile_row_bd[ty + 1]))
    else:
        # rect slices: picture-level slice index = the slice_addr-th slice
        # of the current subpic (SliceSubpicToPicIdx)
        if in_subpic:
            _check(slice_addr < len(in_subpic), "sh_slice_address range")
            global_idx = in_subpic[slice_addr]
        else:
            global_idx = slice_addr
        sh.ctu_addrs = list(pps.slice_maps[global_idx]) \
            if pps.slice_maps else []

    if ph.inter_slice_allowed:
        sh.slice_type = r.ue()
        _check(sh.slice_type <= 2, "invalid sh_slice_type")
    else:
        sh.slice_type = I_SLICE
    _check(ph.intra_slice_allowed or sh.slice_type != I_SLICE,
           "intra slice not allowed by PH")

    if nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                    NalUnitType.CRA, NalUnitType.GDR):
        sh.no_output_of_prior_pics = r.flag()

    # inherit from PH
    sh.lmcs_enabled = ph.lmcs_enabled if sh.picture_header_in_slice_header else False
    sh.explicit_scaling_list_used = (ph.explicit_scaling_list_enabled
                                     if sh.picture_header_in_slice_header else False)
    sh.deblocking_disabled = ph.deblocking_disabled
    sh.beta_offset_div2 = ph.beta_offset_div2
    sh.tc_offset_div2 = ph.tc_offset_div2
    sh.cb_beta_offset_div2 = ph.cb_beta_offset_div2
    sh.cb_tc_offset_div2 = ph.cb_tc_offset_div2
    sh.cr_beta_offset_div2 = ph.cr_beta_offset_div2
    sh.cr_tc_offset_div2 = ph.cr_tc_offset_div2
    if pps.rpl_info_in_ph:
        sh.rpl = [ph.rpl[0].copy() if ph.rpl[0] else None,
                  ph.rpl[1].copy() if ph.rpl[1] else None]
    if pps.sao_info_in_ph:
        sh.sao_enabled_luma = ph.sao_enabled_luma
        sh.sao_enabled_chroma = ph.sao_enabled_chroma
    if pps.alf_info_in_ph:
        sh.alf_enabled = list(ph.alf_enabled)
        sh.num_alf_aps_ids_luma = ph.num_alf_aps_ids_luma
        sh.alf_aps_ids_luma = list(ph.alf_aps_ids_luma)
        sh.alf_aps_id_chroma = ph.alf_aps_id_chroma
        sh.ccalf_cb_enabled = ph.ccalf_cb_enabled
        sh.ccalf_cb_aps_id = ph.ccalf_cb_aps_id
        sh.ccalf_cr_enabled = ph.ccalf_cr_enabled
        sh.ccalf_cr_aps_id = ph.ccalf_cr_aps_id
    if pps.wp_info_in_ph:
        sh.weight_table = ph.weight_table
    sh.collocated_from_l0 = ph.collocated_from_l0
    sh.collocated_ref_idx = ph.collocated_ref_idx

    if sps.alf_enabled and not pps.alf_info_in_ph:
        sh.alf_enabled[0] = r.flag()
        if sh.alf_enabled[0]:
            sh.num_alf_aps_ids_luma = r.u(3)
            sh.alf_aps_ids_luma = [r.u(3) for _ in range(sh.num_alf_aps_ids_luma)]
            if chroma:
                sh.alf_enabled[1] = r.flag()
                sh.alf_enabled[2] = r.flag()
            if sh.alf_enabled[1] or sh.alf_enabled[2]:
                sh.alf_aps_id_chroma = r.u(3)
            if sps.ccalf_enabled:
                sh.ccalf_cb_enabled = r.flag()
                if sh.ccalf_cb_enabled:
                    sh.ccalf_cb_aps_id = r.u(3)
                sh.ccalf_cr_enabled = r.flag()
                if sh.ccalf_cr_enabled:
                    sh.ccalf_cr_aps_id = r.u(3)

    if ph.lmcs_enabled and not sh.picture_header_in_slice_header:
        sh.lmcs_enabled = r.flag()
    if ph.explicit_scaling_list_enabled and not sh.picture_header_in_slice_header:
        sh.explicit_scaling_list_used = r.flag()

    if pps.rpl_info_in_ph:
        pass  # inherited above
    elif idr and not sps.idr_rpl_present:
        sh.rpl = [RefPicList(), RefPicList()]
    else:
        sh.rpl = [None, None]
        parse_pic_or_slice_header_rpl(r, sh, sps, pps)

    # num_ref_idx_active derivation
    override = True
    num_ref_idx_active_minus1 = [0, 0]
    if ((sh.slice_type != I_SLICE and sh.rpl[0].num_ref_entries > 1)
            or (sh.is_b and sh.rpl[1].num_ref_entries > 1)):
        override = r.flag()
        if override:
            for i in range(2 if sh.is_b else 1):
                if sh.rpl[i].num_ref_entries > 1:
                    num_ref_idx_active_minus1[i] = r.ue()
    for i in (0, 1):
        if sh.is_b or (sh.is_p and i == 0):
            if override:
                sh.num_ref_idx_active[i] = num_ref_idx_active_minus1[i] + 1
            else:
                default = pps.num_ref_idx_default_active[i]
                sh.num_ref_idx_active[i] = min(default, sh.rpl[i].num_ref_entries)
        else:
            sh.num_ref_idx_active[i] = 0
    if sh.is_p or sh.is_b:
        _check(sh.num_ref_idx_active[0] > 0, "P/B slice with empty RPL0")
        if sh.is_b:
            _check(sh.num_ref_idx_active[1] > 0, "B slice with empty RPL1")

    if not sh.is_intra:
        if pps.cabac_init_present:
            sh.cabac_init_flag = r.flag()
        if ph.temporal_mvp_enabled and not pps.rpl_info_in_ph:
            if sh.is_b:
                sh.collocated_from_l0 = r.flag()
            else:
                sh.collocated_from_l0 = True
            lst = 0 if sh.collocated_from_l0 else 1
            if sh.num_ref_idx_active[lst] > 1:
                sh.collocated_ref_idx = r.ue()
        if not pps.wp_info_in_ph and ((pps.weighted_pred and sh.is_p)
                                      or (pps.weighted_bipred and sh.is_b)):
            from refdec.hls.weight_table import parse_pred_weight_table
            sh.weight_table = parse_pred_weight_table(
                r, sps, pps, (sh.num_ref_idx_active[0], sh.num_ref_idx_active[1]), None)

    if not pps.qp_delta_info_in_ph:
        qp_delta = r.se()
        sh.qp_y = 26 + (pps.init_qp - 26) + qp_delta
    else:
        sh.qp_y = 26 + (pps.init_qp - 26) + ph.qp_delta
    _check(-sps.qp_bd_offset <= sh.qp_y <= 63, "SliceQpY out of range")

    if pps.slice_chroma_qp_offsets_present:
        sh.cb_qp_offset = r.se()
        sh.cr_qp_offset = r.se()
        if sps.joint_cbcr_enabled:
            sh.joint_cbcr_qp_offset = r.se()
    if pps.cu_chroma_qp_offset_list_enabled:
        sh.cu_chroma_qp_offset_enabled = r.flag()

    if sps.sao_enabled and not pps.sao_info_in_ph:
        sh.sao_enabled_luma = r.flag()
        if chroma:
            sh.sao_enabled_chroma = r.flag()

    if pps.deblocking_filter_override_enabled and not pps.dbf_info_in_ph:
        sh.deblocking_override = r.flag()
    sh.deblocking_disabled = (False if (pps.deblocking_filter_disabled and sh.deblocking_override)
                              else ph.deblocking_disabled)
    if sh.deblocking_override:
        if not pps.deblocking_filter_disabled:
            sh.deblocking_disabled = r.flag()
        if not sh.deblocking_disabled:
            sh.beta_offset_div2 = r.se()
            sh.tc_offset_div2 = r.se()
    if sh.deblocking_override and not sh.deblocking_disabled and pps.chroma_tool_offsets_present:
        sh.cb_beta_offset_div2 = r.se()
        sh.cb_tc_offset_div2 = r.se()
        sh.cr_beta_offset_div2 = r.se()
        sh.cr_tc_offset_div2 = r.se()
    elif not (sh.deblocking_override and not sh.deblocking_disabled):
        if pps.chroma_tool_offsets_present:
            sh.cb_beta_offset_div2 = ph.cb_beta_offset_div2
            sh.cb_tc_offset_div2 = ph.cb_tc_offset_div2
            sh.cr_beta_offset_div2 = ph.cr_beta_offset_div2
            sh.cr_tc_offset_div2 = ph.cr_tc_offset_div2
        else:
            sh.cb_beta_offset_div2 = sh.cr_beta_offset_div2 = sh.beta_offset_div2
            sh.cb_tc_offset_div2 = sh.cr_tc_offset_div2 = sh.tc_offset_div2

    if sps.dep_quant_enabled:
        sh.dep_quant_used = r.flag()
    if sps.sign_data_hiding_enabled and not sh.dep_quant_used:
        sh.sign_data_hiding_used = r.flag()
    if (sps.transform_skip_enabled and not sh.dep_quant_used
            and not sh.sign_data_hiding_used):
        sh.ts_residual_coding_disabled = r.flag()

    if pps.slice_header_extension_present:
        n = r.ue()
        for _ in range(n):
            r.u(8)

    # entry points
    num_entry_points = _num_entry_points(sps, pps, sh)
    if num_entry_points > 0:
        offset_len = r.ue() + 1
        sh.entry_point_offsets = [r.u(offset_len) + 1 for _ in range(num_entry_points)]

    # byte_alignment()
    _check(r.u(1) == 1, "sh alignment_bit_equal_to_one != 1")
    while not r.byte_aligned():
        _check(r.u(1) == 0, "sh alignment_bit_equal_to_zero != 0")
    sh.data_offset_bits = r.pos
    return sh, ph


def _num_entry_points(sps: SPS, pps: PPS, sh: SliceHeader) -> int:
    """Parity: Slice::setNumEntryPoints (vvdec Slice.cpp)."""
    if not sps.entry_point_offsets_present:
        return 0
    n = 0
    w = pps.pic_width_in_ctu
    prev = None
    for addr in sh.ctu_addrs:
        x, y = addr % w, addr // w
        if prev is not None:
            px, py = prev
            same_tile = (pps.ctu_to_tile_col[x] == pps.ctu_to_tile_col[px]
                         and pps.ctu_to_tile_row[y] == pps.ctu_to_tile_row[py])
            if not same_tile or (sps.entropy_coding_sync_enabled and y != py):
                n += 1
        prev = (x, y)
    return n


class ParameterSetManager:
    """Slot-keyed storage of SPS/PPS/APS.  Parity: vvdec ParameterSetManager
    (source/Lib/CommonLib/ParameterSetManager.h:56-159)."""

    def __init__(self) -> None:
        self.sps: dict[int, SPS] = {}
        self.pps: dict[int, PPS] = {}
        self.aps: dict[tuple[int, int], object] = {}  # (type, id)
        self.vps: dict[int, VPS] = {}
        self.dci: DCI | None = None

    def store_sps(self, sps: SPS) -> None:
        self.sps[sps.sps_id] = sps

    def store_vps(self, vps: VPS) -> None:
        self.vps[vps.vps_id] = vps

    def get_vps(self, vps_id: int) -> VPS | None:
        return self.vps.get(vps_id)

    def store_dci(self, dci: DCI) -> None:
        """First DCI is kept; repeats must be identical
        (DecLibParser::xDecodeDCI, DecLibParser.cpp:1536-1551)."""
        if self.dci is None:
            self.dci = dci
        elif not self.dci.same_as(dci):
            raise HlsError("two signalled DCIs are different")

    def store_pps(self, pps: PPS) -> None:
        self.pps[pps.pps_id] = pps

    def store_aps(self, aps) -> None:
        self.aps[(aps.aps_type, aps.aps_id)] = aps

    def get_sps(self, sps_id: int) -> SPS | None:
        return self.sps.get(sps_id)

    def get_pps(self, pps_id: int) -> PPS | None:
        return self.pps.get(pps_id)

    def get_aps(self, aps_type: int, aps_id: int):
        return self.aps.get((aps_type, aps_id))
