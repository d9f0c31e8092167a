"""HLS writers: SPS / PPS / slice-header emitters consuming the same
dataclasses the parser produces.  Only the constrained feature set used by the
test encoder is supported; anything else raises.

The syntax order mirrors refdec.hls.reader (H.266 clause 7.3), so
writer+reader round-trip tests pin both against each other, and the reference
vvdec binary pins them against the standard.
"""

from __future__ import annotations

import math

from refdec.bitstream.nal import NalUnitType, rbsp_to_ebsp
from refdec.hls.params import CHROMA_400, CHROMA_420, I_SLICE, PPS, SPS, PicHeader, SliceHeader
from refdec.testenc.bitwriter import BitWriter


def _unsupported(cond: bool, what: str) -> None:
    if cond:
        raise NotImplementedError(f"test encoder does not support {what}")


def write_ptl(w: BitWriter, sps: SPS) -> None:
    ptl = sps.ptl
    w.u(ptl.profile_idc, 7)
    w.u(ptl.tier_flag, 1)
    w.u(ptl.level_idc, 8)
    w.flag(ptl.frame_only_constraint_flag)
    w.flag(False)  # ptl_multilayer_enabled_flag
    w.flag(False)  # gci_present_flag
    w.byte_align(0)  # gci alignment
    for _ in range(sps.max_sublayers - 1):
        w.flag(False)  # sub_layer_level_present_flag
    w.byte_align(0)  # ptl_reserved
    w.u(0, 8)  # ptl_num_sub_profiles


def _write_general_timing_hrd(w, hrd: dict) -> None:
    w.u(hrd["num_units_in_tick"], 32)
    w.u(hrd["time_scale"], 32)
    w.flag(hrd["nal_hrd"])
    w.flag(hrd["vcl_hrd"])
    if hrd["nal_hrd"] or hrd["vcl_hrd"]:
        w.flag(hrd.get("same_pic_timing_in_all_ols", False))
        w.flag(hrd["du_hrd"])
        if hrd["du_hrd"]:
            w.u(hrd["tick_divisor"] - 2, 8)
        w.u(hrd["bit_rate_scale"], 4)
        w.u(hrd["cpb_size_scale"], 4)
        if hrd["du_hrd"]:
            w.u(hrd["cpb_size_du_scale"], 4)
        w.ue(hrd["cpb_cnt"] - 1)


def _write_sublayer_hrd(w, hrd: dict, entries: list) -> None:
    for e in entries:
        w.ue(e["bit_rate_value"] - 1)
        w.ue(e["cpb_size_value"] - 1)
        if hrd["du_hrd"]:
            w.ue(e["cpb_size_du_value"] - 1)
            w.ue(e["bit_rate_du_value"] - 1)
        w.flag(e["cbr"])


def _write_ols_timing_hrd(w, hrd: dict, sublayers: dict) -> None:
    for i in sorted(sublayers):
        sl = sublayers[i]
        w.flag(sl["fixed_pic_rate_general"])
        if not sl["fixed_pic_rate_general"]:
            w.flag(sl["fixed_pic_rate_within_cvs"])
        if sl["fixed_pic_rate_within_cvs"]:
            w.ue(sl["elemental_duration_in_tc"] - 1)
        elif (hrd["nal_hrd"] or hrd["vcl_hrd"]) and hrd["cpb_cnt"] == 1:
            w.flag(sl.get("low_delay_hrd", False))
        if hrd["nal_hrd"]:
            _write_sublayer_hrd(w, hrd, sl["nal"])
        if hrd["vcl_hrd"]:
            _write_sublayer_hrd(w, hrd, sl["vcl"])


def _vui_payload_bytes(v: dict) -> bytes:
    """Serialize vui_parameters() + payload trailing bits (spec 7.3.6)."""
    from refdec.testenc.bitwriter import BitWriter
    w = BitWriter()
    w.flag(v.get("progressive_source", False))
    w.flag(v.get("interlaced_source", False))
    w.flag(v.get("non_packed_constraint", False))
    w.flag(v.get("non_projected_constraint", False))
    has_ar = "aspect_ratio_idc" in v
    w.flag(has_ar)
    if has_ar:
        w.flag(v.get("aspect_ratio_constant", True))
        w.u(v["aspect_ratio_idc"], 8)
        if v["aspect_ratio_idc"] == 255:
            w.u(v["sar_width"], 16)
            w.u(v["sar_height"], 16)
    has_os = "overscan_appropriate" in v
    w.flag(has_os)
    if has_os:
        w.flag(v["overscan_appropriate"])
    has_cd = "colour_primaries" in v
    w.flag(has_cd)
    if has_cd:
        w.u(v["colour_primaries"], 8)
        w.u(v["transfer_characteristics"], 8)
        w.u(v["matrix_coeffs"], 8)
        w.flag(v.get("full_range", False))
    has_cl = ("chroma_sample_loc_type" in v
              or "chroma_sample_loc_type_top" in v)
    w.flag(has_cl)
    if has_cl:
        if v.get("progressive_source") and not v.get("interlaced_source"):
            w.ue(v["chroma_sample_loc_type"])
        else:
            w.ue(v["chroma_sample_loc_type_top"])
            w.ue(v["chroma_sample_loc_type_bottom"])
    # vui_payload trailing: bit_equal_to_one + zero-pad to the byte
    w.u(1, 1)
    w.byte_align(0)
    return w.bytes()


def write_dci(w: BitWriter, sps: SPS) -> None:
    """decoding_capability_information() with one PTL (spec 7.3.2.1)."""
    import types
    w.u(0, 4)   # dci_reserved_zero_4bits
    w.u(0, 4)   # dci_num_ptls_minus1
    write_ptl(w, types.SimpleNamespace(ptl=sps.ptl, max_sublayers=1))
    w.flag(False)  # dci_extension_flag
    w.u(1, 1)      # rbsp_stop_one_bit
    w.byte_align(0)


def write_vps(w: BitWriter, sps: SPS, vps_id: int = 1) -> None:
    """Single-layer video_parameter_set_rbsp() (spec 7.3.2.3)."""
    import types
    w.u(vps_id, 4)
    w.u(0, 6)   # vps_max_layers_minus1
    w.u(0, 3)   # vps_max_sublayers_minus1
    w.u(0, 6)   # vps_layer_id[0]
    # single layer: no OLS section; vps_num_ptls == 1, pt present, aligned
    w.byte_align(0)
    write_ptl(w, types.SimpleNamespace(ptl=sps.ptl, max_sublayers=1))
    # single-layer stream: TotalNumOlss == 1, vps_num_ptls == 1 -> no
    # ols_ptl_idx; each_layer_is_an_ols -> no DPB/HRD tables
    w.flag(False)  # vps_extension_flag
    w.u(1, 1)      # rbsp_stop_one_bit
    w.byte_align(0)


def write_sps(w: BitWriter, sps: SPS) -> None:
    _unsupported(sps.max_sublayers != 1, "sublayers")
    _unsupported(sps.vps_id != 0, "VPS")
    _unsupported(sps.poc_msb_cycle_flag, "poc msb cycle")
    _unsupported(sps.ladf_enabled, "LADF")
    _unsupported(bool(sps.extra_ph_bit_present) or bool(sps.extra_sh_bit_present),
                 "extra PH/SH bits")

    w.u(sps.sps_id, 4)
    w.u(0, 4)  # vps id
    w.u(sps.max_sublayers - 1, 3)
    w.u(sps.chroma_format_idc, 2)
    w.u(sps.ctu_log2 - 5, 2)
    w.flag(True)  # ptl_dpb_hrd_params_present
    write_ptl(w, sps)
    w.flag(sps.gdr_enabled)
    w.flag(sps.rpr_enabled)
    if sps.rpr_enabled:
        w.flag(sps.res_change_in_clvs_allowed)
    w.ue(sps.pic_width_max)
    w.ue(sps.pic_height_max)
    have_conf = any(sps.conf_win)
    w.flag(have_conf)
    if have_conf:
        for v in sps.conf_win:
            w.ue(v)
    # subpicture info (mirrors parse_sps subpic block)
    subpic_present = sps.subpic_info_present or sps.num_subpics > 1
    w.flag(subpic_present)
    if subpic_present:
        ctb = sps.ctu_size
        w_ctbs = (sps.pic_width_max + ctb - 1) // ctb
        h_ctbs = (sps.pic_height_max + ctb - 1) // ctb
        w.ue(sps.num_subpics - 1)
        if sps.num_subpics > 1:
            w.flag(sps.independent_subpics)
            w.flag(False)  # sps_subpic_same_size_flag
            cl2w = max(1, math.ceil(math.log2(w_ctbs))) if w_ctbs > 1 else 0
            cl2h = max(1, math.ceil(math.log2(h_ctbs))) if h_ctbs > 1 else 0
            for i in range(sps.num_subpics):
                x, y = sps.subpic_ctu_top_left[i]
                sw, sh_ = sps.subpic_size_ctus[i]
                if i > 0 and sps.pic_width_max > ctb:
                    w.u(x, cl2w)
                if i > 0 and sps.pic_height_max > ctb:
                    w.u(y, cl2h)
                if i < sps.num_subpics - 1 and sps.pic_width_max > ctb:
                    w.u(sw - 1, cl2w)
                if i < sps.num_subpics - 1 and sps.pic_height_max > ctb:
                    w.u(sh_ - 1, cl2h)
                if not sps.independent_subpics:
                    w.flag(sps.subpic_treated_as_pic[i])
                    w.flag(sps.loop_filter_across_subpic[i])
        w.ue(sps.subpic_id_len - 1)
        w.flag(False)  # subpic_id_mapping_explicitly_signalled
    w.ue(sps.bit_depth - 8)
    w.flag(sps.entropy_coding_sync_enabled)
    w.flag(sps.entry_point_offsets_present)
    w.u(sps.log2_max_poc_lsb - 4, 4)
    w.flag(False)  # poc_msb_cycle_flag
    w.u(0, 2)  # num_extra_ph_bytes
    w.u(0, 2)  # num_extra_sh_bytes
    # dpb_parameters (one sublayer)
    w.ue(sps.max_dec_pic_buffering[0] - 1)
    w.ue(sps.num_reorder_pics[0])
    w.ue(sps.max_latency_increase_plus1[0])
    w.ue(sps.log2_min_cb_size - 2)
    w.flag(sps.partition_constraints_override_enabled)

    min_cb_log2 = sps.log2_min_cb_size

    def log2(x: int) -> int:
        return x.bit_length() - 1

    w.ue(log2(sps.min_qt_size[0]) - min_cb_log2)
    w.ue(sps.max_mtt_depth[0])
    if sps.max_mtt_depth[0] != 0:
        w.ue(log2(sps.max_bt_size[0]) - log2(sps.min_qt_size[0]))
        w.ue(log2(sps.max_tt_size[0]) - log2(sps.min_qt_size[0]))
    if sps.chroma_format_idc != CHROMA_400:
        w.flag(sps.dual_tree_intra)
    if sps.dual_tree_intra:
        w.ue(log2(sps.min_qt_size[2]) - min_cb_log2)
        w.ue(sps.max_mtt_depth[2])
        if sps.max_mtt_depth[2] != 0:
            w.ue(log2(sps.max_bt_size[2]) - log2(sps.min_qt_size[2]))
            w.ue(log2(sps.max_tt_size[2]) - log2(sps.min_qt_size[2]))
    w.ue(log2(sps.min_qt_size[1]) - min_cb_log2)
    w.ue(sps.max_mtt_depth[1])
    if sps.max_mtt_depth[1] != 0:
        w.ue(log2(sps.max_bt_size[1]) - log2(sps.min_qt_size[1]))
        w.ue(log2(sps.max_tt_size[1]) - log2(sps.min_qt_size[1]))
    if sps.ctu_size > 32:
        w.u(sps.log2_max_tb_size - 5, 1)
    w.flag(sps.transform_skip_enabled)
    if sps.transform_skip_enabled:
        w.ue(sps.log2_max_ts_size - 2)
        w.flag(sps.bdpcm_enabled)
    w.flag(sps.mts_enabled)
    if sps.mts_enabled:
        w.flag(sps.explicit_mts_intra)
        w.flag(sps.explicit_mts_inter)
    w.flag(sps.lfnst_enabled)
    if sps.chroma_format_idc != CHROMA_400:
        w.flag(sps.joint_cbcr_enabled)
        tab = sps.chroma_qp_table
        w.flag(tab.same_qp_table_for_chroma)
        for i in range(tab.num_qp_tables):
            w.se(tab.qp_table_start_minus26[i])
            w.ue(len(tab.delta_qp_in_val_minus1[i]) - 1)
            for j in range(len(tab.delta_qp_in_val_minus1[i])):
                d_in = tab.delta_qp_in_val_minus1[i][j]
                w.ue(d_in)
                w.ue(tab.delta_qp_out_val[i][j] ^ d_in)
    w.flag(sps.sao_enabled)
    w.flag(sps.alf_enabled)
    if sps.alf_enabled and sps.chroma_format_idc != CHROMA_400:
        w.flag(sps.ccalf_enabled)
    w.flag(sps.lmcs_enabled)
    w.flag(sps.weighted_pred)
    w.flag(sps.weighted_bipred)
    w.flag(sps.long_term_ref_pics)
    w.flag(sps.idr_rpl_present)
    w.flag(sps.rpl1_same_as_rpl0)
    for i in range(1 if sps.rpl1_same_as_rpl0 else 2):
        w.ue(len(sps.rpl_lists[i]))
        for j, rpl in enumerate(sps.rpl_lists[i]):
            write_ref_pic_list(w, sps, rpl, j)
    w.flag(sps.ref_wraparound_enabled)
    w.flag(sps.temporal_mvp_enabled)
    if sps.temporal_mvp_enabled:
        w.flag(sps.sbtmvp_enabled)
    w.flag(sps.amvr_enabled)
    w.flag(sps.bdof_enabled)
    if sps.bdof_enabled:
        w.flag(sps.bdof_control_present_in_ph)
    w.flag(sps.smvd_enabled)
    w.flag(sps.dmvr_enabled)
    if sps.dmvr_enabled:
        w.flag(sps.dmvr_control_present_in_ph)
    w.flag(sps.mmvd_enabled)
    if sps.mmvd_enabled:
        w.flag(sps.mmvd_fullpel_only)
    w.ue(6 - sps.max_num_merge_cand)
    w.flag(sps.sbt_enabled)
    w.flag(sps.affine_enabled)
    if sps.affine_enabled:
        w.ue(5 - sps.max_num_affine_merge_cand)
        w.flag(sps.affine_6param)
        if sps.amvr_enabled:
            w.flag(sps.affine_amvr)
        w.flag(sps.prof_enabled)
        if sps.prof_enabled:
            w.flag(sps.prof_control_present_in_ph)
    w.flag(sps.bcw_enabled)
    w.flag(sps.ciip_enabled)
    if sps.max_num_merge_cand >= 2:
        w.flag(sps.gpm_enabled)
        if sps.gpm_enabled and sps.max_num_merge_cand >= 3:
            w.ue(sps.max_num_merge_cand - sps.max_num_gpm_cand)
    w.ue(sps.log2_parallel_merge_level - 2)
    w.flag(sps.isp_enabled)
    w.flag(sps.mrl_enabled)
    w.flag(sps.mip_enabled)
    if sps.chroma_format_idc != CHROMA_400:
        w.flag(sps.cclm_enabled)
    if sps.chroma_format_idc == CHROMA_420:
        w.flag(sps.chroma_hor_collocated)
        w.flag(sps.chroma_ver_collocated)
    w.flag(False)  # palette
    from refdec.hls.params import CHROMA_444
    if sps.chroma_format_idc == CHROMA_444 and sps.log2_max_tb_size != 6:
        w.flag(sps.act_enabled)
    if sps.transform_skip_enabled:
        w.ue(sps.internal_minus_input_bit_depth)
    w.flag(sps.ibc_enabled)
    if sps.ibc_enabled:
        w.ue(6 - sps.max_num_ibc_merge_cand)
    w.flag(False)  # ladf
    w.flag(sps.explicit_scaling_list_enabled)
    if sps.lfnst_enabled and sps.explicit_scaling_list_enabled:
        w.flag(sps.scaling_matrix_for_lfnst_disabled)
    if sps.act_enabled and sps.explicit_scaling_list_enabled:
        w.flag(sps.scaling_matrix_for_alt_cs_disabled)
        if sps.scaling_matrix_for_alt_cs_disabled:
            w.flag(sps.scaling_matrix_designated_cs)
    w.flag(sps.dep_quant_enabled)
    w.flag(sps.sign_data_hiding_enabled)
    w.flag(sps.virtual_boundaries_enabled)
    if sps.virtual_boundaries_enabled:
        w.flag(sps.virtual_boundaries_present)
        if sps.virtual_boundaries_present:
            xs = getattr(sps, "virtual_boundary_pos_x", [])
            ys = getattr(sps, "virtual_boundary_pos_y", [])
            w.ue(len(xs))
            for v in xs:
                w.ue((v >> 3) - 1)
            w.ue(len(ys))
            for v in ys:
                w.ue((v >> 3) - 1)
    w.flag(sps.timing_hrd_params_present)
    if sps.timing_hrd_params_present:
        _write_general_timing_hrd(w, sps.hrd_params)
        # sps.max_sublayers == 1: no sublayer_cpb_params flag; OLS HRD
        # covers the single (highest) sublayer only
        _write_ols_timing_hrd(w, sps.hrd_params,
                              sps.hrd_params["ols"]["sublayers"])
    w.flag(sps.field_seq_flag)
    w.flag(sps.vui_present)
    if sps.vui_present:
        payload = _vui_payload_bytes(sps.vui)
        w.ue(len(payload) - 1)
        w.byte_align(0)  # sps_vui_alignment_zero_bit
        for b in payload:
            w.u(b, 8)
    w.flag(False)  # sps_extension
    w.rbsp_trailing()


def write_ref_pic_list(w: BitWriter, sps: SPS, rpl, rpl_idx: int) -> None:
    w.ue(rpl.num_ref_entries)
    if sps.long_term_ref_pics and rpl.num_ref_entries > 0 and rpl_idx != -1:
        w.flag(rpl.ltrp_in_header_flag)
    prev_delta = 0
    for ii, e in enumerate(rpl.entries):
        _unsupported(e.is_inter_layer, "inter-layer refs")
        if sps.long_term_ref_pics:
            w.flag(not e.is_long_term)
        if not e.is_long_term:
            delta = e.value - prev_delta
            prev_delta = e.value
            abs_delta = abs(delta)
            v = abs_delta
            if (not sps.weighted_pred and not sps.weighted_bipred) or ii == 0:
                assert v >= 1
                v -= 1
            w.ue(v)
            if abs_delta > 0:
                w.flag(delta < 0)
        else:
            if not rpl.ltrp_in_header_flag:
                w.u(e.value, sps.log2_max_poc_lsb)


def write_pps(w: BitWriter, pps: PPS, sps: SPS) -> None:
    _unsupported(pps.subpic_id_mapping_present, "pps subpic ids")
    _unsupported(pps.cu_chroma_qp_offset_list_enabled, "chroma qp offset lists")

    w.u(pps.pps_id, 6)
    w.u(pps.sps_id, 4)
    w.flag(pps.mixed_nalu_types)
    w.ue(pps.pic_width)
    w.ue(pps.pic_height)
    w.flag(pps.conformance_window_present)
    if pps.conformance_window_present:
        for v in pps.conf_win:
            w.ue(v)
    have_scaling = pps.scaling_win != pps.conf_win
    w.flag(have_scaling)  # scaling_window_explicit
    if have_scaling:
        for v in pps.scaling_win:
            w.se(v)
    w.flag(pps.output_flag_present)
    w.flag(pps.no_pic_partition)
    w.flag(False)  # subpic_id_mapping
    if not pps.no_pic_partition:
        w.u(sps.ctu_log2 - 5, 2)
        w.ue(pps.num_exp_tile_cols - 1)
        w.ue(pps.num_exp_tile_rows - 1)
        for i in range(pps.num_exp_tile_cols):
            w.ue(pps.tile_col_widths[i] - 1)
        for i in range(pps.num_exp_tile_rows):
            w.ue(pps.tile_row_heights[i] - 1)
        # derive tile count the same way the parser does
        import copy as _copy
        tmp = _copy.deepcopy(pps)
        tmp.finalize(sps)
        num_tiles = tmp.num_tile_cols * tmp.num_tile_rows
        if num_tiles > 1:
            w.flag(pps.loop_filter_across_tiles)
            w.flag(pps.rect_slice)
        if pps.rect_slice:
            w.flag(pps.single_slice_per_subpic)
        if pps.rect_slice and not pps.single_slice_per_subpic:
            # tile-aligned slices in implied walk order (no tile_idx_delta,
            # no sub-tile slices) — mirrors the parse loop in
            # refdec/hls/reader.py (parsePPS rect-slice layout)
            n = pps.num_slices_in_pic
            w.ue(n - 1)
            if n - 1 > 1:
                _unsupported(pps.tile_idx_delta_present, "tile_idx_delta")
                w.flag(False)
            cols, rows = tmp.num_tile_cols, tmp.num_tile_rows
            tile_idx = 0
            s = 0
            while s < n - 1:
                if pps.slice_top_left_tile_idx[s] != tile_idx:
                    raise NotImplementedError(
                        "rect slices out of implied walk order")
                sw = pps.slice_width_in_tiles[s]
                sh_t = pps.slice_height_in_tiles[s]
                if tile_idx % cols != cols - 1:
                    w.ue(sw - 1)
                elif sw != 1:
                    raise ValueError("slice width must be 1 in last column")
                if (tile_idx // cols != rows - 1
                        and (tile_idx % cols == 0)):
                    w.ue(sh_t - 1)
                if sw == 1 and sh_t == 1:
                    row_h = tmp.tile_row_bd[tile_idx // cols + 1] \
                        - tmp.tile_row_bd[tile_idx // cols]
                    if row_h > 1:
                        w.ue(0)  # whole-tile slice (no sub-tile splits)
                tile_idx += sw
                if tile_idx % cols == 0:
                    tile_idx += (sh_t - 1) * cols
                s += 1
        if not pps.rect_slice or pps.single_slice_per_subpic or pps.num_slices_in_pic > 1:
            w.flag(pps.loop_filter_across_slices)
    w.flag(pps.cabac_init_present)
    w.ue(pps.num_ref_idx_default_active[0] - 1)
    w.ue(pps.num_ref_idx_default_active[1] - 1)
    w.flag(pps.rpl1_idx_present)
    w.flag(pps.weighted_pred)
    w.flag(pps.weighted_bipred)
    w.flag(pps.ref_wraparound_enabled)
    if pps.ref_wraparound_enabled:
        w.ue(pps.pic_width_minus_wraparound_offset)
    w.se(pps.init_qp - 26)
    w.flag(pps.cu_qp_delta_enabled)
    w.flag(pps.chroma_tool_offsets_present)
    if pps.chroma_tool_offsets_present:
        w.se(pps.cb_qp_offset)
        w.se(pps.cr_qp_offset)
        w.flag(pps.joint_cbcr_qp_offset_present)
        if pps.joint_cbcr_qp_offset_present:
            w.se(pps.joint_cbcr_qp_offset)
        w.flag(pps.slice_chroma_qp_offsets_present)
        w.flag(False)  # cu_chroma_qp_offset_list
    w.flag(pps.deblocking_filter_control_present)
    if pps.deblocking_filter_control_present:
        w.flag(pps.deblocking_filter_override_enabled)
        w.flag(pps.deblocking_filter_disabled)
        if not pps.no_pic_partition and pps.deblocking_filter_override_enabled:
            w.flag(pps.dbf_info_in_ph)
        if not pps.deblocking_filter_disabled:
            w.se(pps.beta_offset_div2)
            w.se(pps.tc_offset_div2)
            if pps.chroma_tool_offsets_present:
                w.se(pps.cb_beta_offset_div2)
                w.se(pps.cb_tc_offset_div2)
                w.se(pps.cr_beta_offset_div2)
                w.se(pps.cr_tc_offset_div2)
    if not pps.no_pic_partition:
        w.flag(pps.rpl_info_in_ph)
        w.flag(pps.sao_info_in_ph)
        w.flag(pps.alf_info_in_ph)
        if (pps.weighted_pred or pps.weighted_bipred) and pps.rpl_info_in_ph:
            w.flag(pps.wp_info_in_ph)
        w.flag(pps.qp_delta_info_in_ph)
    w.flag(False)  # ph extension
    w.flag(False)  # sh extension
    w.flag(False)  # pps extension
    w.rbsp_trailing()


def write_picture_header(w: BitWriter, ph: PicHeader, sps: SPS, pps: PPS) -> None:
    _unsupported(ph.gdr_pic, "GDR pictures")
    w.flag(ph.gdr_or_irap_pic)
    w.flag(ph.non_ref_pic)
    if ph.gdr_or_irap_pic:
        w.flag(False)  # gdr_pic_flag
    w.flag(ph.inter_slice_allowed)
    if ph.inter_slice_allowed:
        w.flag(ph.intra_slice_allowed)
    w.ue(ph.pps_id)
    w.u(ph.poc_lsb, sps.log2_max_poc_lsb)
    _unsupported(sps.alf_enabled and pps.alf_info_in_ph, "alf info in PH")
    if sps.lmcs_enabled:
        w.flag(ph.lmcs_enabled)
        if ph.lmcs_enabled:
            w.u(ph.lmcs_aps_id, 2)
            if sps.chroma_format_idc != CHROMA_400:
                w.flag(ph.chroma_residual_scale)
    if sps.explicit_scaling_list_enabled:
        w.flag(ph.explicit_scaling_list_enabled)
        if ph.explicit_scaling_list_enabled:
            w.u(ph.scaling_list_aps_id, 3)
    if sps.virtual_boundaries_enabled and not sps.virtual_boundaries_present:
        vb_present = bool(getattr(ph, "virtual_boundaries_present", False))
        w.flag(vb_present)
        if vb_present:
            xs = getattr(ph, "virtual_boundary_pos_x", [])
            ys = getattr(ph, "virtual_boundary_pos_y", [])
            w.ue(len(xs))
            for x in xs:
                w.ue((x >> 3) - 1)
            w.ue(len(ys))
            for y in ys:
                w.ue((y >> 3) - 1)
    if pps.output_flag_present and not ph.non_ref_pic:
        w.flag(ph.pic_output_flag)
    if pps.rpl_info_in_ph:
        write_header_rpl(w, ph, sps, pps)
    if sps.partition_constraints_override_enabled:
        w.flag(ph.split_cons_override)
        _unsupported(ph.split_cons_override, "PH partition override")
    if ph.intra_slice_allowed:
        if pps.cu_qp_delta_enabled:
            w.ue(ph.cu_qp_delta_subdiv_intra)
    if ph.inter_slice_allowed:
        if pps.cu_qp_delta_enabled:
            w.ue(ph.cu_qp_delta_subdiv_inter)
        if sps.temporal_mvp_enabled:
            w.flag(ph.temporal_mvp_enabled)
            if ph.temporal_mvp_enabled and pps.rpl_info_in_ph:
                if ph.rpl[1].num_ref_entries > 0:
                    w.flag(ph.collocated_from_l0)
                nrefs = (ph.rpl[0] if ph.collocated_from_l0 else ph.rpl[1]).num_ref_entries
                if nrefs > 1:
                    w.ue(ph.collocated_ref_idx)
        if sps.mmvd_fullpel_only:
            w.flag(ph.fpel_mmvd)
        presence = (not pps.rpl_info_in_ph) or ph.rpl[1].num_ref_entries > 0
        if presence:
            w.flag(ph.mvd_l1_zero)
            if sps.bdof_control_present_in_ph:
                w.flag(ph.bdof_disabled)
            if sps.dmvr_control_present_in_ph:
                w.flag(ph.dmvr_disabled)
        if sps.prof_control_present_in_ph:
            w.flag(ph.prof_disabled)
        _unsupported((pps.weighted_pred or pps.weighted_bipred) and pps.wp_info_in_ph,
                     "wp info in PH")
    if pps.qp_delta_info_in_ph:
        w.se(ph.qp_delta)
    if sps.joint_cbcr_enabled:
        w.flag(ph.joint_cbcr_sign)
    if sps.sao_enabled and pps.sao_info_in_ph:
        w.flag(ph.sao_enabled_luma)
        if sps.chroma_format_idc != CHROMA_400:
            w.flag(ph.sao_enabled_chroma)
    if pps.dbf_info_in_ph:
        w.flag(ph.deblocking_override)
        _unsupported(ph.deblocking_override, "PH deblocking override")
    if pps.picture_header_extension_present:
        w.ue(0)


def write_header_rpl(w: BitWriter, header, sps: SPS, pps: PPS) -> None:
    for list_idx in (0, 1):
        n_sps = sps.num_rpl(list_idx)
        use_sps = header.rpl_idx[list_idx] >= 0
        if n_sps > 0 and (list_idx == 0 or pps.rpl1_idx_present):
            w.flag(use_sps)
        if use_sps:
            if n_sps > 1 and (list_idx == 0 or pps.rpl1_idx_present):
                nbits = math.ceil(math.log2(n_sps))
                w.u(header.rpl_idx[list_idx], nbits)
        else:
            write_ref_pic_list(w, sps, header.rpl[list_idx], -1)
        for e in header.rpl[list_idx].entries:
            if e.is_long_term and not e.is_inter_layer:
                if header.rpl[list_idx].ltrp_in_header_flag:
                    w.u(e.value, sps.log2_max_poc_lsb)
                w.flag(e.delta_poc_msb_present)
                if e.delta_poc_msb_present:
                    w.ue(e.delta_poc_msb_cycle)


def write_slice_header(w: BitWriter, sh: SliceHeader, ph: PicHeader,
                       sps: SPS, pps: PPS) -> None:
    """Write a slice header.  Assumes PH-in-SH when
    sh.picture_header_in_slice_header is set."""
    from refdec.bitstream.nal import NalUnitType

    w.flag(sh.picture_header_in_slice_header)
    if sh.picture_header_in_slice_header:
        write_picture_header(w, ph, sps, pps)
    if sps.subpic_info_present or sps.num_subpics > 1:
        w.u(sh.subpic_id, sps.subpic_id_len)
    if not pps.rect_slice:
        if pps.num_tiles > 1:
            bits = math.ceil(math.log2(pps.num_tiles))
            w.u(sh.slice_address, bits)
    else:
        # address indexes slices within the current subpicture
        # (NumSlicesInSubpic; sh.slice_address is the in-subpic index)
        idx = getattr(sh, "subpic_idx", 0)
        in_subpic = pps.slices_of_subpic[idx] \
            if idx < len(pps.slices_of_subpic) else []
        n_in_subpic = len(in_subpic) if in_subpic else pps.num_slices_in_pic
        if n_in_subpic > 1:
            bits = math.ceil(math.log2(n_in_subpic))
            w.u(sh.slice_address, bits)
    if not pps.rect_slice and pps.num_tiles - sh.slice_address > 1:
        w.ue(sh.num_tiles_in_slice - 1)
    if ph.inter_slice_allowed:
        w.ue(sh.slice_type)
    if sh.nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                       NalUnitType.CRA, NalUnitType.GDR):
        w.flag(sh.no_output_of_prior_pics)
    if sps.alf_enabled and not pps.alf_info_in_ph:
        w.flag(sh.alf_enabled[0])
        if sh.alf_enabled[0]:
            w.u(sh.num_alf_aps_ids_luma, 3)
            for a in sh.alf_aps_ids_luma:
                w.u(a, 3)
            if sps.chroma_format_idc != CHROMA_400:
                w.flag(sh.alf_enabled[1])
                w.flag(sh.alf_enabled[2])
            if sh.alf_enabled[1] or sh.alf_enabled[2]:
                w.u(sh.alf_aps_id_chroma, 3)
            if sps.ccalf_enabled:
                w.flag(sh.ccalf_cb_enabled)
                if sh.ccalf_cb_enabled:
                    w.u(sh.ccalf_cb_aps_id, 3)
                w.flag(sh.ccalf_cr_enabled)
                if sh.ccalf_cr_enabled:
                    w.u(sh.ccalf_cr_aps_id, 3)
    if ph.lmcs_enabled and not sh.picture_header_in_slice_header:
        w.flag(sh.lmcs_enabled)
    if ph.explicit_scaling_list_enabled and not sh.picture_header_in_slice_header:
        w.flag(sh.explicit_scaling_list_used)
    idr = sh.nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)
    if pps.rpl_info_in_ph:
        pass
    elif idr and not sps.idr_rpl_present:
        pass
    else:
        write_header_rpl(w, sh, sps, pps)
    if ((sh.slice_type != I_SLICE and sh.rpl[0].num_ref_entries > 1)
            or (sh.is_b and sh.rpl[1].num_ref_entries > 1)):
        w.flag(True)  # num_ref_idx_active_override
        for i in range(2 if sh.is_b else 1):
            if sh.rpl[i].num_ref_entries > 1:
                w.ue(sh.num_ref_idx_active[i] - 1)
    if not sh.is_intra:
        if pps.cabac_init_present:
            w.flag(sh.cabac_init_flag)
        if ph.temporal_mvp_enabled and not pps.rpl_info_in_ph:
            if sh.is_b:
                w.flag(sh.collocated_from_l0)
            lst = 0 if sh.collocated_from_l0 else 1
            if sh.num_ref_idx_active[lst] > 1:
                w.ue(sh.collocated_ref_idx)
        if not pps.wp_info_in_ph and ((pps.weighted_pred and sh.is_p)
                                      or (pps.weighted_bipred and sh.is_b)):
            from refdec.hls.weight_table import write_pred_weight_table
            write_pred_weight_table(w, sh.weight_table, sps, pps,
                                    sh.num_ref_idx_active)
    if not pps.qp_delta_info_in_ph:
        w.se(sh.qp_y - 26 - (pps.init_qp - 26))
    if pps.slice_chroma_qp_offsets_present:
        w.se(sh.cb_qp_offset)
        w.se(sh.cr_qp_offset)
        if sps.joint_cbcr_enabled:
            w.se(sh.joint_cbcr_qp_offset)
    if sps.sao_enabled and not pps.sao_info_in_ph:
        w.flag(sh.sao_enabled_luma)
        if sps.chroma_format_idc != CHROMA_400:
            w.flag(sh.sao_enabled_chroma)
    if pps.deblocking_filter_override_enabled and not pps.dbf_info_in_ph:
        w.flag(sh.deblocking_override)
        _unsupported(sh.deblocking_override, "slice deblocking override")
    if sps.dep_quant_enabled:
        w.flag(sh.dep_quant_used)
    if sps.sign_data_hiding_enabled and not sh.dep_quant_used:
        w.flag(sh.sign_data_hiding_used)
    if (sps.transform_skip_enabled and not sh.dep_quant_used
            and not sh.sign_data_hiding_used):
        w.flag(sh.ts_residual_coding_disabled)
    if sh.entry_point_offsets:
        offset_len = max(v - 1 for v in sh.entry_point_offsets).bit_length()
        offset_len = max(offset_len, 1)
        w.ue(offset_len - 1)
        for v in sh.entry_point_offsets:
            w.u(v - 1, offset_len)
    # byte_alignment
    w.u(1, 1)
    w.byte_align(0)


def write_lmcs_aps(w: BitWriter, aps) -> None:
    """LMCS APS RBSP (mirrors parseAPS/parseLmcsAps,
    HLSyntaxReader.cpp:855,1014)."""
    info = aps.lmcs
    w.u(aps.aps_type, 3)
    w.u(aps.aps_id, 5)
    w.flag(aps.chroma_present)
    w.ue(info.min_bin_idx)
    w.ue(15 - info.max_bin_idx)
    w.ue(info.delta_cw_prec - 1)
    for i in range(info.min_bin_idx, info.max_bin_idx + 1):
        v = info.cw_delta[i]
        w.u(abs(v), info.delta_cw_prec)
        if v:
            w.flag(v < 0)
    if aps.chroma_present:
        w.u(abs(info.crs_offset), 3)
        if info.crs_offset:
            w.flag(info.crs_offset < 0)
    w.flag(False)  # aps_extension_flag
    w.u(1, 1)      # rbsp_stop_one_bit
    w.byte_align(0)


def write_scaling_aps(w: BitWriter, aps) -> None:
    """Scaling-list APS RBSP (mirrors parseAPS/parseScalingListAps,
    HLSyntaxReader.cpp:855,1056)."""
    from refdec.hls.scaling_list import write_scaling_list
    w.u(aps.aps_type, 3)
    w.u(aps.aps_id, 5)
    w.flag(aps.chroma_present)
    write_scaling_list(w, aps.scaling_list, aps.chroma_present)
    w.flag(False)  # aps_extension_flag
    w.u(1, 1)      # rbsp_stop_one_bit
    w.byte_align(0)


def make_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0,
             long_start_code: bool = True) -> bytes:
    """Wrap an RBSP payload into an Annex-B NAL unit."""
    hdr = bytes([0, (int(nal_type) << 3) | (temporal_id + 1)])
    sc = b"\x00\x00\x00\x01" if long_start_code else b"\x00\x00\x01"
    return sc + hdr + rbsp_to_ebsp(rbsp)
