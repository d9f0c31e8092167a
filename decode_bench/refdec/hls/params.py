"""High-level-syntax parameter objects (SPS/PPS/APS/PicHeader/SliceHeader).

Field names follow the H.266 syntax element names (minus the sps_/pps_/ph_/sh_
prefixes).  Behavioral parity: vvdec Slice.h parameter-set classes
(source/Lib/CommonLib/Slice.h:928-2826) — re-designed as plain dataclasses; the
decoder derives per-frame tensor metadata from these on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

# Chroma format idc values
CHROMA_400, CHROMA_420, CHROMA_422, CHROMA_444 = 0, 1, 2, 3

# APS types (vvdec ApsType, Slice.h)
ALF_APS, LMCS_APS, SCALING_LIST_APS = 0, 1, 2
PIC_CODE_CW_BINS = 16

MRG_MAX_NUM_CANDS = 6
AFFINE_MRG_MAX_NUM_CANDS = 5
IBC_MRG_MAX_NUM_CANDS = 6
MAX_NUM_REF_PICS = 29
MAX_QP = 63

# slice types (H.266 sh_slice_type)
B_SLICE, P_SLICE, I_SLICE = 0, 1, 2


def sub_wh(chroma_format_idc: int) -> tuple[int, int]:
    """(SubWidthC, SubHeightC) for a chroma format."""
    return {
        CHROMA_400: (1, 1),
        CHROMA_420: (2, 2),
        CHROMA_422: (2, 1),
        CHROMA_444: (1, 1),
    }[chroma_format_idc]


@dataclass
class ConstraintInfo:
    """general_constraints_info() — all false by default (gci_present_flag=0)."""

    gci_present_flag: bool = False
    # Only the flags the decoder acts on are kept individually; the rest are
    # parsed for bit-position correctness and retained as a dict.
    flags: dict = field(default_factory=dict)

    def get(self, name: str) -> bool:
        return bool(self.flags.get(name, False))


@dataclass
class ProfileTierLevel:
    profile_idc: int = 1  # Main 10
    tier_flag: int = 0
    level_idc: int = 51
    frame_only_constraint_flag: bool = True
    multilayer_enabled_flag: bool = False
    constraint_info: ConstraintInfo = field(default_factory=ConstraintInfo)
    sub_layer_level_present: list[bool] = field(default_factory=list)
    sub_layer_level_idc: list[int] = field(default_factory=list)
    num_sub_profiles: int = 0
    sub_profile_idc: list[int] = field(default_factory=list)


@dataclass
class RefPicEntry:
    """One entry of a ref_pic_list_struct."""

    is_long_term: bool = False
    is_inter_layer: bool = False
    # short-term: cumulative delta POC; long-term: poc_lsb_lt; inter-layer: ilrp_idx
    value: int = 0
    # slice/PH-level LTRP additions
    delta_poc_msb_present: bool = False
    delta_poc_msb_cycle: int = 0


@dataclass
class RefPicList:
    entries: list[RefPicEntry] = field(default_factory=list)
    ltrp_in_header_flag: bool = False
    inter_layer_present: bool = False

    @property
    def num_ref_entries(self) -> int:
        return len(self.entries)

    @property
    def num_short_term(self) -> int:
        return sum(1 for e in self.entries if not e.is_long_term and not e.is_inter_layer)

    @property
    def num_long_term(self) -> int:
        return sum(1 for e in self.entries if e.is_long_term)

    def copy(self) -> "RefPicList":
        return RefPicList(
            entries=[RefPicEntry(e.is_long_term, e.is_inter_layer, e.value,
                                 e.delta_poc_msb_present, e.delta_poc_msb_cycle)
                     for e in self.entries],
            ltrp_in_header_flag=self.ltrp_in_header_flag,
            inter_layer_present=self.inter_layer_present,
        )


@dataclass
class LmcsInfo:
    """LMCS (reshaper) model from an LMCS APS (vvdec SliceReshapeInfo,
    Slice.h; parseLmcsAps HLSyntaxReader.cpp:1014)."""
    min_bin_idx: int = 0
    max_bin_idx: int = PIC_CODE_CW_BINS - 1
    delta_cw_prec: int = 1  # maxNbitsNeededDeltaCW
    cw_delta: list[int] = field(
        default_factory=lambda: [0] * PIC_CODE_CW_BINS)
    crs_offset: int = 0     # chroma residual scaling offset (lmcsDeltaCrs)


@dataclass
class APS:
    """Adaptation parameter set container (vvdec APS, Slice.h:2168)."""
    aps_type: int = 0
    aps_id: int = 0
    chroma_present: bool = False
    lmcs: LmcsInfo | None = None
    alf: object | None = None
    cc_alf: object | None = None
    scaling_list: object | None = None


@dataclass
class DCI:
    """Decoding capability information (vvdec DCI, Slice.h; parseDCI
    HLSyntaxReader.cpp:2318)."""
    ptls: list[ProfileTierLevel] = field(default_factory=list)

    def same_as(self, other: "DCI") -> bool:
        """Identity check for repeated DCI NALs (DCI::IsIndenticalDCI):
        the reference compares profile/tier/level triples."""
        if len(self.ptls) != len(other.ptls):
            return False
        return all(
            (a.profile_idc, a.tier_flag, a.level_idc)
            == (b.profile_idc, b.tier_flag, b.level_idc)
            for a, b in zip(self.ptls, other.ptls))


@dataclass
class VPS:
    """Video parameter set (H.266 7.3.2.3).  The reference keeps VPS
    handling minimal (parseVPS is compiled out, DecLibParser.cpp:1525);
    this build parses the layer/OLS head so multilayer streams are
    rejected cleanly and single-layer VPS-bearing streams decode."""
    vps_id: int = 0
    max_layers: int = 1
    max_sublayers: int = 1
    layer_id: list[int] = field(default_factory=list)
    independent_layer: list[bool] = field(default_factory=list)
    all_independent_layers: bool = True
    each_layer_is_an_ols: bool = True
    ols_mode_idc: int = 0
    ptls: list[ProfileTierLevel] = field(default_factory=list)


@dataclass
class ChromaQpTable:
    """sps chroma QP mapping table (derived full LUT per table)."""

    same_qp_table_for_chroma: bool = True
    num_qp_tables: int = 1
    qp_table_start_minus26: list[int] = field(default_factory=list)
    delta_qp_in_val_minus1: list[list[int]] = field(default_factory=list)
    delta_qp_out_val: list[list[int]] = field(default_factory=list)
    qp_bd_offset: int = 12
    # derived: full mapping arrays qpInVal -> qpOutVal, index = qp + qp_bd_offset
    tables: list[list[int]] = field(default_factory=list)

    def derive(self) -> None:
        """Derive the full chroma QP mapping LUTs (H.266 eq. 7-31..7-33).

        Parity: vvdec ChromaQpMappingTable::deriveChromaQPMappingTables
        (Slice.cpp)."""
        self.tables = []
        off = self.qp_bd_offset
        for i in range(self.num_qp_tables):
            start = self.qp_table_start_minus26[i] + 26
            n = len(self.delta_qp_in_val_minus1[i])
            qp_in = [start]
            qp_out = [start]
            for j in range(n):
                qp_in.append(qp_in[-1] + self.delta_qp_in_val_minus1[i][j] + 1)
                qp_out.append(qp_out[-1] + self.delta_qp_out_val[i][j])
            # build full table over [-off, 63]
            tab = [0] * (64 + off)

            def idx(qp: int) -> int:
                return qp + off

            tab[idx(qp_in[0])] = qp_out[0]
            for k in range(qp_in[0] - 1, -off - 1, -1):
                tab[idx(k)] = max(-off, min(63, tab[idx(k + 1)] - 1))
            for j in range(n):
                d_in = self.delta_qp_in_val_minus1[i][j] + 1
                sh = d_in >> 1
                for m, k in enumerate(range(qp_in[j] + 1, qp_in[j + 1] + 1), 1):
                    num = (qp_out[j + 1] - qp_out[j]) * m + sh
                    # C++ integer division truncates toward zero
                    q = abs(num) // d_in
                    tab[idx(k)] = tab[idx(qp_in[j])] + (q if num >= 0 else -q)
            for k in range(qp_in[n] + 1, 64):
                tab[idx(k)] = max(-off, min(63, tab[idx(k - 1)] + 1))
            self.tables.append(tab)

    def map_qp(self, comp_idx: int, qp: int) -> int:
        """comp_idx: 0=Cb, 1=Cr, 2=JointCbCr."""
        t = self.tables[0] if self.same_qp_table_for_chroma else self.tables[comp_idx]
        return t[qp + self.qp_bd_offset]

    @staticmethod
    def default(qp_bd_offset: int) -> "ChromaQpTable":
        """Default mapping when sps_chroma_format_idc == 0 or no table given:
        identity-ish table with one point (spec default: single table, start 26,
        num points 0)."""
        t = ChromaQpTable(
            same_qp_table_for_chroma=True,
            num_qp_tables=1,
            qp_table_start_minus26=[0],
            delta_qp_in_val_minus1=[[0]],
            delta_qp_out_val=[[0]],
            qp_bd_offset=qp_bd_offset,
        )
        t.derive()
        return t


@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sublayers: int = 1
    chroma_format_idc: int = CHROMA_420
    ctu_size: int = 128
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    ptl_dpb_hrd_params_present: bool = True
    gdr_enabled: bool = False
    rpr_enabled: bool = False
    res_change_in_clvs_allowed: bool = False
    pic_width_max: int = 0
    pic_height_max: int = 0
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)  # left,right,top,bottom
    # subpics
    subpic_info_present: bool = False
    num_subpics: int = 1
    independent_subpics: bool = True
    subpic_ctu_top_left: list[tuple[int, int]] = field(default_factory=list)
    subpic_size_ctus: list[tuple[int, int]] = field(default_factory=list)
    subpic_treated_as_pic: list[bool] = field(default_factory=list)
    loop_filter_across_subpic: list[bool] = field(default_factory=list)
    subpic_id_len: int = 0
    subpic_id_mapping_explicit: bool = False
    subpic_id_mapping_present: bool = False
    subpic_ids: list[int] = field(default_factory=list)
    bit_depth: int = 10
    entropy_coding_sync_enabled: bool = False  # WPP
    entry_point_offsets_present: bool = False
    log2_max_poc_lsb: int = 8
    poc_msb_cycle_flag: bool = False
    poc_msb_cycle_len: int = 0
    extra_ph_bit_present: list[bool] = field(default_factory=list)
    extra_sh_bit_present: list[bool] = field(default_factory=list)
    sublayer_dpb_params: bool = False
    max_dec_pic_buffering: list[int] = field(default_factory=lambda: [8])
    num_reorder_pics: list[int] = field(default_factory=lambda: [0])
    max_latency_increase_plus1: list[int] = field(default_factory=lambda: [0])
    log2_min_cb_size: int = 2
    partition_constraints_override_enabled: bool = False
    # partition constraints arrays indexed [intra-luma, inter, intra-chroma]
    min_qt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_mtt_depth: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_bt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_tt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    dual_tree_intra: bool = False
    log2_max_tb_size: int = 5
    transform_skip_enabled: bool = False
    log2_max_ts_size: int = 2
    bdpcm_enabled: bool = False
    mts_enabled: bool = False
    explicit_mts_intra: bool = False
    explicit_mts_inter: bool = False
    lfnst_enabled: bool = False
    joint_cbcr_enabled: bool = False
    chroma_qp_table: ChromaQpTable | None = None
    sao_enabled: bool = False
    alf_enabled: bool = False
    ccalf_enabled: bool = False
    lmcs_enabled: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    long_term_ref_pics: bool = False
    inter_layer_prediction: bool = False
    idr_rpl_present: bool = False
    rpl1_same_as_rpl0: bool = False
    rpl_lists: tuple[list[RefPicList], list[RefPicList]] = field(
        default_factory=lambda: ([], [])
    )
    ref_wraparound_enabled: bool = False
    temporal_mvp_enabled: bool = False
    sbtmvp_enabled: bool = False
    amvr_enabled: bool = False
    bdof_enabled: bool = False
    bdof_control_present_in_ph: bool = False
    smvd_enabled: bool = False
    dmvr_enabled: bool = False
    dmvr_control_present_in_ph: bool = False
    mmvd_enabled: bool = False
    mmvd_fullpel_only: bool = False
    max_num_merge_cand: int = 6
    sbt_enabled: bool = False
    affine_enabled: bool = False
    max_num_affine_merge_cand: int = 5
    affine_6param: bool = False
    affine_amvr: bool = False
    prof_enabled: bool = False
    prof_control_present_in_ph: bool = False
    bcw_enabled: bool = False
    ciip_enabled: bool = False
    gpm_enabled: bool = False
    max_num_gpm_cand: int = 0
    log2_parallel_merge_level: int = 2
    isp_enabled: bool = False
    mrl_enabled: bool = False
    mip_enabled: bool = False
    cclm_enabled: bool = False
    chroma_hor_collocated: bool = True
    chroma_ver_collocated: bool = True
    palette_enabled: bool = False
    act_enabled: bool = False
    internal_minus_input_bit_depth: int = 0
    ibc_enabled: bool = False
    max_num_ibc_merge_cand: int = 6
    ladf_enabled: bool = False
    explicit_scaling_list_enabled: bool = False
    scaling_matrix_for_lfnst_disabled: bool = False
    scaling_matrix_for_alt_cs_disabled: bool = False
    scaling_matrix_designated_cs: bool = False
    dep_quant_enabled: bool = False
    sign_data_hiding_enabled: bool = False
    virtual_boundaries_enabled: bool = False
    virtual_boundaries_present: bool = False
    num_ver_virtual_boundaries: int = 0
    num_hor_virtual_boundaries: int = 0
    virtual_boundary_pos_x: list[int] = field(default_factory=list)
    virtual_boundary_pos_y: list[int] = field(default_factory=list)
    timing_hrd_params_present: bool = False
    hrd_params: dict | None = None
    field_seq_flag: bool = False
    vui_present: bool = False
    vui_payload: bytes = b""
    vui: dict | None = None

    # -- derived -----------------------------------------------------------
    @property
    def ctu_log2(self) -> int:
        return self.ctu_size.bit_length() - 1

    @property
    def qp_bd_offset(self) -> int:
        return 6 * (self.bit_depth - 8)

    @property
    def max_poc_lsb(self) -> int:
        return 1 << self.log2_max_poc_lsb

    def num_rpl(self, list_idx: int) -> int:
        return len(self.rpl_lists[list_idx])


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    mixed_nalu_types: bool = False
    pic_width: int = 0
    pic_height: int = 0
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)
    conformance_window_present: bool = False
    scaling_win: tuple[int, int, int, int] = (0, 0, 0, 0)
    output_flag_present: bool = False
    no_pic_partition: bool = True
    subpic_id_mapping_present: bool = False
    num_subpics: int = 1
    subpic_id_len: int = 0
    subpic_ids: list[int] = field(default_factory=list)
    # tiles
    log2_ctu_size: int = 7
    num_exp_tile_cols: int = 1
    num_exp_tile_rows: int = 1
    tile_col_widths: list[int] = field(default_factory=list)  # full, in CTUs
    tile_row_heights: list[int] = field(default_factory=list)
    tile_col_bd: list[int] = field(default_factory=list)
    tile_row_bd: list[int] = field(default_factory=list)
    loop_filter_across_tiles: bool = False
    rect_slice: bool = True
    single_slice_per_subpic: bool = True
    num_slices_in_pic: int = 1
    tile_idx_delta_present: bool = False
    slice_top_left_tile_idx: list[int] = field(default_factory=list)
    slice_width_in_tiles: list[int] = field(default_factory=list)
    slice_height_in_tiles: list[int] = field(default_factory=list)
    num_slices_in_tile: list[int] = field(default_factory=list)
    slice_height_in_ctu: list[int] = field(default_factory=list)
    loop_filter_across_slices: bool = False
    cabac_init_present: bool = False
    num_ref_idx_default_active: tuple[int, int] = (1, 1)
    rpl1_idx_present: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    ref_wraparound_enabled: bool = False
    pic_width_minus_wraparound_offset: int = 0
    wraparound_offset: int = 0  # derived, in luma samples
    init_qp: int = 26
    cu_qp_delta_enabled: bool = False
    chroma_tool_offsets_present: bool = False
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    joint_cbcr_qp_offset_present: bool = False
    joint_cbcr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: bool = False
    cu_chroma_qp_offset_list_enabled: bool = False
    chroma_qp_offset_list: list[tuple[int, int, int]] = field(default_factory=list)
    deblocking_filter_control_present: bool = False
    deblocking_filter_override_enabled: bool = False
    deblocking_filter_disabled: bool = False
    dbf_info_in_ph: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0
    rpl_info_in_ph: bool = False
    sao_info_in_ph: bool = False
    alf_info_in_ph: bool = False
    wp_info_in_ph: bool = False
    qp_delta_info_in_ph: bool = False
    picture_header_extension_present: bool = False
    slice_header_extension_present: bool = False

    # derived (set by finalize)
    pic_width_in_ctu: int = 0
    pic_height_in_ctu: int = 0
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    ctu_to_tile_col: list[int] = field(default_factory=list)
    ctu_to_tile_row: list[int] = field(default_factory=list)
    # slice maps: per slice, list of CTU raster addresses
    slice_maps: list[list[int]] = field(default_factory=list)
    # per-subpic list of picture-level slice indices (spec 6.5.1)
    slices_of_subpic: list[list[int]] = field(default_factory=list)

    @property
    def num_tiles(self) -> int:
        return self.num_tile_cols * self.num_tile_rows

    def finalize(self, sps: SPS) -> None:
        """Derive tile grid and slice maps.  Parity: vvdec PPS::initTiles
        (Slice.cpp:1167), PPS::initRectSliceMap, finalizePPSPartitioning."""
        ctu = sps.ctu_size
        self.pic_width_in_ctu = (self.pic_width + ctu - 1) // ctu
        self.pic_height_in_ctu = (self.pic_height + ctu - 1) // ctu
        if self.ref_wraparound_enabled:
            min_cb = 1 << sps.log2_min_cb_size
            self.wraparound_offset = min_cb * (
                self.pic_width // min_cb
                - self.pic_width_minus_wraparound_offset)

        if self.no_pic_partition:
            self.tile_col_widths = [self.pic_width_in_ctu]
            self.tile_row_heights = [self.pic_height_in_ctu]
            self.num_tile_cols = self.num_tile_rows = 1
        else:
            # uniform-fill remaining area with the last explicit size
            for sizes, total in (
                (self.tile_col_widths, self.pic_width_in_ctu),
                (self.tile_row_heights, self.pic_height_in_ctu),
            ):
                rem = total - sum(sizes)
                assert rem >= 0, "explicit tile sizes exceed picture"
                uniform = sizes[-1]
                while rem > 0:
                    uniform = min(rem, uniform)
                    sizes.append(uniform)
                    rem -= uniform
            self.num_tile_cols = len(self.tile_col_widths)
            self.num_tile_rows = len(self.tile_row_heights)

        self.tile_col_bd = [0]
        for w in self.tile_col_widths:
            self.tile_col_bd.append(self.tile_col_bd[-1] + w)
        self.tile_row_bd = [0]
        for h in self.tile_row_heights:
            self.tile_row_bd.append(self.tile_row_bd[-1] + h)

        self.ctu_to_tile_col = []
        c = 0
        for x in range(self.pic_width_in_ctu + 1):
            if x == self.tile_col_bd[c + 1]:
                c += 1
            self.ctu_to_tile_col.append(c)
        self.ctu_to_tile_row = []
        r = 0
        for y in range(self.pic_height_in_ctu + 1):
            if y == self.tile_row_bd[r + 1]:
                r += 1
            self.ctu_to_tile_row.append(r)

        # slice maps
        self.slice_maps = []
        if self.rect_slice and self.single_slice_per_subpic \
                and sps.num_subpics > 1:
            # one slice per subpicture: each slice covers its subpic's CTUs
            # in tile-scan order restricted to the subpic (subpic boundaries
            # coincide with tile boundaries per the conformance constraint)
            self.num_slices_in_pic = sps.num_subpics
            W = self.pic_width_in_ctu
            for (sx0, sy0), (sw, shh) in zip(sps.subpic_ctu_top_left,
                                             sps.subpic_size_ctus):
                ctus: list[int] = []
                for ty in range(self.num_tile_rows):
                    for tx in range(self.num_tile_cols):
                        for y in range(self.tile_row_bd[ty],
                                       self.tile_row_bd[ty + 1]):
                            if not sy0 <= y < sy0 + shh:
                                continue
                            for x in range(self.tile_col_bd[tx],
                                           self.tile_col_bd[tx + 1]):
                                if sx0 <= x < sx0 + sw:
                                    ctus.append(y * W + x)
                self.slice_maps.append(ctus)
        elif self.no_pic_partition or (self.rect_slice
                                       and self.single_slice_per_subpic
                                       and sps.num_subpics == 1):
            # one slice covering the picture; CTUs in tile-scan order
            self.num_slices_in_pic = 1
            W = self.pic_width_in_ctu
            order: list[int] = []
            for ty in range(self.num_tile_rows):
                for tx in range(self.num_tile_cols):
                    for y in range(self.tile_row_bd[ty], self.tile_row_bd[ty + 1]):
                        for x in range(self.tile_col_bd[tx], self.tile_col_bd[tx + 1]):
                            order.append(y * W + x)
            self.slice_maps = [order]
        elif self.rect_slice and not self.single_slice_per_subpic:
            W = self.pic_width_in_ctu
            for s in range(self.num_slices_in_pic):
                tile_idx = self.slice_top_left_tile_idx[s]
                tx = tile_idx % self.num_tile_cols
                ty = tile_idx // self.num_tile_cols
                ctus: list[int] = []
                if (self.slice_width_in_tiles[s] == 1 and self.slice_height_in_tiles[s] == 1
                        and s < len(self.num_slices_in_tile) and self.num_slices_in_tile[s] > 1):
                    # slice covering part of one tile: rows [y0, y0+h)
                    y0 = self.tile_row_bd[ty]
                    # accumulate heights of previous slices in this tile
                    first = s
                    while first > 0 and self.slice_top_left_tile_idx[first - 1] == tile_idx:
                        first -= 1
                    for p in range(first, s):
                        y0 += self.slice_height_in_ctu[p]
                    h = self.slice_height_in_ctu[s]
                    for y in range(y0, y0 + h):
                        for x in range(self.tile_col_bd[tx], self.tile_col_bd[tx + 1]):
                            ctus.append(y * W + x)
                else:
                    for dy in range(self.slice_height_in_tiles[s]):
                        for y in range(self.tile_row_bd[ty + dy], self.tile_row_bd[ty + dy + 1]):
                            for dx in range(self.slice_width_in_tiles[s]):
                                for x in range(self.tile_col_bd[tx + dx],
                                               self.tile_col_bd[tx + dx + 1]):
                                    ctus.append(y * W + x)
                self.slice_maps.append(ctus)
        # raster-scan slices: maps are built per slice header (addCtusToSlice)

        # subpic -> slice mapping (spec 6.5.1 SubpicIdxForSlice /
        # NumSlicesInSubpic): each rect slice belongs to the subpic
        # containing its first CTU; sh_slice_address indexes within it
        self.slices_of_subpic = [[] for _ in range(max(1, sps.num_subpics))]
        W = self.pic_width_in_ctu
        for s, ctus in enumerate(self.slice_maps):
            if not ctus:
                continue
            x, y = ctus[0] % W, ctus[0] // W
            k = 0
            for i, ((sx0, sy0), (sw, shh)) in enumerate(
                    zip(sps.subpic_ctu_top_left, sps.subpic_size_ctus)):
                if sx0 <= x < sx0 + sw and sy0 <= y < sy0 + shh:
                    k = i
                    break
            self.slices_of_subpic[k].append(s)

    def tile_ctus(self, tile_x0: int, tile_x1: int, tile_y0: int, tile_y1: int) -> list[int]:
        """CTU raster addresses of the tile-aligned rectangle [x0,x1)x[y0,y1) in CTUs."""
        W = self.pic_width_in_ctu
        return [y * W + x for y in range(tile_y0, tile_y1) for x in range(tile_x0, tile_x1)]


@dataclass
class PicHeader:
    gdr_or_irap_pic: bool = False
    non_ref_pic: bool = False
    gdr_pic: bool = False
    inter_slice_allowed: bool = True
    intra_slice_allowed: bool = True
    pps_id: int = 0
    poc_lsb: int = 0
    recovery_poc_cnt: int = -1
    poc_msb_present: bool = False
    poc_msb_val: int = 0
    # ALF
    alf_enabled: list[bool] = field(default_factory=lambda: [False, False, False])
    num_alf_aps_ids_luma: int = 0
    alf_aps_ids_luma: list[int] = field(default_factory=list)
    alf_aps_id_chroma: int = 0
    ccalf_cb_enabled: bool = False
    ccalf_cb_aps_id: int = 0
    ccalf_cr_enabled: bool = False
    ccalf_cr_aps_id: int = 0
    # LMCS
    lmcs_enabled: bool = False
    lmcs_aps_id: int = 0
    chroma_residual_scale: bool = False
    # scaling lists
    explicit_scaling_list_enabled: bool = False
    scaling_list_aps_id: int = 0
    # virtual boundaries
    virtual_boundaries_present: bool = False
    num_ver_virtual_boundaries: int = 0
    num_hor_virtual_boundaries: int = 0
    virtual_boundary_pos_x: list[int] = field(default_factory=list)
    virtual_boundary_pos_y: list[int] = field(default_factory=list)
    pic_output_flag: bool = True
    # RPL
    rpl: list[RefPicList | None] = field(default_factory=lambda: [None, None])
    rpl_idx: list[int] = field(default_factory=lambda: [-1, -1])
    # partition overrides
    split_cons_override: bool = False
    min_qt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_mtt_depth: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_bt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_tt_size: list[int] = field(default_factory=lambda: [0, 0, 0])
    cu_qp_delta_subdiv_intra: int = 0
    cu_qp_delta_subdiv_inter: int = 0
    cu_chroma_qp_offset_subdiv_intra: int = 0
    cu_chroma_qp_offset_subdiv_inter: int = 0
    # inter controls
    temporal_mvp_enabled: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    max_num_affine_merge_cand: int = 5
    fpel_mmvd: bool = False
    mvd_l1_zero: bool = False
    bdof_disabled: bool = True
    dmvr_disabled: bool = True
    prof_disabled: bool = True
    # weighted prediction (when wp_info_in_ph)
    weight_table: object | None = None
    qp_delta: int = 0
    joint_cbcr_sign: bool = False
    sao_enabled_luma: bool = False
    sao_enabled_chroma: bool = False
    # deblocking
    deblocking_override: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0


@dataclass
class SliceHeader:
    picture_header_in_slice_header: bool = False
    subpic_id: int = 0
    subpic_idx: int = 0
    slice_address: int = 0
    num_tiles_in_slice: int = 1
    slice_type: int = I_SLICE
    no_output_of_prior_pics: bool = False
    poc: int = 0
    # ALF (slice-level)
    alf_enabled: list[bool] = field(default_factory=lambda: [False, False, False])
    num_alf_aps_ids_luma: int = 0
    alf_aps_ids_luma: list[int] = field(default_factory=list)
    alf_aps_id_chroma: int = 0
    ccalf_cb_enabled: bool = False
    ccalf_cb_aps_id: int = 0
    ccalf_cr_enabled: bool = False
    ccalf_cr_aps_id: int = 0
    lmcs_enabled: bool = False
    explicit_scaling_list_used: bool = False
    rpl: list[RefPicList | None] = field(default_factory=lambda: [None, None])
    rpl_idx: list[int] = field(default_factory=lambda: [-1, -1])
    num_ref_idx_active: list[int] = field(default_factory=lambda: [0, 0])
    cabac_init_flag: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    weight_table: object | None = None
    qp_y: int = 26
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    joint_cbcr_qp_offset: int = 0
    cu_chroma_qp_offset_enabled: bool = False
    sao_enabled_luma: bool = False
    sao_enabled_chroma: bool = False
    deblocking_override: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    cb_beta_offset_div2: int = 0
    cb_tc_offset_div2: int = 0
    cr_beta_offset_div2: int = 0
    cr_tc_offset_div2: int = 0
    dep_quant_used: bool = False
    sign_data_hiding_used: bool = False
    ts_residual_coding_disabled: bool = False
    entry_point_offsets: list[int] = field(default_factory=list)
    # derived
    ctu_addrs: list[int] = field(default_factory=list)  # raster CTU addresses in slice
    nal_type: int = 0
    temporal_id: int = 0
    data_offset_bits: int = 0  # bit position where slice data starts in RBSP

    @property
    def is_intra(self) -> bool:
        return self.slice_type == I_SLICE

    @property
    def is_b(self) -> bool:
        return self.slice_type == B_SLICE

    @property
    def is_p(self) -> bool:
        return self.slice_type == P_SLICE

    @property
    def is_irap(self) -> bool:
        return 7 <= int(self.nal_type) <= 9  # IDR_W_RADL..CRA
