"""Per-picture coding data model: CodingUnit / TransformUnit / CodingStructure.

TPU-first design: the CABAC parse stage fills *whole-frame tensors* (coefficient
planes, per-4x4 CU-index / QP maps) that the device pipeline consumes directly.
CU/TU objects carry only scalar mode metadata for host-side derivations.

Behavioral parity: vvdec CodingStructure/CodingUnit/TransformUnit
(source/Lib/CommonLib/CodingStructure.h:85-236, Unit.h:285-669) — re-designed,
not ported: flat numpy maps instead of pointer soup.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# prediction modes
MODE_INTER, MODE_INTRA, MODE_IBC = 0, 1, 2
# tree types
TREE_D, TREE_L, TREE_C = 0, 1, 2
# mode types (local dual tree)
MODE_TYPE_ALL, MODE_TYPE_INTER, MODE_TYPE_INTRA = 0, 1, 2

# intra prediction modes
PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 18
VER_IDX = 50
VDIA_IDX = 66
NUM_LUMA_MODE = 67
LM_CHROMA_IDX = 67
MDLM_L_IDX = 68
MDLM_T_IDX = 69
DM_CHROMA_IDX = 70
NUM_CHROMA_MODE = 8
NUM_MPM = 6

# MTS indices
MTS_DCT2_DCT2 = 0
MTS_SKIP = 1
MTS_DST7_DST7 = 2
MTS_DCT8_DST7 = 3
MTS_DST7_DCT8 = 4
MTS_DCT8_DCT8 = 5

# ISP
NOT_INTRA_SUBPARTITIONS = 0
HOR_INTRA_SUBPARTITIONS = 1
VER_INTRA_SUBPARTITIONS = 2


class LazyCtuParams(list):
    """addr-indexed per-CTU parameter list (SAO/ALF): entries
    materialize from the syntax walk's flat records on first access.
    The C filter stages read the records directly and never touch
    these; building every dict eagerly cost ~8% of an all-intra
    SAO/ALF decode.  Shared by all slice-walk proxies of a picture
    (disjoint addr ranges)."""

    __slots__ = ("_srcs",)

    def __init__(self, base):
        super().__init__(base)
        self._srcs: dict = {}

    def register(self, addrs, builder) -> None:
        srcs = self._srcs
        for a in addrs:
            srcs[a] = builder

    def __getitem__(self, i):
        v = list.__getitem__(self, i)
        if v is None and self._srcs:
            b = self._srcs.get(i)
            if b is not None:
                v = b(i)
                list.__setitem__(self, i, v)
                del self._srcs[i]
        return v

    def __setitem__(self, i, v):
        self._srcs.pop(i, None)
        list.__setitem__(self, i, v)


@dataclass
class TransformUnit:
    cu_idx: int = -1
    # per component: (x, y, w, h) in that component's sample coords; None if absent
    blocks: list[tuple[int, int, int, int] | None] = field(
        default_factory=lambda: [None, None, None])
    cbf: list[bool] = field(default_factory=lambda: [False, False, False])
    mts_idx: list[int] = field(default_factory=lambda: [0, 0, 0])
    joint_cbcr: int = 0
    qp: int = 0
    chroma_qp: list[int] = field(default_factory=lambda: [0, 0])
    max_scan_x: list[int] = field(default_factory=lambda: [0, 0, 0])
    max_scan_y: list[int] = field(default_factory=lambda: [0, 0, 0])
    # index of this TU within its CU partitioning (ISP/maxTr splits)
    part_idx: int = 0
    # global parse-order counter (assigned by the reconstructor)
    order: int = 0


@dataclass
class CodingUnit:
    idx: int = -1
    # luma-plane geometry (valid unless chroma-only dual-tree CU)
    x: int = 0
    y: int = 0
    w: int = 0
    h: int = 0
    # chroma-plane geometry (component coords); None for luma-only CUs
    cx: int = 0
    cy: int = 0
    cw: int = 0
    ch: int = 0
    has_luma: bool = True
    has_chroma: bool = True
    ch_type: int = 0
    tree_type: int = TREE_D
    mode_type: int = MODE_TYPE_ALL
    qt_depth: int = 0
    mt_depth: int = 0
    depth: int = 0
    pred_mode: int = MODE_INTRA
    skip: bool = False
    qp: int = 0
    chroma_qp_adj: int = 0
    # intra; luma defaults to DC like the reference (CodingUnit::minInit,
    # Unit.cpp:287) — the chroma DM of a co-located IBC/inter block reads it
    intra_dir: list[int] = field(default_factory=lambda: [DC_IDX, PLANAR_IDX])
    bdpcm_mode: int = 0
    bdpcm_mode_chroma: int = 0
    mip_flag: bool = False
    mip_transpose: bool = False
    mip_mode: int = 0
    multi_ref_idx: int = 0
    isp_mode: int = NOT_INTRA_SUBPARTITIONS
    lfnst_idx: int = 0
    color_transform: bool = False
    # residual
    root_cbf: bool = True
    plane_cbf: list[bool] = field(default_factory=lambda: [False, False, False])
    sbt_info: int = 0
    # inter
    merge_flag: bool = False
    merge_idx: int = 0
    inter_dir: int = 0
    mv: list = field(default_factory=list)       # [[x,y] L0, [x,y] L1] 1/16 pel
    mvd: list = field(default_factory=list)      # quarter-pel units
    # affine CPMV differences [lst][cp 1..2] (cp 0 lives in mvd)
    mvd_aff: list = field(default_factory=list)
    ref_idx: list = field(default_factory=lambda: [-1, -1])
    mvp_idx: list = field(default_factory=lambda: [0, 0])
    smvd_mode: int = 0
    mmvd_flag: bool = False
    mmvd_idx: int = 0
    imv: int = 0            # 0 quarter, 1 full, 2 four-pel, 3 half-pel
    bcw_idx: int = 0        # forward form; 0 = default (equal weights)
    alt_hpel: bool = False
    affine_flag: bool = False
    affine_type: int = 0    # 0 = 4-param, 1 = 6-param
    merge_type: int = 0     # 0 = regular, 1 = SbTMVP (MRG_TYPE_SUBPU_ATMVP)
    # control-point MVs [lst][cp 0..2][x,y], 1/16-pel (affine CUs only)
    cpmv: list = field(default_factory=list)
    ciip_flag: bool = False
    geo_flag: bool = False
    geo_split_dir: int = 0
    geo_idx: list = field(default_factory=lambda: [0, 1])
    split_hist: tuple = ()
    tus: list[TransformUnit] = field(default_factory=list)
    slice_idx: int = 0
    tile_idx: int = 0

    @property
    def lwidth(self) -> int:
        return self.w

    @property
    def lheight(self) -> int:
        return self.h


class CodingStructure:
    """Per-picture parse output.

    Frame tensors (device-plane input):
      coef[c]   : int32 [Hc, Wc]   dense coefficient plane (TU-positioned)
      cu_map    : int32 [H/4, W/4] CU index per luma 4x4
      cu_map_c  : int32 [Hc/4(?)..] chroma CU index per chroma 4x4 (dual tree)
      qp_map    : int8  [H/4, W/4] per-4x4 luma QP (deblocking input)
    """

    def __init__(self, sps, pps, ph, shdr) -> None:
        self.sps = sps
        self.pps = pps
        self.ph = ph
        self.sh = shdr
        # all slice headers of the picture, indexed by CU.slice_idx
        # (multi-slice pictures; self.sh stays the first slice's header)
        self.shs = [shdr]
        self.w = pps.pic_width
        self.h = pps.pic_height
        from refdec.hls.params import sub_wh
        self.sub_w, self.sub_h = sub_wh(sps.chroma_format_idc)
        self.ctu_log2 = sps.ctu_size.bit_length() - 1
        self.scaling_list = None  # ScalingListData when explicitly signalled
        self.num_comp = 1 if sps.chroma_format_idc == 0 else 3
        cw, chh = self.w // self.sub_w, self.h // self.sub_h
        self.comp_size = [(self.w, self.h), (cw, chh), (cw, chh)][: self.num_comp]
        self.coef = [np.zeros((h, w), dtype=np.int32) for (w, h) in self.comp_size]
        self.cu_map = np.full((self.h >> 2, self.w >> 2), -1, dtype=np.int32)
        # chroma CU map in 2x2 chroma units (local dual tree produces chroma
        # blocks aligned only to the 2-sample grid)
        self.cu_map_c = np.full((chh >> 1, cw >> 1), -1, dtype=np.int32) \
            if self.num_comp > 1 else None
        self.qp_map = np.zeros((self.h >> 2, self.w >> 2), dtype=np.int8)
        # 4x4 motion field (filled during reconstruction, spanMotionInfo):
        # mi_mv in 1/16 luma units; mi_ref -1 = invalid
        self.mi_mv = np.zeros((self.h >> 2, self.w >> 2, 2, 2), dtype=np.int32)
        self.mi_ref = np.full((self.h >> 2, self.w >> 2, 2), -1, dtype=np.int8)
        self.cus: list[CodingUnit] = []
        # DMVR refined-MV writeback records: (x, y, mv0, mv1) per 8x8 cell
        self.dmvr_fixups: list = []
        n_ctu = pps.pic_width_in_ctu * pps.pic_height_in_ctu
        self.sao_params: list = LazyCtuParams([None] * n_ctu)
        self.alf_params: list = LazyCtuParams([None] * n_ctu)
        self.alf_apss: dict = {}  # aps_id -> APS (ALF type)
        self.tus: list[TransformUnit] = []
        self.chroma_qp_adj = 0
        # per-4x4 slice/tile index for availability checks
        self.slice_map = np.full((self.h >> 2, self.w >> 2), -1, dtype=np.int32)
        self.tile_map = np.zeros((self.h >> 2, self.w >> 2), dtype=np.int32)
        if not pps.no_pic_partition:
            ctu = sps.ctu_size
            for y4 in range(self.h >> 2):
                ty = pps.ctu_to_tile_row[min((y4 << 2) // ctu, pps.pic_height_in_ctu - 1)]
                for x4 in range(self.w >> 2):
                    tx = pps.ctu_to_tile_col[min((x4 << 2) // ctu, pps.pic_width_in_ctu - 1)]
                    self.tile_map[y4, x4] = ty * pps.num_tile_cols + tx
        # subpictures: (x0, y0, x1, y1, treated_as_pic, lf_across) in luma
        # samples (SubPic, Slice.h:824; subpics behave as pictures for MC
        # when treated_as_pic)
        self.subpics: list[tuple] = []
        if sps.num_subpics > 1:
            ctu = sps.ctu_size
            for i in range(sps.num_subpics):
                cx0, cy0 = sps.subpic_ctu_top_left[i]
                cw_, ch_ = sps.subpic_size_ctus[i]
                self.subpics.append((
                    cx0 * ctu, cy0 * ctu,
                    min(self.w, (cx0 + cw_) * ctu),
                    min(self.h, (cy0 + ch_) * ctu),
                    bool(sps.subpic_treated_as_pic[i]),
                    bool(sps.loop_filter_across_subpic[i])))

    # -- CU management -----------------------------------------------------
    def add_cu(self, cu: CodingUnit) -> CodingUnit:
        cu.idx = len(self.cus)
        self.cus.append(cu)
        if cu.has_luma:
            self.cu_map[cu.y >> 2 : (cu.y + cu.h) >> 2,
                        cu.x >> 2 : (cu.x + cu.w) >> 2] = cu.idx
            self.qp_map[cu.y >> 2 : (cu.y + cu.h) >> 2,
                        cu.x >> 2 : (cu.x + cu.w) >> 2] = cu.qp
            self.slice_map[cu.y >> 2 : (cu.y + cu.h) >> 2,
                           cu.x >> 2 : (cu.x + cu.w) >> 2] = cu.slice_idx
        if cu.has_chroma and self.cu_map_c is not None and cu.tree_type != TREE_L:
            self.cu_map_c[cu.cy >> 1 : (cu.cy + cu.ch) >> 1,
                          cu.cx >> 1 : (cu.cx + cu.cw) >> 1] = cu.idx
        return cu

    def sh_of(self, cu: CodingUnit):
        """Slice header governing this CU (multi-slice pictures)."""
        return self.shs[cu.slice_idx]

    def cu_at(self, x: int, y: int, ch_type: int = 0) -> CodingUnit | None:
        """CU covering position (x, y) in the given channel's coords, or None."""
        if x < 0 or y < 0:
            return None
        if ch_type == 0:
            if x >= self.w or y >= self.h:
                return None
            idx = int(self.cu_map[y >> 2, x >> 2])
        else:
            if self.cu_map_c is None or x >= self.comp_size[1][0] or y >= self.comp_size[1][1]:
                return None
            idx = int(self.cu_map_c[y >> 1, x >> 1])
        return self.cus[idx] if idx >= 0 else None

    def cu_at_restricted(self, x: int, y: int, cur: CodingUnit,
                         ch_type: int = 0) -> CodingUnit | None:
        """Neighbor CU query restricted to same slice and tile plus the
        CTU-grid decode-order rule: the neighbor's CTU must be at most one
        CTU to the right in the row above (zero with WPP, which caps the
        wavefront lag at one CTU), never below, and never right of the
        current CTU in the same row (parity
        CodingStructure::getCURestricted, CodingStructure.cpp:468-497)."""
        cu = self.cu_at(x, y, ch_type)
        if cu is None:
            return None
        if cu.slice_idx != cur.slice_idx or cu.tile_idx != cur.tile_idx:
            return None
        if ch_type == 0:
            sh = self.ctu_log2
            cx, cy = cur.x, cur.y
        else:
            sh = self.ctu_log2 - (self.sub_w - 1)
            cx, cy = cur.cx, cur.cy
        xdiff = (x >> sh) - (cx >> sh)
        ydiff = (y >> (self.ctu_log2 - ((self.sub_h - 1) if ch_type else 0))) \
            - (cy >> (self.ctu_log2 - ((self.sub_h - 1) if ch_type else 0)))
        if ydiff == 0 and xdiff == 0:
            # cur.idx < 0: CU still being parsed (not yet added) — every
            # mapped neighbor precedes it in decode order
            if cur.idx >= 0 and cu.idx > cur.idx:
                return None
        elif ydiff > 0 or (ydiff == 0 and xdiff > 0) or xdiff > (
                0 if self.sps.entropy_coding_sync_enabled else 1):
            return None
        return cu

    def virtual_boundaries(self) -> tuple[list[int], list[int]]:
        """(vertical xs, horizontal ys) in luma samples — SPS positions, or
        the picture header's when signalled per picture
        (PicHeader::getVirtualBoundariesPosX semantics)."""
        sps, ph = self.sps, self.ph
        if not sps.virtual_boundaries_enabled:
            return [], []
        if sps.virtual_boundaries_present:
            return (list(getattr(sps, "virtual_boundary_pos_x", [])),
                    list(getattr(sps, "virtual_boundary_pos_y", [])))
        if getattr(ph, "virtual_boundaries_present", False):
            return (list(getattr(ph, "virtual_boundary_pos_x", [])),
                    list(getattr(ph, "virtual_boundary_pos_y", [])))
        return [], []

    def subpic_at(self, x: int, y: int):
        """Subpic tuple (x0, y0, x1, y1, treated, lf_across) covering the
        luma position, or None without subpictures (PPS::getSubPicFromPos)."""
        for sp in self.subpics:
            if sp[0] <= x < sp[2] and sp[1] <= y < sp[3]:
                return sp
        return None

    def add_tu(self, tu: TransformUnit) -> TransformUnit:
        self.tus.append(tu)
        return tu
