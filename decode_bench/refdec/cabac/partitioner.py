"""QT/MTT partition stack used while parsing the coding tree.

Behavioral parity: vvdec Partitioner (source/Lib/CommonLib/UnitPartitioner.cpp:
canSplit :281, splitCurrArea :191, getCUSubPartitions :516, getMaxTuTiling
:706) — implemented as an explicit recursion-friendly node object instead of a
mutable stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

# split kinds
CTU_LEVEL = 0
CU_QUAD_SPLIT = 1
CU_HORZ_SPLIT = 2
CU_VERT_SPLIT = 3
CU_TRIH_SPLIT = 4
CU_TRIV_SPLIT = 5
CU_DONT_SPLIT = 6
TU_MAX_TR_SPLIT = 7

MAX_TU_SIZE_FOR_PROFILE = 64
MIN_DUALTREE_CHROMA_WIDTH = 4
MIN_DUALTREE_CHROMA_SIZE = 16


@dataclass
class Area:
    """Rectangle in luma coords with chroma mirror (component coords)."""

    x: int
    y: int
    w: int
    h: int

    def chroma(self, sub_w: int, sub_h: int) -> tuple[int, int, int, int]:
        return (self.x // sub_w, self.y // sub_h, self.w // sub_w, self.h // sub_h)


@dataclass
class PartNode:
    """Partitioning state at one node of the coding tree."""

    area: Area
    ch_type: int = 0  # 0 luma, 1 chroma
    tree_type: int = 0  # TREE_D/L/C (structure module constants)
    mode_type: int = 0
    qt_depth: int = 0
    mt_depth: int = 0
    impl_bt_depth: int = 0
    tr_depth: int = 0
    depth: int = 0
    subdiv: int = 0
    last_split: int = CTU_LEVEL
    part_idx: int = 0  # index of this node within its parent split
    # quantization-group tracking
    qg_enable: bool = True
    qg_chroma_enable: bool = True
    # coding-split history from the CTU root (CU::getSplitAtDepth source)
    split_hist: tuple = ()

    def child(self, area: Area, split: int, idx: int, n_parts: int) -> "PartNode":
        qt = self.qt_depth + (1 if split == CU_QUAD_SPLIT else 0)
        mt = self.mt_depth + (1 if split in (CU_HORZ_SPLIT, CU_VERT_SPLIT,
                                             CU_TRIH_SPLIT, CU_TRIV_SPLIT) else 0)
        tr = self.tr_depth + (1 if split == TU_MAX_TR_SPLIT else 0)
        # subdiv increments: QT +2; BT +1 each part; TT: middle +1, sides +2
        if split == CU_QUAD_SPLIT:
            subdiv = self.subdiv + 2
        elif split in (CU_HORZ_SPLIT, CU_VERT_SPLIT):
            subdiv = self.subdiv + 1
        elif split in (CU_TRIH_SPLIT, CU_TRIV_SPLIT):
            subdiv = self.subdiv + (1 if idx == 1 else 2)
        else:
            subdiv = self.subdiv
        hist = self.split_hist
        if split != TU_MAX_TR_SPLIT:
            hist = hist + (split,)
        return replace(
            self, area=area, qt_depth=qt, mt_depth=mt, tr_depth=tr,
            depth=self.depth + 1, subdiv=subdiv, last_split=split,
            part_idx=idx, split_hist=hist)


def split_areas(area: Area, split: int, max_tr_size: int = 64) -> list[Area]:
    """Sub-areas of a split, in parse order."""
    x, y, w, h = area.x, area.y, area.w, area.h
    if split == CU_QUAD_SPLIT:
        hw, hh = w >> 1, h >> 1
        return [Area(x, y, hw, hh), Area(x + hw, y, hw, hh),
                Area(x, y + hh, hw, hh), Area(x + hw, y + hh, hw, hh)]
    if split == CU_HORZ_SPLIT:
        hh = h >> 1
        return [Area(x, y, w, hh), Area(x, y + hh, w, hh)]
    if split == CU_VERT_SPLIT:
        hw = w >> 1
        return [Area(x, y, hw, h), Area(x + hw, y, hw, h)]
    if split == CU_TRIH_SPLIT:
        q = h >> 2
        return [Area(x, y, w, q), Area(x, y + q, w, h >> 1), Area(x, y + 3 * q, w, q)]
    if split == CU_TRIV_SPLIT:
        q = w >> 2
        return [Area(x, y, q, h), Area(x + q, y, w >> 1, h), Area(x + 3 * q, y, q, h)]
    if split == TU_MAX_TR_SPLIT:
        from refdec.ops.rom import z_scan_order
        tw = max(1, w // max_tr_size)
        th = max(1, h // max_tr_size)
        pw, ph = w // tw, h // th
        return [Area(x + tx * pw, y + ty * ph, pw, ph)
                for tx, ty in z_scan_order(tw, th)]
    raise ValueError(split)


@dataclass
class SplitConstraints:
    """Per-slice partition limits (from SPS/PH), indexed for current tree."""

    min_qt_size: int
    max_bt_depth: int
    max_bt_size: int
    max_tt_size: int
    min_bt_size: int = 4
    min_tt_size: int = 4
    max_tr_size: int = 64
    min_cb_size: int = 4


def can_split(node: PartNode, c: SplitConstraints, pic_w: int, pic_h: int,
              is_dual_itree: bool, sub_w: int = 2, sub_h: int = 2
              ) -> dict[int, bool]:
    """Which splits are allowed at this node (parity: Partitioner::canSplit,
    UnitPartitioner.cpp:281).  Returns {split_kind: allowed} incl. CU_DONT_SPLIT."""
    a = node.area
    res = {CU_DONT_SPLIT: True, CU_QUAD_SPLIT: True, CU_HORZ_SPLIT: True,
           CU_VERT_SPLIT: True, CU_TRIH_SPLIT: True, CU_TRIV_SPLIT: True}
    can_btt = node.mt_depth < (c.max_bt_depth + node.impl_bt_depth)

    area_c = None
    if node.ch_type == 1:
        area_c = a.chroma(sub_w, sub_h)

    if is_dual_itree and node.ch_type == 0 and (a.w > 64 or a.h > 64):
        return {CU_DONT_SPLIT: False, CU_QUAD_SPLIT: True, CU_HORZ_SPLIT: False,
                CU_VERT_SPLIT: False, CU_TRIH_SPLIT: False, CU_TRIV_SPLIT: False}

    from refdec.frame.structure import TREE_C
    if node.tree_type == TREE_C:
        return {CU_DONT_SPLIT: True, CU_QUAD_SPLIT: False, CU_HORZ_SPLIT: False,
                CU_VERT_SPLIT: False, CU_TRIH_SPLIT: False, CU_TRIV_SPLIT: False}

    last = node.last_split
    tr_in_pic = a.x + a.w <= pic_w
    bl_in_pic = a.y + a.h <= pic_h
    implicit = not tr_in_pic or not bl_in_pic

    can_qt = res[CU_QUAD_SPLIT]
    if last not in (CTU_LEVEL, CU_QUAD_SPLIT):
        can_qt = False
    if a.w <= c.min_qt_size:
        can_qt = False
    if area_c and area_c[2] <= MIN_DUALTREE_CHROMA_WIDTH:
        can_qt = False

    if implicit:
        bt_allowed = (a.w <= c.max_bt_size and a.h <= c.max_bt_size
                      and a.w <= MAX_TU_SIZE_FOR_PROFILE
                      and a.h <= MAX_TU_SIZE_FOR_PROFILE and can_btt)
        can_bh = bt_allowed and not bl_in_pic and (tr_in_pic or not can_qt)
        can_bv = bt_allowed and bl_in_pic and not tr_in_pic
        if area_c and area_c[2] <= 4:
            can_bv = False
        can_qt = can_qt or not bt_allowed
        can_qt = can_qt or (not can_bh and not can_bv)
        return {CU_DONT_SPLIT: False, CU_QUAD_SPLIT: can_qt,
                CU_HORZ_SPLIT: can_bh, CU_VERT_SPLIT: can_bv,
                CU_TRIH_SPLIT: False, CU_TRIV_SPLIT: False}

    can_btt = can_btt and (a.w > c.min_bt_size or a.h > c.min_bt_size
                           or a.w > c.min_tt_size or a.h > c.min_tt_size)
    can_btt = can_btt and ((a.w <= c.max_bt_size and a.h <= c.max_bt_size)
                           or (a.w <= c.max_tt_size and a.h <= c.max_tt_size))

    if not can_btt:
        return {CU_DONT_SPLIT: True, CU_QUAD_SPLIT: can_qt, CU_HORZ_SPLIT: False,
                CU_VERT_SPLIT: False, CU_TRIH_SPLIT: False, CU_TRIV_SPLIT: False}

    from refdec.frame.structure import MODE_TYPE_INTER
    allow_bt = node.mode_type != MODE_TYPE_INTER or a.w * a.h != 32
    allow_tt = node.mode_type != MODE_TYPE_INTER or a.w * a.h != 64

    can_bh = can_bv = True
    if a.w > c.max_bt_size or a.h > c.max_bt_size or not allow_bt:
        can_bh = can_bv = False
    else:
        if last in (CU_TRIH_SPLIT, CU_TRIV_SPLIT) and node.part_idx == 1:
            if last == CU_TRIH_SPLIT:
                can_bh = False
            else:
                can_bv = False
        can_bh = can_bh and c.min_bt_size < a.h <= c.max_bt_size
        can_bh = can_bh and (a.w <= MAX_TU_SIZE_FOR_PROFILE
                             or a.h > MAX_TU_SIZE_FOR_PROFILE)
        can_bv = can_bv and c.min_bt_size < a.w <= c.max_bt_size
        can_bv = can_bv and (a.w > MAX_TU_SIZE_FOR_PROFILE
                             or a.h <= MAX_TU_SIZE_FOR_PROFILE)

    can_th = can_tv = True
    if (a.w > c.max_tt_size or a.h > c.max_tt_size or not allow_tt
            or a.w > MAX_TU_SIZE_FOR_PROFILE or a.h > MAX_TU_SIZE_FOR_PROFILE):
        can_th = can_tv = False
    else:
        can_th = a.h > 2 * c.min_tt_size
        can_tv = a.w > 2 * c.min_tt_size

    if area_c:
        cw, chh = area_c[2], area_c[3]
        can_bh = can_bh and cw * chh > MIN_DUALTREE_CHROMA_SIZE
        can_th = can_th and cw * chh > MIN_DUALTREE_CHROMA_SIZE * 2
        can_bv = can_bv and cw * chh > MIN_DUALTREE_CHROMA_SIZE and cw > 4
        can_tv = can_tv and cw * chh > MIN_DUALTREE_CHROMA_SIZE * 2 and cw > 8

    return {CU_DONT_SPLIT: True, CU_QUAD_SPLIT: can_qt, CU_HORZ_SPLIT: can_bh,
            CU_VERT_SPLIT: can_bv, CU_TRIH_SPLIT: can_th, CU_TRIV_SPLIT: can_tv}


# ---------------------------------------------------------------------------
# ISP (intra sub-partitions) geometry
# Parity: CU::canUseISPSplit / CU::getISPSplitDim (UnitTools.cpp:343,360)
# ---------------------------------------------------------------------------
MIN_TB_SIZE = 4


def can_use_isp_split(w: int, h: int, max_tr_size: int) -> int:
    """Returns the permitted ISP split set: 0 none, 1 hor-only, 2 ver-only,
    3 both (matches the ISPType enum semantics of the reference)."""
    log2_min = MIN_TB_SIZE.bit_length() - 1
    not_enough = (w.bit_length() - 1) + (h.bit_length() - 1) <= (log2_min << 1)
    too_large = w > max_tr_size or h > max_tr_size
    width_ok = 4 if (not too_large and not not_enough) else 2
    height_ok = 0 if (not too_large and not not_enough) else 2
    return width_ok >> height_ok


def isp_split_dim(w: int, h: int, horizontal: bool) -> int:
    """Size of the split dimension of each ISP partition."""
    split_size, non_split = (h, w) if horizontal else (w, h)
    min_samples = 1 << ((MIN_TB_SIZE.bit_length() - 1) << 1)  # 16
    factor = (min_samples >> (non_split.bit_length() - 1)) \
        if non_split < min_samples else 1
    part = split_size >> 2
    return factor if part < factor else part


def can_use_lfnst_with_isp(cu_w: int, cu_h: int, isp_mode: int) -> bool:
    """Parity: CU::canUseLfnstWithISP (UnitTools.cpp:319) — every ISP
    partition must be at least 4x4."""
    if isp_mode == 0:
        return False
    if isp_mode == 1:  # horizontal
        tw, th = cu_w, isp_split_dim(cu_w, cu_h, True)
    else:
        tw, th = isp_split_dim(cu_w, cu_h, False), cu_h
    return tw >= MIN_TB_SIZE and th >= MIN_TB_SIZE
