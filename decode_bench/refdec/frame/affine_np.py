"""Numpy golden affine motion + SbTMVP: derivation and subblock MC with PROF.

Behavioral parity (re-designed, not ported):
  - affine merge:   PU::getAffineMergeCand (UnitTools.cpp:2378),
                    getAffineControlPointCand (:2183), inherited-neighbour
                    scans (:2327-2376)
  - affine AMVP:    PU::fillAffineMvpCand (:1863), addAffineMVPCandUnscaled
                    (:1696), xInheritedAffineMv (:1785)
  - subblock MVs:   PU::setAllAffineMv (:2689), spread limit
                    (InterPrediction::isSubblockVectorSpreadOverLimit :892)
  - SbTMVP:         PU::getInterMergeSubPuMvpCand (:2845), clipColPos (:2821),
                    getColocatedMVP sbFlag path (:1410)
  - MC + PROF:      InterPrediction::xPredAffineBlk (InterPrediction.cpp:934),
                    applyPROFCore (:61), gradFilterCore<false> (:213),
                    PaddBIOCore (:269); 4x4 luma 6-tap filter
                    (InterpolationFilter.cpp:65 m_lumaFilter4x4)

MVs in 1/16 luma units; CPMVs stored on the CU, per-4x4 subblock MVs in the
CodingStructure motion field.
"""

from __future__ import annotations

import numpy as np

from refdec.frame.inter_np import (
    CHROMA_IF,
    IF_INTERNAL_OFFS,
    IF_INTERNAL_PREC,
    LUMA_IF_4X4,
    _nb,
    clip_mv,
    get_colocated_mvp,
    mc_block,
    mi_at,
    round_amvr,
    tmvp_positions,
)
from refdec.frame.structure import CodingStructure, CodingUnit, MODE_INTER

MAX_CU_DEPTH = 7  # CommonDef.h:283
AMVP_MAX = 2


def _log2(v: int) -> int:
    return v.bit_length() - 1


def _clip18(v: int) -> int:
    """Mv::clipToStorageBitDepth (18-bit storage)."""
    return max(-(1 << 17), min((1 << 17) - 1, v))


def round_affine(x: int, y: int, shift: int) -> tuple[int, int]:
    """roundAffineMv (Mv.cpp:57)."""
    off = 1 << (shift - 1)
    return ((x + off - (x >= 0)) >> shift, (y + off - (y >= 0)) >> shift)


def cp_down(v: int, shift: int) -> int:
    """Mv::changePrecision downward step (Mv.h:177)."""
    off = 1 << (shift - 1)
    return (v + off - 1) >> shift if v >= 0 else (v + off) >> shift


def _round_prec(mv: tuple, imv: int) -> tuple:
    """roundToPrecision per affine AMVR mode: imv 0 -> quarter, 2 -> int."""
    if imv == 0:
        return round_amvr(mv, 2)
    if imv == 2:
        return round_amvr(mv, 4)
    return mv


def spread_over_limit(a: int, b: int, c: int, d: int, pred_type: int) -> bool:
    """isSubblockVectorSpreadOverLimit (InterPrediction.cpp:892)."""
    s4 = 4 << 11
    tap = 6
    if pred_type == 3:
        rw = max(0, 4 * a + s4, 4 * c, 4 * a + 4 * c + s4) \
            - min(0, 4 * a + s4, 4 * c, 4 * a + 4 * c + s4)
        rh = max(0, 4 * b, 4 * d + s4, 4 * b + 4 * d + s4) \
            - min(0, 4 * b, 4 * d + s4, 4 * b + 4 * d + s4)
        rw = (rw >> 11) + tap + 3
        rh = (rh >> 11) + tap + 3
        return rw * rh > (tap + 9) * (tap + 9)
    rw = max(0, 4 * a + s4) - min(0, 4 * a + s4)
    rh = max(0, 4 * b) - min(0, 4 * b)
    rw = (rw >> 11) + tap + 3
    rh = (rh >> 11) + tap + 3
    if rw * rh > (tap + 9) * (tap + 5):
        return True
    rw = max(0, 4 * c) - min(0, 4 * c)
    rh = max(0, 4 * d + s4) - min(0, 4 * d + s4)
    rw = (rw >> 11) + tap + 3
    rh = (rh >> 11) + tap + 3
    return rw * rh > (tap + 5) * (tap + 9)


def _deltas(lt: tuple, rt: tuple, lb: tuple, w: int, h: int,
            is6: bool) -> tuple[int, int, int, int]:
    shift = MAX_CU_DEPTH
    dhx = (rt[0] - lt[0]) << (shift - _log2(w))
    dhy = (rt[1] - lt[1]) << (shift - _log2(w))
    if is6:
        dvx = (lb[0] - lt[0]) << (shift - _log2(h))
        dvy = (lb[1] - lt[1]) << (shift - _log2(h))
    else:
        dvx, dvy = -dhy, dhx
    return dhx, dhy, dvx, dvy


def set_all_affine_mv(cs: CodingStructure, cu: CodingUnit, lt: tuple,
                      rt: tuple, lb: tuple, lst: int,
                      clip_cpmvs: bool = False) -> None:
    """PU::setAllAffineMv (UnitTools.cpp:2689): derive per-4x4 subblock MVs
    into the motion field and store CPMVs on the CU."""
    if clip_cpmvs:
        lt = (_clip18(lt[0]), _clip18(lt[1]))
        rt = (_clip18(rt[0]), _clip18(rt[1]))
        if cu.affine_type == 1:
            lb = (_clip18(lb[0]), _clip18(lb[1]))
    shift = MAX_CU_DEPTH
    dhx, dhy, dvx, dvy = _deltas(lt, rt, lb, cu.w, cu.h, cu.affine_type == 1)
    base_x = lt[0] << shift
    base_y = lt[1] << shift
    spread = spread_over_limit(dhx, dhy, dvx, dvy, cu.inter_dir)
    y4a, x4a = cu.y >> 2, cu.x >> 2
    w4, h4 = cu.w >> 2, cu.h >> 2
    if spread:
        fx, fy = round_affine(base_x + dhx * (cu.w >> 1) + dvx * (cu.h >> 1),
                              base_y + dhy * (cu.w >> 1) + dvy * (cu.h >> 1),
                              shift)
        cs.mi_mv[y4a:y4a + h4, x4a:x4a + w4, lst, 0] = _clip18(fx)
        cs.mi_mv[y4a:y4a + h4, x4a:x4a + w4, lst, 1] = _clip18(fy)
    else:
        xs = 2 + (np.arange(w4) << 2)
        ys = 2 + (np.arange(h4) << 2)
        hx = base_x + dhx * xs[None, :] + dvx * ys[:, None]
        hy = base_y + dhy * xs[None, :] + dvy * ys[:, None]
        off = 1 << (shift - 1)
        hx = (hx + off - (hx >= 0)) >> shift
        hy = (hy + off - (hy >= 0)) >> shift
        np.clip(hx, -(1 << 17), (1 << 17) - 1, out=hx)
        np.clip(hy, -(1 << 17), (1 << 17) - 1, out=hy)
        cs.mi_mv[y4a:y4a + h4, x4a:x4a + w4, lst, 0] = hx
        cs.mi_mv[y4a:y4a + h4, x4a:x4a + w4, lst, 1] = hy
    if not cu.cpmv:
        cu.cpmv = [[(0, 0)] * 3, [(0, 0)] * 3]
    cu.cpmv[lst] = [lt, rt, lb]
    if not cu.mv:
        cu.mv = [[0, 0], [0, 0]]
    cu.mv[lst] = [lt[0], lt[1]]


def span_affine_motion(cs: CodingStructure, cu: CodingUnit) -> None:
    """spanMotionInfo affine branch (UnitTools.cpp:3021): fill refIdx per
    4x4, zero MVs on lists without a valid reference."""
    y4a, y4b = cu.y >> 2, (cu.y + cu.h) >> 2
    x4a, x4b = cu.x >> 2, (cu.x + cu.w) >> 2
    for lst in range(2):
        cs.mi_ref[y4a:y4b, x4a:x4b, lst] = cu.ref_idx[lst]
        if cu.ref_idx[lst] < 0:
            cs.mi_mv[y4a:y4b, x4a:x4b, lst] = 0


def inherited_affine_mv(cs: CodingStructure, cu: CodingUnit, is6: bool,
                        nb: CodingUnit, lst: int) -> list[tuple]:
    """PU::xInheritedAffineMv (UnitTools.cpp:1785)."""
    shift = MAX_CU_DEPTH
    pnx, pny = nb.x, nb.y
    lt, rt, lb = [tuple(v) for v in nb.cpmv[lst]]
    top_ctu = ((nb.y + nb.h) % cs.sps.ctu_size == 0) and \
        (nb.y + nb.h == cu.y)
    if top_ctu:
        # inherit from the neighbour's bottom subblock row (motion field)
        blx, bly = nb.x, nb.y + nb.h - 1
        brx = nb.x + nb.w - 1
        lt = (int(cs.mi_mv[bly >> 2, blx >> 2, lst, 0]),
              int(cs.mi_mv[bly >> 2, blx >> 2, lst, 1]))
        rt = (int(cs.mi_mv[bly >> 2, brx >> 2, lst, 0]),
              int(cs.mi_mv[bly >> 2, brx >> 2, lst, 1]))
        pny += nb.h
    dhx = (rt[0] - lt[0]) << (shift - _log2(nb.w))
    dhy = (rt[1] - lt[1]) << (shift - _log2(nb.w))
    if nb.affine_type == 1 and not top_ctu:
        dvx = (lb[0] - lt[0]) << (shift - _log2(nb.h))
        dvy = (lb[1] - lt[1]) << (shift - _log2(nb.h))
    else:
        dvx, dvy = -dhy, dhx
    base_x = lt[0] << shift
    base_y = lt[1] << shift

    def at(px, py):
        x, y = round_affine(base_x + dhx * (px - pnx) + dvx * (py - pny),
                            base_y + dhy * (px - pnx) + dvy * (py - pny),
                            shift)
        return (_clip18(x), _clip18(y))

    out = [at(cu.x, cu.y), at(cu.x + cu.w, cu.y)]
    if is6:
        out.append(at(cu.x, cu.y + cu.h))
    else:
        out.append((0, 0))
    return out


# ---------------------------------------------------------------------------
# affine AMVP
# ---------------------------------------------------------------------------

def _affine_nb(cs, cu, px, py):
    """Affine-inheritable neighbour CU at luma pos (inter + affine +
    regular merge type)."""
    nb = _nb(cs, cu, px, py)
    if nb is None or not nb.affine_flag or nb.merge_type != 0:
        return None
    return nb


def _mvp_unscaled(cs, cu, lst, ref_idx, px, py):
    """addMVPCandUnscaled (UnitTools.cpp): neighbour MV with identical ref
    POC (either list), unscaled."""
    nb = _nb(cs, cu, px, py)
    if nb is None:
        return None
    e = mi_at(cs, nb, px, py)
    cur_poc = cs.ref_pocs[lst][ref_idx]
    for src in range(2):
        li = lst if src == 0 else 1 - lst
        nri = e[3 + li]
        if nri >= 0 and cur_poc == cs.ref_pocs[li][nri]:
            return e[1 + li]
    return None


def _add_affine_mvp_cand(cs, cu, lst, ref_idx, px, py):
    """addAffineMVPCandUnscaled (UnitTools.cpp:1696) for one position;
    returns rounded (lt, rt, lb) or None."""
    nb = _affine_nb(cs, cu, px, py)
    if nb is None:
        return None
    e = mi_at(cs, nb, px, py)
    cur_poc = cs.ref_pocs[lst][ref_idx]
    for src in range(2):
        li = lst if src == 0 else 1 - lst
        nri = e[3 + li]
        if not (nb.inter_dir & (li + 1)) or nri < 0 \
                or cs.ref_pocs[li][nri] != cur_poc:
            continue
        out = inherited_affine_mv(cs, cu, cu.affine_type == 1, nb, li)
        out[0] = _round_prec(out[0], cu.imv)
        out[1] = _round_prec(out[1], cu.imv)
        if cu.affine_type == 1:
            out[2] = _round_prec(out[2], cu.imv)
        return (out[0], out[1], out[2])
    return None


def fill_affine_mvp(cs: CodingStructure, cu: CodingUnit, lst: int,
                    ref_idx: int) -> list[tuple]:
    """PU::fillAffineMvpCand (UnitTools.cpp:1863).  Returns 2 candidates,
    each (lt, rt, lb), at the signalling precision (quarter-pel unless
    imv == 1)."""
    x, y, w, h = cu.x, cu.y, cu.w, cu.h
    cands: list[tuple] = []

    # inherited: left group (below-left, left), above group (above-right,
    # above, above-left)
    c = _add_affine_mvp_cand(cs, cu, lst, ref_idx, x - 1, y + h) or \
        _add_affine_mvp_cand(cs, cu, lst, ref_idx, x - 1, y + h - 1)
    if c:
        cands.append(c)
    c = _add_affine_mvp_cand(cs, cu, lst, ref_idx, x + w, y - 1) or \
        _add_affine_mvp_cand(cs, cu, lst, ref_idx, x + w - 1, y - 1) or \
        _add_affine_mvp_cand(cs, cu, lst, ref_idx, x - 1, y - 1)
    if c:
        cands.append(c)

    def finalize(cands):
        if cu.imv != 1:
            cands = [tuple((cp_down(m[0], 2), cp_down(m[1], 2)) for m in c)
                     for c in cands]
        return cands

    if len(cands) >= AMVP_MAX:
        return finalize(cands)[:AMVP_MAX]

    # constructed from corner MVPs
    v0 = _mvp_unscaled(cs, cu, lst, ref_idx, x - 1, y - 1) or \
        _mvp_unscaled(cs, cu, lst, ref_idx, x, y - 1) or \
        _mvp_unscaled(cs, cu, lst, ref_idx, x - 1, y)
    v1 = _mvp_unscaled(cs, cu, lst, ref_idx, x + w - 1, y - 1) or \
        _mvp_unscaled(cs, cu, lst, ref_idx, x + w, y - 1)
    v2 = _mvp_unscaled(cs, cu, lst, ref_idx, x - 1, y + h - 1) or \
        _mvp_unscaled(cs, cu, lst, ref_idx, x - 1, y + h)
    pattern = (1 if v0 else 0) | (2 if v1 else 0) | (4 if v2 else 0)
    out = [_round_prec(v or (0, 0), cu.imv) for v in (v0, v1, v2)]

    if pattern == 7 or (pattern == 3 and cu.affine_type == 0):
        cands.append((out[0], out[1], out[2]))

    if len(cands) < 2:
        for i in (2, 1, 0):
            if len(cands) >= AMVP_MAX:
                break
            if pattern & (1 << i):
                cands.append((out[i], out[i], out[i]))
        if len(cands) < 2 and cs.ph.temporal_mvp_enabled:
            c0_avail, pos_c0, pos_c1 = tmvp_positions(cs, cu)
            m = (get_colocated_mvp(cs, cu, lst, pos_c0, ref_idx)
                 if c0_avail else None) or \
                get_colocated_mvp(cs, cu, lst, pos_c1, ref_idx)
            if m is not None:
                m = _round_prec(m, cu.imv)
                cands.append((m, m, m))
        while len(cands) < AMVP_MAX:
            z = (0, 0)
            cands.append((z, z, z))
    return finalize(cands)[:AMVP_MAX]


# ---------------------------------------------------------------------------
# affine merge (including SbTMVP)
# ---------------------------------------------------------------------------

class AffCand:
    """One affine merge candidate (AffineMergeCtx slot)."""

    __slots__ = ("inter_dir", "mvf", "ref", "aff_type", "bcw", "subpu")

    def __init__(self, inter_dir=0, mvf=None, ref=(-1, -1), aff_type=0,
                 bcw=0, subpu=False):
        self.inter_dir = inter_dir
        # mvf[lst] = [mv_lt, mv_rt, mv_lb]
        self.mvf = mvf or [[(0, 0)] * 3, [(0, 0)] * 3]
        self.ref = list(ref)
        self.aff_type = aff_type
        self.bcw = bcw
        self.subpu = subpu


def clip_col_pos(px: int, py: int, cu: CodingUnit, cs: CodingStructure
                 ) -> tuple[int, int]:
    """clipColPos (UnitTools.cpp:2821)."""
    ctu = cs.sps.ctu_size
    log2 = _log2(ctu)
    ctu_x = (cu.x >> log2) << log2
    ctu_y = (cu.y >> log2) << log2
    hor_max = min(cs.w - 1, ctu_x + ctu + 3)
    ver_max = min(cs.h - 1, ctu_y + ctu - 1)
    return (min(hor_max, max(ctu_x, px)), min(ver_max, max(ctu_y, py)))


def _col_is_inter(cs, pos, cu) -> bool:
    sh = cs.sh_of(cu)
    col_lst = (1 - int(sh.collocated_from_l0)) if sh.is_b else 0
    col = cs.ref_cols[col_lst][sh.collocated_ref_idx]
    x8, y8 = pos[0] >> 3, pos[1] >> 3
    return col.ref_idx[y8, x8, 0] >= 0 or col.ref_idx[y8, x8, 1] >= 0


def derive_sbtmvp(cs: CodingStructure, cu: CodingUnit, mrg_idx: int,
                  a1_mi) -> AffCand | None:
    """getInterMergeSubPuMvpCand (UnitTools.cpp:2845).  Fills the motion
    field directly when this candidate is the selected one (mrg_idx == 0)."""
    sh = cs.sh_of(cu)
    is_b = sh.is_b
    col_lst = (1 - int(sh.collocated_from_l0)) if sh.is_b else 0
    col = cs.ref_cols[col_lst][sh.collocated_ref_idx]

    ctmv = (0, 0)
    if a1_mi is not None:
        if (a1_mi[0] & 1) and cs.ref_pocs[0][a1_mi[3]] == col.poc:
            ctmv = a1_mi[1]
        elif is_b and (a1_mi[0] & 2) and cs.ref_pocs[1][a1_mi[4]] == col.poc:
            ctmv = a1_mi[2]
    tx = cp_down(ctmv[0], 4)
    ty = cp_down(ctmv[1], 4)

    cx = cu.x + (cu.w >> 1) + tx
    cy = cu.y + (cu.h >> 1) + ty
    cx, cy = clip_col_pos(cx, cy, cu, cs)
    cx &= ~7
    cy &= ~7

    cand = AffCand(subpu=True)
    found = False
    if _col_is_inter(cs, (cx, cy), cu):
        for lst in range(2 if is_b else 1):
            m = get_colocated_mvp(cs, cu, lst, (cx, cy), 0, sb_flag=True)
            if m is not None:
                cand.mvf[lst][0] = m
                cand.ref[lst] = 0
                cand.inter_dir |= 1 << lst
                found = True
    if not found:
        return None
    if mrg_idx > 0:
        return cand

    # selected: span the per-8x8 colocated motion into the field
    y4a, x4a = cu.y >> 2, cu.x >> 2
    for by in range(0, cu.h, 8):
        for bx in range(0, cu.w, 8):
            px, py = clip_col_pos(cu.x + bx + 4 + tx, cu.y + by + 4 + ty,
                                  cu, cs)
            sub_found = False
            ref = [-1, -1]
            mv = [(0, 0), (0, 0)]
            if _col_is_inter(cs, (px, py), cu):
                for lst in range(2 if is_b else 1):
                    m = get_colocated_mvp(cs, cu, lst, (px, py), 0,
                                          sb_flag=True)
                    if m is not None:
                        ref[lst] = 0
                        mv[lst] = m
                        sub_found = True
            if not sub_found:
                mv = [cand.mvf[0][0], cand.mvf[1][0]]
                ref = [cand.ref[0], cand.ref[1]]
            y4, x4 = y4a + (by >> 2), x4a + (bx >> 2)
            for lst in range(2):
                cs.mi_ref[y4:y4 + 2, x4:x4 + 2, lst] = ref[lst]
                cs.mi_mv[y4:y4 + 2, x4:x4 + 2, lst] = mv[lst]
    return cand


def _ctrl_point_cand(cs, cu, mi, avail, ver_idx, bcw, model_idx, ver_num
                    ) -> AffCand | None:
    """getAffineControlPointCand (UnitTools.cpp:2183).  mi[k] are merge-style
    motion tuples (dir, mv0, mv1, r0, r1) for corners LT/RT/LB/RB."""
    shift = MAX_CU_DEPTH
    shift_htow = shift + _log2(cu.w) - _log2(cu.h)
    ref = [-1, -1]
    direction = 0
    idxs = ver_idx[:ver_num]
    if any(not avail[i] for i in idxs):
        return None
    for lst in range(2):
        rs = [mi[i][3 + lst] for i in idxs]
        if all(r >= 0 for r in rs) and all(r == rs[0] for r in rs):
            direction |= lst + 1
            ref[lst] = rs[0]
    if direction == 0:
        return None

    mvf = [[(0, 0)] * 3, [(0, 0)] * 3]
    for lst in range(2):
        if not (direction & (lst + 1)):
            continue
        c = [(0, 0)] * 4
        for i in idxs:
            c[i] = mi[i][1 + lst]
        if model_idx == 1:  # LT, RT, RB -> derive LB
            c[2] = (_clip18(c[3][0] + c[0][0] - c[1][0]),
                    _clip18(c[3][1] + c[0][1] - c[1][1]))
        elif model_idx == 2:  # LT, LB, RB -> derive RT
            c[1] = (_clip18(c[3][0] + c[0][0] - c[2][0]),
                    _clip18(c[3][1] + c[0][1] - c[2][1]))
        elif model_idx == 3:  # RT, LB, RB -> derive LT
            c[0] = (_clip18(c[1][0] + c[2][0] - c[3][0]),
                    _clip18(c[1][1] + c[2][1] - c[3][1]))
        elif model_idx == 5:  # LT, LB -> derive RT (rotate)
            vx = (c[0][0] << shift) + ((c[2][1] - c[0][1]) << shift_htow)
            vy = (c[0][1] << shift) - ((c[2][0] - c[0][0]) << shift_htow)
            vx, vy = round_affine(vx, vy, shift)
            c[1] = (_clip18(vx), _clip18(vy))
        mvf[lst] = [c[0], c[1], c[2]]
    return AffCand(direction, mvf, ref, 0 if ver_num == 2 else 1,
                   bcw if direction == 3 else 0)


def derive_affine_merge(cs: CodingStructure, cu: CodingUnit, mrg_idx: int
                        ) -> list[AffCand]:
    """PU::getAffineMergeCand (UnitTools.cpp:2378).  Returns the candidate
    list at least up to index mrg_idx; fills the SbTMVP motion field when
    that candidate is selected."""
    sh = cs.sh_of(cu)
    is_b = sh.is_b
    max_num = cs.ph.max_num_affine_merge_cand
    cands: list[AffCand] = []

    enable_subpu = cs.sps.sbtmvp_enabled and not (
        sh.poc == cs.ref_pocs[0][0] and getattr(sh, "is_irap", False))
    if enable_subpu and cs.ph.temporal_mvp_enabled:
        a1 = _nb(cs, cu, cu.x - 1, cu.y + cu.h - 1)
        a1_mi = mi_at(cs, a1, cu.x - 1, cu.y + cu.h - 1) if a1 else None
        sub = derive_sbtmvp(cs, cu, mrg_idx, a1_mi)
        if sub is not None:
            cands.append(sub)
            if len(cands) == mrg_idx + 1 or len(cands) == max_num:
                return cands

    if cs.sps.affine_enabled:
        # inherited candidates: first of {A0, A1}, first of {B0, B1, B2}
        x, y, w, h = cu.x, cu.y, cu.w, cu.h
        nbs = []
        nb = _affine_nb(cs, cu, x - 1, y + h) or \
            _affine_nb(cs, cu, x - 1, y + h - 1)
        if nb:
            nbs.append(nb)
        nb = _affine_nb(cs, cu, x + w, y - 1) or \
            _affine_nb(cs, cu, x + w - 1, y - 1) or \
            _affine_nb(cs, cu, x - 1, y - 1)
        if nb:
            nbs.append(nb)
        for nb in nbs:
            cand = AffCand(nb.inter_dir, aff_type=nb.affine_type,
                           bcw=nb.bcw_idx, ref=(nb.ref_idx[0], nb.ref_idx[1]))
            if nb.inter_dir != 2:
                cand.mvf[0] = inherited_affine_mv(
                    cs, cu, nb.affine_type == 1, nb, 0)
            if is_b and nb.inter_dir != 1:
                cand.mvf[1] = inherited_affine_mv(
                    cs, cu, nb.affine_type == 1, nb, 1)
            cands.append(cand)
            if len(cands) - 1 == mrg_idx or len(cands) == max_num:
                return cands

        # constructed candidates
        mi = [None] * 4
        avail = [False] * 4
        nei_bcw = [0, 0]
        # LT: B2 -> B3 -> A2
        for px, py in ((x - 1, y - 1), (x, y - 1), (x - 1, y)):
            nb = _nb(cs, cu, px, py)
            if nb is not None:
                avail[0] = True
                mi[0] = mi_at(cs, nb, px, py)
                nei_bcw[0] = nb.bcw_idx
                break
        # RT: B1 -> B0
        for px, py in ((x + w - 1, y - 1), (x + w, y - 1)):
            nb = _nb(cs, cu, px, py)
            if nb is not None:
                avail[1] = True
                mi[1] = mi_at(cs, nb, px, py)
                nei_bcw[1] = nb.bcw_idx
                break
        # LB: A1 -> A0
        for px, py in ((x - 1, y + h - 1), (x - 1, y + h)):
            nb = _nb(cs, cu, px, py)
            if nb is not None:
                avail[2] = True
                mi[2] = mi_at(cs, nb, px, py)
                break
        # RB: colocated C0
        if cs.ph.temporal_mvp_enabled:
            c0_avail, pos_c0, _ = tmvp_positions(cs, cu)
            mv0 = get_colocated_mvp(cs, cu, 0, pos_c0, 0) if c0_avail else None
            mv1 = (get_colocated_mvp(cs, cu, 1, pos_c0, 0)
                   if (c0_avail and is_b) else None)
            if mv0 is not None or mv1 is not None:
                avail[3] = True
                mi[3] = ((1 if mv0 else 0) + (2 if mv1 else 0),
                         mv0 or (0, 0), mv1 or (0, 0),
                         0 if mv0 else -1, 0 if mv1 else -1)

        models = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3), (0, 1), (0, 2))
        start = 0 if cs.sps.affine_6param else 4
        for model_idx in range(start, 6):
            ver_idx = list(models[model_idx]) + [0]
            cand = _ctrl_point_cand(cs, cu, mi, avail, ver_idx,
                                    nei_bcw[1] if model_idx == 3
                                    else nei_bcw[0],
                                    model_idx, len(models[model_idx]))
            if cand is not None:
                cands.append(cand)
                if len(cands) - 1 == mrg_idx:
                    return cands
                if len(cands) == max_num:
                    return cands

    # zero padding
    while len(cands) < max_num:
        cand = AffCand(3 if is_b else 1, ref=(0, 0 if is_b else -1))
        cands.append(cand)
    return cands


# ---------------------------------------------------------------------------
# MC: affine subblocks with PROF
# ---------------------------------------------------------------------------

PROF_DMV_LIMIT = (1 << 5) - 1


def prof_dmv_grid(lt: tuple, rt: tuple, lb: tuple, w: int, h: int,
                  is6: bool) -> tuple[np.ndarray, np.ndarray]:
    """The per-pixel 4x4 dMv grid (xPredAffineBlk, InterPrediction.cpp:1045)."""
    dhx, dhy, dvx, dvy = _deltas(lt, rt, lb, w, h, is6)
    qhx, qhy = dhx << 2, dhy << 2
    qvx, qvy = dvx << 2, dvy << 2
    dmv_h = np.zeros((4, 4), dtype=np.int64)
    dmv_v = np.zeros((4, 4), dtype=np.int64)
    dmv_h[0, 0] = ((dhx + dvx) * 2) - ((qhx + qvx) * 2)
    dmv_v[0, 0] = ((dhy + dvy) * 2) - ((qhy + qvy) * 2)
    for c in range(1, 4):
        dmv_h[0, c] = dmv_h[0, c - 1] + qhx
        dmv_v[0, c] = dmv_v[0, c - 1] + qhy
    for r in range(1, 4):
        dmv_h[r] = dmv_h[r - 1] + qvx
        dmv_v[r] = dmv_v[r - 1] + qvy
    off = 1 << 7
    dmv_h = (dmv_h + off - (dmv_h >= 0)) >> 8
    dmv_v = (dmv_v + off - (dmv_v >= 0)) >> 8
    np.clip(dmv_h, -PROF_DMV_LIMIT, PROF_DMV_LIMIT, out=dmv_h)
    np.clip(dmv_v, -PROF_DMV_LIMIT, PROF_DMV_LIMIT, out=dmv_v)
    return dmv_h, dmv_v


def _ref_at(ref: np.ndarray, ys, xs, wrap_off: int | None = None
            ) -> np.ndarray:
    hh, ww = ref.shape
    if wrap_off is not None:
        from refdec.frame.inter_np import wrap_cols
        cols = wrap_cols(np.asarray(xs), ww, wrap_off)
    else:
        cols = np.clip(xs, 0, ww - 1)
    return ref[np.ix_(np.clip(ys, 0, hh - 1), cols)].astype(np.int64)


def affine_luma_4x4(ref: np.ndarray, bx: int, by: int, mv: tuple,
                    bit_depth: int, bi: bool, prof: bool,
                    dmv_h: np.ndarray | None, dmv_v: np.ndarray | None,
                    wrap_off: int | None = None) -> np.ndarray:
    """One 4x4 luma affine subblock at (bx, by): 6-tap MC plus optional PROF
    refinement.  Returns final pixels (uni) or 14-bit intermediate (bi)."""
    shift = max(2, IF_INTERNAL_PREC - bit_depth)
    if not prof:
        return mc_block(ref, bx, by, 4, 4, mv, 0, bit_depth, (2, 2), bi,
                        luma_table=LUMA_IF_4X4, wrap_off=wrap_off)
    blk = mc_block(ref, bx, by, 4, 4, mv, 0, bit_depth, (2, 2), True,
                   luma_table=LUMA_IF_4X4, wrap_off=wrap_off)
    fx, fy = mv[0] & 15, mv[1] & 15
    ix, iy = mv[0] >> 4, mv[1] >> 4
    x_off = fx >> 3
    y_off = fy >> 3
    # extended 6x6 buffer: centre = filtered block, border = shifted
    # integer reference samples (PaddBIO, InterPrediction.cpp:269)
    ext = np.zeros((6, 6), dtype=np.int64)
    ext[1:5, 1:5] = blk
    x0 = bx + ix + x_off
    y0 = by + iy + y_off
    cols = np.arange(x0 - 1, x0 + 5)
    ext[0, :] = (_ref_at(ref, [y0 - 1], cols, wrap_off)[0] << shift) - IF_INTERNAL_OFFS
    ext[5, :] = (_ref_at(ref, [y0 + 4], cols, wrap_off)[0] << shift) - IF_INTERNAL_OFFS
    rows = np.arange(y0, y0 + 4)
    ext[1:5, 0] = (_ref_at(ref, rows, [x0 - 1], wrap_off)[:, 0] << shift) \
        - IF_INTERNAL_OFFS
    ext[1:5, 5] = (_ref_at(ref, rows, [x0 + 4], wrap_off)[:, 0] << shift) \
        - IF_INTERNAL_OFFS
    # gradients over the inner 4x4 (gradFilterCore<false>)
    grad_x = (ext[1:5, 2:6] >> 6) - (ext[1:5, 0:4] >> 6)
    grad_y = (ext[2:6, 1:5] >> 6) - (ext[0:4, 1:5] >> 6)
    d_i = dmv_h * grad_x + dmv_v * grad_y
    lim = 1 << max(bit_depth + 1, 13)
    np.clip(d_i, -lim, lim - 1, out=d_i)
    out = blk + d_i
    if bi:
        return out
    offset = (1 << (shift - 1)) + IF_INTERNAL_OFFS
    return np.clip((out + offset) >> shift, 0, (1 << bit_depth) - 1)


def affine_pred(cs: CodingStructure, cu: CodingUnit, lst: int,
                bit_depth: int, force_intermediate: bool = False
                ) -> list[np.ndarray]:
    """Affine prediction of one list for all components
    (xPredAffineBlk, InterPrediction.cpp:934)."""
    bi = cu.inter_dir == 3 or force_intermediate
    planes = cs.ref_planes[lst][cu.ref_idx[lst]]
    scl = getattr(cs, "ref_scaled", None)
    scaled = scl[lst][cu.ref_idx[lst]] \
        if scl and cu.ref_idx[lst] < len(scl[lst]) else None
    lt, rt, lb = [tuple(v) for v in cu.cpmv[lst]]
    is6 = cu.affine_type == 1
    dhx, dhy, dvx, dvy = _deltas(lt, rt, lb, cu.w, cu.h, is6)
    spread = spread_over_limit(dhx, dhy, dvx, dvy, cu.inter_dir)
    # PROF is disabled with scaled references (xPredAffineBlk RPR branch)
    prof = (scaled is None and cs.sps.prof_enabled
            and not cs.ph.prof_disabled
            and not spread
            and not (lt == rt if not is6 else (lt == rt and lt == lb)))

    def rpr_sub(comp, bx, by, mv_raw):
        from refdec.frame.rpr_np import rpr_mc_block
        scaling, ref_pps = scaled
        return rpr_mc_block(
            planes[comp], scaling, cs.pps, ref_pps,
            cs.sps.chroma_format_idc, comp, bx, by, 4, 4, mv_raw,
            bit_depth, bi, filter_index=2,
            hor_collocated=cs.sps.chroma_hor_collocated,
            ver_collocated=cs.sps.chroma_ver_collocated)
    dmv_h = dmv_v = None
    if prof:
        dmv_h, dmv_v = prof_dmv_grid(lt, rt, lb, cu.w, cu.h, is6)

    y4a, x4a = cu.y >> 2, cu.x >> 2
    w4, h4 = cu.w >> 2, cu.h >> 2
    out_l = np.zeros((cu.h, cu.w), dtype=np.int64)
    mvs = [[None] * w4 for _ in range(h4)]
    for r in range(h4):
        for c in range(w4):
            mv = (int(cs.mi_mv[y4a + r, x4a + c, lst, 0]),
                  int(cs.mi_mv[y4a + r, x4a + c, lst, 1]))
            mvs[r][c] = mv
            if scaled is not None:
                # scaled ref: unclamped subblock MV through the RPR path
                out_l[r * 4:r * 4 + 4, c * 4:c * 4 + 4] = rpr_sub(
                    0, cu.x + c * 4, cu.y + r * 4, mv)
                continue
            woff = None
            if cs.sps.ref_wraparound_enabled and cs.pps.ref_wraparound_enabled:
                # per-subblock wrap (xPredAffineBlk, InterPrediction.cpp:1182)
                from refdec.frame.inter_np import wrap_clip_mv
                mvc, wref = wrap_clip_mv(mv, cu.x + c * 4, cu.y + r * 4,
                                         4, 4, cs)
                woff = cs.pps.wraparound_offset if wref else None
            else:
                mvc = clip_mv(mv, cu.x, cu.y, cs)
            out_l[r * 4:r * 4 + 4, c * 4:c * 4 + 4] = affine_luma_4x4(
                planes[0], cu.x + c * 4, cu.y + r * 4, mvc, bit_depth, bi,
                prof, dmv_h, dmv_v, wrap_off=woff)
    preds = [out_l]
    if cs.num_comp > 1:
        sub_w, sub_h = cs.sub_w, cs.sub_h
        cw4, ch4 = cu.cw >> 2, cu.ch >> 2
        out_c = [np.zeros((cu.ch, cu.cw), dtype=np.int64) for _ in range(2)]
        for r in range(ch4):
            for c in range(cw4):
                if sub_w == 2 and sub_h == 2:       # 420: diagonal pair
                    a = mvs[2 * r][2 * c]
                    b = mvs[2 * r + 1][2 * c + 1]
                    mx, my = round_affine(a[0] + b[0], a[1] + b[1], 1)
                elif sub_w == 2:                    # 422: horizontal pair
                    a = mvs[r][2 * c]
                    b = mvs[r][2 * c + 1]
                    mx, my = round_affine(a[0] + b[0], a[1] + b[1], 1)
                else:                               # 444: direct
                    mx, my = mvs[r][c]
                if scaled is not None:
                    for comp in (1, 2):
                        out_c[comp - 1][r * 4:r * 4 + 4, c * 4:c * 4 + 4] = \
                            rpr_sub(comp, cu.cx + c * 4, cu.cy + r * 4,
                                    (mx, my))
                    continue
                woff = None
                if cs.sps.ref_wraparound_enabled \
                        and cs.pps.ref_wraparound_enabled:
                    from refdec.frame.inter_np import wrap_clip_mv
                    mvc, wref = wrap_clip_mv(
                        (mx, my), cu.x + ((c * 4) << (sub_w - 1)),
                        cu.y + ((r * 4) << (sub_h - 1)),
                        4 << (sub_w - 1), 4 << (sub_h - 1), cs)
                    woff = cs.pps.wraparound_offset if wref else None
                else:
                    mvc = clip_mv((mx, my), cu.x, cu.y, cs)
                for comp in (1, 2):
                    out_c[comp - 1][r * 4:r * 4 + 4, c * 4:c * 4 + 4] = \
                        mc_block(planes[comp], cu.cx + c * 4, cu.cy + r * 4,
                                 4, 4, mvc, comp, bit_depth, (sub_w, sub_h),
                                 bi, wrap_off=None if woff is None
                                 else woff >> (sub_w - 1))
        preds += out_c
    return preds
