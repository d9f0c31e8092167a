"""Numpy golden inter prediction: motion derivation + motion compensation.

Behavioral parity (re-designed, not ported):
  - merge list:   PU::getInterMergeCandidates (UnitTools.cpp:841),
                  PU::addMergeHMVPCand (:3770 region), pairwise/zero tail
  - AMVP list:    PU::fillMvpCand (:?), addMVPCandUnscaled, addAMVPHMVPCand
  - HMVP:         MotionHist::addMiToLut (MotionInfo.h:242); reset per CTU row
  - MV clip:      clipMvInPic (Mv.cpp:64)
  - MC filters:   InterpolationFilter::filter<N> (InterpolationFilter.cpp:556),
                  filterCopy (:424); bi average AreaBuf::addAvg (Buffer.cpp:441)

Scope: regular inter (no affine/SbTMVP/MMVD/GPM/CIIP/BCW/DMVR/BDOF); TMVP
optional off.  MVs stored in 1/16 luma sample units.
"""

from __future__ import annotations

import os

import numpy as np

from refdec.frame.structure import CodingStructure, CodingUnit, MODE_INTER

_IF = np.load(os.path.join(os.path.dirname(__file__), "..", "ops",
                           "tables_if.npz"))
LUMA_IF = _IF["LUMA_IF"]          # [16][8]
CHROMA_IF = _IF["CHROMA_IF"]      # [32][4]
LUMA_IF_4X4 = _IF["LUMA_IF_4X4"]  # [16][8] 6-tap (affine 4x4 blocks)
BILINEAR_IF = _IF["BILINEAR_IF"]  # [16][2] (DMVR pre-search)

IF_INTERNAL_PREC = 14
IF_FILTER_PREC = 6
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)
MAX_NUM_HMVP = 5
AMVP_MAX = 2
MAX_NUM_HMVP_AMVP = 4


class MotionHist:
    """History-based MVP tables (regular inter + IBC, MotionInfo.h:237).

    The regular LUT is mirrored into a flat int32 buffer (`buf`/`nbuf`,
    oldest entry first, rows (dir, mv0x, mv0y, mv1x, mv1y, r0, r1, bcw,
    alt)) so the native candidate-derivation kernels can read it."""

    def __init__(self) -> None:
        self._lut: list[tuple] = []  # entries: (inter_dir, mv0, mv1, r0, r1)
        self._dirty = False          # buf/nbuf newer than the mirror
        self.lut_ibc: list[tuple] = []  # entries: (bvx, bvy)
        self.buf = np.zeros((MAX_NUM_HMVP, 9), dtype=np.int32)
        self.nbuf = np.zeros(1, dtype=np.int32)

    @property
    def lut(self) -> list:
        # rebuilt lazily: the native inter driver (walk9.c) updates
        # buf/nbuf in place for EVERY segment, but the Python mirror is
        # only needed when a Python-path CU derives candidates
        if self._dirty:
            self._dirty = False
            self._lut = [
                (int(r[0]), (int(r[1]), int(r[2])),
                 (int(r[3]), int(r[4])), int(r[5]), int(r[6]),
                 int(r[7]), bool(r[8]))
                for r in self.buf[: int(self.nbuf[0])]]
        return self._lut

    @lut.setter
    def lut(self, v: list) -> None:
        self._lut = v
        self._dirty = False

    def reset(self) -> None:
        self.lut = []
        self.lut_ibc = []
        self.nbuf[0] = 0

    @staticmethod
    def _add(lut: list, mi) -> None:
        for i, e in enumerate(lut):
            if e == mi:
                del lut[i]
                break
        else:
            if len(lut) == MAX_NUM_HMVP:
                del lut[0]
        lut.append(mi)

    def add(self, mi: tuple) -> None:
        self._add(self.lut, mi)
        for i, e in enumerate(self.lut):
            self.buf[i] = (e[0], e[1][0], e[1][1], e[2][0], e[2][1],
                           e[3], e[4], e[5], int(e[6]))
        self.nbuf[0] = len(self.lut)

    def add_ibc(self, bv: tuple) -> None:
        self._add(self.lut_ibc, bv)

    def sync_from_buf(self) -> None:
        """Mark the Python mirror stale after the native inter driver
        (walk9.c) updated buf/nbuf in place; the rebuild happens on the
        next .lut read (usually never — C handles the following CUs)."""
        self._dirty = True


def _mi_of(cu: CodingUnit) -> tuple:
    """(inter_dir, mv0, mv1, ref0, ref1, bcw_fwd, alt_hpel)."""
    mv = cu.mv if cu.mv else [[0, 0], [0, 0]]
    return (cu.inter_dir, tuple(mv[0]), tuple(mv[1]),
            cu.ref_idx[0], cu.ref_idx[1], cu.bcw_idx, cu.alt_hpel)


def _mi_eq(a: tuple, b: tuple) -> bool:
    """MotionInfo operator== (MotionInfo.h:127): refIdx match; MVs compared
    only on lists with a valid reference."""
    if a[3] != b[3] or a[4] != b[4]:
        return False
    if a[3] >= 0 and a[1] != b[1]:
        return False
    if a[4] >= 0 and a[2] != b[2]:
        return False
    return True


def _nb(cs: CodingStructure, cu: CodingUnit, x: int, y: int):
    """Inter neighbor CU at luma pos (getCURestricted + isInter)."""
    if x < 0 or y < 0 or x >= cs.w or y >= cs.h:
        return None
    nb = cs.cu_at_restricted(x, y, cu, 0)
    if nb is None or nb.pred_mode != MODE_INTER or nb.idx >= cu.idx:
        return None
    return nb


def mi_at(cs: CodingStructure, nb: CodingUnit, x: int, y: int) -> tuple:
    """Motion info at a position from the 4x4 field (getMotionInfo(pos));
    bcw/alt taken from the owning CU (CU-level attributes)."""
    y4, x4 = y >> 2, x >> 2
    r0 = int(cs.mi_ref[y4, x4, 0])
    r1 = int(cs.mi_ref[y4, x4, 1])
    d = (1 if r0 >= 0 else 0) + (2 if r1 >= 0 else 0)
    return (d,
            (int(cs.mi_mv[y4, x4, 0, 0]), int(cs.mi_mv[y4, x4, 0, 1])),
            (int(cs.mi_mv[y4, x4, 1, 0]), int(cs.mi_mv[y4, x4, 1, 1])),
            r0, r1, nb.bcw_idx if nb is not None else 0,
            (nb.imv == 3) if nb is not None else False)


def span_motion(cs: CodingStructure, cu: CodingUnit) -> None:
    """spanMotionInfo for uniform-motion CUs (UnitTools.cpp:3005)."""
    y4a, y4b = cu.y >> 2, (cu.y + cu.h) >> 2
    x4a, x4b = cu.x >> 2, (cu.x + cu.w) >> 2
    for lst in range(2):
        if cu.ref_idx[lst] >= 0:
            cs.mi_ref[y4a:y4b, x4a:x4b, lst] = cu.ref_idx[lst]
            cs.mi_mv[y4a:y4b, x4a:x4b, lst, 0] = cu.mv[lst][0]
            cs.mi_mv[y4a:y4b, x4a:x4b, lst, 1] = cu.mv[lst][1]
        else:
            cs.mi_ref[y4a:y4b, x4a:x4b, lst] = -1
            cs.mi_mv[y4a:y4b, x4a:x4b, lst] = 0



class ColMotion:
    """Collocated (temporal) motion field of a decoded picture: the 4x4
    motion grid subsampled to 8x8 (DecCu.cpp:218) plus the slice's ref POC
    lists for scaling."""

    def __init__(self, cs: CodingStructure, poc: int) -> None:
        self.poc = poc
        self.ref_pocs = [list(cs.ref_pocs[0]), list(cs.ref_pocs[1])]
        h8 = (cs.h + 7) >> 3
        w8 = (cs.w + 7) >> 3
        self.ref_idx = np.full((h8, w8, 2), -1, dtype=np.int8)
        self.mv = np.zeros((h8, w8, 2, 2), dtype=np.int32)
        self.ref_idx = cs.mi_ref[::2, ::2].copy()
        self.mv = cs.mi_mv[::2, ::2].copy()
        if self.ref_idx.shape[0] != h8 or self.ref_idx.shape[1] != w8:
            self.ref_idx = self.ref_idx[:h8, :w8]
            self.mv = self.mv[:h8, :w8]
        # per-slice RPLs: the colocated MV's ref POC depends on the slice
        # that coded it (Slice::constructRefPicLists is per slice)
        self.slice_pocs = None
        if getattr(cs, "per_slice_rpl", False):
            self.slice_pocs = [
                None if st is None else [list(st[0][0]), list(st[0][1])]
                for st in cs.slice_ref_sets]
            self.slice8 = cs.slice_map[::2, ::2][:h8, :w8].copy()

    def poc_at(self, y8: int, x8: int, e_col: int, col_ref: int) -> int:
        """Ref POC of the colocated MV at (y8, x8)."""
        if self.slice_pocs is not None:
            si = int(self.slice8[y8, x8])
            if 0 <= si < len(self.slice_pocs) \
                    and self.slice_pocs[si] is not None:
                return self.slice_pocs[si][e_col][col_ref]
        return self.ref_pocs[e_col][col_ref]


def _round_mv_comp(v: int) -> int:
    """18-bit MV mantissa/exponent compression round trip
    (convertMvFixedToFloat/convertMvFloatToFixed, UnitTools.cpp:1332)."""
    sign = -1 if v < 0 else 0
    scale = max(((v ^ sign) | 31).bit_length() - 1 - 5, -1)
    if scale >= 0:
        rnd = (1 << scale) >> 1
        n = (v + rnd) >> scale
        exponent = scale + ((n ^ sign) >> 5)
        mantissa = (n & 31) | (sign * 32)
    else:
        exponent = 0
        mantissa = v
    if exponent == 0:
        return mantissa
    return (mantissa ^ 32) * (1 << (exponent - 1))


def _scale_mv(mv: tuple, scale: int) -> tuple:
    """Mv::scaleMv (Mv.h:170)."""
    out = []
    for v in mv:
        p = scale * v
        out.append(max(-131072, min(131071, (p + 128 - (p >= 0)) >> 8)))
    return tuple(out)


def _dist_scale(cur_poc, cur_ref_poc, col_poc, col_ref_poc) -> int:
    dd = col_poc - col_ref_poc
    db = cur_poc - cur_ref_poc
    if dd == db:
        return 4096
    tdb = max(-128, min(127, db))
    tdd = max(-128, min(127, dd))

    def cdiv(a, b):  # C integer division (truncate toward zero)
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q

    ix = cdiv(0x4000 + abs(cdiv(tdd, 2)), tdd)
    return max(-4096, min(4095, (tdb * ix + 32) >> 6))


def get_colocated_mvp(cs: CodingStructure, cu: CodingUnit, lst: int,
                      pos: tuple, ref_idx: int, sb_flag: bool = False):
    """PU::getColocatedMVP (UnitTools.cpp:1410).  Returns scaled MV tuple
    or None.  sb_flag selects the SbTMVP list-derivation variant."""
    sh = cs.sh_of(cu)
    col_lst = (1 - int(sh.collocated_from_l0)) if sh.is_b else 0
    col = cs.ref_cols[col_lst][sh.collocated_ref_idx]
    px, py = pos
    if px >= cs.w or py >= cs.h or px < 0 or py < 0:
        return None
    x8, y8 = px >> 3, py >> 3
    e_col = lst if cs.check_ldc else int(sh.collocated_from_l0)
    if col.ref_idx[y8, x8, 0] < 0 and col.ref_idx[y8, x8, 1] < 0:
        return None
    if sb_flag and not cs.check_ldc:
        e_col = lst
        col_ref = int(col.ref_idx[y8, x8, e_col])
        if col_ref < 0:
            return None
    else:
        col_ref = int(col.ref_idx[y8, x8, e_col])
        if col_ref < 0:
            e_col = 1 - e_col
            col_ref = int(col.ref_idx[y8, x8, e_col])
            if col_ref < 0:
                return None
    mv = (int(col.mv[y8, x8, e_col, 0]), int(col.mv[y8, x8, e_col, 1]))
    mv = (_round_mv_comp(mv[0]), _round_mv_comp(mv[1]))
    cur_poc = sh.poc
    cur_ref_poc = cs.ref_pocs[lst][ref_idx]
    col_poc = col.poc
    col_ref_poc = col.poc_at(y8, x8, e_col, col_ref)
    scale = _dist_scale(cur_poc, cur_ref_poc, col_poc, col_ref_poc)
    if scale == 4096:
        return (max(-(1 << 17), min((1 << 17) - 1, mv[0])),
                max(-(1 << 17), min((1 << 17) - 1, mv[1])))
    return _scale_mv(mv, scale)


def tmvp_positions(cs: CodingStructure, cu: CodingUnit):
    """(c0_avail, posC0, posC1) — the bottom-right and center collocated
    positions with the CTU-row restriction."""
    ctu = cs.sps.ctu_size
    rb = (cu.x + cu.w - 1 - 3, cu.y + cu.h - 1 - 3)
    boundary = (rb[0] + 4 < cs.w) and (rb[1] + 4 < cs.h)
    c0_avail = boundary and ((rb[1] & (ctu - 1)) + 4 < ctu)
    pos_c0 = (rb[0] + 4, rb[1] + 4)
    pos_c1 = (cu.x + (cu.w >> 1), cu.y + (cu.h >> 1))
    return c0_avail, pos_c0, pos_c1


def _motion_ctx(cs: CodingStructure, hist: MotionHist):
    """Native candidate-derivation context (walk8.c MotionCtx), built once
    per picture over the flat CU records + motion-field planes; None when
    the native path is unavailable (Python fallback)."""
    cached = getattr(cs, "_mctx", None)
    if cached is not None:
        ctx, hist_ref = cached
        return ctx if hist_ref is hist else None
    ctx = _build_motion_ctx(cs, hist)
    cs._mctx = (ctx, hist)
    return ctx


def _build_motion_ctx(cs, hist):
    import os
    if os.environ.get("REFDEC_NO_NATIVE") == "1" \
            or os.environ.get("REFDEC_NO_NATIVE_MOTION") == "1":
        return None
    nw = getattr(cs, "_nw", None)
    if nw is None or not len(cs.cus):
        return None
    if getattr(cs, "per_slice_rpl", False):
        # per-slice RPLs: the C context models one ref set per picture
        return None
    from refdec.native import native_cabac
    nc = native_cabac()
    if nc is None or not hasattr(nc, "MotionCtx"):
        return None
    n_cu = len(cs.cus)
    ref_pocs = getattr(cs, "ref_pocs", None)
    if ref_pocs is None or any(len(lst) > 17 for lst in ref_pocs):
        return None
    from refdec.cabac.native_walk import CU_F
    rec = nw["cu_rec"]
    side = np.empty((n_cu, 2), dtype=np.int32)
    side[:, 0] = rec[:n_cu, CU_F["bcw"]]
    side[:, 1] = rec[:n_cu, CU_F["imv"]]
    cs._mctx_side = side
    pocs_cur = np.zeros((2, 17), dtype=np.int32)
    for lst in range(2):
        pocs_cur[lst, : len(ref_pocs[lst])] = ref_pocs[lst]
    # per-slice table + deduped collocated pictures
    cols: list[tuple] = []
    col_ids: dict[int, int] = {}
    slt = np.zeros((len(cs.shs), 5), dtype=np.int32)
    tmvp = bool(cs.ph.temporal_mvp_enabled)
    keep = [side, pocs_cur, slt, hist.buf, hist.nbuf]
    for i, sh in enumerate(cs.shs):
        slt[i, 0] = int(sh.is_b)
        slt[i, 1] = sh.num_ref_idx_active[0]
        slt[i, 2] = sh.num_ref_idx_active[1]
        slt[i, 3] = -1
        slt[i, 4] = int(sh.collocated_from_l0)
        if tmvp and sh.slice_type != 2:  # not I_SLICE
            col_lst = (1 - int(sh.collocated_from_l0)) if sh.is_b else 0
            ref_cols = getattr(cs, "ref_cols", None)
            if ref_cols is None or sh.collocated_ref_idx >= len(
                    ref_cols[col_lst]):
                return None
            col = ref_cols[col_lst][sh.collocated_ref_idx]
            if col is None:
                continue
            ci = col_ids.get(id(col))
            if ci is None:
                if not (col.ref_idx.flags["C_CONTIGUOUS"]
                        and col.mv.flags["C_CONTIGUOUS"]
                        and col.ref_idx.dtype == np.int8
                        and col.slice_pocs is None
                        and all(len(p) <= 17 for p in col.ref_pocs)):
                    return None
                cpocs = np.zeros((2, 17), dtype=np.int32)
                for lst in range(2):
                    cpocs[lst, : len(col.ref_pocs[lst])] = \
                        col.ref_pocs[lst]
                keep.append(cpocs)
                ci = len(cols)
                cols.append((col.ref_idx, col.mv, int(col.poc), cpocs,
                             int(col.ref_idx.shape[1]),
                             int(col.ref_idx.shape[0])))
                col_ids[id(col)] = ci
            slt[i, 3] = ci
    if cs.mi_ref.dtype != np.int8 or not cs.mi_ref.flags["C_CONTIGUOUS"] \
            or not cs.mi_mv.flags["C_CONTIGUOUS"] \
            or not cs.cu_map.flags["C_CONTIGUOUS"]:
        return None
    ctx = nc.MotionCtx(
        rec, cs.cu_map, cs.mi_ref, cs.mi_mv, side, hist.buf, hist.nbuf,
        slt, pocs_cur, cols,
        (n_cu, cs.w, cs.h, int(cs.cu_map.shape[1]),
         int(cs.cu_map.shape[0]), cs.ctu_log2,
         int(cs.sps.entropy_coding_sync_enabled)),
        (cs.sps.max_num_merge_cand, int(tmvp), int(cs.check_ldc),
         cs.shs[0].poc))
    cs._mctx_keep = keep
    cs._mctx_out = np.empty((cs.sps.max_num_merge_cand, 9), dtype=np.int32)
    cs._mctx_amvp = np.empty(4, dtype=np.int32)
    return ctx


def derive_merge(cs: CodingStructure, cu: CodingUnit, hist: MotionHist,
                 is_b: bool) -> list[tuple]:
    """Regular merge candidate list (full list; idx selection by caller).
    Each candidate: (inter_dir, mv0, mv1, ref0, ref1)."""
    max_cand = cs.sps.max_num_merge_cand
    if getattr(cu, "idx", -1) >= 0:
        ctx = _motion_ctx(cs, hist)
        if ctx is not None:
            out = cs._mctx_out
            n = ctx.merge_list(cu.idx, out)
            return [(r[0], (r[1], r[2]), (r[3], r[4]), r[5], r[6], r[7],
                     bool(r[8])) for r in out[:n].tolist()]
    cands: list[tuple] = []
    x, y, w, h = cu.x, cu.y, cu.w, cu.h

    def mi(nb, nx, ny):
        e = mi_at(cs, nb, nx, ny)
        bcw = e[5] if e[0] == 3 else 0
        return (e[0], e[1], e[2], e[3], e[4], bcw, e[6])

    b1 = _nb(cs, cu, x + w - 1, y - 1)
    mi_b1 = mi(b1, x + w - 1, y - 1) if b1 else None
    if b1:
        cands.append(mi_b1)
    if len(cands) == max_cand:
        return cands
    a1 = _nb(cs, cu, x - 1, y + h - 1)
    mi_a1 = mi(a1, x - 1, y + h - 1) if a1 else None
    if a1 and (mi_b1 is None or not _mi_eq(mi_a1, mi_b1)):
        cands.append(mi_a1)
    if len(cands) == max_cand:
        return cands
    spatial_cnt_pos = len(cands)
    b0 = _nb(cs, cu, x + w, y - 1)
    if b0:
        mi_b0 = mi(b0, x + w, y - 1)
        if mi_b1 is None or not _mi_eq(mi_b0, mi_b1):
            cands.append(mi_b0)
        if len(cands) == max_cand:
            return cands
    a0 = _nb(cs, cu, x - 1, y + h)
    if a0:
        mi_a0 = mi(a0, x - 1, y + h)
        if mi_a1 is None or not _mi_eq(mi_a0, mi_a1):
            cands.append(mi_a0)
        if len(cands) == max_cand:
            return cands
    if len(cands) < 4:
        b2 = _nb(cs, cu, x - 1, y - 1)
        if b2:
            mi_b2 = mi(b2, x - 1, y - 1)
            if (mi_a1 is None or not _mi_eq(mi_b2, mi_a1)) and \
                    (mi_b1 is None or not _mi_eq(mi_b2, mi_b1)):
                cands.append(mi_b2)
        if len(cands) == max_cand:
            return cands

    if cs.ph.temporal_mvp_enabled and (w + h > 12):
        c0_avail, pos_c0, pos_c1 = tmvp_positions(cs, cu)
        d = 0
        mv0 = mv1 = (0, 0)
        m = (get_colocated_mvp(cs, cu, 0, pos_c0, 0) if c0_avail else None) \
            or get_colocated_mvp(cs, cu, 0, pos_c1, 0)
        if m is not None:
            d |= 1
            mv0 = m
        if is_b:
            m = (get_colocated_mvp(cs, cu, 1, pos_c0, 0) if c0_avail
                 else None) or get_colocated_mvp(cs, cu, 1, pos_c1, 0)
            if m is not None:
                d |= 2
                mv1 = m
        if d:
            cands.append((d, mv0, mv1, 0 if d & 1 else -1,
                          0 if d & 2 else -1, 0, False))
            if len(cands) == max_cand:
                return cands

    # HMVP (newest first), pruned vs the first spatial candidates
    if len(cands) != max_cand - 1:
        pruned = [False] * 8

        def similar(cand):
            for ui in range(spatial_cnt_pos):
                if pruned[ui]:
                    continue
                c = cands[ui]
                if c[0] == cand[0]:
                    if c[0] == 3:
                        same = c[1] == cand[1] and c[2] == cand[2] and \
                            c[3] == cand[3] and c[4] == cand[4]
                    else:
                        lst = c[0] - 1
                        same = c[1 + lst] == cand[1 + lst] and \
                            c[3 + lst] == cand[3 + lst]
                    if same:
                        pruned[ui] = True
                        return True
            return False

        for k, e in enumerate(reversed(hist.lut)):
            if is_b:
                cand = e
            else:
                cand = (1, e[1], (0, 0), e[3], -1, 0, e[6])
            cand = (cand[0], cand[1], cand[2], cand[3], cand[4],
                    cand[5] if cand[0] == 3 else 0, cand[6])
            if k + 1 > 2 or not similar(cand):
                cands.append(cand)
                if len(cands) == max_cand - 1:
                    break

    # pairwise average of the first two candidates
    if 1 < len(cands) < max_cand:
        inter_dir = 0
        mv_out = [(0, 0), (0, 0)]
        ref_out = [-1, -1]
        for lst in range(2 if is_b else 1):
            ri = cands[0][3 + lst]
            rj = cands[1][3 + lst]
            if ri < 0 and rj < 0:
                continue
            inter_dir += 1 << lst
            if ri >= 0 and rj >= 0:
                ax = cands[0][1 + lst][0] + cands[1][1 + lst][0]
                ay = cands[0][1 + lst][1] + cands[1][1 + lst][1]
                ax = (ax + 1 - (ax >= 0)) >> 1
                ay = (ay + 1 - (ay >= 0)) >> 1
                mv_out[lst] = (ax, ay)
                ref_out[lst] = ri
            elif ri >= 0:
                mv_out[lst] = cands[0][1 + lst]
                ref_out[lst] = ri
            else:
                mv_out[lst] = cands[1][1 + lst]
                ref_out[lst] = rj
        if inter_dir > 0:
            alt = cands[0][6] if cands[0][6] == cands[1][6] else False
            cands.append((inter_dir, mv_out[0], mv_out[1],
                          ref_out[0], ref_out[1], 0, alt))

    # zero candidates
    n0 = cs.sh_of(cu).num_ref_idx_active[0]
    n1 = cs.sh_of(cu).num_ref_idx_active[1]
    n_ref = min(n0, n1) if is_b else n0
    r = 0
    refcnt = 0
    while len(cands) < max_cand:
        if is_b:
            cands.append((3, (0, 0), (0, 0), r, r, 0, False))
        else:
            cands.append((1, (0, 0), (0, 0), r, -1, 0, False))
        if refcnt == n_ref - 1:
            r = 0
        else:
            r += 1
            refcnt += 1
    return cands


def derive_ibc_merge(cs: CodingStructure, cu: CodingUnit, hist: MotionHist
                     ) -> list[tuple]:
    """IBC merge BV candidates (PU::getIBCMergeCandidates,
    UnitTools.cpp:728).  Entries are BVs in 1/16 units (integer-pel <<4)."""
    from refdec.frame.structure import MODE_IBC
    max_cand = cs.sps.max_num_ibc_merge_cand
    cands: list[tuple] = []
    x, y, w, h = cu.x, cu.y, cu.w, cu.h
    gt4x4 = w * h > 16

    def ibc_nb(px, py):
        if px < 0 or py < 0 or px >= cs.w or py >= cs.h:
            return None
        nb = cs.cu_at_restricted(px, py, cu, 0)
        if nb is None or nb.pred_mode != MODE_IBC or nb.idx >= cu.idx:
            return None
        return nb

    bv_a1 = None
    nb = ibc_nb(x - 1, y + h - 1)
    if gt4x4 and nb is not None:
        y4, x4 = (y + h - 1) >> 2, (x - 1) >> 2
        bv_a1 = (int(cs.mi_mv[y4, x4, 0, 0]), int(cs.mi_mv[y4, x4, 0, 1]))
        cands.append(bv_a1)
    if len(cands) == max_cand:
        return cands
    nb = ibc_nb(x + w - 1, y - 1)
    if gt4x4 and nb is not None:
        y4, x4 = (y - 1) >> 2, (x + w - 1) >> 2
        bv = (int(cs.mi_mv[y4, x4, 0, 0]), int(cs.mi_mv[y4, x4, 0, 1]))
        if bv_a1 is None or bv != bv_a1:
            cands.append(bv)
    if len(cands) == max_cand:
        return cands
    spatial_cnt = len(cands)
    # HMVP (newest first); only the first entry pruned, only when >16 pels
    pruned = [False] * len(cands)
    for k, bv in enumerate(reversed(hist.lut_ibc)):
        skip_prune = (k + 1) > 2 or (k + 1) > 1 or not gt4x4
        if not skip_prune:
            sim = False
            for ui in range(spatial_cnt):
                if not pruned[ui] and cands[ui] == bv:
                    pruned[ui] = True
                    sim = True
                    break
            if sim:
                continue
        cands.append(bv)
        if len(cands) == max_cand:
            return cands
    while len(cands) < max_cand:
        cands.append((0, 0))
    return cands


def fill_ibc_mvp(cs: CodingStructure, cu: CodingUnit, hist: MotionHist
                 ) -> list[tuple]:
    """IBC AMVP pair (PU::fillIBCMvpCand, UnitTools.cpp:1537)."""
    cands = derive_ibc_merge(cs, cu, hist)[:AMVP_MAX]
    shift = 6 if cu.imv == 2 else 4  # 4-pel / full-pel rounding
    return [round_amvr(bv, shift) for bv in cands]


def round_amvr(mv: tuple, shift: int = 2) -> tuple:
    """Round an internal-precision MV to the AMVR signalling grid
    (Mv::roundToPrecision + changePrecision, Mv.h:177): shift 2 for
    quarter-pel (imv 0)."""
    if shift == 0:
        return mv
    off = 1 << (shift - 1)
    out = []
    for v in mv:
        r = (v + off - 1) >> shift if v >= 0 else (v + off) >> shift
        out.append(r << shift)
    return tuple(out)


AMVR_SHIFT = {0: 2, 1: 4, 2: 6, 3: 3}  # imv -> internal-precision shift


def fill_mvp(cs: CodingStructure, cu: CodingUnit, lst: int, ref_idx: int,
             hist: MotionHist) -> list[tuple]:
    """AMVP candidate pair (PU::fillMvpCand)."""
    if getattr(cu, "idx", -1) >= 0:
        ctx = _motion_ctx(cs, hist)
        if ctx is not None:
            out = cs._mctx_amvp
            ctx.amvp_list(cu.idx, lst, ref_idx, out)
            o = out.tolist()
            return [(o[0], o[1]), (o[2], o[3])]
    shift = AMVR_SHIFT[cu.imv]
    cands: list[tuple] = []
    x, y, w, h = cu.x, cu.y, cu.w, cu.h
    cur_ref_poc = cs.ref_pocs[lst][ref_idx]

    def try_add(nx, ny):
        nb = _nb(cs, cu, nx, ny)
        if nb is None:
            return False
        e = mi_at(cs, nb, nx, ny)
        for src in range(2):
            li = lst if src == 0 else 1 - lst
            nri = e[3 + li]
            if nri >= 0 and cur_ref_poc == cs.ref_pocs[li][nri]:
                cands.append(e[1 + li])
                return True
        return False

    # left: A0 (below-left) then A1 (left)
    if not try_add(x - 1, y + h):
        try_add(x - 1, y + h - 1)
    # above: B0, B1, B2
    if not try_add(x + w, y - 1):
        if not try_add(x + w - 1, y - 1):
            try_add(x - 1, y - 1)

    cands = [round_amvr(c, shift) for c in cands]
    if len(cands) == 2 and cands[0] == cands[1]:
        cands.pop()
    if cs.ph.temporal_mvp_enabled and len(cands) < AMVP_MAX and (w + h > 12):
        c0_avail, pos_c0, pos_c1 = tmvp_positions(cs, cu)
        m = (get_colocated_mvp(cs, cu, lst, pos_c0, ref_idx) if c0_avail
             else None) or get_colocated_mvp(cs, cu, lst, pos_c1, ref_idx)
        if m is not None:
            cands.append(round_amvr(m, shift))
    if len(cands) < AMVP_MAX:
        for e in hist.lut[:MAX_NUM_HMVP_AMVP]:
            if len(cands) >= AMVP_MAX:
                break
            for src in range(2):
                li = lst if src == 0 else 1 - lst
                nri = e[3 + li]
                if nri >= 0 and cur_ref_poc == cs.ref_pocs[li][nri]:
                    cands.append(round_amvr(e[1 + li], shift))
                    if len(cands) >= AMVP_MAX:
                        break
    while len(cands) < AMVP_MAX:
        cands.append((0, 0))
    return cands[:AMVP_MAX]


def clip_mv(mv: tuple, x: int, y: int, cs: CodingStructure,
            size: tuple | None = None) -> tuple:
    """clipMvInPic / clipMvInSubpic (Mv.cpp:64,:84); 1/16-pel units.  With
    reference wraparound enabled this is the wrapping clip (size required).
    Inside a treated-as-picture subpicture the clamp window is the subpic."""
    if cs.sps.ref_wraparound_enabled and size is not None:
        return wrap_clip_mv(mv, x, y, size[0], size[1], cs)[0]
    ctu = cs.sps.ctu_size
    x0, y0, x1, y1 = 0, 0, cs.w, cs.h
    sp = cs.subpic_at(x, y) if cs.subpics else None
    if sp is not None and sp[4]:  # treated_as_pic
        x0, y0, x1, y1 = sp[0], sp[1], sp[2], sp[3]
    hor_max = (x1 + 8 - x - 1) << 4
    hor_min = (-ctu - 8 - (x - x0) + 1) << 4
    ver_max = (y1 + 8 - y - 1) << 4
    ver_min = (-ctu - 8 - (y - y0) + 1) << 4
    return (min(hor_max, max(hor_min, mv[0])),
            min(ver_max, max(ver_min, mv[1])))


def wrap_clip_mv(mv: tuple, x: int, y: int, w: int, h: int,
                 cs: CodingStructure) -> tuple[tuple, bool]:
    """wrapClipMv (Mv.cpp:112): horizontal 360-wraparound MV clip.
    Returns (clipped mv, wrap_ref) — wrap_ref selects the wraparound-padded
    reference buffer; False when the MV itself was shifted by the offset."""
    ctu = cs.sps.ctu_size
    hor_max = (cs.w + ctu - w + 8 - x - 1) << 4
    hor_min = (-ctu - 8 - x + 1) << 4
    ver_max = (cs.h + 8 - y - 1) << 4
    ver_min = (-ctu - 8 - y + 1) << 4
    mx, my = mv
    wrap_ref = True
    off16 = cs.pps.wraparound_offset << 4
    if mx > hor_max:
        mx = min(hor_max, max(hor_min, mx - off16))
        wrap_ref = False
    if mx < hor_min:
        mx = min(hor_max, max(hor_min, mx + off16))
        wrap_ref = False
    return (mx, min(ver_max, max(ver_min, my))), wrap_ref


def wrap_cols(xs: np.ndarray, ww: int, off: int) -> np.ndarray:
    """Horizontal index map of the wraparound-padded reference buffer
    (Picture::extendPicBorderWrap, Picture.cpp:410): the first `off`
    margin columns wrap to the opposite side, the rest clamp to the
    unwrapped edge sample."""
    out = np.clip(xs, 0, ww - 1)
    left = xs < 0
    lw = left & (xs >= -off)
    out[lw] = xs[lw] + off
    out[left & (xs < -off)] = 0
    right = xs >= ww
    rw = right & (xs < ww + off)
    out[rw] = xs[rw] - off
    out[right & (xs >= ww + off)] = ww - 1
    return out


def _filter_1d(arr: np.ndarray, coeffs: np.ndarray, axis: int) -> np.ndarray:
    """N-tap FIR along axis; arr already includes the (N-1) extension."""
    n = len(coeffs)
    out = None
    for k in range(n):
        c = int(coeffs[k])
        if c == 0:
            continue
        sl = [slice(None)] * 2
        sl[axis] = slice(k, k + (arr.shape[axis] - n + 1))
        term = arr[tuple(sl)].astype(np.int64) * c
        out = term if out is None else out + term
    return out


ALT_HPEL_IF = np.array([0, 3, 9, 20, 20, 9, 3, 0], dtype=np.int32)
_ALT_HPEL_2D = ALT_HPEL_IF[None, :]

_NC = None
_IF_BYTES: dict = {}


def _native_mod():
    global _NC
    if _NC is None:
        from refdec.native import native_cabac
        _NC = native_cabac() or False
    return _NC or None


def _coef_bytes(table: np.ndarray, frac: int) -> bytes:
    """int32 coefficient row as bytes, cached (the table ref is kept in the
    cache entry so the id() key stays valid)."""
    key = (id(table), frac)
    ent = _IF_BYTES.get(key)
    if ent is None:
        b = np.ascontiguousarray(table[frac], dtype=np.int32).tobytes()
        ent = _IF_BYTES[key] = (table, b)
    return ent[1]


def mc_block(ref: np.ndarray, x: int, y: int, w: int, h: int,
             mv: tuple, comp: int, bit_depth: int, sub: tuple[int, int],
             intermediate: bool, alt_hpel: bool = False,
             luma_table: np.ndarray | None = None,
             wrap_off: int | None = None,
             bounds: tuple | None = None) -> np.ndarray:
    """Motion-compensated prediction of one block.

    ref: reference plane (this component).  (x, y, w, h) in component coords.
    mv in 1/16 luma units.  intermediate=True returns the 14-bit signal for
    bi averaging; otherwise the clipped final prediction.
    bounds: optional (x0, y0, x1, y1) gather window in this component's
    coords — the treated-as-picture subpicture rectangle (the reference
    extracts per-subpic ref buffers with replicated subpic edges,
    DecLibRecon.cpp:387-421).
    """
    if comp == 0:
        frac_bits, taps, table = 4, 8, LUMA_IF
    else:
        frac_bits, taps = 4 + (sub[0] - 1), 4
        table = CHROMA_IF
    fx_bits = 4 + (sub[0] - 1) if comp else 4
    fy_bits = 4 + (sub[1] - 1) if comp else 4
    ix = mv[0] >> fx_bits
    iy = mv[1] >> fy_bits
    fx = mv[0] & ((1 << fx_bits) - 1)
    fy = mv[1] & ((1 << fy_bits) - 1)
    if comp:
        # chroma fraction index is in 1/32 units regardless of subsampling
        fx <<= (5 - fx_bits)
        fy <<= (5 - fy_bits)

    half = taps // 2 - 1
    x0 = x + ix - half
    y0 = y + iy - half
    # edge-extended reference window (wraparound-padded when wrap_off set)
    hh, ww = ref.shape
    lo_x, lo_y, hi_x, hi_y = 0, 0, ww - 1, hh - 1
    if bounds is not None:  # treated-as-pic subpic: replicate subpic edges
        lo_x, lo_y = bounds[0], bounds[1]
        hi_x, hi_y = bounds[2] - 1, bounds[3] - 1
    bd = bit_depth

    # native pixel core (refdec/native/walk6.c): same gather + FIR +
    # shift semantics; fraction/coefficient selection stays here
    nc = _native_mod()
    if nc is not None and ref.dtype == np.int32 and w <= 128 \
            and ref.flags["C_CONTIGUOUS"]:
        def _cb(frac):
            if frac == 0:
                return b""
            if comp == 0 and alt_hpel and frac == 8:
                return _coef_bytes(_ALT_HPEL_2D, 0)
            if comp == 0 and luma_table is not None:
                return _coef_bytes(luma_table, frac)
            return _coef_bytes(table, frac)
        out = np.empty((h, w), dtype=np.int32)
        nc.mc_block(ref, ww, hh, x + ix, y + iy, w, h, _cb(fx), _cb(fy),
                    taps, bd, 1 if intermediate else 0,
                    -1 if wrap_off is None else wrap_off,
                    lo_x, lo_y, hi_x, hi_y, out)
        return out.astype(np.int64)

    if wrap_off is not None:
        xs = wrap_cols(np.arange(x0, x0 + w + taps - 1), ww, wrap_off)
    else:
        xs = np.clip(np.arange(x0, x0 + w + taps - 1), lo_x, hi_x)
    ys = np.clip(np.arange(y0, y0 + h + taps - 1), lo_y, hi_y)
    win = ref[np.ix_(ys, xs)].astype(np.int64)

    head = max(2, IF_INTERNAL_PREC - bd)

    if fx == 0 and fy == 0:
        blk = win[half: half + h, half: half + w]
        if intermediate:
            return (blk << head) - IF_INTERNAL_OFFS
        return blk

    def coeffs(frac):
        if comp == 0 and alt_hpel and frac == 8:
            return ALT_HPEL_IF
        if comp == 0 and luma_table is not None:
            return luma_table[frac]
        return table[frac]

    if fx and fy:
        # pass 1 horizontal (isFirst, !isLast): shift = 6 - head,
        # offset = -IF_INTERNAL_OFFS << shift
        tmp = _filter_1d(win, coeffs(fx), axis=1)   # [h+taps-1, w]
        s1 = IF_FILTER_PREC - head
        tmp = (tmp - (IF_INTERNAL_OFFS << s1)) >> s1
        blk = _filter_1d(tmp, coeffs(fy), axis=0)   # [h, w]
        if intermediate:
            # pass 2 (!isFirst, !isLast): shift = 6, offset = 0
            return blk >> IF_FILTER_PREC
        # pass 2 (!isFirst, isLast): shift = 6 + head,
        # offset = (1 << (shift-1)) + (IF_INTERNAL_OFFS << 6)
        s2 = IF_FILTER_PREC + head
        off2 = (1 << (s2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC)
        out = (blk + off2) >> s2
        return np.clip(out, 0, (1 << bd) - 1)

    if fx:
        row = win[half: half + h, :]
        blk = _filter_1d(row, coeffs(fx), axis=1)
    else:
        col = win[:, half: half + w]
        blk = _filter_1d(col, coeffs(fy), axis=0)
    if intermediate:
        # single pass (isFirst, !isLast): shift = 6 - head,
        # offset = -IF_INTERNAL_OFFS << shift
        s = IF_FILTER_PREC - head
        return (blk - (IF_INTERNAL_OFFS << s)) >> s
    # single pass (isFirst, isLast): shift = 6, offset = 32
    s = IF_FILTER_PREC
    out = (blk + (1 << (s - 1))) >> s
    return np.clip(out, 0, (1 << bd) - 1)




BCW_WEIGHTS = (-2, 3, 4, 5, 10)
BCW_INTERN = (2, 0, 1, 3, 4)  # forward-form index -> weight-table index


def derive_mmvd(cs: CodingStructure, cu: CodingUnit, cands: list) -> tuple:
    """MMVD motion (MergeCtx::setMmvdMergeCandiInfo, ContextModelling.cpp).
    Returns a merge-style candidate tuple."""
    bases = []
    for c in cands:
        bases.append(c)
        if len(bases) == 2:
            break
    base_idx = cu.mmvd_idx // 32
    tmp = cu.mmvd_idx - base_idx * 32
    step = tmp // 4
    pos = tmp - step * 4
    offset = (1 << step) << 2  # MV_FRACTIONAL_BITS_DIFF = 2
    if cs.ph.fpel_mmvd:
        offset <<= 2
    base = bases[base_idx]
    r0, r1 = base[3], base[4]
    off_mv = ((offset, 0), (-offset, 0), (0, offset), (0, -offset))[pos]
    if r0 >= 0 and r1 >= 0:
        poc0 = cs.ref_pocs[0][r0]
        poc1 = cs.ref_pocs[1][r1]
        cur = cs.sh.poc
        mv0 = off_mv
        if (poc0 - cur) == (poc1 - cur):
            mv1 = off_mv
        elif abs(poc1 - cur) > abs(poc0 - cur):
            mv1 = off_mv
            scale = _dist_scale(cur, poc0, cur, poc1)
            mv0 = _scale_mv(mv1, scale)
        else:
            mv1_scale = _dist_scale(cur, poc1, cur, poc0)
            mv0 = off_mv
            mv1 = _scale_mv(mv0, mv1_scale)
        return (3, (base[1][0] + mv0[0], base[1][1] + mv0[1]),
                (base[2][0] + mv1[0], base[2][1] + mv1[1]), r0, r1,
                base[5], base[6])
    if r0 >= 0:
        return (1, (base[1][0] + off_mv[0], base[1][1] + off_mv[1]),
                (0, 0), r0, -1, base[5], base[6])
    return (2, (0, 0), (base[2][0] + off_mv[0], base[2][1] + off_mv[1]),
            -1, r1, base[5], base[6])


def bi_weighted(a: np.ndarray, b: np.ndarray, bit_depth: int,
                bcw_fwd: int) -> np.ndarray:
    """AreaBuf::addWeightedAvg (Buffer.cpp) with BCW weights."""
    w1 = BCW_WEIGHTS[BCW_INTERN[bcw_fwd]]
    w0 = 8 - w1
    shift = max(2, IF_INTERNAL_PREC - bit_depth) + 3
    offset = (1 << (shift - 1)) + (IF_INTERNAL_OFFS << 3)
    return np.clip((a * w0 + b * w1 + offset) >> shift,
                   0, (1 << bit_depth) - 1)


def bi_average(a: np.ndarray, b: np.ndarray, bit_depth: int) -> np.ndarray:
    shift = max(2, IF_INTERNAL_PREC - bit_depth) + 1
    offset = (1 << (shift - 1)) + 2 * IF_INTERNAL_OFFS
    return np.clip((a + b + offset) >> shift, 0, (1 << bit_depth) - 1)


def derive_geo(cs: CodingStructure, cu: CodingUnit, cands: list) -> list:
    """Uni-prediction GPM candidate list from the regular merge list
    (PU::getGeoMergeCandidates, UnitTools.cpp:3125)."""
    out = []
    for i, c in enumerate(cands):
        parity = i & 1
        if c[0] & (1 + parity):
            mv = [(0, 0), (0, 0)]
            ref = [-1, -1]
            mv[parity] = c[1 + parity]
            ref[parity] = c[3 + parity]
            out.append((1 + parity, mv[0], mv[1], ref[0], ref[1], 0, False))
        elif c[0] & (2 - parity):
            mv = [(0, 0), (0, 0)]
            ref = [-1, -1]
            mv[1 - parity] = c[2 - parity]
            ref[1 - parity] = c[4 - parity]
            out.append((2 - parity, mv[0], mv[1], ref[0], ref[1], 0, False))
        if len(out) == 6:
            break
    return out


def span_geo_motion(cs: CodingStructure, cu: CodingUnit, geo_cands: list
                    ) -> None:
    """Per-4x4 GPM motion storage (PU::spanGeoMotionInfo, UnitTools.cpp:3184)."""
    from refdec.frame.geo_np import DIS, GEO_NUM_ANGLES, GEO_PARAMS
    c0 = geo_cands[cu.geo_idx[0]]
    c1 = geo_cands[cu.geo_idx[1]]
    d0, d1 = c0[0], c1[0]
    if d0 == 1 and d1 == 2:
        bi = (c0[1], c1[2], c0[3], c1[4])
    elif d0 == 2 and d1 == 1:
        bi = (c1[1], c0[2], c1[3], c0[4])
    elif d0 == 1 and d1 == 1:
        bi = (c1[1], (0, 0), c1[3], -1)
    else:
        bi = ((0, 0), c1[2], -1, c1[4])
    mi0 = (c0[1], c0[2], c0[3], c0[4])
    mi1 = (c1[1], c1[2], c1[3], c1[4])

    angle, dist = GEO_PARAMS[cu.geo_split_dir]
    dx = angle
    dy = (dx + (GEO_NUM_ANGLES >> 2)) % GEO_NUM_ANGLES
    off_x = (-cu.w) >> 1
    off_y = (-cu.h) >> 1
    if dist > 0:
        if angle % 16 == 8 or (angle % 16 != 0 and cu.h >= cu.w):
            off_y += (dist * cu.h) >> 3 if angle < 16 else -((dist * cu.h) >> 3)
        else:
            off_x += (dist * cu.w) >> 3 if angle < 16 else -((dist * cu.w) >> 3)
    is_flip = 13 <= angle <= 27
    for y in range(cu.h >> 2):
        look_y = (((4 * y + off_y) * 2) + 5) * DIS[dy]
        for x in range(cu.w >> 2):
            midx = (((4 * x + off_x) * 2) + 5) * DIS[dx] + look_y
            mask = 2 if abs(midx) < 32 else \
                ((1 - is_flip) if midx <= 0 else int(is_flip))
            mi = bi if mask == 2 else (mi0 if mask == 0 else mi1)
            y4, x4 = (cu.y >> 2) + y, (cu.x >> 2) + x
            for lst in range(2):
                cs.mi_ref[y4, x4, lst] = mi[2 + lst]
                cs.mi_mv[y4, x4, lst] = mi[lst] if mi[2 + lst] >= 0 else (0, 0)
