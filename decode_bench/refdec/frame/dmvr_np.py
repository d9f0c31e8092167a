"""Numpy golden DMVR (decoder-side MV refinement) and BDOF (bi-directional
optical flow).

Behavioral parity (re-designed, not ported):
  - conditions:  PU::checkDMVRCondition (UnitTools.cpp:1277), BDOF gating
                 (InterPrediction.cpp:1411-1429),
                 PU::isBiPredFromDifferentDirEqDistPoc (UnitTools.cpp:3096)
  - bilinear MC: xinitMC (InterPrediction.cpp:1813), 2-tap filter path
                 (InterpolationFilter.cpp:583-599 N==2, filterCopy :424)
  - search:      xProcessDMVR (:1847), xBIPMVRefine (:1709), SAD with
                 subShift=1 (RdCost.cpp:108-176, X5 variants :177),
                 xDMVRSubPixelErrorSurface (:1784), xSubPelErrorSrfc (:1656)
  - final MC:    xPrefetchPad (:1525) + paddingCore<2> (:283),
                 xFinalPaddedMCForDMVR (:1736), xPredInterBlk (:751)
  - BDOF:        xSubPuBio (:551), applyBiOptFlow (:1290), BiOptFlowCore
                 (:162), calcBIOSums (:134), gradFilterCore (:213),
                 addBIOAvg4 (:110), rightShiftMSB (:92)
  - MV writeback: DecCu::TaskFinishMotionInfo (DecCu.cpp:161-213)
"""

from __future__ import annotations

import numpy as np

from refdec.frame.inter_np import (
    BILINEAR_IF,
    CHROMA_IF,
    IF_INTERNAL_OFFS,
    IF_INTERNAL_PREC,
    LUMA_IF,
    ALT_HPEL_IF,
    clip_mv,
)

DMVR_ITER = 2               # DMVR_NUM_ITERATION
DMVR_SUBCU = 16             # DMVR_SUBCU_WIDTH/HEIGHT
BDOF_REGION = 16            # MAX_BDOF_APPLICATION_REGION
IF_PREC_BILINEAR = 4        # IF_FILTER_PREC_BILINEAR
IF_INTERNAL_PREC_BILINEAR = 10


def _clip18(v: int) -> int:
    return max(-(1 << 17), min((1 << 17) - 1, v))


def eq_dist_bipred(cs, cu) -> bool:
    """PU::isBiPredFromDifferentDirEqDistPoc (no long-term refs here)."""
    if cu.ref_idx[0] < 0 or cu.ref_idx[1] < 0:
        return False
    poc0 = cs.ref_pocs[0][cu.ref_idx[0]]
    poc1 = cs.ref_pocs[1][cu.ref_idx[1]]
    poc = cs.sh_of(cu).poc
    return (poc - poc0) == (poc1 - poc)


def _wp_present(cs, cu) -> bool:
    """Any explicit weight present for the CU's references."""
    from refdec.hls.weight_table import wp_present_any
    wt = cs.sh_of(cu).weight_table
    return wp_present_any(wt, 0, cu.ref_idx[0]) \
        or wp_present_any(wt, 1, cu.ref_idx[1])


def bdof_condition(cs, cu) -> bool:
    """BDOF applicability (InterPrediction.cpp:1411-1429)."""
    if not cs.sps.bdof_enabled or cs.ph.bdof_disabled:
        return False
    if cu.affine_flag or cu.merge_type == 1 or cu.ciip_flag \
            or cu.smvd_mode or (cs.sps.bcw_enabled and cu.bcw_idx != 0):
        return False
    if _wp_present(cs, cu) and cs.sh_of(cu).is_b:
        return False
    if cs.pps.weighted_pred and cs.sh_of(cu).is_p:
        return False
    return eq_dist_bipred(cs, cu) and cu.h >= 8 and cu.w >= 8 \
        and cu.w * cu.h >= 128


def dmvr_condition(cs, cu) -> bool:
    """PU::checkDMVRCondition (UnitTools.cpp:1277); no RPR yet."""
    if not cs.sps.dmvr_enabled or cs.ph.dmvr_disabled:
        return False
    return cu.merge_flag and cu.merge_type == 0 and not cu.ciip_flag \
        and not cu.affine_flag and not cu.mmvd_flag \
        and eq_dist_bipred(cs, cu) and cu.h >= 8 and cu.w >= 8 \
        and cu.w * cu.h >= 128 and cu.bcw_idx == 0 \
        and not _wp_present(cs, cu)


class RefView:
    """Clamped 2D sample source in picture coordinates.  A full reference
    plane models the picture's edge-padded margins; a DMVR prefetch window
    models the pad-limited buffer (paddingCore<2>)."""

    def __init__(self, arr: np.ndarray, x0: int = 0, y0: int = 0,
                 wrap_off: int | None = None):
        self.arr = arr
        self.x0 = x0
        self.y0 = y0
        self.wrap_off = wrap_off

    @classmethod
    def window(cls, plane: np.ndarray, wx: int, wy: int, ww: int, wh: int,
               wrap_off: int | None = None) -> "RefView":
        """Prefetch the picture window [wx, wx+ww) x [wy, wy+wh) (clamped
        to picture edges).  The clamped get() reproduces the reference's
        edge-replication padding (paddingCore, InterPrediction.cpp:283) —
        reads never exceed the reference's physical pad of the window.
        With wrap_off, columns map through the wraparound-padded buffer."""
        from refdec.frame.inter_np import wrap_cols
        hh, ww_p = plane.shape
        if wrap_off is not None:
            xs = wrap_cols(np.arange(wx, wx + ww), ww_p, wrap_off)
        else:
            xs = np.clip(np.arange(wx, wx + ww), 0, ww_p - 1)
        ys = np.clip(np.arange(wy, wy + wh), 0, hh - 1)
        return cls(plane[np.ix_(ys, xs)], wx, wy)

    def get(self, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
        from refdec.frame.inter_np import wrap_cols
        hh, ww = self.arr.shape
        if self.wrap_off is not None:
            cols = wrap_cols(xs - self.x0, ww, self.wrap_off)
        else:
            cols = np.clip(xs - self.x0, 0, ww - 1)
        return self.arr[np.ix_(np.clip(ys - self.y0, 0, hh - 1),
                               cols)].astype(np.int64)


def _filt1d(win: np.ndarray, coeffs, axis: int) -> np.ndarray:
    n = len(coeffs)
    out = None
    for k in range(n):
        c = int(coeffs[k])
        if c == 0:
            continue
        sl = [slice(None)] * 2
        sl[axis] = slice(k, k + (win.shape[axis] - n + 1))
        t = win[tuple(sl)] * c
        out = t if out is None else out + t
    return out


def bilinear_pred(view: RefView, x: int, y: int, w: int, h: int, mv: tuple,
                  bd: int) -> np.ndarray:
    """2-tap bilinear prediction at 10-bit precision (xinitMC path)."""
    ix, iy = mv[0] >> 4, mv[1] >> 4
    fx, fy = mv[0] & 15, mv[1] & 15
    sh1 = IF_PREC_BILINEAR - (IF_INTERNAL_PREC_BILINEAR - bd)
    if fx == 0 and fy == 0:
        win = view.get(np.arange(y + iy, y + iy + h),
                       np.arange(x + ix, x + ix + w))
        return win << (IF_INTERNAL_PREC_BILINEAR - bd)
    if fy == 0:
        win = view.get(np.arange(y + iy, y + iy + h),
                       np.arange(x + ix, x + ix + w + 1))
        return (_filt1d(win, BILINEAR_IF[fx], 1) + (1 << (sh1 - 1))) >> sh1
    if fx == 0:
        win = view.get(np.arange(y + iy, y + iy + h + 1),
                       np.arange(x + ix, x + ix + w))
        return (_filt1d(win, BILINEAR_IF[fy], 0) + (1 << (sh1 - 1))) >> sh1
    win = view.get(np.arange(y + iy, y + iy + h + 1),
                   np.arange(x + ix, x + ix + w + 1))
    tmp = (_filt1d(win, BILINEAR_IF[fx], 1) + (1 << (sh1 - 1))) >> sh1
    return (_filt1d(tmp, BILINEAR_IF[fy], 0) + 8) >> 4


def mc_from_view(view: RefView, x: int, y: int, w: int, h: int,
                 int_x: int, int_y: int, fx: int, fy: int, comp: int,
                 bd: int, intermediate: bool, bio_ext: bool = False,
                 alt_hpel: bool = False):
    """8/4-tap MC reading via a RefView with explicit integer position
    (xPredInterBlk).  Returns pred, or (pred, ext) when bio_ext: the
    (h+2, w+2) extended 14-bit block with integer-sample borders."""
    taps = 8 if comp == 0 else 4
    half = taps // 2 - 1
    head = max(2, IF_INTERNAL_PREC - bd)

    def coeffs(frac):
        if comp == 0:
            if alt_hpel and frac == 8:
                return ALT_HPEL_IF
            return LUMA_IF[frac]
        return CHROMA_IF[frac]

    x0 = x + int_x - half
    y0 = y + int_y - half
    win = view.get(np.arange(y0, y0 + h + taps - 1),
                   np.arange(x0, x0 + w + taps - 1))
    if fx == 0 and fy == 0:
        blk = win[half:half + h, half:half + w]
        blk = (blk << head) - IF_INTERNAL_OFFS if intermediate else blk
    elif fx and fy:
        tmp = _filt1d(win, coeffs(fx), axis=1)
        s1 = 6 - head
        tmp = (tmp - (IF_INTERNAL_OFFS << s1)) >> s1
        blk = _filt1d(tmp, coeffs(fy), axis=0)
        if intermediate:
            blk = blk >> 6
        else:
            s2 = 6 + head
            off2 = (1 << (s2 - 1)) + (IF_INTERNAL_OFFS << 6)
            blk = np.clip((blk + off2) >> s2, 0, (1 << bd) - 1)
    else:
        if fx:
            blk = _filt1d(win[half:half + h, :], coeffs(fx), axis=1)
        else:
            blk = _filt1d(win[:, half:half + w], coeffs(fy), axis=0)
        if intermediate:
            s = 6 - head
            blk = (blk - (IF_INTERNAL_OFFS << s)) >> s
        else:
            blk = np.clip((blk + 32) >> 6, 0, (1 << bd) - 1)
    if not bio_ext:
        return blk
    # integer-sample borders at the nearest-integer position
    # (xPredInterBlk bio tail, InterPrediction.cpp:863-889)
    rx = x + int_x - 1 + (1 if fx >= 8 else 0)
    ry = y + int_y - 1 + (1 if fy >= 8 else 0)
    ext = np.zeros((h + 2, w + 2), dtype=np.int64)
    ext[1:h + 1, 1:w + 1] = blk
    shift = head
    cols = np.arange(rx, rx + w + 2)
    ext[0, :] = (view.get(np.array([ry]), cols)[0] << shift) \
        - IF_INTERNAL_OFFS
    ext[h + 1, :] = (view.get(np.array([ry + h + 1]), cols)[0] << shift) \
        - IF_INTERNAL_OFFS
    rows = np.arange(ry + 1, ry + h + 1)
    ext[1:h + 1, 0] = (view.get(rows, np.array([rx]))[:, 0] << shift) \
        - IF_INTERNAL_OFFS
    ext[1:h + 1, w + 1] = (view.get(rows, np.array([rx + w + 1]))[:, 0]
                           << shift) - IF_INTERNAL_OFFS
    return blk, ext


def _right_shift_msb(numer: int, denom: int) -> int:
    """rightShiftMSB (InterPrediction.cpp:92): arithmetic shift by
    floor(log2(denom))."""
    msb = 0
    while msb < 32 and denom >= (1 << msb):
        msb += 1
    return numer >> (msb - 1)


def bdof_blend(ext0: np.ndarray, ext1: np.ndarray, w: int, h: int,
               bd: int) -> np.ndarray:
    """BDOF: gradients + per-4x4 flow + blended output (applyBiOptFlow)."""
    # gradFilterCore<PAD=true>: gradient over inner wxh from the ext
    # buffers, then replicate-pad ext and gradients by 1
    def grads(ext):
        gx = np.zeros_like(ext)
        gy = np.zeros_like(ext)
        gx[1:h + 1, 1:w + 1] = (ext[1:h + 1, 2:w + 2] >> 6) \
            - (ext[1:h + 1, 0:w] >> 6)
        gy[1:h + 1, 1:w + 1] = (ext[2:h + 2, 1:w + 1] >> 6) \
            - (ext[0:h, 1:w + 1] >> 6)
        for a in (gx, gy, ext):
            a[1:h + 1, 0] = a[1:h + 1, 1]
            a[1:h + 1, w + 1] = a[1:h + 1, w]
            a[0, :] = a[1, :]
            a[h + 1, :] = a[h, :]
        return gx, gy

    gx0, gy0 = grads(ext0)
    gx1, gy1 = grads(ext1)

    shift_num = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift_num - 1)) + 2 * IF_INTERNAL_OFFS
    limit = (1 << 4) - 1
    out = np.zeros((h, w), dtype=np.int64)
    for yu in range(h >> 2):
        for xu in range(w >> 2):
            ya, xa = yu * 4, xu * 4  # window top-left in ext coords
            sl = (slice(ya, ya + 6), slice(xa, xa + 6))
            tgx = (gx0[sl] + gx1[sl]) >> 1
            tgy = (gy0[sl] + gy1[sl]) >> 1
            tdi = (ext1[sl] >> 4) - (ext0[sl] >> 4)
            sum_abs_gx = int(np.abs(tgx).sum())
            sum_abs_gy = int(np.abs(tgy).sum())
            sum_dix = int((np.sign(tgx) * tdi).sum())
            sum_diy = int((np.sign(tgy) * tdi).sum())
            sum_sign_gy_gx = int((np.sign(tgy) * tgx).sum())
            tmpx = 0 if sum_abs_gx == 0 else \
                _right_shift_msb(sum_dix * 4, sum_abs_gx)
            tmpx = max(-limit, min(limit, tmpx))
            mains = sum_sign_gy_gx >> 12
            secs = sum_sign_gy_gx & 4095
            tmp_data = ((tmpx * mains) * (1 << 12) + tmpx * secs) >> 1
            tmpy = 0 if sum_abs_gy == 0 else \
                _right_shift_msb(sum_diy * 4 - tmp_data, sum_abs_gy)
            tmpy = max(-limit, min(limit, tmpy))
            isl = (slice(ya + 1, ya + 5), slice(xa + 1, xa + 5))
            b = tmpx * (gx0[isl] - gx1[isl]) + tmpy * (gy0[isl] - gy1[isl])
            out[ya:ya + 4, xa:xa + 4] = np.clip(
                (ext0[isl] + ext1[isl] + b + offset) >> shift_num,
                0, (1 << bd) - 1)
    return out


def _sad_sub2(a: np.ndarray, b: np.ndarray) -> int:
    """SAD over even rows (subShift=1), without the <<1 compensation
    (the callers' >>1 is pre-applied; RdCost.cpp:108+177)."""
    return int(np.abs(a[::2].astype(np.int64) - b[::2].astype(np.int64))
               .sum())


def _div_for_maxq7(n: int, d: int) -> int:
    sign = 0
    if n < 0:
        sign = 1
        n = -n
    q = 0
    d = d << 3
    if n >= d:
        n -= d
        q += 1
    q <<= 1
    d >>= 1
    if n >= d:
        n -= d
        q += 1
    q <<= 1
    if n >= (d >> 1):
        q += 1
    return -q if sign else q


def _subpel_delta(sad_c, sad_l, sad_t, sad_r, sad_b) -> tuple[int, int]:
    """xSubPelErrorSrfc (InterPrediction.cpp:1656)."""
    out = [0, 0]
    for k, (s1, s3) in enumerate(((sad_l, sad_r), (sad_t, sad_b))):
        num = (s1 - s3) * 16
        den = s1 + s3 - 2 * sad_c
        if den != 0:
            if s1 != sad_c and s3 != sad_c:
                out[k] = _div_for_maxq7(num, den)
            else:
                out[k] = -8 if s1 == sad_c else 8
    return out[0], out[1]


def dmvr_search(bl0: np.ndarray, bl1: np.ndarray, xs: int, ys: int,
                dx: int, dy: int) -> tuple[tuple[int, int], int]:
    """25-point integer search + parametric sub-pel fit for one subblock.
    bl0/bl1 are the CU-wide bilinear buffers with a 2-sample margin
    (centre at (2,2)).  Returns ((dmv_x, dmv_y) in 1/16 units, minCost)."""
    cx, cy = 2 + xs, 2 + ys

    def sad(hor, ver):
        a = bl0[cy + ver:cy + ver + dy, cx + hor:cx + hor + dx]
        b = bl1[cy - ver:cy - ver + dy, cx - hor:cx - hor + dx]
        return _sad_sub2(a, b)

    center = _sad_sub2(bl0[cy:cy + dy, cx:cx + dx],
                       bl1[cy:cy + dy, cx:cx + dx])
    min_cost = center - (center >> 2)
    if min_cost < dx * dy:
        return (0, 0), min_cost

    sads = np.zeros((5, 5), dtype=np.int64)
    best = (0, 0)
    for ver in range(-2, 3):
        for hor in range(-2, 3):
            if ver == 0 and hor == 0:
                sads[2, 2] = min_cost
            else:
                sads[ver + 2, hor + 2] = sad(hor, ver)
    for ver in range(-2, 3):
        for hor in range(-2, 3):
            c = int(sads[ver + 2, hor + 2])
            if c < min_cost:
                min_cost = c
                best = (hor, ver)

    total = [best[0] * 16, best[1] * 16]
    if abs(total[0]) != 32 and abs(total[1]) != 32:
        bx, by = best[0] + 2, best[1] + 2
        dmx, dmy = _subpel_delta(int(sads[by, bx]), int(sads[by, bx - 1]),
                                 int(sads[by - 1, bx]), int(sads[by, bx + 1]),
                                 int(sads[by + 1, bx]))
        total[0] += dmx
        total[1] += dmy
    return (total[0], total[1]), min_cost
