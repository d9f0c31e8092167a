"""RPR: reference picture resampling — scaled-reference motion compensation.

Behavioral parity: InterPrediction::xPredInterBlkRPR
(InterPrediction.cpp:2081-2217), CU::getRprScaling (UnitTools.cpp:92),
Picture::isRefScaled (Picture.h:260).  Per-output-sample stepped source
positions with 14-bit scaling ratios; 1.5x/2x downsampling filter sets
(tables_rpr.npz); 8/4-tap separable filtering in the standard 14-bit MC
intermediate precision.
"""

from __future__ import annotations

import os

import numpy as np

SCALE_RATIO_BITS = 14
SCALE_1X = 1 << SCALE_RATIO_BITS
RPR_THR1 = SCALE_1X * 5 // 4
RPR_THR2 = SCALE_1X * 7 // 4
IF_INTERNAL_PREC = 14
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)
IF_FILTER_PREC = 6

_T = np.load(os.path.join(os.path.dirname(__file__), "..", "ops",
                          "tables_rpr.npz"))
LUMA_RPR1 = _T["LUMA_RPR1"].astype(np.int64)
LUMA_RPR2 = _T["LUMA_RPR2"].astype(np.int64)
CHROMA_RPR1 = _T["CHROMA_RPR1"].astype(np.int64)
CHROMA_RPR2 = _T["CHROMA_RPR2"].astype(np.int64)
AFF_LUMA_RPR1 = _T["AFF_LUMA_RPR1"].astype(np.int64)
AFF_LUMA_RPR2 = _T["AFF_LUMA_RPR2"].astype(np.int64)


def get_rpr_scaling(sps, cur_pps, ref_pps) -> tuple[int, int]:
    """14-bit scaling ratio between scaling windows (CU::getRprScaling)."""
    from refdec.hls.params import sub_wh
    wux, wuy = sub_wh(sps.chroma_format_idc)
    cl, cr, ct, cb = cur_pps.scaling_win
    cur_w = cur_pps.pic_width - (cl + cr) * wux
    cur_h = cur_pps.pic_height - (ct + cb) * wuy
    rl, rr, rt, rb = ref_pps.scaling_win
    ref_w = ref_pps.pic_width - (rl + rr) * wux
    ref_h = ref_pps.pic_height - (rt + rb) * wuy
    return (((ref_w << SCALE_RATIO_BITS) + (cur_w >> 1)) // cur_w,
            ((ref_h << SCALE_RATIO_BITS) + (cur_h >> 1)) // cur_h)


def is_ref_scaled(cur_pps, ref_pps) -> bool:
    """Picture::isRefScaled — size or scaling-window mismatch."""
    if (ref_pps.pic_width, ref_pps.pic_height) \
            != (cur_pps.pic_width, cur_pps.pic_height):
        return True
    if ref_pps.scaling_win == cur_pps.scaling_win:
        return False
    return any(v != 0 for v in ref_pps.scaling_win) \
        or any(v != 0 for v in cur_pps.scaling_win)


def _sign_round(v: int, shift: int) -> int:
    a = abs(v)
    r = (a + (1 << (shift - 1))) >> shift
    return r if v >= 0 else -r


def rpr_mc_block(ref: np.ndarray, scaling: tuple[int, int], cur_pps, ref_pps,
                 chroma_fmt: int, comp: int, bx: int, by: int, w: int,
                 h: int, mv: tuple[int, int], bit_depth: int, bi: bool,
                 alt_hpel: bool = False, hor_collocated: bool = True,
                 ver_collocated: bool = True,
                 filter_index: int = 0) -> np.ndarray:
    """Scaled-reference MC for one block (xPredInterBlkRPR).

    ref: the reference plane of this component.  (bx, by, w, h) in current
    component coords, mv in 1/16 luma units (UNclipped — the reference
    skips clipMv for scaled refs, InterPrediction.cpp:650-653).  Returns
    the clipped prediction, or the 14-bit intermediate when bi."""
    from refdec.frame.inter_np import ALT_HPEL_IF, CHROMA_IF, LUMA_IF
    from refdec.hls.params import sub_wh
    sub_w, sub_h = sub_wh(chroma_fmt)
    csx = 0 if comp == 0 else sub_w - 1
    csy = 0 if comp == 0 else sub_h - 1
    sx, sy = scaling
    shift_hor, shift_ver = 4 + csx, 4 + csy
    luma = comp == 0
    taps = 8 if luma else 4
    half = taps // 2 - 1
    ext = 1 if luma else 2

    affine = filter_index == 2
    if luma:
        # filterIndex==2 (affine subblocks): 6-tap base + affine RPR sets
        # (filterHor luma dispatch: xFilter += 2, InterPrediction.cpp:2112)
        r1 = AFF_LUMA_RPR1 if affine else LUMA_RPR1
        r2 = AFF_LUMA_RPR2 if affine else LUMA_RPR2
        xtab = r2 if sx > RPR_THR2 else (r1 if sx > RPR_THR1 else None)
        ytab = r2 if sy > RPR_THR2 else (r1 if sy > RPR_THR1 else None)
    else:
        xtab = CHROMA_RPR2 if sx > RPR_THR2 else (
            CHROMA_RPR1 if sx > RPR_THR1 else None)
        ytab = CHROMA_RPR2 if sy > RPR_THR2 else (
            CHROMA_RPR1 if sy > RPR_THR1 else None)

    def coeffs(tab, frac, for_x):
        if luma:
            if tab is None:
                if affine:
                    from refdec.frame.inter_np import LUMA_IF_4X4
                    return LUMA_IF_4X4[frac].astype(np.int64)
                if frac == 8 and alt_hpel \
                        and (sx if for_x else sy) == SCALE_1X:
                    return ALT_HPEL_IF.astype(np.int64)
                return LUMA_IF[frac].astype(np.int64)
            return tab[frac]
        idx = frac << (1 - csx) if for_x else frac << (1 - csy)
        if tab is None:
            return CHROMA_IF[idx].astype(np.int64)
        return tab[idx]

    pos_shift = SCALE_RATIO_BITS - 4
    step_x = (sx + 8) >> 4
    step_y = (sy + 8) >> 4
    off_x = 1 << (pos_shift - shift_hor - 1)
    off_y = 1 << (pos_shift - shift_ver - 1)
    wux, wuy = sub_wh(chroma_fmt)

    pos_x = ((bx << csx) - cur_pps.scaling_win[0] * wux) >> csx
    pos_y = ((by << csy) - cur_pps.scaling_win[2] * wuy) >> csy
    add_x = 0
    add_y = 0
    if not luma:
        # chroma sample-location adjustment (non-collocated siting of the
        # REFERENCE picture's SPS)
        add_x = int(not hor_collocated) * 8 * (sx - SCALE_1X)
        add_y = int(not ver_collocated) * 8 * (sy - SCALE_1X)

    x0 = ((pos_x << (4 + csx)) + mv[0]) * sx + add_x
    x0 = _sign_round(x0, 8 + csx) \
        + ((ref_pps.scaling_win[0] * wux) << (pos_shift - csx))
    y0 = ((pos_y << (4 + csy)) + mv[1]) * sy + add_y
    y0 = _sign_round(y0, 8 + csy) \
        + ((ref_pps.scaling_win[2] * wuy) << (pos_shift - csy))

    ref_lw, ref_lh = ref_pps.pic_width, ref_pps.pic_height
    max_x = (ref_lw >> csx) + 4
    max_y = (ref_lh >> csy) + 4

    y_int0 = min(max(-4, (y0 + off_y) >> pos_shift), max_y)
    x_int0 = min(max(-4, (x0 + off_x) >> pos_shift), max_x)
    ref_height = max(1, ((y0 + (h - 1) * step_y + off_y) >> pos_shift)
                     - ((y0 + off_y) >> pos_shift) + 1)
    filt_h = ref_height + taps - 1 + ext

    bd = bit_depth
    head = max(2, IF_INTERNAL_PREC - bd)
    rh, rw = ref.shape

    # source rows for the horizontal pass: yInt0 - half + [0, filt_h)
    rows = np.clip(np.arange(y_int0 - half, y_int0 - half + filt_h),
                   0, rh - 1)

    # per-column integer position + phase
    cols = np.arange(w, dtype=np.int64)
    pos_xs = x0 + cols * step_x
    x_ints = np.clip((pos_xs + off_x) >> pos_shift, -4, max_x)
    x_fracs = ((pos_xs + off_x) >> (pos_shift - shift_hor)) \
        & ((1 << shift_hor) - 1)

    # gather [filt_h, w, taps] source samples and apply per-column filters
    tap_idx = np.clip(x_ints[:, None] - half + np.arange(taps)[None, :],
                      0, rw - 1)                       # [w, taps]
    src = ref[rows][:, tap_idx].astype(np.int64)       # [filt_h, w, taps]
    co = np.stack([coeffs(xtab, int(f), True) for f in x_fracs])  # [w,taps]
    conv = np.einsum("hwt,wt->hw", src, co)
    s1 = IF_FILTER_PREC - head
    buf = (conv - (IF_INTERNAL_OFFS << s1)) >> s1
    # frac==0 columns use the copy path ((src << head) - OFFS) — but ONLY
    # with the standard filter set; the RPR downsampling filters apply at
    # every phase (filterHor: "frac == 0 && nFilterIdx < 2")
    zero_cols = (x_fracs == 0) if (xtab is None and filter_index < 2) \
        else np.zeros(w, dtype=bool)
    if zero_cols.any():
        center = ref[rows][:, np.clip(x_ints, 0, rw - 1)].astype(np.int64)
        buf[:, zero_cols] = (center[:, zero_cols] << head) - IF_INTERNAL_OFFS

    # vertical pass per output row
    rows_out = np.arange(h, dtype=np.int64)
    pos_ys = y0 + rows_out * step_y
    y_ints = np.clip((pos_ys + off_y) >> pos_shift, -4, max_y)
    y_fracs = ((pos_ys + off_y) >> (pos_shift - shift_ver)) \
        & ((1 << shift_ver) - 1)
    base = np.clip(y_ints - y_int0, 0, filt_h - 1)
    row_idx = np.clip(base[:, None] + np.arange(taps)[None, :],
                      0, filt_h - 1)                   # [h, taps]
    vsrc = buf[row_idx]                                # [h, taps, w]
    vco = np.stack([coeffs(ytab, int(f), False) for f in y_fracs])
    vconv = np.einsum("htw,ht->hw", vsrc, vco)
    zr = (y_fracs == 0) if (ytab is None and filter_index < 2) \
        else np.zeros(h, dtype=bool)
    if bi:
        out = vconv >> IF_FILTER_PREC
        if zr.any():
            out[zr] = buf[np.clip(y_ints[zr] - y_int0 + half, 0,
                                  filt_h - 1)]
        return out
    s2 = IF_FILTER_PREC + head
    off2 = (1 << (s2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC)
    out = (vconv + off2) >> s2
    if zr.any():
        center = buf[np.clip(y_ints[zr] - y_int0 + half, 0, filt_h - 1)]
        out[zr] = (center + IF_INTERNAL_OFFS + (1 << (head - 1))) >> head
    return np.clip(out, 0, (1 << bd) - 1)
