"""Numpy golden ALF (adaptive loop filter) + CC-ALF.

Behavioral parity (re-designed, not ported):
  - coefficient reconstruction: AdaptiveLoopFilter::reconstructCoeff
    (AdaptiveLoopFilter.cpp:888), fixed filter sets (ctor :82-117)
  - classification: deriveClassificationBlk (:969)
  - luma 7x7 / chroma 5x5 clipped diamond filters: filterBlk (:1176)
  - CC-ALF: filterBlkCcAlf (:1348)
  - per-CTU orchestration + virtual boundaries: filterCTU (:664),
    prepareCTU border extension (:453), constants (create :389)

ALF reads the post-SAO picture and writes a fresh buffer (the reference's
m_alfBuf swap, DecLibRecon.cpp:423-427).
"""

from __future__ import annotations

import os

import numpy as np

_T = np.load(os.path.join(os.path.dirname(__file__), "..", "ops",
                          "tables_alf.npz"))
FIXED_COEFF = _T["FIXED_FILTER_COEFF"]    # [64][13]
CLASS_TO_FILTER = _T["CLASS_TO_FILTER"]   # [16][25]
CLIP_VALUES = _T["CLIP_VALUES"]           # [bd-8][4]

MAX_NUM_ALF_CLASSES = 25
NUM_FIXED_FILTER_SETS = 16

# transpose index permutations of the 13 diamond positions
# (reconstructCoeff, AdaptiveLoopFilter.cpp:932-960)
TRANSPOSE_PERM = (
    tuple(range(13)),
    (9, 4, 10, 8, 1, 5, 11, 7, 3, 0, 2, 6, 12),
    (0, 3, 2, 1, 8, 7, 6, 5, 4, 9, 10, 11, 12),
    (9, 8, 10, 4, 3, 7, 11, 5, 1, 0, 2, 6, 12),
)

ACT_TH = (0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4)
TRANSPOSE_TABLE = (0, 1, 0, 2, 2, 3, 1, 3)


def _transposed_sets(coeff25x13: np.ndarray) -> np.ndarray:
    """[4][25][13] with the transpose permutations applied."""
    out = np.zeros((4, 25, 13), dtype=np.int64)
    for t, perm in enumerate(TRANSPOSE_PERM):
        out[t] = coeff25x13[:, list(perm)]
    return out


_FIXED_SETS_CACHE: dict = {}


def build_fixed_sets(bd: int):
    """The 16 fixed luma filter sets + default clip table (cached —
    spec constants per bit depth)."""
    if bd in _FIXED_SETS_CACHE:
        return _FIXED_SETS_CACHE[bd]
    sets = np.zeros((NUM_FIXED_FILTER_SETS, 4, 25, 13), dtype=np.int64)
    for s in range(NUM_FIXED_FILTER_SETS):
        base = FIXED_COEFF[CLASS_TO_FILTER[s]].astype(np.int64).copy()
        base[:, 12] = 128
        sets[s] = _transposed_sets(base)
    clip = np.full((4, 25, 13), int(CLIP_VALUES[bd - 8][0]), dtype=np.int64)
    sets.setflags(write=False)
    clip.setflags(write=False)
    _FIXED_SETS_CACHE[bd] = (sets, clip)
    return sets, clip


def build_luma_coeff(alf, bd: int):
    """reconstructCoeff luma: per-class coeff + clip, with transposes.
    Returns ([4][25][13] coeff, [4][25][13] clip).  Cached on the APS
    payload object (APSs persist across pictures)."""
    cache = getattr(alf, "_luma_tables_cache", None)
    if cache is None:
        try:
            cache = alf._luma_tables_cache = {}
        except AttributeError:
            cache = None
    if cache is not None and bd in cache:
        return cache[bd]
    coeff = np.zeros((25, 13), dtype=np.int64)
    clip = np.zeros((25, 13), dtype=np.int64)
    vls = CLIP_VALUES[bd - 8]
    for cls in range(MAX_NUM_ALF_CLASSES):
        f = alf.filter_coeff_delta_idx[cls]
        coeff[cls, :12] = alf.luma_coeff[f]
        coeff[cls, 12] = 128
        for j in range(12):
            ci = alf.luma_clip_idx[f][j] if alf.non_linear_luma else 0
            clip[cls, j] = vls[ci]
        clip[cls, 12] = vls[0]
    out = (_transposed_sets(coeff), _transposed_sets(clip))
    if cache is not None:
        cache[bd] = out
    return out


def build_chroma_coeff(alf, alt: int, bd: int):
    """Chroma 5x5 coeff + clip for one alternative."""
    coeff = np.array(alf.chroma_coeff[alt] + [128], dtype=np.int64)
    vls = CLIP_VALUES[bd - 8]
    clip = np.array(
        [vls[alf.chroma_clip_idx[alt][j] if alf.non_linear_chroma else 0]
         for j in range(6)] + [int(vls[0])], dtype=np.int64)
    return coeff, clip


def classify(src: np.ndarray, x0: int, y0: int, w: int, h: int, bd: int,
             vb_ctu_h: int, vb_pos: int, bounds: tuple | None = None):
    """deriveClassificationBlk over an area; returns (class, transpose)
    int arrays of shape [h/4, w/4].  bounds: optional (lo_x, lo_y, hi_x,
    hi_y) sample-clamp window — the ALF boundary clipping for CTUs whose
    neighbors are unavailable (loop-filter-across rules,
    AdaptiveLoopFilter.cpp:176-265)."""
    hh, ww = src.shape
    s = src.astype(np.int64)
    lo_x, lo_y, hi_x, hi_y = bounds if bounds is not None \
        else (0, 0, ww - 1, hh - 1)

    def row(r):
        return np.clip(r, lo_y, hi_y)

    def col(c):
        return np.clip(c, lo_x, hi_x)

    gh = (h + 4) // 2 + 1
    gw = (w + 4) // 2 + 1
    lap = np.zeros((4, gh, gw), dtype=np.int64)  # VER, HOR, D0, D1
    for i in range(0, h + 4, 2):
        yoff = y0 - 3 + i + 1
        r0, r1, r2, r3 = yoff - 1, yoff, yoff + 1, yoff + 2
        if (y0 - 2 + i) > 0 and (y0 - 2 + i) % vb_ctu_h == vb_pos - 2:
            r3 = r2
        elif (y0 - 2 + i) > 0 and (y0 - 2 + i) % vb_ctu_h == vb_pos:
            r0 = r1
        js = np.arange(0, w + 4, 2)
        pix = js + 1 + x0 - 3
        s0 = s[row(r0)]
        s1 = s[row(r1)]
        s2 = s[row(r2)]
        s3 = s[row(r3)]
        y0v = s1[col(pix)] * 2
        yup1 = s2[col(pix + 1)] * 2
        lap[0, i // 2, :len(js)] = (
            np.abs(y0v - s0[col(pix)] - s2[col(pix)])
            + np.abs(yup1 - s1[col(pix + 1)] - s3[col(pix + 1)]))
        lap[1, i // 2, :len(js)] = (
            np.abs(y0v - s1[col(pix + 1)] - s1[col(pix - 1)])
            + np.abs(yup1 - s2[col(pix + 2)] - s2[col(pix)]))
        lap[2, i // 2, :len(js)] = (
            np.abs(y0v - s0[col(pix - 1)] - s2[col(pix + 1)])
            + np.abs(yup1 - s1[col(pix)] - s3[col(pix + 2)]))
        lap[3, i // 2, :len(js)] = (
            np.abs(y0v - s2[col(pix - 1)] - s0[col(pix + 1)])
            + np.abs(yup1 - s3[col(pix)] - s1[col(pix + 2)]))

    # horizontal aggregation: 4 consecutive half-cells summed at even cells
    agg = np.zeros_like(lap)
    n_cells = (w + 4) // 2 + ((w + 4) % 2 > 0)
    for j2 in range(0, gw - 3, 2):
        agg[:, :, j2] = lap[:, :, j2] + lap[:, :, j2 + 1] \
            + lap[:, :, j2 + 2] + lap[:, :, j2 + 3]

    cls_out = np.zeros((h // 4, w // 4), dtype=np.int32)
    tr_out = np.zeros((h // 4, w // 4), dtype=np.int32)
    shift = bd + 4
    for bi in range(0, h, 4):
        for bj in range(0, w, 4):
            r = bi // 2
            c = bj // 2
            ymod = (bi + y0) % vb_ctu_h
            if ymod == vb_pos - 4:
                rows = (r, r + 1, r + 2)
            elif ymod == vb_pos:
                rows = (r + 1, r + 2, r + 3)
            else:
                rows = (r, r + 1, r + 2, r + 3)
            sum_v = int(sum(agg[0, rr, c] for rr in rows))
            sum_h = int(sum(agg[1, rr, c] for rr in rows))
            sum_d0 = int(sum(agg[2, rr, c] for rr in rows))
            sum_d1 = int(sum(agg[3, rr, c] for rr in rows))
            temp_act = sum_v + sum_h
            if ymod == vb_pos - 4 or ymod == vb_pos:
                activity = min(15, max(0, (temp_act * 96) >> shift))
            else:
                activity = min(15, max(0, (temp_act * 64) >> shift))
            cls = ACT_TH[activity]
            if sum_v > sum_h:
                hv1, hv0, dir_hv = sum_v, sum_h, 1
            else:
                hv1, hv0, dir_hv = sum_h, sum_v, 3
            if sum_d0 > sum_d1:
                d1, d0, dir_d = sum_d0, sum_d1, 0
            else:
                d1, d0, dir_d = sum_d1, sum_d0, 2
            if d1 * hv0 > hv1 * d0:
                hvd1, hvd0 = d1, d0
                main_dir, sec_dir = dir_d, dir_hv
            else:
                hvd1, hvd0 = hv1, hv0
                main_dir, sec_dir = dir_hv, dir_d
            strength = 0
            if hvd1 > 2 * hvd0:
                strength = 1
            if hvd1 * 2 > 9 * hvd0:
                strength = 2
            if strength:
                cls += (((main_dir & 1) << 1) + strength) * 5
            tr = TRANSPOSE_TABLE[main_dir * 2 + (sec_dir >> 1)]
            cls_out[bi // 4, bj // 4] = cls
            tr_out[bi // 4, bj // 4] = tr
    return cls_out, tr_out


def classify_frame(src: np.ndarray, bd: int, vb_h: int, vb_pos: int):
    """Whole-frame vectorized 4x4 classification (bounds=None fast path
    of classify(); bit-exact — the per-block scalar version below is the
    golden reference and still serves restricted sub-areas)."""
    h, w = src.shape
    from refdec.native import native_cabac
    nc = native_cabac()
    if nc is not None and hasattr(nc, "alf_classify"):
        s32 = np.ascontiguousarray(src, dtype=np.int32)
        cls = np.empty((h // 4, w // 4), dtype=np.int32)
        tr = np.empty((h // 4, w // 4), dtype=np.int32)
        nc.alf_classify(s32, cls, tr, h, w, bd, vb_h, vb_pos)
        return cls, tr
    s = src.astype(np.int64)
    gh = (h + 4) // 2
    gw = (w + 4) // 2

    i = np.arange(0, h + 4, 2)
    yoff = i - 2
    r0, r1, r2, r3 = yoff - 1, yoff, yoff + 1, yoff + 2
    vb_lo = (yoff > 0) & (yoff % vb_h == vb_pos - 2)
    vb_hi = (yoff > 0) & (~vb_lo) & (yoff % vb_h == vb_pos)
    r3 = np.where(vb_lo, r2, r3)
    r0 = np.where(vb_hi, r1, r0)
    r0, r1, r2, r3 = (np.clip(r, 0, h - 1) for r in (r0, r1, r2, r3))
    js = np.arange(0, w + 4, 2)
    pix = js - 2
    cm1, c0, cp1, cp2 = (np.clip(pix + d, 0, w - 1) for d in (-1, 0, 1, 2))

    s0, s1, s2, s3 = s[r0], s[r1], s[r2], s[r3]
    y0v = s1[:, c0] * 2
    yup1 = s2[:, cp1] * 2
    lap = np.stack([
        np.abs(y0v - s0[:, c0] - s2[:, c0])
        + np.abs(yup1 - s1[:, cp1] - s3[:, cp1]),
        np.abs(y0v - s1[:, cp1] - s1[:, cm1])
        + np.abs(yup1 - s2[:, cp2] - s2[:, c0]),
        np.abs(y0v - s0[:, cm1] - s2[:, cp1])
        + np.abs(yup1 - s1[:, c0] - s3[:, cp2]),
        np.abs(y0v - s2[:, cm1] - s0[:, cp1])
        + np.abs(yup1 - s3[:, c0] - s1[:, cp2])])  # [4, gh, gw]

    lp = np.pad(lap, ((0, 0), (0, 3), (0, 3)))
    agg = lp[:, :gh, :gw] + lp[:, :gh, 1:gw + 1] + lp[:, :gh, 2:gw + 2] \
        + lp[:, :gh, 3:gw + 3]
    h4, w4 = h // 4, w // 4
    rs = 2 * np.arange(h4)
    csel = 2 * np.arange(w4)
    aggp = np.pad(agg, ((0, 0), (0, 3), (0, 0)))
    S = [aggp[:, rs + k][:, :, csel] for k in range(4)]
    sum4 = S[0] + S[1] + S[2] + S[3]
    ymod = (4 * np.arange(h4)) % vb_h
    row_lo = (ymod == vb_pos - 4)[None, :, None]
    row_hi = (ymod == vb_pos)[None, :, None]
    sums = np.where(row_lo, sum4 - S[3],
                    np.where(row_hi, sum4 - S[0], sum4))
    sum_v, sum_h, sum_d0, sum_d1 = sums

    shift = bd + 4
    temp_act = sum_v + sum_h
    near = row_lo[0] | row_hi[0]
    act = np.where(near, (temp_act * 96) >> shift,
                   (temp_act * 64) >> shift)
    act = np.clip(act, 0, 15)
    act_th = np.array((0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4),
                      dtype=np.int32)
    cls = act_th[act]

    vgh = sum_v > sum_h
    hv1 = np.where(vgh, sum_v, sum_h)
    hv0 = np.where(vgh, sum_h, sum_v)
    dir_hv = np.where(vgh, 1, 3)
    dgd = sum_d0 > sum_d1
    d1 = np.where(dgd, sum_d0, sum_d1)
    d0 = np.where(dgd, sum_d1, sum_d0)
    dir_d = np.where(dgd, 0, 2)
    dsel = d1 * hv0 > hv1 * d0
    hvd1 = np.where(dsel, d1, hv1)
    hvd0 = np.where(dsel, d0, hv0)
    main_dir = np.where(dsel, dir_d, dir_hv)
    sec_dir = np.where(dsel, dir_hv, dir_d)
    strength = np.where(hvd1 * 2 > 9 * hvd0, 2,
                        np.where(hvd1 > 2 * hvd0, 1, 0))
    cls = np.where(strength > 0,
                   cls + (((main_dir & 1) << 1) + strength) * 5, cls)
    transpose = np.array((0, 1, 0, 2, 2, 3, 1, 3), dtype=np.int32)
    tr = transpose[main_dir * 2 + (sec_dir >> 1)]
    return cls.astype(np.int32), tr.astype(np.int32)


def filter_luma_frame(src: np.ndarray, dst: np.ndarray, co4, cl4, dmap,
                      near, lo_x, lo_y, hi_x, hi_y, mask, bd: int) -> None:
    """Vectorized whole-frame 7x7 clipped-diamond luma filter with
    per-4x4 coefficients/clips (blocked broadcast) and clamp windows
    (parity: filter_luma_area)."""
    _diamond_frame(src, dst, co4, cl4, dmap, near, lo_x, lo_y, hi_x,
                   hi_y, mask, bd, LUMA_TAPS)


def filter_chroma_frame(src, dst, co4, cl4, dmap, near, lo_x, lo_y, hi_x,
                        hi_y, mask, bd: int) -> None:
    _diamond_frame(src, dst, co4, cl4, dmap, near, lo_x, lo_y, hi_x,
                   hi_y, mask, bd, CHROMA_TAPS)


def _diamond_frame(src, dst, co4, cl4, dmap, near, lo_x, lo_y, hi_x,
                   hi_y, mask, bd, taps) -> None:
    """co4/cl4: [h/4, w/4, n_taps] int per-4x4 coefficients/clips.
    lo_x=None selects the pad+slice fast path (whole-picture clamp
    windows, the common case); per-pixel clamp maps take the gather
    path (restricted loop-filter-across areas)."""
    h, w = src.shape
    h4, w4 = h // 4, w // 4
    s = src.astype(np.int32, copy=False)
    trivial = lo_x is None
    if trivial:
        from refdec.native import native_cabac
        nc = native_cabac()
        if nc is not None and hasattr(nc, "alf_diamond") \
                and s.flags.c_contiguous:
            co4c = np.ascontiguousarray(co4, dtype=np.int32)
            cl4c = np.ascontiguousarray(cl4, dtype=np.int32)
            outc = np.empty((h, w), dtype=np.int32)
            nc.alf_diamond(s, outc, h, w, len(taps), co4c, cl4c,
                           np.ascontiguousarray(dmap, dtype=np.int32),
                           np.ascontiguousarray(near, dtype=np.uint8),
                           np.ascontiguousarray(mask, dtype=np.uint8),
                           bd)
            np.copyto(dst, outc.astype(dst.dtype), where=mask)
            return
        pad = np.pad(s, 3, mode="edge")
    else:
        ys = np.arange(h)[:, None]
        xs = np.arange(w)[None, :]
    acc = np.zeros((h, w), dtype=np.int32)
    accb = acc.reshape(h4, 4, w4, 4)
    co4b = np.ascontiguousarray(co4.transpose(2, 0, 1))[
        :, :, None, :, None].astype(np.int32)
    cl4b = np.ascontiguousarray(cl4.transpose(2, 0, 1))[
        :, :, None, :, None].astype(np.int32)
    for k, (dy, dx) in enumerate(taps):
        if trivial:
            a = pad[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
            b = pad[3 - dy: 3 - dy + h, 3 - dx: 3 - dx + w]
            dcol = dmap[:, dy]
            fix = np.nonzero(dcol != dy)[0]
            if len(fix):
                a = a.copy()
                b = b.copy()
                for r in fix:
                    dv = int(dcol[r])
                    a[r] = pad[3 + r + dv, 3 + dx: 3 + dx + w]
                    b[r] = pad[3 + r - dv, 3 - dx: 3 - dx + w]
        else:
            dd = dmap[:, dy][:, None]
            a = s[np.clip(ys + dd, lo_y, hi_y),
                  np.clip(xs + dx, lo_x, hi_x)]
            b = s[np.clip(ys - dd, lo_y, hi_y),
                  np.clip(xs - dx, lo_x, hi_x)]
        ck = cl4b[k]
        da = (a - s).reshape(h4, 4, w4, 4)
        db_ = (b - s).reshape(h4, 4, w4, 4)
        diff = np.clip(da, -ck, ck) + np.clip(db_, -ck, ck)
        accb += co4b[k] * diff
    nr = near[:, None]
    outv = np.where(nr, (acc + (1 << 9)) >> 10, (acc + 64) >> 7)
    outv = np.clip(outv + s, 0, (1 << bd) - 1)
    np.copyto(dst, outv.astype(dst.dtype), where=mask)


def filter_cc_frame(luma, dst, coeff, off_rows, skip_rows, lo_x, lo_y,
                    hi_x, hi_y, active, bd: int, sx: int, sy: int,
                    trivial: bool = False) -> None:
    """Vectorized whole-frame CC-ALF (numpy port of the device kernel;
    parity: filter_cc_area)."""
    hc, wc = dst.shape
    if trivial:
        from refdec.native import native_cabac
        nc = native_cabac()
        if nc is not None and hasattr(nc, "cc_alf") \
                and luma.dtype == np.int32 and luma.flags.c_contiguous \
                and dst.dtype == np.int32 and dst.flags.c_contiguous:
            h, w = luma.shape
            nc.cc_alf(luma, dst, h, w, hc, wc, sx, sy,
                      np.ascontiguousarray(coeff, dtype=np.int32),
                      np.ascontiguousarray(off_rows, dtype=np.int32),
                      np.ascontiguousarray(skip_rows, dtype=np.uint8),
                      np.ascontiguousarray(active, dtype=np.uint8), bd)
            return
    if lo_x is None:
        # repair of this copy: with no clamp window the lattice clamps to
        # the whole picture, as the C path does (np.clip takes no double
        # None under numpy < 2.1)
        lo_x, lo_y, hi_x, hi_y = 0, 0, luma.shape[1] - 1, luma.shape[0] - 1
    sl = luma.astype(np.int64)
    pel_max = (1 << bd) - 1
    half = (1 << bd) >> 1
    ly = (np.arange(hc) << sy)[:, None]
    lx = (np.arange(wc) << sx)[None, :]

    def lat(ry, rx):
        return sl[np.clip(ry, lo_y, hi_y), np.clip(rx, lo_x, hi_x)]

    off1 = off_rows[:, 0][:, None]
    off2 = off_rows[:, 1][:, None]
    off3 = off_rows[:, 2][:, None]
    curr = lat(ly, lx)
    acc = (coeff[:, :, 0] * (lat(ly + off2, lx) - curr)
           + coeff[:, :, 1] * (lat(ly, lx - 1) - curr)
           + coeff[:, :, 2] * (lat(ly, lx + 1) - curr)
           + coeff[:, :, 3] * (lat(ly + off1, lx - 1) - curr)
           + coeff[:, :, 4] * (lat(ly + off1, lx) - curr)
           + coeff[:, :, 5] * (lat(ly + off1, lx + 1) - curr)
           + coeff[:, :, 6] * (lat(ly + off3, lx) - curr))
    acc = (acc + 64) >> 7
    acc = np.clip(acc + half, 0, pel_max) - half
    d = dst.astype(np.int64)
    outv = np.clip(acc + d, 0, pel_max)
    use = active & ~skip_rows[:, None]
    dst[use] = outv[use]


def _clip_diff(clip, curr, a, b):
    return np.clip(a - curr, -clip, clip) + np.clip(b - curr, -clip, clip)


# 7x7 diamond tap offsets (dy, dx) per coefficient pair (filterBlk 7x7)
LUMA_TAPS = ((3, 0), (2, 1), (2, 0), (2, -1), (1, 2), (1, 1), (1, 0),
             (1, -1), (1, -2), (0, 3), (0, 2), (0, 1))
CHROMA_TAPS = ((2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1))


def _vb_row_offsets(y_abs: int, vb_ctu_h: int, vb_pos: int, chroma: bool):
    """Per-row clipped vertical tap distances (filterBlk VB handling).
    Returns (d1, d2, d3, near_vb): usable downward distances for nominal
    1, 2, 3 (upward mirrored)."""
    yvb = y_abs & (vb_ctu_h - 1)
    d = [0, 1, 2, 3]
    near = yvb == vb_pos - 1 or yvb == vb_pos
    lim = 2 if chroma else 4
    if yvb < vb_pos and yvb >= vb_pos - lim:
        d[1] = 0 if yvb == vb_pos - 1 else 1
        d[2] = d[1] if yvb >= vb_pos - 2 else 2
        d[3] = d[2] if yvb >= vb_pos - 3 else 3
    elif yvb >= vb_pos and yvb <= vb_pos + lim - 1:
        d[1] = 0 if yvb == vb_pos else 1
        d[2] = d[1] if yvb <= vb_pos + 1 else 2
        d[3] = d[2] if yvb <= vb_pos + 2 else 3
    return d[1], d[2], d[3], near


def filter_luma_area(src: np.ndarray, dst: np.ndarray, cls, tr,
                     coeff_sets: np.ndarray, clip_sets: np.ndarray,
                     x0: int, y0: int, w: int, h: int, bd: int,
                     vb_ctu_h: int, vb_pos: int,
                     bounds: tuple | None = None) -> None:
    """7x7 clipped diamond (filterBlk<ALF_FILTER_7>); cls/tr indexed by
    absolute 4x4 position."""
    hh, ww = src.shape
    s = src.astype(np.int64)
    pel_max = (1 << bd) - 1
    lo_x, lo_y, hi_x, hi_y = bounds if bounds is not None \
        else (0, 0, ww - 1, hh - 1)

    def at(r, cdelta, base_cols):
        return s[np.clip(r, lo_y, hi_y)][np.clip(base_cols + cdelta, lo_x,
                                                 hi_x)]

    for bi in range(0, h, 4):
        for bj in range(0, w, 4):
            c_idx = int(cls[(y0 + bi) >> 2, (x0 + bj) >> 2])
            t_idx = int(tr[(y0 + bi) >> 2, (x0 + bj) >> 2])
            co = coeff_sets[t_idx, c_idx]
            cl = clip_sets[t_idx, c_idx]
            cols = np.arange(x0 + bj, x0 + bj + 4)
            for ii in range(4):
                y = y0 + bi + ii
                d1, d2, d3, near = _vb_row_offsets(y, vb_ctu_h, vb_pos,
                                                   False)
                curr = at(y, 0, cols)
                acc = np.zeros(4, dtype=np.int64)
                dmap = (0, d1, d2, d3)
                for k, (dy, dx) in enumerate(LUMA_TAPS):
                    dd = dmap[dy]
                    acc += co[k] * _clip_diff(cl[k], curr,
                                              at(y + dd, dx, cols),
                                              at(y - dd, -dx, cols))
                if near:
                    acc = (acc + (1 << 9)) >> 10
                else:
                    acc = (acc + 64) >> 7
                dst[y, x0 + bj:x0 + bj + 4] = np.clip(acc + curr, 0,
                                                      pel_max)


def filter_chroma_area(src: np.ndarray, dst: np.ndarray, coeff, clip,
                       x0: int, y0: int, w: int, h: int, bd: int,
                       vb_ctu_h: int, vb_pos: int,
                       bounds: tuple | None = None) -> None:
    """5x5 clipped diamond (filterBlk<ALF_FILTER_5>)."""
    hh, ww = src.shape
    s = src.astype(np.int64)
    pel_max = (1 << bd) - 1
    lo_x, lo_y, hi_x, hi_y = bounds if bounds is not None \
        else (0, 0, ww - 1, hh - 1)

    def at(r, cdelta, base_cols):
        return s[np.clip(r, lo_y, hi_y)][np.clip(base_cols + cdelta, lo_x,
                                                 hi_x)]

    for bi in range(0, h, 4):
        for bj in range(0, w, 4):
            cols = np.arange(x0 + bj, x0 + bj + 4)
            for ii in range(4):
                y = y0 + bi + ii
                d1, d2, _, near = _vb_row_offsets(y, vb_ctu_h, vb_pos, True)
                curr = at(y, 0, cols)
                acc = np.zeros(4, dtype=np.int64)
                dmap = (0, d1, d2)
                for k, (dy, dx) in enumerate(CHROMA_TAPS):
                    dd = dmap[dy]
                    acc += coeff[k] * _clip_diff(clip[k], curr,
                                                 at(y + dd, dx, cols),
                                                 at(y - dd, -dx, cols))
                if near:
                    acc = (acc + (1 << 9)) >> 10
                else:
                    acc = (acc + 64) >> 7
                dst[y, x0 + bj:x0 + bj + 4] = np.clip(acc + curr, 0,
                                                      pel_max)


def filter_cc_area(luma_src: np.ndarray, dst: np.ndarray, coeff,
                   cx0: int, cy0: int, cw: int, chh: int, bd: int,
                   scale_x: int, scale_y: int, vb_ctu_h: int, vb_pos: int,
                   bounds: tuple | None = None) -> None:
    """CC-ALF correction on one chroma area from the pre-ALF luma
    (filterBlkCcAlf, AdaptiveLoopFilter.cpp:1348).  dst modified in place
    (already contains the chroma-ALF output).  bounds in luma coords."""
    hh, ww = luma_src.shape
    s = luma_src.astype(np.int64)
    pel_max = (1 << bd) - 1
    half = 1 << bd >> 1
    lo_x, lo_y, hi_x, hi_y = bounds if bounds is not None \
        else (0, 0, ww - 1, hh - 1)

    def lat(r, c):
        return s[np.clip(r, lo_y, hi_y)][np.clip(c, lo_x, hi_x)]

    for ci in range(chh):
        y = cy0 + ci
        ly = y << scale_y
        pos = (ly) & (vb_ctu_h - 1)
        if scale_y == 0 and (pos == vb_pos or pos == vb_pos + 1):
            continue
        off1, off2, off3 = 1, -1, 2
        if pos == vb_pos - 2 or pos == vb_pos + 1:
            off3 = off1
        elif pos == vb_pos - 1 or pos == vb_pos:
            off1 = off2 = off3 = 0
        cols = (np.arange(cx0, cx0 + cw) << scale_x)
        curr = lat(ly, cols)
        acc = (coeff[0] * (lat(ly + off2, cols) - curr)
               + coeff[1] * (lat(ly, cols - 1) - curr)
               + coeff[2] * (lat(ly, cols + 1) - curr)
               + coeff[3] * (lat(ly + off1, cols - 1) - curr)
               + coeff[4] * (lat(ly + off1, cols) - curr)
               + coeff[5] * (lat(ly + off1, cols + 1) - curr)
               + coeff[6] * (lat(ly + off3, cols) - curr))
        acc = (acc + 64) >> 7
        acc = np.clip(acc + half, 0, pel_max) - half
        out = acc + dst[y, cx0:cx0 + cw].astype(np.int64)
        dst[y, cx0:cx0 + cw] = np.clip(out, 0, pel_max)


def _raster_slice_alf_pad(cs, x0: int, y0: int, w: int, h: int,
                          region: tuple | None) -> int:
    """rasterSliceAlfPad (AdaptiveLoopFilter.cpp:262-289): with raster-
    scan slices and loop-filter-across-slices off, a diagonal-neighbour
    CTU in another slice while both orthogonal neighbours are available
    (the L-shaped slice corner) pads the 4x4 corner.  Bit 1 = top-left,
    bit 2 = bottom-right."""
    pps = cs.pps
    if len(cs.shs) <= 1 or pps.loop_filter_across_slices \
            or getattr(pps, "rect_slice", True):
        return 0
    ctu = cs.sps.ctu_size
    si_c = int(cs.slice_map[y0 >> 2, x0 >> 2])
    lo_x, lo_y, hi_x, hi_y = region if region is not None \
        else (0, 0, cs.w - 1, cs.h - 1)
    clip_top, clip_left = lo_y == y0, lo_x == x0
    clip_bot = hi_y == y0 + h - 1 and y0 + h < cs.h
    clip_right = hi_x == x0 + w - 1 and x0 + w < cs.w
    pad = 0
    if not clip_top and not clip_left and x0 >= ctu and y0 >= ctu \
            and int(cs.slice_map[(y0 - ctu) >> 2, (x0 - ctu) >> 2]) != si_c:
        pad |= 1
    if not clip_bot and not clip_right and x0 + ctu < cs.w \
            and y0 + ctu < cs.h \
            and int(cs.slice_map[(y0 + ctu) >> 2, (x0 + ctu) >> 2]) != si_c:
        pad |= 2
    return pad


def _alf_clip_bounds(cs, x0: int, y0: int, w: int, h: int) -> tuple | None:
    """Per-CTU sample-clamp window from the loop-filter-across rules
    (AdaptiveLoopFilter.cpp:176-265: clipTop/Bottom/Left/Right via
    CU::isAvailable on the neighbor CTUs), or None when unrestricted.
    Note: the subpic restriction uses the CURRENT CTU's subpic flag only
    (unlike deblocking, which requires both)."""
    pps = cs.pps
    ctu = cs.sps.ctu_size
    sp_cur = cs.subpic_at(x0, y0) if cs.subpics else None
    lf_subpic = bool(sp_cur[5]) if sp_cur is not None else True
    lf_tiles = True
    if not pps.no_pic_partition \
            and pps.num_tile_cols * pps.num_tile_rows > 1:
        lf_tiles = bool(pps.loop_filter_across_tiles)
    lf_slices = bool(pps.loop_filter_across_slices) if len(cs.shs) > 1 \
        else True
    if lf_subpic and lf_tiles and lf_slices:
        return None

    si_c = int(cs.slice_map[y0 >> 2, x0 >> 2])
    ti_c = int(cs.tile_map[y0 >> 2, x0 >> 2]) \
        if not pps.no_pic_partition else 0

    def avail(nx, ny):
        if not lf_slices \
                and int(cs.slice_map[ny >> 2, nx >> 2]) != si_c:
            return False
        if not lf_tiles \
                and int(cs.tile_map[ny >> 2, nx >> 2]) != ti_c:
            return False
        if not lf_subpic and cs.subpic_at(nx, ny) is not sp_cur:
            return False
        return True

    lo_x, lo_y, hi_x, hi_y = 0, 0, cs.w - 1, cs.h - 1
    if x0 >= ctu and not avail(x0 - ctu, y0):
        lo_x = x0
    if x0 + ctu < cs.w and not avail(x0 + ctu, y0):
        hi_x = x0 + w - 1
    if y0 >= ctu and not avail(x0, y0 - ctu):
        lo_y = y0
    if y0 + ctu < cs.h and not avail(x0, y0 + ctu):
        hi_y = y0 + h - 1
    if lo_x == 0 and lo_y == 0 and hi_x == cs.w - 1 and hi_y == cs.h - 1:
        return None
    return (lo_x, lo_y, hi_x, hi_y)


def _alf_vb_areas(cs, x0: int, y0: int, w: int, h: int,
                  region_bounds: tuple | None) -> list:
    """Split a CTU area at picture-header/SPS virtual boundaries
    (AdaptiveLoopFilter filterCTU numHor/VerVirBndry loop): each sub-area
    filters with sample clamping at its VB-side edges.  Returns
    [(ax, ay, aw, ah, bounds)]."""
    vbx, vby = cs.virtual_boundaries()
    if not vbx and not vby:
        return [(x0, y0, w, h, region_bounds)]
    rb = region_bounds if region_bounds is not None \
        else (0, 0, cs.w - 1, cs.h - 1)
    xs = sorted({x0, x0 + w} | {v for v in vbx if x0 < v < x0 + w})
    ys = sorted({y0, y0 + h} | {v for v in vby if y0 < v < y0 + h})
    clip_l, clip_r = x0 in vbx, (x0 + w) in vbx
    clip_t, clip_b = y0 in vby, (y0 + h) in vby
    if len(xs) == 2 and len(ys) == 2 \
            and not (clip_l or clip_r or clip_t or clip_b):
        return [(x0, y0, w, h, region_bounds)]
    out = []
    for j in range(len(ys) - 1):
        for i in range(len(xs) - 1):
            ax, ay = xs[i], ys[j]
            aw, ah = xs[i + 1] - ax, ys[j + 1] - ay
            lo_x = max(rb[0], ax if (i > 0 or clip_l) else 0)
            hi_x = min(rb[2], (xs[i + 1] - 1)
                       if (i < len(xs) - 2 or clip_r) else cs.w - 1)
            lo_y = max(rb[1], ay if (j > 0 or clip_t) else 0)
            hi_y = min(rb[3], (ys[j + 1] - 1)
                       if (j < len(ys) - 2 or clip_b) else cs.h - 1)
            b = (lo_x, lo_y, hi_x, hi_y)
            if b == (0, 0, cs.w - 1, cs.h - 1):
                b = None
            out.append((ax, ay, aw, ah, b))
    return out


import functools


@functools.lru_cache(maxsize=16)
def _vb_tables(h: int, vb_ctu_h: int, vb_pos: int, chroma: bool):
    d = np.zeros((h, 4), dtype=np.int32)
    near = np.zeros(h, dtype=bool)
    for y in range(h):
        d1, d2, d3, nr = _vb_row_offsets(y, vb_ctu_h, vb_pos, chroma)
        d[y] = (0, d1, d2, d3)
        near[y] = nr
    return d, near


@functools.lru_cache(maxsize=16)
def _cc_row_tables(hc: int, sy: int, vb_luma_h: int, vb_luma_pos: int):
    """Per-chroma-row CC-ALF luma tap offsets + VB skip rows."""
    off_rows = np.zeros((hc, 3), dtype=np.int32)
    skip_rows = np.zeros(hc, dtype=bool)
    for y in range(hc):
        ly = y << sy
        pos = ly & (vb_luma_h - 1)
        if sy == 0 and pos in (vb_luma_pos, vb_luma_pos + 1):
            skip_rows[y] = True
            continue
        o1, o2, o3 = 1, -1, 2
        if pos in (vb_luma_pos - 2, vb_luma_pos + 1):
            o3 = o1
        elif pos in (vb_luma_pos - 1, vb_luma_pos):
            o1 = o2 = o3 = 0
        off_rows[y] = (o1, o2, o3)
    return off_rows, skip_rows


def alf_frame_vec(cs, planes: list) -> list:
    """Whole-frame vectorized ALF pass — the host fast path; identical
    output to alf_frame (the per-block golden below), via the same
    parameter maps the device stage uses (alf_prepare_maps)."""
    if len(cs.shs) > 1 and not cs.pps.loop_filter_across_slices \
            and not getattr(cs.pps, "rect_slice", True):
        # raster-scan slices may need the diagonal-corner padding
        # (rasterSliceAlfPad) — handled by the per-CTU golden path
        return alf_frame(cs, planes)
    bd = cs.sps.bit_depth
    maps = alf_prepare_maps(cs, planes, bd)
    if maps is None:
        return planes
    vb_luma_h, vb_luma_pos, vb_chma_h, vb_chma_pos = maps["vb"]

    vbx, vby = cs.virtual_boundaries()
    trivial = (not vbx and not vby and not cs.subpics
               and (len(cs.shs) <= 1 or cs.pps.loop_filter_across_slices)
               and (cs.pps.no_pic_partition
                    or cs.pps.loop_filter_across_tiles))

    from refdec.native import native_cabac
    nc = native_cabac()

    def _one_pass(src, banks_co, banks_cl, idx, mask, dmap, near, n_taps):
        """Whole-plane C ALF: filter + copy-through in one pass (no
        per-block coefficient materialization, no plane copies)."""
        if not (trivial and nc is not None and hasattr(nc, "alf_apply")
                and src.dtype == np.int32 and src.flags.c_contiguous
                and src.shape[0] % 4 == 0 and src.shape[1] % 4 == 0):
            return None
        dst = np.empty_like(src)
        mask4 = np.ascontiguousarray(mask[::4, ::4], dtype=np.uint8)
        nc.alf_apply(src, dst, src.shape[0], src.shape[1], n_taps,
                     np.ascontiguousarray(banks_co, dtype=np.int32),
                     np.ascontiguousarray(banks_cl, dtype=np.int32),
                     banks_co.shape[-1],
                     np.ascontiguousarray(idx, dtype=np.int32), mask4,
                     np.ascontiguousarray(dmap, dtype=np.int32),
                     np.ascontiguousarray(near, dtype=np.uint8), bd)
        return dst

    out = list(planes)
    if maps["any_luma"]:
        h, w = planes[0].shape
        cls4 = maps["cls"]
        tr4 = maps["tr"]
        dmap, near = _vb_tables(h, vb_luma_h, vb_luma_pos, False)
        bco, bcl = maps["banks_co"], maps["banks_cl"]
        idx = (maps["set_map"] * bco.shape[1] + tr4) * bco.shape[2] + cls4
        dst = _one_pass(planes[0], bco, bcl, idx, maps["mask_y"], dmap,
                        near, 12)
        if dst is not None:
            out[0] = dst
        else:
            out[0] = planes[0].copy()
            co4 = bco[maps["set_map"], tr4, cls4][:, :, :12]
            cl4 = bcl[maps["set_map"], tr4, cls4][:, :, :12]
            filter_luma_frame(planes[0], out[0], co4, cl4, dmap, near,
                              None if trivial else maps["lo_x"],
                              maps["lo_y"], maps["hi_x"],
                              maps["hi_y"], maps["mask_y"], bd)

    if cs.num_comp > 1 and (maps["any_chroma"] or maps["any_cc"]):
        hc, wc = planes[1].shape
        dmap_c, near_c = _vb_tables(hc, vb_chma_h, vb_chma_pos, True)
        for comp in (1, 2):
            if maps["any_chroma"] and maps["mask_c"][comp - 1].any():
                alt4 = maps["chroma_alt"][comp - 1]
                dst = _one_pass(planes[comp], maps["chroma_co"],
                                maps["chroma_cl"], alt4,
                                maps["mask_c"][comp - 1], dmap_c, near_c,
                                6)
                if dst is not None:
                    out[comp] = dst
                else:
                    out[comp] = planes[comp].copy()
                    co4 = maps["chroma_co"][alt4][:, :, :6]
                    cl4 = maps["chroma_cl"][alt4][:, :, :6]
                    filter_chroma_frame(planes[comp], out[comp], co4, cl4,
                                    dmap_c, near_c,
                                    None if trivial else maps["lo_xc"],
                                    maps["lo_yc"], maps["hi_xc"],
                                    maps["hi_yc"],
                                    maps["mask_c"][comp - 1], bd)
            if maps["any_cc"] and (maps["cc_idx"][comp - 1] != 0).any():
                if out[comp] is planes[comp]:
                    # CC-ALF adds offsets in place: detach from the
                    # pre-ALF source plane first
                    out[comp] = planes[comp].copy()
                sx, sy = cs.sub_w - 1, cs.sub_h - 1
                off_rows, skip_rows = _cc_row_tables(
                    hc, sy, vb_luma_h, vb_luma_pos)
                luma = planes[0]
                dstp = out[comp]
                if (trivial and nc is not None and hasattr(nc, "cc_alf2")
                        and luma.dtype == np.int32
                        and luma.flags.c_contiguous
                        and dstp.dtype == np.int32
                        and dstp.flags.c_contiguous):
                    # banked C path: per-pixel bank indexing, no
                    # per-pixel coefficient expansion
                    h_l, w_l = luma.shape
                    nc.cc_alf2(
                        luma, dstp, h_l, w_l, hc, wc, sx, sy,
                        np.ascontiguousarray(maps["cc_banks"],
                                             dtype=np.int32),
                        np.ascontiguousarray(maps["cc_idx"][comp - 1],
                                             dtype=np.int32),
                        np.ascontiguousarray(off_rows, dtype=np.int32),
                        np.ascontiguousarray(skip_rows, dtype=np.uint8),
                        bd)
                elif trivial:
                    coeff = maps["cc_banks"][maps["cc_idx"][comp - 1]]
                    filter_cc_frame(planes[0], out[comp], coeff,
                                    off_rows, skip_rows, None, None,
                                    None, None,
                                    maps["cc_idx"][comp - 1] != 0, bd,
                                    sx, sy, trivial=True)
                else:
                    coeff = maps["cc_banks"][maps["cc_idx"][comp - 1]]
                    lyi = (np.arange(hc) << sy)[:, None]
                    lxi = (np.arange(wc) << sx)[None, :]
                    filter_cc_frame(planes[0], out[comp], coeff,
                                    off_rows, skip_rows,
                                    maps["lo_x"][lyi, lxi],
                                    maps["lo_y"][lyi, lxi],
                                    maps["hi_x"][lyi, lxi],
                                    maps["hi_y"][lyi, lxi],
                                    maps["cc_idx"][comp - 1] != 0, bd,
                                    sx, sy)
    return out


def alf_frame(cs, planes: list) -> list:
    """Whole-frame ALF pass; returns new plane list (the m_alfBuf swap)."""
    if not any(any(s_.alf_enabled) or s_.ccalf_cb_enabled
               or s_.ccalf_cr_enabled for s_ in cs.shs):
        return planes
    sh = cs.sh
    bd = cs.sps.bit_depth
    ctu = cs.sps.ctu_size
    vb_luma_h, vb_luma_pos = ctu, ctu - 4
    sub_y = cs.sub_h
    vb_chma_h = ctu // sub_y
    vb_chma_pos = vb_chma_h - 2

    fixed_sets, fixed_clip = build_fixed_sets(bd)
    luma_tables = {}  # (slice_idx, aps position in slice list) -> tables
    for si, s_ in enumerate(cs.shs):
        for i, aps_id in enumerate(s_.alf_aps_ids_luma):
            aps = cs.alf_apss[aps_id]
            luma_tables[(si, i)] = build_luma_coeff(aps.alf, bd)

    # whole-frame classification (position-local; identical to per-32x32)
    cls = tr = None
    if any(s_.alf_enabled[0] for s_ in cs.shs):
        cls, tr = classify_frame(planes[0], bd, vb_luma_h, vb_luma_pos)

    out = [p.copy() for p in planes]
    w_ctu = cs.pps.pic_width_in_ctu
    h_ctu = cs.pps.pic_height_in_ctu
    for ry in range(h_ctu):
        for rx in range(w_ctu):
            p = cs.alf_params[ry * w_ctu + rx]
            if p is None:
                continue
            x0, y0 = rx * ctu, ry * ctu
            w = min(ctu, cs.w - x0)
            h = min(ctu, cs.h - y0)
            si = int(cs.slice_map[y0 >> 2, x0 >> 2])
            sh = cs.shs[si if 0 <= si < len(cs.shs) else 0]
            region = _alf_clip_bounds(cs, x0, y0, w, h)
            srcs = planes
            pads = _raster_slice_alf_pad(cs, x0, y0, w, h, region)
            if pads:
                # raster-scan slice diagonal-corner padding: filter this
                # CTU from patched plane copies whose unavailable corner
                # samples replicate the adjacent available column
                # (AdaptiveLoopFilter.cpp:262-289 rasterSliceAlfPad +
                # AreaBuf::padBorderPel, Buffer.h:608)
                srcs = [pl.copy() for pl in planes]
                for comp, pl in enumerate(srcs):
                    sx = cs.sub_w if comp else 1
                    sy = cs.sub_h if comp else 1
                    # The reference pads the chroma-scaled temp subbuffer:
                    # with CC-ALF on for the component the whole unit pads
                    # with component-scaled margins; otherwise the
                    # per-component path uses the UNSCALED 4-sample margin
                    # on the scaled subbuffer, so on subsampled chroma the
                    # 4x4 pad square reaches 4-margin samples INTO the CTU
                    # (AdaptiveLoopFilter.cpp:795-827, Buffer.h:608,:847).
                    cc_en = comp == 0 or (sh.ccalf_cb_enabled if comp == 1
                                          else sh.ccalf_cr_enabled)
                    mgx, mgy = 4 // sx, 4 // sy       # subbuf margins
                    mw, mh = (mgx, mgy) if cc_en else (4, 4)
                    cx0, cy0 = x0 // sx, y0 // sy
                    cw_, ch_ = w // sx, h // sy
                    if pads & 1:
                        oy, ox = cy0 - mgy, cx0 - mgx
                        pl[oy: oy + mh, ox: ox + mw] = \
                            pl[oy: oy + mh, ox + mw: ox + mw + 1]
                    if pads & 2:
                        oy = cy0 - mgy + ch_ + 2 * mgy - mh
                        ox = cx0 - mgx + cw_ + 2 * mgx - mw
                        pl[oy: oy + mh, ox: ox + mw] = \
                            pl[oy: oy + mh, ox - 1: ox]
                # classification must see the patch too
                c_b, t_b = classify(srcs[0], x0, y0, w, h, bd,
                                    vb_luma_h, vb_luma_pos,
                                    region)
                if cls is not None:
                    cls[y0 >> 2:(y0 + h) >> 2, x0 >> 2:(x0 + w) >> 2] = c_b
                    tr[y0 >> 2:(y0 + h) >> 2, x0 >> 2:(x0 + w) >> 2] = t_b
            for ax, ay, aw, ah, bounds in _alf_vb_areas(cs, x0, y0, w, h,
                                                        region):
                if sh.alf_enabled[0] and p["enable"][0]:
                    idx = p["filt_idx"]
                    if idx < NUM_FIXED_FILTER_SETS:
                        co, cl = fixed_sets[idx], fixed_clip
                    else:
                        co, cl = luma_tables[(si,
                                              idx - NUM_FIXED_FILTER_SETS)]
                    if bounds is not None:
                        # clipped area: re-classify with the clamp window
                        c_b, t_b = classify(srcs[0], ax, ay, aw, ah, bd,
                                            vb_luma_h, vb_luma_pos, bounds)
                        cls[ay >> 2:(ay + ah) >> 2,
                            ax >> 2:(ax + aw) >> 2] = c_b
                        tr[ay >> 2:(ay + ah) >> 2,
                           ax >> 2:(ax + aw) >> 2] = t_b
                    filter_luma_area(srcs[0], out[0], cls, tr, co, cl,
                                     ax, ay, aw, ah, bd, vb_luma_h,
                                     vb_luma_pos, bounds)
                if cs.num_comp > 1:
                    cx0, cy0 = ax // cs.sub_w, ay // cs.sub_h
                    cw = aw // cs.sub_w
                    chh = ah // cs.sub_h
                    bounds_c = None
                    if bounds is not None:
                        bounds_c = (bounds[0] // cs.sub_w,
                                    bounds[1] // cs.sub_h,
                                    (bounds[2] + 1) // cs.sub_w - 1,
                                    (bounds[3] + 1) // cs.sub_h - 1)
                    for comp in (1, 2):
                        if sh.alf_enabled[comp] and p["enable"][comp]:
                            aps = cs.alf_apss[sh.alf_aps_id_chroma]
                            alt = p["alt"][comp - 1]
                            coeff, clip = build_chroma_coeff(aps.alf, alt,
                                                             bd)
                            filter_chroma_area(srcs[comp], out[comp],
                                               coeff, clip, cx0, cy0, cw,
                                               chh, bd, vb_chma_h,
                                               vb_chma_pos, bounds_c)
                    for comp in (1, 2):
                        cc_on = sh.ccalf_cb_enabled if comp == 1 \
                            else sh.ccalf_cr_enabled
                        fidx = p["cc"][comp - 1]
                        if cc_on and fidx:
                            aps_id = sh.ccalf_cb_aps_id if comp == 1 \
                                else sh.ccalf_cr_aps_id
                            coeff = cs.alf_apss[aps_id].cc_alf \
                                .coeff[comp - 1][fidx - 1]
                            filter_cc_area(srcs[0], out[comp], coeff,
                                           cx0, cy0, cw, chh, bd,
                                           cs.sub_w - 1, cs.sub_h - 1,
                                           vb_luma_h, vb_luma_pos, bounds)
    return out


class _AlfMaps(dict):
    """ALF parameter-map dict whose sample-clamp window maps materialize
    with whole-picture defaults on first access (they stay None — never
    allocated — for the common unrestricted case)."""

    _WINDOWS = ("lo_x", "lo_y", "hi_x", "hi_y",
                "lo_xc", "lo_yc", "hi_xc", "hi_yc")

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        if v is None and k in self._WINDOWS:
            (h, w), (ch_c, cw_c) = self._shapes
            hh, ww = (h, w) if not k.endswith("c") else (ch_c, cw_c)
            if k.startswith("lo"):
                v = np.zeros((hh, ww), dtype=np.int32)
            else:
                lim = (ww if k in ("hi_x", "hi_xc") else hh) - 1
                v = np.full((hh, ww), lim, dtype=np.int32)
            self[k] = v
        return v


def alf_prepare_maps(cs, planes: list, bd: int):
    """Host-side parameter tensors for the device (JAX) ALF stage.

    Returns None when ALF is entirely off, else a dict with, per plane:
    classification/transpose maps (luma), per-4x4 filter-bank indices,
    stacked coefficient/clip banks, per-pixel clamp-window maps (loop-
    filter-across + virtual-boundary sub-areas) and enable masks, plus the
    CC-ALF coefficient bank and per-4x4 (chroma) filter indices."""
    if not any(any(s_.alf_enabled) or s_.ccalf_cb_enabled
               or s_.ccalf_cr_enabled for s_ in cs.shs):
        return None
    ctu = cs.sps.ctu_size
    vb_luma_h, vb_luma_pos = ctu, ctu - 4
    sub_y = cs.sub_h
    vb_chma_h = ctu // sub_y
    vb_chma_pos = vb_chma_h - 2

    fixed_sets, fixed_clip = build_fixed_sets(bd)
    luma_tables = {}
    for si, s_ in enumerate(cs.shs):
        for i, aps_id in enumerate(s_.alf_aps_ids_luma):
            aps = cs.alf_apss[aps_id]
            luma_tables[(si, i)] = build_luma_coeff(aps.alf, bd)

    cls = tr = None
    if any(s_.alf_enabled[0] for s_ in cs.shs):
        cls, tr = classify_frame(planes[0], bd, vb_luma_h, vb_luma_pos)

    h, w = planes[0].shape
    # luma banks: id 0..n-1 -> (coeff [4,25,13], clip [4,25,13])
    bank_key_to_id: dict = {}
    banks_co: list = []
    banks_cl: list = []

    def bank_id(si, idx):
        key = ("fixed", idx) if idx < NUM_FIXED_FILTER_SETS else (si, idx)
        if key not in bank_key_to_id:
            if idx < NUM_FIXED_FILTER_SETS:
                co, cl = fixed_sets[idx], fixed_clip
            else:
                co, cl = luma_tables[(si, idx - NUM_FIXED_FILTER_SETS)]
            bank_key_to_id[key] = len(banks_co)
            banks_co.append(co)
            banks_cl.append(cl)
        return bank_key_to_id[key]

    set_map = np.zeros((h >> 2, w >> 2), dtype=np.int32)
    mask_y = np.zeros((h, w), dtype=bool)
    cw_c, ch_c = cs.comp_size[1] if cs.num_comp > 1 else (1, 1)
    # sample-clamp window maps materialize only when some CTU actually
    # restricts availability (loop-filter-across / subpic / VB areas);
    # the common whole-picture case never allocates them
    lo_x = lo_y = hi_x = hi_y = None
    lo_xc = lo_yc = hi_xc = hi_yc = None

    def _ensure_windows():
        nonlocal lo_x, lo_y, hi_x, hi_y, lo_xc, lo_yc, hi_xc, hi_yc
        if lo_x is not None:
            return
        lo_x = np.zeros((h, w), dtype=np.int32)
        lo_y = np.zeros((h, w), dtype=np.int32)
        hi_x = np.full((h, w), w - 1, dtype=np.int32)
        hi_y = np.full((h, w), h - 1, dtype=np.int32)
        lo_xc = np.zeros((ch_c, cw_c), dtype=np.int32)
        lo_yc = np.zeros((ch_c, cw_c), dtype=np.int32)
        hi_xc = np.full((ch_c, cw_c), cw_c - 1, dtype=np.int32)
        hi_yc = np.full((ch_c, cw_c), ch_c - 1, dtype=np.int32)
    chroma_alt = np.zeros((2, (ch_c + 3) >> 2, (cw_c + 3) >> 2),
                          dtype=np.int32)
    mask_c = np.zeros((2, ch_c, cw_c), dtype=bool)
    cc_idx = np.zeros((2, ch_c, cw_c), dtype=np.int32)  # 0 = off, else 1+i
    chroma_banks_co: list = []
    chroma_banks_cl: list = []
    chroma_bank_ids: dict = {}
    cc_banks: list = [np.zeros(7, dtype=np.int64)]
    cc_bank_ids: dict = {}

    w_ctu = cs.pps.pic_width_in_ctu
    h_ctu = cs.pps.pic_height_in_ctu
    any_luma = any_chroma = any_cc = False
    vbx_f, vby_f = cs.virtual_boundaries()
    pps_ = cs.pps
    fast = (not vbx_f and not vby_f and not cs.subpics
            and (pps_.no_pic_partition
                 or pps_.num_tile_cols * pps_.num_tile_rows == 1
                 or pps_.loop_filter_across_tiles)
            and (len(cs.shs) == 1 or pps_.loop_filter_across_slices))
    if fast:
        # unrestricted common case: no per-CTU clamp windows or VB
        # sub-areas ever materialize, so collect per-CTU SCALARS into
        # CTU-grid arrays and upsample once (the per-CTU sample-slab
        # writes below cost ~7% of an all-intra SAO/ALF decode)
        g_set = np.full((h_ctu, w_ctu), -1, dtype=np.int32)
        g_alt = np.zeros((2, h_ctu, w_ctu), dtype=np.int32)
        g_cm = np.zeros((2, h_ctu, w_ctu), dtype=bool)
        g_cc = np.zeros((2, h_ctu, w_ctu), dtype=np.int32)
        for addr in range(h_ctu * w_ctu):
            p = cs.alf_params[addr]
            if p is None:
                continue
            ry, rx = divmod(addr, w_ctu)
            si = int(cs.slice_map[(ry * ctu) >> 2, (rx * ctu) >> 2])
            sh = cs.shs[si if 0 <= si < len(cs.shs) else 0]
            if sh.alf_enabled[0] and p["enable"][0]:
                any_luma = True
                g_set[ry, rx] = bank_id(si, p["filt_idx"])
            if cs.num_comp > 1:
                for comp in (1, 2):
                    if sh.alf_enabled[comp] and p["enable"][comp]:
                        any_chroma = True
                        aps = cs.alf_apss[sh.alf_aps_id_chroma]
                        alt = p["alt"][comp - 1]
                        key = (sh.alf_aps_id_chroma, alt)
                        if key not in chroma_bank_ids:
                            co, cl = build_chroma_coeff(aps.alf, alt, bd)
                            chroma_bank_ids[key] = len(chroma_banks_co)
                            chroma_banks_co.append(co)
                            chroma_banks_cl.append(cl)
                        g_alt[comp - 1, ry, rx] = chroma_bank_ids[key]
                        g_cm[comp - 1, ry, rx] = True
                    cc_on = sh.ccalf_cb_enabled if comp == 1 \
                        else sh.ccalf_cr_enabled
                    fidx = p["cc"][comp - 1]
                    if cc_on and fidx:
                        any_cc = True
                        aps_id = sh.ccalf_cb_aps_id if comp == 1 \
                            else sh.ccalf_cr_aps_id
                        coeff = cs.alf_apss[aps_id].cc_alf \
                            .coeff[comp - 1][fidx - 1]
                        key = (aps_id, comp, fidx)
                        if key not in cc_bank_ids:
                            cc_bank_ids[key] = len(cc_banks)
                            cc_banks.append(
                                np.asarray(coeff, dtype=np.int64))
                        g_cc[comp - 1, ry, rx] = cc_bank_ids[key]

        def _rep(g, fy, fx, hh, ww):
            return np.repeat(np.repeat(g, fy, axis=-2),
                             fx, axis=-1)[..., :hh, :ww]

        q = ctu >> 2
        set_map = _rep(np.maximum(g_set, 0), q, q, h >> 2, w >> 2)
        mask_y = _rep(g_set >= 0, ctu, ctu, h, w)
        if cs.num_comp > 1:
            cth, ctw = ctu // cs.sub_h, ctu // cs.sub_w
            chroma_alt = _rep(g_alt, cth >> 2, ctw >> 2,
                              (ch_c + 3) >> 2, (cw_c + 3) >> 2)
            mask_c = _rep(g_cm, cth, ctw, ch_c, cw_c)
            cc_idx = _rep(g_cc, cth, ctw, ch_c, cw_c)
        h_ctu = 0  # the general per-CTU loop below is fully covered
    for ry in range(h_ctu):
        for rx in range(w_ctu):
            p = cs.alf_params[ry * w_ctu + rx]
            if p is None:
                continue
            x0, y0 = rx * ctu, ry * ctu
            cw = min(ctu, cs.w - x0)
            chh = min(ctu, cs.h - y0)
            si = int(cs.slice_map[y0 >> 2, x0 >> 2])
            sh = cs.shs[si if 0 <= si < len(cs.shs) else 0]
            region = _alf_clip_bounds(cs, x0, y0, cw, chh)
            for ax, ay, aw, ah, bounds in _alf_vb_areas(cs, x0, y0, cw, chh,
                                                        region):
                if bounds is not None:
                    b = bounds
                    _ensure_windows()
                    lo_x[ay:ay + ah, ax:ax + aw] = b[0]
                    lo_y[ay:ay + ah, ax:ax + aw] = b[1]
                    hi_x[ay:ay + ah, ax:ax + aw] = b[2]
                    hi_y[ay:ay + ah, ax:ax + aw] = b[3]
                    if cs.num_comp > 1:
                        bx0, by0 = ax // cs.sub_w, ay // cs.sub_h
                        bw_, bh_ = aw // cs.sub_w, ah // cs.sub_h
                        lo_xc[by0:by0 + bh_, bx0:bx0 + bw_] = \
                            b[0] // cs.sub_w
                        lo_yc[by0:by0 + bh_, bx0:bx0 + bw_] = \
                            b[1] // cs.sub_h
                        hi_xc[by0:by0 + bh_, bx0:bx0 + bw_] = \
                            (b[2] + 1) // cs.sub_w - 1
                        hi_yc[by0:by0 + bh_, bx0:bx0 + bw_] = \
                            (b[3] + 1) // cs.sub_h - 1
                if sh.alf_enabled[0] and p["enable"][0]:
                    any_luma = True
                    if bounds is not None and cls is not None:
                        c_b, t_b = classify(planes[0], ax, ay, aw, ah, bd,
                                            vb_luma_h, vb_luma_pos, bounds)
                        cls[ay >> 2:(ay + ah) >> 2,
                            ax >> 2:(ax + aw) >> 2] = c_b
                        tr[ay >> 2:(ay + ah) >> 2,
                           ax >> 2:(ax + aw) >> 2] = t_b
                    set_map[ay >> 2:(ay + ah) >> 2, ax >> 2:(ax + aw) >> 2] \
                        = bank_id(si, p["filt_idx"])
                    mask_y[ay:ay + ah, ax:ax + aw] = True
                if cs.num_comp > 1:
                    cx0, cy0 = ax // cs.sub_w, ay // cs.sub_h
                    ccw = aw // cs.sub_w
                    cch = ah // cs.sub_h
                    for comp in (1, 2):
                        if sh.alf_enabled[comp] and p["enable"][comp]:
                            any_chroma = True
                            aps = cs.alf_apss[sh.alf_aps_id_chroma]
                            alt = p["alt"][comp - 1]
                            key = (sh.alf_aps_id_chroma, alt)
                            if key not in chroma_bank_ids:
                                co, cl = build_chroma_coeff(aps.alf, alt,
                                                            bd)
                                chroma_bank_ids[key] = len(chroma_banks_co)
                                chroma_banks_co.append(co)
                                chroma_banks_cl.append(cl)
                            cid = chroma_bank_ids[key]
                            chroma_alt[comp - 1,
                                       cy0 >> 2:(cy0 + cch + 3) >> 2,
                                       cx0 >> 2:(cx0 + ccw + 3) >> 2] = cid
                            mask_c[comp - 1, cy0:cy0 + cch,
                                   cx0:cx0 + ccw] = True
                        cc_on = sh.ccalf_cb_enabled if comp == 1 \
                            else sh.ccalf_cr_enabled
                        fidx = p["cc"][comp - 1]
                        if cc_on and fidx:
                            any_cc = True
                            aps_id = sh.ccalf_cb_aps_id if comp == 1 \
                                else sh.ccalf_cr_aps_id
                            coeff = cs.alf_apss[aps_id].cc_alf \
                                .coeff[comp - 1][fidx - 1]
                            key = (aps_id, comp, fidx)
                            if key not in cc_bank_ids:
                                cc_bank_ids[key] = len(cc_banks)
                                cc_banks.append(
                                    np.asarray(coeff, dtype=np.int64))
                            cc_idx[comp - 1, cy0:cy0 + cch,
                                   cx0:cx0 + ccw] = cc_bank_ids[key]

    maps = _AlfMaps(
        cls=cls, tr=tr, set_map=set_map, mask_y=mask_y,
        banks_co=np.stack(banks_co) if banks_co else None,
        banks_cl=np.stack(banks_cl) if banks_cl else None,
        lo_x=lo_x, lo_y=lo_y, hi_x=hi_x, hi_y=hi_y,
        chroma_alt=chroma_alt, mask_c=mask_c,
        chroma_co=np.stack(chroma_banks_co) if chroma_banks_co else None,
        chroma_cl=np.stack(chroma_banks_cl) if chroma_banks_cl else None,
        cc_idx=cc_idx, cc_banks=np.stack(cc_banks),
        lo_xc=lo_xc, lo_yc=lo_yc, hi_xc=hi_xc, hi_yc=hi_yc,
        any_luma=any_luma, any_chroma=any_chroma, any_cc=any_cc,
        vb=(vb_luma_h, vb_luma_pos, vb_chma_h, vb_chma_pos))
    maps._shapes = ((h, w), (ch_c, cw_c))
    return maps
