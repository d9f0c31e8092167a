"""Scaling-list APS payload and dequantization-matrix derivation.

Parity: HLSyntaxReader::parseScalingList/decodeScalingList
(HLSyntaxReader.cpp:4509/4545), ScalingList (Slice.h:156),
Quant::setScalingListDec/processScalingListDec (Quant.cpp:385/483),
g_scalingListId (Rom.cpp:504).

28 coded lists: ids 0-1 are 2x2 (inter chroma only), 2-7 are 4x4,
8-27 are 8x8 (representing 8x8..64x64 via nearest-neighbour upsampling,
with an explicit DC term for ids >= 14).  Rectangular transform blocks
sample the square matrix of their larger side.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# g_scalingListId[sizeId][listType]: coded-list id per TB size (1<<sizeId)
# and list type (intra Y/Cb/Cr, inter Y/Cb/Cr).  Rom.cpp:504.
SCALING_LIST_ID = (
    (0, 0, 0, 0, 0, 0),        # 1x1 (unused)
    (0, 0, 0, 0, 0, 1),        # 2x2 (chroma inter only)
    (2, 3, 4, 5, 6, 7),        # 4x4
    (8, 9, 10, 11, 12, 13),    # 8x8
    (14, 15, 16, 17, 18, 19),  # 16x16
    (20, 21, 22, 23, 24, 25),  # 32x32
    (26, 21, 22, 27, 24, 25),  # 64x64 (luma 26/27, chroma reuse 32x32)
)

ZERO_OUT_TH = 32  # JVET_C0024_ZERO_OUT_TH


def matrix_size(list_id: int) -> int:
    return 2 if list_id < 2 else 4 if list_id < 8 else 8


def is_luma_list(list_id: int) -> bool:
    return list_id % 3 == 2 or list_id == 27


@dataclass
class ScalingListData:
    """Decoded ScalingMatrixRec: 28 square matrices + DC values."""
    mats: list = field(default_factory=lambda: [
        np.zeros((matrix_size(i),) * 2, dtype=np.int32) for i in range(28)])
    dc: list = field(default_factory=lambda: [0] * 28)


def _diag_scan(s: int):
    from refdec.ops.rom import _diag_scan as ds
    return ds(s, s)


def parse_scaling_list(r, chroma_present: bool) -> ScalingListData:
    """Parity: parseScalingList + decodeScalingList
    (HLSyntaxReader.cpp:4509-4577)."""
    sl = ScalingListData()
    for list_id in range(28):
        if not (chroma_present or is_luma_list(list_id)):
            continue
        copy_flag = bool(r.flag())
        pred_flag = bool(r.flag()) if not copy_flag else False
        pred_id_delta = 0
        if (copy_flag or pred_flag) and list_id not in (0, 2, 8):
            pred_id_delta = r.ue()
            max_delta = list_id if list_id < 2 else \
                list_id - 2 if list_id < 8 else list_id - 8
            if pred_id_delta > max_delta:
                raise ValueError("scaling_list_pred_id_delta out of range")
        _decode_one(r, sl, list_id, pred_id_delta, copy_flag, pred_flag)
    return sl


def _decode_one(r, sl: ScalingListData, list_id: int, pred_id_delta: int,
                copy_flag: bool, pred_flag: bool) -> None:
    s = matrix_size(list_id)
    ref_id = list_id - pred_id_delta
    if not copy_flag and not pred_flag:
        pred = np.full((s, s), 8, dtype=np.int32)
        dc_pred = 8
    elif pred_id_delta == 0:
        pred = np.full((s, s), 16, dtype=np.int32)
        dc_pred = 16
    else:
        pred = sl.mats[ref_id].copy()
        # note: the reference indexes ScalingListDC with the full id, not
        # id-14 (the "MINUS_14" workaround in decodeScalingList); for
        # refId <= 13 the DC predictor is the top-left predictor sample
        dc_pred = sl.dc[ref_id] if ref_id > 13 else int(pred.flat[0])

    if copy_flag:
        sl.mats[list_id] = pred
        if list_id >= 14:
            sl.dc[list_id] = dc_pred
        return

    next_coef = 0
    if list_id > 13:
        d = r.se()
        if not -128 <= d <= 127:
            raise ValueError("scaling_list_dc_coef out of range")
        next_coef += d
        sl.dc[list_id] = (dc_pred + d) & 255
        if sl.dc[list_id] <= 0:
            raise ValueError("ScalingMatrixDcRec must be > 0")

    rec = np.zeros((s, s), dtype=np.int32)
    for (x, y) in _diag_scan(s):
        if not (list_id > 25 and x >= 4 and y >= 4):
            d = r.se()
            if not -128 <= d <= 127:
                raise ValueError("scaling_list_delta_coef out of range")
            next_coef += d
        rec[y, x] = (int(pred[y, x]) + next_coef) & 255
        if rec[y, x] <= 0:
            raise ValueError("ScalingMatrixRec must be > 0")
    sl.mats[list_id] = rec


def write_scaling_list(w, sl: ScalingListData, chroma_present: bool) -> None:
    """Encoder-side payload writer (no copy/pred modes; every list coded
    against the default predictor 8)."""
    for list_id in range(28):
        if not (chroma_present or is_luma_list(list_id)):
            continue
        w.flag(False)  # scaling_list_copy_mode_flag
        w.flag(False)  # scaling_list_pred_mode_flag
        s = matrix_size(list_id)
        mat = sl.mats[list_id]
        next_coef = 0
        if list_id > 13:
            d = _wrap_delta(sl.dc[list_id] - 8 - next_coef)
            w.se(d)
            next_coef += d
        for (x, y) in _diag_scan(s):
            if list_id > 25 and x >= 4 and y >= 4:
                continue
            target = int(mat[y, x]) - 8  # rec = (8 + next_coef) & 255
            d = _wrap_delta(target - next_coef)
            w.se(d)
            next_coef += d


def _wrap_delta(d: int) -> int:
    d &= 255
    return d - 256 if d > 127 else d


# ----------------------------------------------------------------------
# dequantization matrix derivation
# ----------------------------------------------------------------------
def build_dequant_tables(sl: ScalingListData) -> dict:
    """All (list_type, log2_w, log2_h) -> int32 [h, w] dequant matrices.

    Parity: Quant::setScalingListDec + xSet(Rec)ScalingListDec +
    processScalingListDec (Quant.cpp:385-560).  Only the top-left
    min(32, dim) region is meaningful (64-pt zero-out)."""
    out = {}
    for lt in range(6):
        for lw in range(7):
            for lh in range(7):
                w, h = 1 << lw, 1 << lh
                if max(w, h) < 4 and not (w == h == 2 and lt >= 4):
                    continue  # 1x1/1x2/2x1/2x2-luma never use matrices
                if w == h == 2 and lt < 4:
                    continue  # 2x2 luma / intra chroma skipped
                large = max(lw, lh)
                list_id = SCALING_LIST_ID[large][lt]
                base = sl.mats[list_id]
                dc = sl.dc[list_id]
                out[(lt, lw, lh)] = _expand(base, dc, w, h)
    return out


def _expand(base: np.ndarray, dc: int, w: int, h: int) -> np.ndarray:
    """processScalingListDec for one target size (Quant.cpp:483-560)."""
    s = base.shape[0]
    m = np.zeros((h, w), dtype=np.int32)
    loop_h, loop_w = min(h, ZERO_OUT_TH), min(w, ZERO_OUT_TH)
    if w == h:
        rl2 = max(0, (w // min(8, w) - 1).bit_length())
        # square: nearest-neighbour upsample of the s x s base
        j = np.arange(loop_h) >> rl2
        i = np.arange(loop_w) >> rl2
        m[:loop_h, :loop_w] = base[np.ix_(j, i)]
    else:
        hl2, wl2 = h.bit_length() - 1, w.bit_length() - 1
        sl2 = s.bit_length() - 1
        ratio_wh = abs(hl2 - wl2)
        ratio_h = hl2 - sl2 if h >= s else sl2 - hl2
        ratio_w = wl2 - sl2 if w >= s else sl2 - wl2
        if h > w:
            for j in range(0, loop_h, 1 << ratio_h):
                row = base[j >> ratio_h,
                           (np.arange(loop_w) << ratio_wh) >> ratio_h]
                for jj in range(1 << ratio_h):
                    if j + jj < h:
                        m[j + jj, :loop_w] = row
        else:
            jj = (np.arange(loop_h) << ratio_wh) >> ratio_w
            ii = np.arange(loop_w) >> ratio_w
            m[:loop_h, :loop_w] = base[np.ix_(jj, ii)]
    if max(w, h) > 8:
        m[0, 0] = dc
    return m
