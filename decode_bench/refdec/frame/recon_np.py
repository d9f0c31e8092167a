"""Numpy golden reconstruction: the bit-exact scalar reference for the device
pipeline (same role as vvdec's scalar kernels vs SIMD).

Implements H.266 clause 8.4 (intra prediction) and 8.7 (dequant + inverse
transform) for the intra tool subset.  Behavioral parity:
  - dequant: vvdec Quant::dequant / DeQuantImpl (Quant.cpp:292,120)
  - inverse transform: TrQuant::xIT (TrQuant.cpp:410), _fastInverseMM
    (TrQuant_EMT.cpp:103)
  - intra: IntraPrediction.cpp — xFillReferenceSamples :1069,
    xFilterReferenceSamples :1248, xPredIntraPlanarCore :154, xGetPredValDc
    :409, xPredIntraAng :589, PDPC IntraPredSampleFilterCore :212,
    availability rule CodingStructure::getCURestricted (CodingStructure.cpp:468)
"""

from __future__ import annotations

import numpy as np

from refdec.frame.structure import (
    CodingStructure,
    CodingUnit,
    DC_IDX,
    DM_CHROMA_IDX,
    HOR_IDX,
    LM_CHROMA_IDX,
    MDLM_L_IDX,
    MDLM_T_IDX,
    MODE_IBC,
    MODE_INTRA,
    MTS_SKIP,
    PLANAR_IDX,
    TREE_D,
    TransformUnit,
    VDIA_IDX,
    VER_IDX,
    HOR_INTRA_SUBPARTITIONS,
)
from refdec.ops import rom
from refdec.ops.tables import (
    ANG_TABLE,
    CHROMA_FILTER,
    GAUSS_FILTER,
    INTRA_FILTER_THRESH,
    INV_ANG_TABLE,
    tr_matrix,
)

DIA_IDX = 34

# 4:2:2 chroma directional-mode mapping (g_chroma422IntraAngleMappingTable,
# Rom.cpp:392): squeezes luma angles onto the half-width chroma grid
CHROMA422_MAP = (
    0, 1, 61, 62, 63, 64, 65, 66, 2, 3, 5, 6, 8, 10, 12, 13, 14, 16,
    18, 20, 22, 23, 24, 26, 28, 30, 31, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 41, 42, 43, 43, 44, 44, 45, 45, 46, 47, 48, 48, 49, 49,
    50, 51, 51, 52, 52, 53, 54, 55, 55, 56, 56, 57, 57, 58, 59, 59, 60)


# ======================================================================
# dequant + inverse transform
# ======================================================================
def dequant_block(levels: np.ndarray, qp: int, log2_w: int, log2_h: int,
                  bit_depth: int, dep_quant: bool, max_x: int, max_y: int,
                  ts: bool = False, internal_minus_input: int = 0,
                  scale_mat: np.ndarray | None = None) -> np.ndarray:
    """Scalar dequantization.  levels: int32 [h, w].  scale_mat: optional
    per-coefficient dequant matrix (explicit scaling lists, Quant.cpp:338:
    rightShift += LOG2_SCALING_LIST_NEUTRAL_VALUE, scale *= matrix)."""
    max_log2_tr_range = 15
    transform_shift = max_log2_tr_range - bit_depth - ((log2_w + log2_h) >> 1)
    needs_sqrt2 = (not ts) and ((log2_w + log2_h) & 1) == 1
    i_transform_shift = transform_shift + (-1 if needs_sqrt2 else 0)
    if ts:
        qp = max(qp, 4 + 6 * internal_minus_input)
        dep_quant = False
        i_transform_shift = 0
    if dep_quant:
        qp_per = (qp + 1) // 6
        qp_rem = qp + 1 - 6 * qp_per
    else:
        qp_per, qp_rem = qp // 6, qp % 6
    right_shift = 6 + (1 if dep_quant else 0) - (i_transform_shift + qp_per)
    scale = int(rom.INV_QUANT_SCALES[1 if needs_sqrt2 else 0][qp_rem])
    if scale_mat is not None:
        right_shift += 4  # LOG2_SCALING_LIST_NEUTRAL_VALUE
        scale = scale_mat[: max_y + 1, : max_x + 1].astype(np.int64) * scale

    target_bd = min(max_log2_tr_range + 1, 64 + right_shift - 7)
    input_max = (1 << (target_bd - 1)) - 1
    tr_max = (1 << max_log2_tr_range) - 1

    out = np.zeros_like(levels, dtype=np.int64)
    region = levels[: max_y + 1, : max_x + 1].astype(np.int64)
    clipped = np.clip(region, -input_max - 1, input_max)
    if right_shift > 0:
        add = 1 << (right_shift - 1)
        deq = (clipped * scale + add) >> right_shift
    else:
        deq = (clipped * scale) << (-right_shift)
    out[: max_y + 1, : max_x + 1] = np.where(
        region != 0, np.clip(deq, -tr_max - 1, tr_max), 0)
    return out


def inverse_transform(coeff: np.ndarray, tr_hor: str, tr_ver: str,
                      bit_depth: int) -> np.ndarray:
    """Separable inverse transform; coeff int64 [h, w] -> residual int [h, w]."""
    h, w = coeff.shape
    max_log2_tr_range = 15
    clip_min, clip_max = -(1 << max_log2_tr_range), (1 << max_log2_tr_range) - 1

    if w > 1 and h > 1:
        s1 = 7  # TRANSFORM_MATRIX_SHIFT + 1
        s2 = (6 + max_log2_tr_range - 1) - bit_depth
        mv = tr_matrix(tr_ver, h).astype(np.int64)
        mh = tr_matrix(tr_hor, w).astype(np.int64)
        # pass 1 (vertical): tmp[x][y'] = sum_k coeff[k][x] * Mv[k][y']
        tmp = coeff.T @ mv  # [w, h]
        tmp = np.clip((tmp + (1 << (s1 - 1))) >> s1, clip_min, clip_max)
        # pass 2 (horizontal): block[y'][x'] = sum_k tmp[k][y'] * Mh[k][x']
        block = tmp.T @ mh  # [h, w]
        res = np.clip((block + (1 << (s2 - 1))) >> s2, clip_min, clip_max)
        return res
    # 1-D transforms
    s = (6 + max_log2_tr_range - 1) - bit_depth + 1
    if w == 1:
        m = tr_matrix(tr_ver, h).astype(np.int64)
        block = coeff.reshape(1, h) @ m  # [1, h] -> transposed layout
        res = np.clip((block + (1 << (s - 1))) >> s, clip_min, clip_max)
        return res.reshape(h, 1)
    m = tr_matrix(tr_hor, w).astype(np.int64)
    block = coeff.reshape(1, w) @ m
    res = np.clip((block + (1 << (s - 1))) >> s, clip_min, clip_max)
    return res.reshape(1, w)


def lfnst_params(cs: CodingStructure, tu: TransformUnit, cu: CodingUnit,
                 comp: int, final_mode_fn):
    """(kernel matrix [48|16, 16], transpose, sb, zero_out) for one TU
    component, or None when LFNST does not apply to it (the mode
    derivation of TrQuant::xInvLfnst, TrQuant.cpp:201)."""
    from refdec.ops.tables import LFNST_4x4, LFNST_8x8, LFNST_LUT

    if cu.lfnst_idx == 0 or tu.mts_idx[comp] == MTS_SKIP:
        return None
    sep_tree = cu.tree_type != 0
    if not sep_tree and comp != 0:
        return None
    x, y, w, h = tu.blocks[comp]
    ch = 0 if comp == 0 else 1
    if cu.mip_flag and ch == 0:
        intra_mode = PLANAR_IDX
    else:
        d = cu.intra_dir[ch]
        if LM_CHROMA_IDX <= d <= MDLM_T_IDX:
            intra_mode = co_located_luma_mode_of(cs, cu)
        else:
            intra_mode = final_mode_fn(cu, comp)
    # LFNST wide-angle remap (PU::getWideAngIntraMode, UnitTools.cpp:617):
    # differs from the prediction remap — the h>w branch subtracts VDIA+1
    # (67, yielding negative modes), and ISP uses the CU dims.
    ww, wh = (cu.w, cu.h) if (cu.isp_mode and comp == 0) else (w, h)
    wide = intra_mode
    if intra_mode >= 2:
        mode_shift = (0, 6, 10, 12, 14, 15)
        delta = abs((ww.bit_length() - 1) - (wh.bit_length() - 1))
        if ww > wh and intra_mode < 2 + mode_shift[delta]:
            wide = intra_mode + (VDIA_IDX - 1)
        elif wh > ww and intra_mode > VDIA_IDX - mode_shift[delta]:
            wide = intra_mode - (VDIA_IDX + 1)
    if wide < 0:
        lfnst_mode = wide + 14 + 67
    elif wide >= 67:
        lfnst_mode = wide + 14
    else:
        lfnst_mode = wide
    transpose = (lfnst_mode >= 81) or (67 > lfnst_mode > DIA_IDX)
    whge3 = w >= 8 and h >= 8
    sb = 8 if whge3 else 4
    zero_out = 8 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 16
    mat = (LFNST_8x8 if sb == 8 else LFNST_4x4)[int(LFNST_LUT[lfnst_mode])][cu.lfnst_idx - 1]
    return mat, transpose, sb, zero_out


def apply_inv_lfnst(cs: CodingStructure, deq: np.ndarray, tu: TransformUnit,
                    cu: CodingUnit, comp: int, final_mode_fn) -> np.ndarray:
    """Inverse LFNST on dequantized coefficients (parity: TrQuant::xInvLfnst
    TrQuant.cpp:201, invLfnstNxNCore :79)."""
    prm = lfnst_params(cs, tu, cu, comp, final_mode_fn)
    if prm is None:
        return deq
    mat, transpose, sb, zero_out = prm
    x, y, w, h = tu.blocks[comp]
    flat = deq.reshape(-1)
    scan = rom.scan_grouped(w, h)[:16]
    src = flat[scan].astype(np.int64)
    out = (mat[:, :zero_out].astype(np.int64) @ src[:zero_out] + 64) >> 7
    out = np.clip(out, -(1 << 15), (1 << 15) - 1)
    res = deq.copy()
    if not transpose:
        if sb == 4:
            res[:4, :4] = out.reshape(4, 4)
        else:
            res[:4, :8] = out[:32].reshape(4, 8)
            res[4:8, :4] = out[32:48].reshape(4, 4)
    else:
        if sb == 4:
            res[:4, :4] = out.reshape(4, 4).T
        else:
            res[:8, :4] = out[:32].reshape(4, 8).T
            res[:4, 4:8] = out[32:48].reshape(4, 4).T
    return res


ACT_QP_DELTA = (-5, 1, 3, 1)  # Y, Cb, Cr, joint-CbCr (CommonDef.h:397)


def tu_qp(cs: CodingStructure, tu: TransformUnit, cu: CodingUnit,
          comp: int) -> int:
    """Dequant QP for one TU component (QpParam, Quant.cpp:65): the
    stored TU QPs plus the ACT colour-space offset (deblocking keeps the
    unadjusted QPs, so the delta applies only here)."""
    qp = (tu.qp + cs.sps.qp_bd_offset) if comp == 0 \
        else tu.chroma_qp[comp - 1]
    if cu.color_transform:
        idx = 0 if comp == 0 else (3 if tu.joint_cbcr == 3 else comp)
        qp = max(0, min(63 + cs.sps.qp_bd_offset, qp + ACT_QP_DELTA[idx]))
    return qp


def ts_residual(cs: CodingStructure, tu: TransformUnit, cu: CodingUnit,
                comp: int) -> np.ndarray:
    """Transform-skip / BDPCM residual: (invResDPCM +) TS dequant.
    Parity: Quant.cpp invResDPCM :236 + DeQuantPCM/DeQuant."""
    x, y, w, h = tu.blocks[comp]
    levels = cs.coef[comp][y: y + h, x: x + w].astype(np.int64)
    bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma
    if bdpcm:
        acc = np.zeros_like(levels)
        lo, hi = -(1 << 15), (1 << 15) - 1
        if bdpcm == 1:  # horizontal: accumulate along rows
            acc[:, 0] = levels[:, 0]
            for xx in range(1, w):
                acc[:, xx] = np.clip(acc[:, xx - 1] + levels[:, xx], lo, hi)
        else:  # vertical
            acc[0, :] = levels[0, :]
            for yy in range(1, h):
                acc[yy, :] = np.clip(acc[yy - 1, :] + levels[yy, :], lo, hi)
        levels = acc
        max_x, max_y = w - 1, h - 1
    else:
        max_x, max_y = tu.max_scan_x[comp], tu.max_scan_y[comp]
    qp = tu_qp(cs, tu, cu, comp)
    return dequant_block(levels, qp, w.bit_length() - 1, h.bit_length() - 1,
                         cs.sps.bit_depth, bool(cs.sh_of(cu).dep_quant_used),
                         max_x, max_y, ts=True,
                         internal_minus_input=cs.sps.internal_minus_input_bit_depth)



def scaling_matrix_for(cs: CodingStructure, tu: TransformUnit,
                       cu: CodingUnit, comp: int) -> np.ndarray | None:
    """Explicit scaling-list dequant matrix for this TU component, or None.

    Gating parity: Quant::dequant (Quant.cpp:303-316) — disabled for
    transform skip, for LFNST blocks when the SPS says so, and for the
    (non-)designated colour space when ACT-disabling is signalled."""
    sl = cs.scaling_list
    if sl is None or tu.mts_idx[comp] == MTS_SKIP:
        return None
    sep_tree = cu.tree_type != TREE_D
    lfnst_applied = cu.lfnst_idx > 0 and (sep_tree or comp == 0)
    if lfnst_applied and cs.sps.scaling_matrix_for_lfnst_disabled:
        return None
    # disableSMForACT (Quant.cpp:306): scaling lists off when the TU's
    # colour space is the one the SPS disables them for
    if cs.sps.scaling_matrix_for_alt_cs_disabled \
            and cs.sps.scaling_matrix_designated_cs == bool(
                cu.color_transform):
        return None
    tables = getattr(cs, "_dq_tables", None)
    if tables is None:
        from refdec.hls.scaling_list import build_dequant_tables
        tables = cs._dq_tables = build_dequant_tables(sl)
    lt = (0 if cu.pred_mode == MODE_INTRA else 3) + comp
    _, _, w, h = tu.blocks[comp]
    return tables.get((lt, w.bit_length() - 1, h.bit_length() - 1))


_ITX_NC = None
_ITX_MAT: dict = {}


def _native_itx(cs, tu, cu, comp, x, y, w, h, qp, dep_quant, bd, scale_mat):
    """Per-TU dequant + ITX via native/walk7.c, or None for fallback."""
    global _ITX_NC
    if _ITX_NC is None:
        from refdec.native import native_cabac
        nc = native_cabac()
        _ITX_NC = nc if (nc is not None and hasattr(nc, "itx_block")) \
            else False
    if _ITX_NC is False:
        return None
    plane = cs.coef[comp]
    if plane.dtype != np.int32 or not plane.flags["C_CONTIGUOUS"]:
        return None
    hor, ver = get_tr_types(cs, tu, cu, comp)
    kh = (hor, w)
    kv = (ver, h)
    mh = _ITX_MAT.get(kh)
    if mh is None:
        mh = _ITX_MAT[kh] = np.ascontiguousarray(
            tr_matrix(hor, w), dtype=np.int32).tobytes()
    mv = _ITX_MAT.get(kv)
    if mv is None:
        mv = _ITX_MAT[kv] = np.ascontiguousarray(
            tr_matrix(ver, h), dtype=np.int32).tobytes()
    if scale_mat is not None:
        sm = np.ascontiguousarray(scale_mat, dtype=np.int32).tobytes()
    else:
        sm = b""
    out = np.empty((h, w), dtype=np.int64)
    _ITX_NC.itx_block(plane, plane.shape[1], x, y, w, h, qp,
                      int(dep_quant), tu.max_scan_x[comp],
                      tu.max_scan_y[comp], bd, mh, mv, sm, out)
    return out


def mip_size_id(w: int, h: int) -> int:
    """Parity: getMipSizeId (UnitTools.cpp:3748)."""
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def num_mip_modes(w: int, h: int) -> int:
    return (16, 8, 6)[mip_size_id(w, h)]


def co_located_luma_mode_of(cs: CodingStructure, cu: CodingUnit) -> int:
    if cu.tree_type == 2 or not cu.has_luma:
        lx = (cu.cx + (cu.cw >> 1)) * cs.sub_w
        ly = (cu.cy + (cu.ch >> 1)) * cs.sub_h
        luma_cu = cs.cu_at(lx, ly, 0)
        if luma_cu is None:
            return PLANAR_IDX
        return PLANAR_IDX if luma_cu.mip_flag else luma_cu.intra_dir[0]
    return PLANAR_IDX if cu.mip_flag else cu.intra_dir[0]


def get_tr_types(cs: CodingStructure, tu: TransformUnit, cu: CodingUnit,
                 comp: int) -> tuple[str, str]:
    """Parity: TrQuant::getTrTypes (TrQuant.cpp:330)."""
    sps = cs.sps
    if not sps.mts_enabled:
        return "DCT2", "DCT2"
    is_implicit = (cu.pred_mode == MODE_INTRA and comp == 0
                   and sps.mts_enabled and not sps.explicit_mts_intra
                   and cu.lfnst_idx == 0 and not cu.mip_flag)
    if cu.isp_mode and comp == 0 and cu.lfnst_idx:
        return "DCT2", "DCT2"
    if is_implicit or (cu.isp_mode and comp == 0):
        _, _, tw, th = tu.blocks[comp]
        hor = "DST7" if 4 <= tw <= 16 else "DCT2"
        ver = "DST7" if 4 <= th <= 16 else "DCT2"
        return hor, ver
    if cu.sbt_info and comp == 0:
        # implicit SBT transforms (TrQuant::getTrTypes SBT branch)
        sbt_idx = cu.sbt_info & 0xF
        pos = (cu.sbt_info >> 4) & 3
        _, _, tw, th = tu.blocks[0]
        if sbt_idx in (1, 3):  # vertical split
            if th > 32:
                return "DCT2", "DCT2"
            return ("DCT8", "DST7") if pos == 0 else ("DST7", "DST7")
        if tw > 32:
            return "DCT2", "DCT2"
        return ("DST7", "DCT8") if pos == 0 else ("DST7", "DST7")
    mts = tu.mts_idx[0] if comp == 0 else 0
    if comp != 0 or mts <= 1:
        return "DCT2", "DCT2"
    # explicit MTS: 2=DST7/DST7, 3=DCT8/DST7, 4=DST7/DCT8, 5=DCT8/DCT8
    hor = "DST7" if mts in (2, 4) else "DCT8"
    ver = "DST7" if mts in (2, 3) else "DCT8"
    return hor, ver


# ======================================================================
# intra prediction
# ======================================================================
def wide_angle(width: int, height: int, mode: int) -> int:
    if DC_IDX < mode <= VDIA_IDX:
        mode_shift = (0, 6, 10, 12, 14, 15)
        delta = abs((width.bit_length() - 1) - (height.bit_length() - 1))
        if width > height and mode < 2 + mode_shift[delta]:
            mode += VDIA_IDX - 1
        elif height > width and mode > VDIA_IDX - mode_shift[delta]:
            mode -= VDIA_IDX - 1
    return mode


def sample_available(cs, tu_order_map, wpp: bool, ctu_log2: int, px: int,
                     py: int, comp: int, cu, tu_order: int) -> bool:
    """Is the reference sample at (px, py) in comp coords available?
    Parity: getCURestricted; shared by the host golden and the device
    descriptor builder (ops/intra_device.py)."""
    if px < 0 or py < 0:
        return False
    sx = cs.sub_w if comp else 1
    sy = cs.sub_h if comp else 1
    w_comp, h_comp = cs.comp_size[comp]
    if px >= w_comp or py >= h_comp:
        return False
    # CTU-grid availability rule (getCURestricted)
    shx = ctu_log2 - (sx - 1)
    shy = ctu_log2 - (sy - 1)
    cux, cuy = (cu.cx, cu.cy) if comp else (cu.x, cu.y)
    xdiff = (px >> shx) - (cux >> shx)
    ydiff = (py >> shy) - (cuy >> shy)
    if ydiff > 0 or (ydiff == 0 and xdiff > 0):
        return False
    if xdiff > (0 if wpp else 1):
        return False
    # neighbor CU in the channel's own map (getCURestricted is queried
    # with the prediction's chType; essential for dual-tree chroma where
    # the luma tree's CUs have unrelated decode order)
    lx, ly = px * sx, py * sy
    cu2 = cs.cu_at(px, py, 1) if comp else cs.cu_at(lx, ly, 0)
    if cu2 is None:
        return False
    if cu2.slice_idx != cu.slice_idx or cu2.tile_idx != cu.tile_idx:
        return False
    if cu2.idx > cu.idx:
        return False
    if cu2.idx == cu.idx:
        order = int(tu_order_map[ly >> 2, lx >> 2])
        if order < 0 or order >= tu_order:
            return False
    return True


class IntraReconstructor:
    """Whole-frame intra reconstruction in parse order (numpy golden)."""

    def __init__(self, cs: CodingStructure, residual_planes=None,
                 census=None):
        self.cs = cs
        # optional precomputed residual planes (device ITX stage output)
        self.residual_planes = residual_planes
        # optional fallback census (StreamDecoder.fallback_census): counts
        # TUs/CUs that fell back from the C engines to the Python golden
        self.census = census
        self.bit_depth = cs.sps.bit_depth
        self.pel_max = (1 << self.bit_depth) - 1
        # np.empty: every sample is written by exactly one CU's
        # reconstruction before any read (decode order + availability),
        # and error paths grey-fill explicitly — zeroing costs ~0.5 ms
        # per 832x480 frame for nothing
        self.reco = [np.empty((h, w), dtype=np.int32) for (w, h) in cs.comp_size]
        self.wpp = cs.sps.entropy_coding_sync_enabled
        # per-4x4 luma map of TU parse order (for intra availability)
        self.tu_order_map = np.full((cs.h >> 2, cs.w >> 2), -1, dtype=np.int32)
        self.ctu_log2 = cs.sps.ctu_log2
        # per-CU ISP state: base reference arrays + prediction-region cache
        self._isp_cache: dict[int, dict] = {}
        # inter state: reference planes per list (set by the decoder for
        # P/B slices) and per-CU prediction cache
        self._inter_pred: dict[int, list] = {}
        self._seen_cu = -1
        self._hist = None
        # LMCS reshaper model (Reshape::initSlice, Reshape.cpp:118)
        self.reshaper = None
        if cs.ph.lmcs_enabled \
                and getattr(cs, "lmcs_info", None) is not None:
            from refdec.frame.lmcs_np import Reshaper
            self.reshaper = Reshaper(cs.lmcs_info, self.bit_depth,
                                     cs.ph.chroma_residual_scale)
        # forward-map inter predictions only outside I slices (getCTUFlag);
        # per-slice gating happens at the use sites (multi-slice pictures)
        self.lmcs_fwd = self.reshaper is not None

    # ---------------- availability ----------------
    def _avail(self, px: int, py: int, comp: int, cu: CodingUnit,
               tu_order: int) -> bool:
        """Is the reference sample at (px, py) in comp coords available?"""
        return sample_available(self.cs, self.tu_order_map, self.wpp,
                                self.ctu_log2, px, py, comp, cu, tu_order)

    # ---------------- reference sample fill ----------------
    def fill_reference(self, tu: TransformUnit, cu: CodingUnit, comp: int,
                       mrl: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Returns (top_ref[2w+1+mrl], left_ref[2h+1+mrl]); index 0 is the
        corner sample at (x-1-mrl, y-1-mrl).  Parity: xFillReferenceSamples."""
        cs = self.cs
        x, y, w, h = tu.blocks[comp]
        reco = self.reco[comp]
        pred_size = 2 * w
        pred_h = 2 * h
        sx = cs.sub_w if comp else 1
        sy = cs.sub_h if comp else 1
        unit_w = 4 // sx
        unit_h = 4 // sy
        tu_order = tu.order

        top = np.zeros(pred_size + 1 + mrl, dtype=np.int32)
        left = np.zeros(pred_h + 1 + mrl, dtype=np.int32)

        total_above_units = (pred_size + unit_w - 1) // unit_w
        total_left_units = (pred_h + unit_h - 1) // unit_h
        num_above_units = w // unit_w
        num_left_units = h // unit_h
        total_units = total_above_units + total_left_units + 1

        # contiguous availability counts
        n_topleft = 1 if self._avail(x - 1, y - 1, comp, cu, tu_order) else 0
        n_above = 0
        for u in range(total_above_units):
            if self._avail(x + u * unit_w, y - 1, comp, cu, tu_order):
                n_above += 1
            else:
                break
        n_left = 0
        for u in range(total_left_units):
            if self._avail(x - 1, y + u * unit_h, comp, cu, tu_order):
                n_left += 1
            else:
                break
        num_avail = n_topleft + n_above + n_left

        dc_val = 1 << (self.bit_depth - 1)
        if num_avail == 0:
            top[:] = dc_val
            left[:] = dc_val
            return top, left
        if num_avail == total_units:
            # top row from line y-1-mrl starting at x-1-mrl
            n = min(pred_size + 1 + mrl, reco.shape[1] - (x - 1 - mrl))
            top[:n] = reco[y - 1 - mrl, x - 1 - mrl: x - 1 - mrl + n]
            if n < len(top):  # clip at picture edge: replicate
                top[n:] = top[n - 1]
            n = min(pred_h + mrl, reco.shape[0] - (y - mrl))
            left[0] = top[0]
            left[1: 1 + n] = reco[y - mrl: y - mrl + n, x - 1 - mrl]
            if 1 + n < len(left):
                left[1 + n:] = left[n]
            return top, left

        # partial availability (vvdec scheme, xFillReferenceSamples :1161)
        if n_left > 0:
            # left column: rows y.. from column x-1-mrl
            n = min(n_left * unit_h, pred_h)
            n = min(n, reco.shape[0] - y)
            left[1 + mrl: 1 + mrl + n] = reco[y: y + n, x - 1 - mrl]
            left[1 + mrl + n:] = left[mrl + n]
            if n_topleft:
                # corner sample(s) from the reference line(s)
                top[0: mrl + 1] = reco[y - 1 - mrl, x - 1 - mrl: x - 1 - mrl + mrl + 1]
                for i in range(1, mrl + 1):
                    left[i] = reco[y - 1 - mrl + i, x - 1 - mrl]
                left[0] = top[0]
            else:
                corner = reco[y, x - 1 - mrl]
                top[0: mrl + 1] = corner
                left[0: mrl + 1] = corner
            if n_above > 0:
                n = min(n_above * unit_w, pred_size)
                n = min(n, reco.shape[1] - x)
                top[1 + mrl: 1 + mrl + n] = reco[y - 1 - mrl, x: x + n]
                top[1 + mrl + n:] = top[mrl + n]
            else:
                top[1 + mrl:] = top[mrl]
        else:
            # left unavailable -> top must be available
            n = min(n_above * unit_w, pred_size)
            n = min(n, reco.shape[1] - x)
            top[1 + mrl: 1 + mrl + n] = reco[y - 1 - mrl, x: x + n]
            top[1 + mrl + n:] = top[mrl + n]
            corner = reco[y - 1 - mrl, x]
            top[0: mrl + 1] = corner
            left[:] = corner
        return top, left

    @staticmethod
    def filter_reference(top: np.ndarray, left: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """[1 2 1] reference smoothing (xFilterReferenceSamples)."""
        ft = top.copy()
        fl = left.copy()
        # interior of left column (bottom-left sample unfiltered)
        if len(left) > 2:
            fl[1:-1] = (left[:-2] + 2 * left[1:-1] + left[2:] + 2) >> 2
        # corner: left[1], corner, top[1]
        c = (left[1] + 2 * top[0] + top[1] + 2) >> 2
        ft[0] = c
        fl[0] = c
        if len(top) > 2:
            ft[1:-1] = (top[:-2] + 2 * top[1:-1] + top[2:] + 2) >> 2
        return ft, fl

    # ---------------- predictors ----------------
    def pred_planar(self, top: np.ndarray, left: np.ndarray, w: int, h: int
                    ) -> np.ndarray:
        log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
        top_row = top[1: w + 2].astype(np.int64)  # w+1 entries
        left_col = left[1: h + 2].astype(np.int64)
        bottom_left = left_col[h]
        top_right = top_row[w]
        xs = np.arange(1, w + 1, dtype=np.int64)
        ys = np.arange(1, h + 1, dtype=np.int64)
        hor = (left_col[:h, None] << log2w) + xs[None, :] * (top_right - left_col[:h, None])
        ver = (top_row[None, :w] << log2h) + ys[:, None] * (bottom_left - top_row[None, :w])
        offset = 1 << (log2w + log2h)
        return ((hor << log2h) + (ver << log2w) + offset) >> (1 + log2w + log2h)

    def pred_dc(self, top: np.ndarray, left: np.ndarray, w: int, h: int,
                mrl: int = 0) -> np.ndarray:
        s = 0
        denom = (w << 1) if w == h else max(w, h)
        if w >= h:
            s += int(np.sum(top[mrl + 1: mrl + 1 + w]))
        if w <= h:
            s += int(np.sum(left[mrl + 1: mrl + 1 + h]))
        dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
        return np.full((h, w), dc, dtype=np.int64)

    def pred_angular(self, top: np.ndarray, left: np.ndarray, w: int, h: int,
                     mode: int, comp: int, filtered_used: bool,
                     mrl: int = 0, use_isp: bool = False,
                     cu_size: tuple[int, int] | None = None,
                     top_len: int | None = None,
                     left_len: int | None = None) -> np.ndarray:
        """Parity: xPredIntraAng.  For ISP: wide-angle mapping uses the CU
        dims, the 4-tap filter is always cubic, and the main reference length
        is the (shorter) ISP length instead of 2*size."""
        if use_isp and cu_size is not None:
            pred_mode = wide_angle(cu_size[0], cu_size[1], mode)
        else:
            pred_mode = wide_angle(w, h, mode)
        if top_len is None:
            top_len = 2 * w
        if left_len is None:
            left_len = 2 * h
        is_ver = pred_mode >= DIA_IDX
        ang_mode = (pred_mode - VER_IDX) if is_ver else -(pred_mode - HOR_IDX)
        abs_ang = int(ANG_TABLE[abs(ang_mode)])
        inv_angle = int(INV_ANG_TABLE[abs(ang_mode)])
        angle = (1 if ang_mode >= 0 else -1) * abs_ang

        # main/side reference arrays
        if not is_ver:
            w, h = h, w
            main_src, side_src = left, top
        else:
            main_src, side_src = top, left

        if angle < 0:
            size_side = h
            ref_main = np.zeros(size_side + 2 * w + 3 + mrl, dtype=np.int64)
            off = size_side  # index of sample 0 (pre-mrl shift)
            n = min(w + 2 + mrl, len(main_src))
            ref_main[off: off + n] = main_src[:n]
            ks = np.arange(-size_side, 0, dtype=np.int64)
            sidx = np.minimum((-ks * inv_angle + 256) >> 9, size_side)
            ref_main[off - size_side: off] = side_src[sidx]
        else:
            log2_ratio = (w.bit_length() - 1) - (h.bit_length() - 1)
            s_ext = max(0, log2_ratio)
            max_index = (mrl << s_ext) + 2
            ref_len = top_len if is_ver else left_len
            ref_main = np.zeros(ref_len + 1 + mrl + max_index + 1,
                                dtype=np.int64)
            off = 0
            n = min(ref_len + 1 + mrl, len(main_src))
            ref_main[:n] = main_src[:n]
            # extend right by replication of refMain[refLength + mrl]
            val = ref_main[ref_len + mrl]
            ref_main[ref_len + mrl + 1: ref_len + mrl + 1 + max_index] = val
        # compensate for the reference line offset (refMain += mrl)
        off += mrl

        dst = np.zeros((h, w), dtype=np.int64)
        if angle == 0:
            dst[:, :] = ref_main[off + 1: off + 1 + w][None, :]
            # PDPC for pure hor/ver (xPredIntraAng angle==0 branch)
            if self._pdpc_enabled(w, h) and mrl == 0:
                scale = ((w.bit_length() - 3) + (h.bit_length() - 3) + 2) >> 2
                lev = (min(3, w), min(6, w), min(12, w), min(24, w))[scale]
                corner = int(side_src[0])
                for yy in range(h):
                    left_v = int(side_src[yy + 1])
                    for xx in range(lev):
                        wl = 32 >> min(31, (xx << 1) >> scale)
                        v = (wl * (left_v - corner)
                             + int(ref_main[off + xx + 1]) * 64 + 32) >> 6
                        dst[yy, xx] = min(max(v, 0), self.pel_max)
        else:
            positions = np.arange(w, dtype=np.int64)
            frac_needed = (abs_ang & 0x1F) != 0
            if frac_needed:
                if comp == 0:
                    # 4-tap filter selection
                    diff = min(abs(pred_mode - HOR_IDX), abs(pred_mode - VER_IDX))
                    log2_size = ((w.bit_length() - 1) + (h.bit_length() - 1)) >> 1
                    filter_flag = diff > INTRA_FILTER_THRESH[0][log2_size]
                    interpolation = filter_flag  # isRefFilter false when frac != 0
                    use_cubic = True if use_isp else \
                        ((not interpolation) or mrl > 0)
                    f = CHROMA_FILTER if use_cubic else GAUSS_FILTER
                    deltas = angle * (np.arange(h, dtype=np.int64) + 1 + mrl)
                    di = deltas >> 5
                    frac = deltas & 31
                    co = np.asarray(f, dtype=np.int64)[frac]  # [h, 4]
                    idx = (off + di + 1)[:, None] \
                        + np.arange(w, dtype=np.int64)[None, :]
                    val = (co[:, 0:1] * ref_main[idx - 1]
                           + co[:, 1:2] * ref_main[idx]
                           + co[:, 2:3] * ref_main[idx + 1]
                           + co[:, 3:4] * ref_main[idx + 2] + 32) >> 6
                    if use_cubic:
                        val = np.clip(val, 0, self.pel_max)
                    dst[:, :] = val
                else:
                    deltas = angle * (np.arange(h, dtype=np.int64) + 1 + mrl)
                    di = deltas >> 5
                    frac = (deltas & 31)[:, None]
                    idx = (off + di + 1)[:, None] \
                        + np.arange(w, dtype=np.int64)[None, :]
                    dst[:, :] = ((32 - frac) * ref_main[idx]
                                 + frac * ref_main[idx + 1] + 16) >> 5
            else:
                deltas = angle * (np.arange(h, dtype=np.int64) + 1 + mrl)
                idx = (off + (deltas >> 5) + 1)[:, None] \
                    + np.arange(w, dtype=np.int64)[None, :]
                dst[:, :] = ref_main[idx]

            # PDPC for positive angles.  Reference uses pDst.height (ver) or
            # pDst.width (hor) of the *unswapped* block — both equal local h.
            if self._pdpc_enabled(w, h) and mrl == 0 and angle > 0:
                side_size = h
                max_scale = 2
                angular_scale = min(max_scale, (side_size.bit_length() - 1)
                                    - ((3 * inv_angle - 2).bit_length() - 1 - 8))
                if angular_scale >= 0:
                    nx = min(3 << angular_scale, w)
                    xs = np.arange(nx, dtype=np.int64)
                    inv_sums = 256 + inv_angle * (xs + 1)
                    wl = 32 >> np.minimum(31, (2 * xs) >> angular_scale)
                    ys = np.arange(h, dtype=np.int64)
                    sidx = np.minimum(ys[:, None] + (inv_sums >> 9)[None, :]
                                      + 1, len(side_src) - 1)
                    lv = side_src[sidx].astype(np.int64)
                    sub = dst[:, :nx]
                    dst[:, :nx] = sub + ((wl[None, :] * (lv - sub) + 32) >> 6)

        if not is_ver:
            dst = dst.T
        return dst

    def _pdpc_enabled(self, w: int, h: int) -> bool:
        return w >= 4 and h >= 4

    def pdpc_dc_planar(self, pred: np.ndarray, top: np.ndarray,
                       left: np.ndarray) -> np.ndarray:
        h, w = pred.shape
        scale = ((w.bit_length() - 3) + (h.bit_length() - 3) + 2) >> 2
        ys = np.arange(h, dtype=np.int64)
        xs = np.arange(w, dtype=np.int64)
        wt = (32 >> np.minimum(31, (ys << 1) >> scale))[:, None]
        wl = (32 >> np.minimum(31, (xs << 1) >> scale))[None, :]
        lv = left[1: h + 1].astype(np.int64)[:, None]
        tv = top[1: w + 1].astype(np.int64)[None, :]
        v = pred.astype(np.int64)
        return v + ((wl * (lv - v) + wt * (tv - v) + 32) >> 6)



    def pred_mip(self, tu: TransformUnit, cu: CodingUnit, comp: int
                 ) -> np.ndarray:
        """Matrix intra prediction.  Parity: Mip::PredictorMIP
        (MatrixIntraPrediction.cpp:60): Haar boundary downsample, rebased
        affine matrix product, linear upsampling."""
        from refdec.ops.tables import MIP_4x4, MIP_8x8, MIP_16x16

        x, y, w, h = tu.blocks[comp]
        top, left = self.fill_reference(tu, cu, comp)
        ref_top = top[1: 1 + w].astype(np.int64)
        ref_left = left[1: 1 + h].astype(np.int64)
        size_id = mip_size_id(w, h)
        bdry = 2 if size_id == 0 else 4
        red = 4 if size_id < 2 else 8
        up_h, up_v = w // red, h // red
        bd = self.bit_depth

        def down(srcv: np.ndarray, n: int) -> np.ndarray:
            if n < len(srcv):
                f = len(srcv) // n
                lg = f.bit_length() - 1
                return (srcv.reshape(n, f).sum(axis=1) + (1 << (lg - 1))) >> lg
            return srcv[:n].copy()

        t_red = down(ref_top, bdry)
        l_red = down(ref_left, bdry)
        bound = np.concatenate([t_red, l_red])
        bound_t = np.concatenate([l_red, t_red])
        inp = (bound_t if cu.mip_transpose else bound).copy()
        in_off = int(inp[0])
        inp[0] = ((1 << (bd - 1)) - in_off) if size_id < 2 else 0
        inp[1:] -= in_off
        input_size = 2 * bdry

        mat = (MIP_4x4, MIP_8x8, MIP_16x16)[size_id][cu.intra_dir[0]]
        red_size = 1 if size_id == 2 else 0
        offset = (1 << 5) - 32 * int(inp.sum())
        out = np.zeros(red * red, dtype=np.int64)
        for pos in range(red * red):
            wrow = mat[pos]
            acc = 0 if red_size else int(inp[0]) * int(wrow[0])
            for i in range(1, input_size):
                acc += int(inp[i]) * int(wrow[i - red_size])
            out[pos] = ((acc + offset) >> 6) + in_off
        out = np.clip(out, 0, self.pel_max)
        pred = out.reshape(red, red)
        if cu.mip_transpose:
            pred = pred.T.copy()

        if up_h == 1 and up_v == 1:
            return pred
        # horizontal upsampling (rows land at y = (k+1)*up_v - 1)
        if up_h > 1:
            lg = up_h.bit_length() - 1
            ro = 1 << (lg - 1)
            hor = np.zeros((red, w), dtype=np.int64)
            for k in range(red):
                prev = int(ref_left[(k + 1) * up_v - 1])
                pos = 0
                for j in range(red):
                    behind = int(pred[k, j])
                    diff = behind - prev
                    scaled = prev * up_h + ro
                    for _ in range(up_h):
                        scaled += diff
                        hor[k, pos] = scaled >> lg
                        pos += 1
                    prev = behind
            ver_src = hor
        else:
            ver_src = pred
        if up_v == 1:
            return ver_src
        lg = up_v.bit_length() - 1
        ro = 1 << (lg - 1)
        res = np.zeros((h, w), dtype=np.int64)
        for c in range(w):
            prev = int(ref_top[c])
            for j in range(red):
                behind = int(ver_src[j, c])
                diff = behind - prev
                scaled = prev * up_v + ro
                for i in range(up_v):
                    scaled += diff
                    res[j * up_v + i, c] = scaled >> lg
                prev = behind
        return res

    # ---------------- ISP (intra sub-partitions) ----------------
    def _isp_base(self, cu: CodingUnit) -> dict:
        """Whole-CU reference fill shared by all ISP subpartitions.
        Parity: initIntraPatternChTypeISP first-partition path
        (IntraPrediction.cpp:963)."""
        cache = self._isp_cache.get(cu.idx)
        if cache is None:
            first = cu.tus[0]
            base = TransformUnit()
            base.blocks[0] = (cu.x, cu.y, cu.w, cu.h)
            base.order = first.order
            bt, bl = self.fill_reference(base, cu, 0)
            above = self._avail(cu.x, cu.y - 1, 0, cu, first.order)
            left = self._avail(cu.x - 1, cu.y, 0, cu, first.order)
            cache = dict(top=bt, left=bl, above=above, left_avail=left,
                         regions={})
            self._isp_cache[cu.idx] = cache
        return cache

    def _isp_refs(self, cu: CodingUnit, px: int, py: int, pw: int, ph: int
                  ) -> tuple[np.ndarray, np.ndarray, int, int]:
        """References for one ISP prediction block at (px, py, pw, ph).
        Returns (top, left, top_len, left_len); index 0 is the corner.
        Parity: initIntraPatternChTypeISP subsequent-partition path."""
        cache = self._isp_base(cu)
        horiz = cu.isp_mode == HOR_INTRA_SUBPARTITIONS
        reco = self.reco[0]
        top_len = cu.w + pw
        left_len = cu.h + ph
        if px == cu.x and py == cu.y:
            return cache["top"], cache["left"], top_len, left_len
        if horiz:
            ty = py - cu.y
            top = np.zeros(top_len + 1, dtype=np.int32)
            row = reco[py - 1, px: px + pw]
            top[1: 1 + pw] = row
            top[1 + pw:] = row[-1]
            top[0] = cache["left"][ty]
            left = np.zeros(left_len + 1, dtype=np.int32)
            n = min(left_len, len(cache["left"]) - 1 - ty)
            left[1: 1 + n] = cache["left"][ty + 1: ty + 1 + n]
            if 1 + n < len(left):
                left[1 + n:] = left[n]
            left[0] = top[0]
            if not cache["left_avail"]:
                s = int(reco[py - 1, px])
                left[:] = s
                top[0] = s
            return top, left, top_len, left_len
        tx = px - cu.x
        left = np.zeros(left_len + 1, dtype=np.int32)
        col = reco[py: py + ph, px - 1]
        left[1: 1 + ph] = col
        left[1 + ph:] = col[-1]
        left[0] = cache["top"][tx]
        top = np.zeros(top_len + 1, dtype=np.int32)
        n = min(top_len, len(cache["top"]) - 1 - tx)
        top[1: 1 + n] = cache["top"][tx + 1: tx + 1 + n]
        if 1 + n < len(top):
            top[1 + n:] = top[n]
        top[0] = left[0]
        if not cache["above"]:
            s = int(reco[py, px - 1])
            top[:] = s
            left[0] = s
        return top, left, top_len, left_len

    def _isp_pred_block(self, cu: CodingUnit, top: np.ndarray,
                        left: np.ndarray, w: int, h: int,
                        top_len: int, left_len: int) -> np.ndarray:
        mode = cu.intra_dir[0]
        if mode == PLANAR_IDX:
            pred = self.pred_planar(top, left, w, h)
        elif mode == DC_IDX:
            pred = self.pred_dc(top, left, w, h)
        else:
            return self.pred_angular(top, left, w, h, mode, 0, False,
                                     use_isp=True, cu_size=(cu.w, cu.h),
                                     top_len=top_len, left_len=left_len)
        if self._pdpc_enabled(w, h):
            pred = self.pdpc_dc_planar(pred, top, left)
        return pred

    def _predict_isp(self, tu: TransformUnit, cu: CodingUnit) -> np.ndarray:
        """Luma prediction for one ISP subpartition.  Narrow vertical
        partitions predict on a shared 4-wide region (CU::isPredRegDiffFromTB,
        UnitTools.cpp:3404; DecCu.cpp:333)."""
        x, y, w, h = tu.blocks[0]
        horiz = cu.isp_mode == HOR_INTRA_SUBPARTITIONS
        pred_reg = (not horiz) and ((cu.w == 8 and cu.h > 4) or cu.w == 4)
        if pred_reg and w < 4:
            regions = self._isp_base(cu)["regions"]
            rx = cu.x + ((x - cu.x) >> 2 << 2)
            if rx not in regions:
                top, left, tl, ll = self._isp_refs(cu, rx, y, 4, h)
                regions[rx] = self._isp_pred_block(cu, top, left, 4, h,
                                                   tl, ll)
            return regions[rx][:, x - rx: x - rx + w]
        top, left, tl, ll = self._isp_refs(cu, x, y, w, h)
        return self._isp_pred_block(cu, top, left, w, h, tl, ll)

    # ---------------- per-TU prediction + reconstruction ----------------
    def final_mode(self, cu: CodingUnit, comp: int) -> int:
        if comp == 0:
            return cu.intra_dir[0]
        mode = cu.intra_dir[1]
        if mode == DM_CHROMA_IDX:
            # co-located luma mode at chroma block center
            lx = (cu.cx + (cu.cw >> 1)) * self.cs.sub_w
            ly = (cu.cy + (cu.ch >> 1)) * self.cs.sub_h
            if cu.tree_type == 2 or not cu.has_luma:  # TREE_C
                luma_cu = self.cs.cu_at(lx, ly, 0)
            else:
                luma_cu = cu
            mode = PLANAR_IDX if (luma_cu is None or luma_cu.mip_flag) \
                else luma_cu.intra_dir[0]
        # 4:2:2 maps directional/planar/DC chroma modes (getFinalIntraMode,
        # UnitTools.cpp:595)
        if self.cs.sps.chroma_format_idc == 2 and mode < 67:
            mode = CHROMA422_MAP[mode]
        return mode

    def use_filtered_refs(self, cu: CodingUnit, comp: int, w: int, h: int) -> bool:
        """Parity: useFilteredIntraRefSamples (IntraPrediction.cpp:1299)."""
        if comp != 0:
            return False
        if cu.multi_ref_idx or cu.bdpcm_mode or cu.isp_mode or cu.mip_flag:
            return False
        mode = self.final_mode(cu, comp)
        if mode == DC_IDX:
            return False
        if mode == PLANAR_IDX:
            return w * h > 32
        pred_mode = wide_angle(w, h, mode)
        diff = min(abs(pred_mode - HOR_IDX), abs(pred_mode - VER_IDX))
        log2_size = ((w.bit_length() - 1) + (h.bit_length() - 1)) >> 1
        ang_mode = (pred_mode - VER_IDX) if pred_mode >= DIA_IDX else -(pred_mode - HOR_IDX)
        abs_ang = int(ANG_TABLE[abs(ang_mode)])
        return diff > INTRA_FILTER_THRESH[0][log2_size] and (abs_ang & 0x1F) == 0

    # ---------------- CCLM ----------------
    def pred_cclm(self, tu: TransformUnit, cu: CodingUnit, comp: int,
                  mode: int) -> np.ndarray:
        """Cross-component linear model chroma prediction (420).
        Parity: xGetLumaRecPixels :1400, xGetLMParameters :1691,
        predIntraChromaLM :516."""
        cs = self.cs
        cx, cy, cw, chh = tu.blocks[comp]
        luma = self.reco[0]
        collocated = cs.sps.chroma_ver_collocated
        ctu_c = cs.sps.ctu_size // cs.sub_h

        unit = 2  # chroma unit size (4 >> scale)
        tu_w_units = cw // unit
        tu_h_units = chh // unit

        # CU-level neighbor availability (cu.above / cu.left analogs).
        # The luma downsample edge handling uses these CU-level flags
        # (xGetLumaRecPixels bAbove/bLeftAvaillable), while the LM parameter
        # sampling uses the per-mode template availability below.
        cu_above = self._avail(cu.cx, cu.cy - 1, comp, cu, tu.order)
        cu_left = self._avail(cu.cx - 1, cu.cy, comp, cu, tu.order)
        above_flag = cu_above or cy > cu.cy
        left_flag = cu_left or cx > cu.cx
        build_above = bool(above_flag)
        build_left = bool(left_flag)

        above_avail = left_avail = False
        actual_top = actual_left = 0
        if mode == MDLM_T_IDX:
            avai_above = 0
            if above_flag:
                avai_above = tu_w_units
                ar_units = min((2 * cw) // unit - tu_w_units, chh // unit)
                for u in range(ar_units):
                    if self._avail(cx + cw + u * unit, cy - 1, comp, cu, tu.order):
                        avai_above += 1
                    else:
                        break
            above_avail = avai_above >= tu_w_units
            actual_top = unit * avai_above
        elif mode == MDLM_L_IDX:
            avai_left = 0
            if left_flag:
                avai_left = tu_h_units
                lb_units = min((2 * chh) // unit - tu_h_units, cw // unit)
                for u in range(lb_units):
                    if self._avail(cx - 1, cy + chh + u * unit, comp, cu, tu.order):
                        avai_left += 1
                    else:
                        break
            left_avail = avai_left >= tu_h_units
            actual_left = unit * avai_left
        else:  # LM_CHROMA
            above_avail = bool(above_flag)
            left_avail = bool(left_flag)
            actual_top = cw if above_avail else 0
            actual_left = chh if left_avail else 0

        lx, ly = cx * cs.sub_w, cy * cs.sub_h
        first_row_of_ctu = (ly & (cs.sps.ctu_size - 1)) == 0
        # per-format downsampling taps (xGetLumaRecPixels,
        # IntraPrediction.cpp format switch): 3-tap (first CTU row),
        # 5-tap (collocated), 6-tap (default)
        mult = cs.sub_w
        rec2 = cs.sub_h              # luma rows per chroma row
        stro = 0 if cs.sub_w == 1 else 1  # vertical tap row offset (0: 444)
        lh, lw = luma.shape

        def lum(r: int, c: int) -> int:
            # zero-coefficient taps may index one past the picture edge
            # (the reference reads its margin there); clamp — harmless
            # since those taps are only live in-bounds
            return int(luma[min(r, lh - 1), min(c, lw - 1)])
        if cs.sps.chroma_format_idc == 2:    # 4:2:2
            t3 = (2, 1, 1, 2, 2)
            t5 = (0, 2, 1, 1, 0, 2, 2)
            t6 = (2, 1, 1, 0, 0, 0, 2, 2)
        elif cs.sps.chroma_format_idc == 3:  # 4:4:4
            t3 = (1, 0, 0, 0, 0)
            t5 = (0, 1, 0, 0, 0, 0, 0)
            t6 = (1, 0, 0, 0, 0, 0, 0, 0)
        else:                                # 4:2:0
            t3 = (2, 1, 1, 2, 2)
            t5 = (1, 4, 1, 1, 1, 4, 3)
            t6 = (2, 1, 1, 2, 1, 1, 4, 3)

        def ds_top(i: int) -> int:
            """Downsampled luma above the block at template position i."""
            xx = lx + mult * i
            left_tap = xx if (i == 0 and not build_left) else xx - 1
            if first_row_of_ctu:
                r = ly - 1
                return (t3[0] * lum(r, xx) + t3[1] * lum(r, left_tap)
                        + t3[2] * lum(r, xx + 1) + t3[3]) >> t3[4]
            r = ly - rec2
            if collocated:
                return (t5[0] * lum(r - stro, xx)
                        + t5[1] * lum(r, xx)
                        + t5[2] * lum(r, left_tap)
                        + t5[3] * lum(r, xx + 1)
                        + t5[4] * lum(r + stro, xx) + t5[5]) >> t5[6]
            return (t6[0] * lum(r, xx) + t6[1] * lum(r, left_tap)
                    + t6[2] * lum(r, xx + 1)
                    + t6[3] * lum(r + stro, xx)
                    + t6[4] * lum(r + stro, left_tap)
                    + t6[5] * lum(r + stro, xx + 1) + t6[6]) >> t6[7]

        def ds_left(j: int) -> int:
            yy = ly + rec2 * j
            base = lx - 2 - (cs.sub_w - 1)  # piSrc origin (left template)
            if collocated:
                top_tap = yy if (j == 0 and not build_above) else yy - stro
                return (t5[0] * lum(top_tap, base + 1)
                        + t5[1] * lum(yy, base + 1)
                        + t5[2] * lum(yy, base)
                        + t5[3] * lum(yy, base + 2)
                        + t5[4] * lum(yy + stro, base + 1)
                        + t5[5]) >> t5[6]
            return (t6[0] * lum(yy, base + 1)
                    + t6[1] * lum(yy, base)
                    + t6[2] * lum(yy, base + 2)
                    + t6[3] * lum(yy + stro, base + 1)
                    + t6[4] * lum(yy + stro, base)
                    + t6[5] * lum(yy + stro, base + 2) + t6[6]) >> t6[7]

        # chroma reference samples (unfiltered)
        top_ref, left_ref = self.fill_reference(tu, cu, comp)

        above_is4 = 0 if left_avail else 1
        left_is4 = 0 if above_avail else 1
        start_t = actual_top >> (2 + above_is4)
        step_t = max(1, actual_top >> (1 + above_is4))
        start_l = actual_left >> (2 + left_is4)
        step_l = max(1, actual_left >> (1 + left_is4))

        sel_luma = [0, 0, 0, 0]
        sel_chroma = [0, 0, 0, 0]
        cnt_t = cnt_l = 0
        cnt = 0
        if above_avail:
            cnt_t = min(actual_top, (1 + above_is4) << 1)
            pos = start_t
            while cnt < cnt_t:
                sel_luma[cnt] = ds_top(pos)
                sel_chroma[cnt] = int(top_ref[1 + pos])
                pos += step_t
                cnt += 1
        if left_avail:
            cnt_l = min(actual_left, (1 + left_is4) << 1)
            pos = start_l
            k = 0
            while k < cnt_l:
                sel_luma[k + cnt_t] = ds_left(pos)
                sel_chroma[k + cnt_t] = int(left_ref[1 + pos])
                pos += step_l
                k += 1
        cnt = cnt_l + cnt_t

        if cnt == 2:
            sel_luma[3], sel_chroma[3] = sel_luma[0], sel_chroma[0]
            sel_luma[2], sel_chroma[2] = sel_luma[1], sel_chroma[1]
            sel_luma[0], sel_chroma[0] = sel_luma[1], sel_chroma[1]
            sel_luma[1], sel_chroma[1] = sel_luma[3], sel_chroma[3]

        min_grp = [0, 2]
        max_grp = [1, 3]
        if sel_luma[min_grp[0]] > sel_luma[min_grp[1]]:
            min_grp[0], min_grp[1] = min_grp[1], min_grp[0]
        if sel_luma[max_grp[0]] > sel_luma[max_grp[1]]:
            max_grp[0], max_grp[1] = max_grp[1], max_grp[0]
        if sel_luma[min_grp[0]] > sel_luma[max_grp[1]]:
            min_grp, max_grp = max_grp, min_grp
        if sel_luma[min_grp[1]] > sel_luma[max_grp[0]]:
            min_grp[1], max_grp[0] = max_grp[0], min_grp[1]

        min_l = (sel_luma[min_grp[0]] + sel_luma[min_grp[1]] + 1) >> 1
        min_c = (sel_chroma[min_grp[0]] + sel_chroma[min_grp[1]] + 1) >> 1
        max_l = (sel_luma[max_grp[0]] + sel_luma[max_grp[1]] + 1) >> 1
        max_c = (sel_chroma[max_grp[0]] + sel_chroma[max_grp[1]] + 1) >> 1

        if left_avail or above_avail:
            diff = max_l - min_l
            if diff > 0:
                diff_c = max_c - min_c
                xsh = diff.bit_length() - 1
                div_sig = (0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0)
                norm_diff = ((diff << 4) >> xsh) & 15
                v = div_sig[norm_diff] | 8
                xsh += int(norm_diff != 0)
                ysh = 0 if diff_c == 0 else (abs(diff_c).bit_length() - 1) + 1
                add = (1 << ysh) >> 1
                a = (diff_c * v + add) >> ysh
                shift = 3 + xsh - ysh
                if shift < 1:
                    shift = 1
                    a = 0 if a == 0 else (-15 if a < 0 else 15)
                b = min_c - ((a * min_l) >> shift)
            else:
                a, b, shift = 0, min_c, 0
        else:
            a, b, shift = 0, 1 << (self.bit_depth - 1), 0

        # interior downsampled luma + linear transform
        ds = np.zeros((chh, cw), dtype=np.int64)
        if collocated:
            for j in range(chh):
                yy = ly + rec2 * j
                for i in range(cw):
                    xx = lx + mult * i
                    left_tap = xx if (i == 0 and not build_left) else xx - 1
                    top_tap = yy if (j == 0 and not build_above) else yy - stro
                    ds[j, i] = (t5[0] * lum(top_tap, xx)
                                + t5[1] * lum(yy, xx)
                                + t5[2] * lum(yy, left_tap)
                                + t5[3] * lum(yy, xx + 1)
                                + t5[4] * lum(yy + stro, xx)
                                + t5[5]) >> t5[6]
        else:
            l64 = luma.astype(np.int64)
            rows = ly + rec2 * np.arange(chh)
            r0 = l64[rows, :]
            r1 = l64[np.minimum(rows + stro, lh - 1), :]
            xs = np.arange(cw) * mult + lx
            left_xs = np.maximum(xs - 1, 0)
            if build_left:
                lx0 = xs - 1
            else:
                lx0 = left_xs.copy()
                lx0[0] = xs[0]
            # 6-tap interior (GET_LUMA_REC_PIX_OP2): rows yy and yy+stro
            xs1 = np.minimum(xs + 1, lw - 1)
            ds = (t6[0] * r0[:, xs] + t6[1] * r0[:, lx0]
                  + t6[2] * r0[:, xs1]
                  + t6[3] * r1[:, xs] + t6[4] * r1[:, lx0]
                  + t6[5] * r1[:, xs1] + t6[6]) >> t6[7]
        pred = b + ((a * ds) >> shift)
        return np.clip(pred, 0, self.pel_max)

    def predict_tu(self, tu: TransformUnit, cu: CodingUnit, comp: int
                   ) -> np.ndarray:
        x, y, w, h = tu.blocks[comp]
        if cu.pred_mode != MODE_INTRA:
            ox = x - (cu.x if comp == 0 else cu.cx)
            oy = y - (cu.y if comp == 0 else cu.cy)
            return self._inter_pred[cu.idx][comp][oy: oy + h, ox: ox + w]
        bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma
        if bdpcm:
            top, left = self.fill_reference(tu, cu, comp)
            pred = np.zeros((h, w), dtype=np.int64)
            if bdpcm == 1:  # horizontal: replicate left column
                pred[:, :] = left[1: h + 1][:, None]
            else:  # vertical: replicate top row
                pred[:, :] = top[1: w + 1][None, :]
            return pred
        if comp == 0 and cu.mip_flag:
            return self.pred_mip(tu, cu, comp)
        if comp == 0 and cu.isp_mode:
            return self._predict_isp(tu, cu)
        mode = self.final_mode(cu, comp)
        if comp != 0 and LM_CHROMA_IDX <= mode <= MDLM_T_IDX:
            return self.pred_cclm(tu, cu, comp, mode)
        mrl = cu.multi_ref_idx if comp == 0 else 0
        top, left = self.fill_reference(tu, cu, comp, mrl=mrl)
        filtered = self.use_filtered_refs(cu, comp, w, h)
        if filtered:
            ftop, fleft = self.filter_reference(top, left)
        else:
            ftop, fleft = top, left
        do_pdpc = self._pdpc_enabled(w, h) and mrl == 0
        if mode == PLANAR_IDX:
            pred = self.pred_planar(ftop, fleft, w, h)
        elif mode == DC_IDX:
            pred = self.pred_dc(ftop, fleft, w, h, mrl=mrl)
        else:
            return self.pred_angular(ftop, fleft, w, h, mode, comp, filtered,
                                     mrl=mrl)
        if do_pdpc:
            pred = self.pdpc_dc_planar(pred, ftop, fleft)
        return pred

    def tu_residual(self, tu: TransformUnit, cu: CodingUnit, comp: int
                    ) -> np.ndarray:
        """Residual of one coded TU component (dequant + LFNST + ITX or TS)."""
        cs = self.cs
        x, y, w, h = tu.blocks[comp]
        if self.residual_planes is not None:
            return self.residual_planes[comp][y: y + h, x: x + w]
        levels = cs.coef[comp][y: y + h, x: x + w]
        # luma: QpParam baseQp = qp + QpBdOffset (Quant.cpp:79);
        # chroma qp already includes the offset (_set_chroma_qp);
        # ACT colour-space delta folded in by tu_qp
        qp = tu_qp(cs, tu, cu, comp)
        dep_quant = cs.sh_of(cu).dep_quant_used
        if tu.mts_idx[comp] == MTS_SKIP:
            # transform skip / BDPCM: residual = dequantized levels
            return ts_residual(cs, tu, cu, comp)
        scale_mat = scaling_matrix_for(cs, tu, cu, comp)
        if cu.lfnst_idx == 0 and w > 1 and h > 1 and w <= 64 and h <= 64:
            out = _native_itx(cs, tu, cu, comp, x, y, w, h, qp,
                              bool(dep_quant), self.bit_depth, scale_mat)
            if out is not None:
                return out
        deq = dequant_block(levels, qp, w.bit_length() - 1,
                            h.bit_length() - 1, self.bit_depth,
                            dep_quant, tu.max_scan_x[comp],
                            tu.max_scan_y[comp],
                            scale_mat=scale_mat)
        if cu.lfnst_idx:
            deq = apply_inv_lfnst(cs, deq, tu, cu, comp, self.final_mode)
        hor, ver = get_tr_types(cs, tu, cu, comp)
        return inverse_transform(deq, hor, ver, self.bit_depth)

    def _reconstruct_tu_act(self, tu: TransformUnit, cu: CodingUnit) -> None:
        """Intra TU under the adaptive colour transform (DecCu::xIntraRecACT,
        DecCu.cpp:597): residuals of all three components are inverse
        YCgCo-R converted first, chroma LMCS residual scaling applies to the
        converted signal, then each component predicts and reconstructs
        (prediction + residual added for every component — the conversion
        mixes channels, so zero-cbf planes still receive residual)."""
        cs = self.cs
        x, y, w, h = tu.blocks[0]

        def raw_resi(comp):
            if comp == 1 and tu.joint_cbcr:
                coded = 1 if (tu.joint_cbcr >> 1) else 2
                r = self.tu_residual(tu, cu, coded).astype(np.int64)
                neg = bool(cs.ph.joint_cbcr_sign)
                if tu.joint_cbcr == 1:
                    self._act_jccr = (((-r) >> 1) if neg else (r >> 1), r)
                elif tu.joint_cbcr == 2:
                    self._act_jccr = (r, ((-r) >> 1) if neg else (r >> 1))
                else:
                    self._act_jccr = (r, -r if neg else r)
                return self._act_jccr[0]
            if comp == 2 and tu.joint_cbcr:
                return self._act_jccr[1]
            if tu.cbf[comp]:
                return self.tu_residual(tu, cu, comp).astype(np.int64)
            return np.zeros((h, w), dtype=np.int64)

        r0, r1, r2 = (raw_resi(c) for c in range(3))
        # inverse YCgCo-R (UnitBuf::colorSpaceConvert, Buffer.cpp:809)
        max_abs = (1 << (self.bit_depth + 1)) - 1
        y0 = np.clip(r0, -max_abs - 1, max_abs)
        cg = np.clip(r1, -max_abs - 1, max_abs)
        co = np.clip(r2, -max_abs - 1, max_abs)
        t = y0 - (cg >> 1)
        resi = [cg + t, t - (co >> 1), None]
        resi[2] = co + resi[1]
        # chroma LMCS residual scaling on the converted residual
        # (xIntraRecACT order, DecCu.cpp:618-631)
        if self.reshaper is not None and cs.sh_of(cu).lmcs_enabled \
                and cs.ph.chroma_residual_scale and w * h > 4:
            for comp in (1, 2):
                if tu.cbf[comp] or tu.joint_cbcr:
                    inv = self.reshaper.chroma_adj_vpdu(self.reco, cs, x, y)
                    resi[comp] = self.reshaper.scale_signal(resi[comp], inv)
        for comp in range(3):
            pred = self.predict_tu(tu, cu, comp)
            self.reco[comp][y: y + h, x: x + w] = np.clip(
                pred + resi[comp], 0, self.pel_max)
        self.tu_order_map[y >> 2: (y + h) >> 2,
                          x >> 2: (x + w) >> 2] = tu.order

    def reconstruct_tu(self, tu: TransformUnit, cu: CodingUnit) -> None:
        cs = self.cs
        if cu.color_transform and cu.pred_mode == MODE_INTRA:
            self._reconstruct_tu_act(tu, cu)
            return
        comps = []
        if tu.blocks[0] is not None and cu.has_luma:
            comps.append(0)
        if tu.blocks[1] is not None and cu.has_chroma:
            comps += [1, 2]
        # LMCS chroma residual scaling (DecCu.cpp:381-395, :489-508)
        chroma_scale_inv = None
        if self.reshaper is not None and cs.sh_of(cu).lmcs_enabled \
                and cs.ph.chroma_residual_scale \
                and tu.blocks[1] is not None and cu.has_chroma \
                and cs.num_comp > 1:
            _, _, cw_, ch_ = tu.blocks[1]
            if cw_ * ch_ > 4 and (tu.cbf[1] or tu.cbf[2] or tu.joint_cbcr):
                if tu.blocks[0] is not None:
                    lx, ly = tu.blocks[0][0], tu.blocks[0][1]
                else:
                    lx = tu.blocks[1][0] * cs.sub_w
                    ly = tu.blocks[1][1] * cs.sub_h
                chroma_scale_inv = self.reshaper.chroma_adj_vpdu(
                    self.reco, cs, lx, ly)

        def chr_scale(resi):
            if chroma_scale_inv is None:
                return resi
            return self.reshaper.scale_signal(resi, chroma_scale_inv)

        for comp in comps:
            x, y, w, h = tu.blocks[comp]
            pred = self.predict_tu(tu, cu, comp)
            if comp == 1 and tu.joint_cbcr:
                # joint Cb-Cr: one coded plane, the other derived by the
                # inverse color transform (TU::getICTMode UnitTools.cpp:3613,
                # invTransformCbCr TrQuant.cpp:108)
                coded = 1 if (tu.joint_cbcr >> 1) else 2
                resi = self.tu_residual(tu, cu, coded).astype(np.int64)
                neg = bool(cs.ph.joint_cbcr_sign)
                if tu.joint_cbcr == 1:      # coded Cr, Cb = (±Cr) >> 1
                    resi_cr = resi
                    resi_cb = ((-resi_cr) >> 1) if neg else (resi_cr >> 1)
                elif tu.joint_cbcr == 2:    # coded Cb, Cr = (±Cb) >> 1
                    resi_cb = resi
                    resi_cr = ((-resi_cb) >> 1) if neg else (resi_cb >> 1)
                else:                       # coded Cb, Cr = ±Cb
                    resi_cb = resi
                    resi_cr = -resi_cb if neg else resi_cb
                self._jccr_cr = chr_scale(resi_cr)
                out = np.clip(pred + chr_scale(resi_cb), 0, self.pel_max)
            elif comp == 2 and tu.joint_cbcr:
                out = np.clip(pred + self._jccr_cr, 0, self.pel_max)
            elif tu.cbf[comp]:
                resi = self.tu_residual(tu, cu, comp)
                if comp:
                    resi = chr_scale(resi)
                out = np.clip(pred + resi, 0, self.pel_max)
            else:
                out = np.clip(pred, 0, self.pel_max)
            self.reco[comp][y: y + h, x: x + w] = out
        # mark TU decoded for availability (luma-granularity map)
        if tu.blocks[0] is not None:
            x, y, w, h = tu.blocks[0]
        else:
            cxx, cyy, cww, chh = tu.blocks[1]
            x, y = cxx * cs.sub_w, cyy * cs.sub_h
            w, h = cww * cs.sub_w, chh * cs.sub_h
        self.tu_order_map[y >> 2: (y + h) >> 2, x >> 2: (x + w) >> 2] = tu.order

    def run(self) -> list[np.ndarray]:
        from refdec.frame.inter_np import MotionHist
        if type(self.cs.tus) is list:
            # parse order index; lazily-materialized TUs carry it already
            for i, tu in enumerate(self.cs.tus):
                tu.order = i
        self._hist = MotionHist()
        last_ctu_row = -1
        prev_cu = None
        ibc_on = self.cs.sps.ibc_enabled
        # native fast paths (C engines): intra TUs (recon.c) and whole
        # inter CUs (walk9.c); ineligible TUs fall back to the Python
        # golden per TU, preserving parse order
        from refdec.frame.recon_native import NativeFastPath
        fp = NativeFastPath(self)
        ifp = None
        if not self.cs.sh.is_intra or len(self.cs.shs) > 1:
            from refdec.frame.inter_native import InterFastPath
            ifp = InterFastPath(self)
            if not ifp.active:
                if self.census is not None and ifp.reason:
                    self.census[f"inter_c:{ifp.reason}"] += 1
                ifp = None
        if self.census is not None and not fp.active and fp.reason:
            self.census[f"intra_c:{fp.reason}"] += 1
        tus = self.cs.tus
        n_tus = len(tus)
        n_py_tus = 0
        i = 0
        while i < n_tus:
            if fp.active:
                j = fp.run_from(i)
                if j > i:
                    i = j
                    continue
            if ifp is not None:
                # share the HMVP-reset key with the C driver
                if last_ctu_row != -1:
                    ifp.state[0], ifp.state[1] = last_ctu_row
                j = ifp.run_from(i)
                if j > i:
                    i = j
                    last_ctu_row = (int(ifp.state[0]), int(ifp.state[1]))
                    # boundary CU index straight from the flat records —
                    # materializing the CU (and all its TUs) here costs
                    # more than the whole C inter run for small runs
                    cu_idx = int(self.cs._nw["tu_rec"][j - 1, 0])
                    self._seen_cu = cu_idx
                    prev_cu = self.cs.cus[cu_idx] if ibc_on else None
                    continue
            tu = tus[i]
            i += 1
            n_py_tus += 1
            cu = self.cs.cus[tu.cu_idx]
            if cu.idx != self._seen_cu:
                self._seen_cu = cu.idx
                if ibc_on and prev_cu is not None:
                    self._ibc_fill(prev_cu)
                prev_cu = cu
                # HMVP resets at each CTU row start and tile start
                # (DecCu.cpp:70-74)
                row = (cu.y >> self.ctu_log2, cu.tile_idx)
                if row != last_ctu_row:
                    self._hist.reset()
                    last_ctu_row = row
                if cu.pred_mode != MODE_INTRA:
                    self._derive_motion(cu)
                    # derived bcw/imv feed later neighbors' mi_at reads
                    # through the native candidate-derivation side table
                    side = getattr(self.cs, "_mctx_side", None)
                    if side is not None and cu.idx >= 0:
                        side[cu.idx, 0] = cu.bcw_idx
                        side[cu.idx, 1] = cu.imv
            self.reconstruct_tu(tu, cu)
        if ifp is not None:
            ifp.flush_fixups()
        if self.census is not None:
            self.census["tu_python"] += n_py_tus
            self.census["tu_native"] += n_tus - n_py_tus
        cs = self.cs
        if self.reshaper is not None and any(s.lmcs_enabled
                                             for s in cs.shs):
            # RSP stage: inverse-map the reconstructed luma back to the
            # original domain before deblocking (rspCtuBcw, Reshape.cpp:377);
            # per-slice gating via the 4x4 slice map (multi-slice pictures)
            mapped = self.reshaper.inv_map(self.reco[0]) \
                .astype(self.reco[0].dtype)
            if all(s.lmcs_enabled for s in cs.shs):
                self.reco[0] = mapped
            else:
                lut = np.array([bool(s.lmcs_enabled) for s in cs.shs])
                mask = np.repeat(np.repeat(lut[cs.slice_map], 4, 0), 4, 1)
                self.reco[0] = np.where(mask[: self.reco[0].shape[0],
                                             : self.reco[0].shape[1]],
                                        mapped, self.reco[0])
        return self.reco

    def _derive_motion(self, cu: CodingUnit) -> None:
        """Resolve merge/AMVP motion, run MC, update HMVP (DecCu.cpp:820)."""
        from refdec.frame import inter_np as I
        cs = self.cs
        if getattr(cs, "per_slice_rpl", False):
            # per-slice RPLs: swap in this CU's slice's resolved reference
            # set (Slice::constructRefPicLists is per slice)
            st = cs.slice_ref_sets[cu.slice_idx]
            if st is not None:
                (cs.ref_pocs, cs.ref_planes, cs.ref_cols, cs.ref_scaled,
                 cs.check_ldc) = st
        is_b = cs.sh_of(cu).is_b
        if cu.pred_mode == MODE_IBC:
            self._derive_ibc_motion(cu)
            return
        if cu.geo_flag:
            self._derive_geo_motion(cu)
            return
        if cu.affine_flag:
            self._derive_affine_motion(cu)
            return
        if cu.merge_flag:
            cands = I.derive_merge(cs, cu, self._hist, is_b)
            if cu.mmvd_flag:
                d, mv0, mv1, r0, r1, bcw, alt = I.derive_mmvd(cs, cu, cands)
            else:
                d, mv0, mv1, r0, r1, bcw, alt = cands[cu.merge_idx]
            cu.inter_dir = d
            cu.mv = [list(mv0), list(mv1)]
            cu.ref_idx = [r0 if d & 1 else -1, r1 if d & 2 else -1]
            cu.bcw_idx = bcw
            cu.alt_hpel = alt
            cu.imv = 3 if alt else 0  # propagate IMV_HPEL to neighbors
            if cu.w + cu.h == 12 and cu.inter_dir == 3:
                # 4x8/8x4 merge CUs drop to L0 uni-prediction
                # (PU::restrictBiPredMergeCandsOne, UnitTools.cpp:3111)
                cu.inter_dir = 1
                cu.ref_idx[1] = -1
                cu.mv[1] = [0, 0]
                cu.bcw_idx = 0
        else:
            mv = [[0, 0], [0, 0]]
            sh_amvr = I.AMVR_SHIFT[cu.imv]
            cu.alt_hpel = cu.imv == 3
            for lst in range(2):
                if not (cu.inter_dir & (1 << lst)):
                    cu.ref_idx[lst] = -1
                    continue
                amvp = I.fill_mvp(cs, cu, lst, cu.ref_idx[lst], self._hist)
                base = amvp[cu.mvp_idx[lst]]
                # MVD is signalled at the AMVR precision
                mx = base[0] + (cu.mvd[lst][0] << sh_amvr)
                my = base[1] + (cu.mvd[lst][1] << sh_amvr)
                clip17 = (1 << 17)
                mx = ((mx + clip17) & (2 * clip17 - 1)) - clip17
                my = ((my + clip17) & (2 * clip17 - 1)) - clip17
                mv[lst] = [mx, my]
            cu.mv = mv
        if getattr(self, "derive_only", False):
            # derivation-only pass (device pipeline): span the motion
            # field and update HMVP, skip all pixel work (the device MC
            # stage consumes the derived motion)
            I.span_motion(cs, cu)
            self._hist.add(I._mi_of(cu))
            return
        # motion compensation (DMVR / BDOF take dedicated paths,
        # motionCompensation InterPrediction.cpp:1412-1459)
        from refdec.frame import dmvr_np as D

        def _ref_scaling(lst):
            scl = getattr(cs, "ref_scaled", None)
            if not scl or cu.ref_idx[lst] < 0 \
                    or cu.ref_idx[lst] >= len(scl[lst]):
                return None
            return scl[lst][cu.ref_idx[lst]]

        any_scaled = any(_ref_scaling(lst) is not None
                         for lst in range(2) if cu.inter_dir & (1 << lst))
        # DMVR/BDOF are prohibited with scaled references (spec 8.5.1)
        cs_bio = (not any_scaled) and D.bdof_condition(cs, cu)
        cs_dmvr = (not any_scaled) and D.dmvr_condition(cs, cu)
        if cs_dmvr:
            preds = self._dmvr_mc(cu, cs_bio)
            while len(preds) < 3:
                preds.append(None)
            I.span_motion(cs, cu)
            self._store_inter_pred(cu, preds)
            self._hist.add(I._mi_of(cu))
            return
        if cs_bio:
            preds = self._bdof_mc(cu)
            while len(preds) < 3:
                preds.append(None)
            I.span_motion(cs, cu)
            self._store_inter_pred(cu, preds)
            self._hist.add(I._mi_of(cu))
            return
        preds = [None, None, None]
        wp_on = self._wp_on(cu)
        parts = []
        for lst in range(2):
            if not (cu.inter_dir & (1 << lst)):
                continue
            planes = cs.ref_planes[lst][cu.ref_idx[lst]]
            bi = cu.inter_dir == 3 or wp_on
            scaled = _ref_scaling(lst)
            if scaled is not None:
                # RPR: scaled-reference interpolation with the UNclipped MV
                # (xPredInterBlkRPR; clipMv skipped for scaled refs)
                from refdec.frame.rpr_np import rpr_mc_block
                scaling, ref_pps = scaled
                part = []
                for comp in range(cs.num_comp):
                    bx, by = (cu.x, cu.y) if comp == 0 else (cu.cx, cu.cy)
                    bw, bh = (cu.w, cu.h) if comp == 0 else (cu.cw, cu.ch)
                    part.append(rpr_mc_block(
                        planes[comp], scaling, cs.pps, ref_pps,
                        cs.sps.chroma_format_idc, comp, bx, by, bw, bh,
                        tuple(cu.mv[lst]), self.bit_depth, bi,
                        alt_hpel=cu.alt_hpel,
                        hor_collocated=cs.sps.chroma_hor_collocated,
                        ver_collocated=cs.sps.chroma_ver_collocated))
                parts.append(part)
                continue
            mvc = I.clip_mv(tuple(cu.mv[lst]), cu.x, cu.y, cs,
                            size=(cu.w, cu.h))
            mvc, woff = self._wrap(mvc, cu.x, cu.y, cu.w, cu.h)
            # treated-as-pic subpicture: gather window = subpic rect
            sp = cs.subpic_at(cu.x, cu.y) if cs.subpics else None
            bl = bc = None
            if sp is not None and sp[4]:
                bl = (sp[0], sp[1], sp[2], sp[3])
                bc = (sp[0] // cs.sub_w, sp[1] // cs.sub_h,
                      sp[2] // cs.sub_w, sp[3] // cs.sub_h)
            part = []
            for comp in range(cs.num_comp):
                if comp == 0:
                    part.append(I.mc_block(planes[0], cu.x, cu.y, cu.w, cu.h,
                                           mvc, 0, self.bit_depth,
                                           (cs.sub_w, cs.sub_h), bi,
                                           alt_hpel=cu.alt_hpel,
                                           wrap_off=woff, bounds=bl))
                else:
                    part.append(I.mc_block(planes[comp], cu.cx, cu.cy,
                                           cu.cw, cu.ch, mvc, comp,
                                           self.bit_depth,
                                           (cs.sub_w, cs.sub_h), bi,
                                           wrap_off=None if woff is None
                                           else woff >> (cs.sub_w - 1),
                                           bounds=bc))
            parts.append(part)
        if wp_on:
            preds[:cs.num_comp] = self._apply_wp(cu, parts)
        elif cu.inter_dir == 3:
            for comp in range(cs.num_comp):
                if cu.bcw_idx != 0 and not cu.ciip_flag:
                    preds[comp] = I.bi_weighted(parts[0][comp],
                                                parts[1][comp],
                                                self.bit_depth, cu.bcw_idx)
                else:
                    preds[comp] = I.bi_average(parts[0][comp],
                                               parts[1][comp],
                                               self.bit_depth)
        else:
            for comp in range(cs.num_comp):
                preds[comp] = parts[0][comp]
        I.span_motion(cs, cu)
        self._store_inter_pred(cu, preds)
        # HMVP update (parallel merge level 2 -> always eligible here)
        self._hist.add(I._mi_of(cu))

    def _derive_ibc_motion(self, cu: CodingUnit) -> None:
        """IBC: BV derivation (DecCu.cpp:785,850) + copy from the virtual
        IBC buffer (xIntraBlockCopy, InterPrediction.cpp:1998)."""
        from refdec.frame import inter_np as I
        cs = self.cs
        cu.inter_dir = 1
        if cu.merge_flag:
            cands = I.derive_ibc_merge(cs, cu, self._hist)
            bv = cands[cu.merge_idx]
        else:
            preds = I.fill_ibc_mvp(cs, cu, self._hist)
            sh_amvr = 6 if cu.imv == 2 else 4
            p = preds[cu.mvp_idx[0]]
            bv = (p[0] + (cu.mvd[0][0] << sh_amvr),
                  p[1] + (cu.mvd[0][1] << sh_amvr))
            clip17 = 1 << 17
            bv = (((bv[0] + clip17) & (2 * clip17 - 1)) - clip17,
                  ((bv[1] + clip17) & (2 * clip17 - 1)) - clip17)
        cu.mv = [[bv[0], bv[1]], [0, 0]]
        cu.ref_idx = [-1, -1]
        # span BV into the motion field (spanMotionInfo IBC: refIdx invalid)
        y4a, y4b = cu.y >> 2, (cu.y + cu.h) >> 2
        x4a, x4b = cu.x >> 2, (cu.x + cu.w) >> 2
        cs.mi_ref[y4a:y4b, x4a:x4b] = -1
        cs.mi_mv[y4a:y4b, x4a:x4b, 0] = bv
        cs.mi_mv[y4a:y4b, x4a:x4b, 1] = 0
        # prediction: copy from the per-CTU-line virtual buffer
        ctu = cs.sps.ctu_size
        line = cu.y // ctu
        bufs = self._ibc_line_buf(line)
        preds_out = []
        bvx, bvy = bv[0] >> 4, bv[1] >> 4
        n_comp = cs.num_comp if cu.has_chroma else 1
        for comp in range(n_comp):
            if comp == 0:
                bx, by, bw, bh = cu.x, cu.y, cu.w, cu.h
                ox, oy = bvx, bvy
            else:
                bx, by = cu.cx, cu.cy
                bw, bh = cu.cw, cu.ch
                ox, oy = bvx >> (cs.sub_w - 1), bvy >> (cs.sub_h - 1)
            buf = bufs[comp]
            ibc_w = buf.shape[1]
            ctu_h = buf.shape[0]
            refx = (bx + ox) & (ibc_w - 1)
            refy = (by + oy) & (ctu_h - 1)
            cols = (refx + np.arange(bw)) & (ibc_w - 1)
            preds_out.append(buf[refy:refy + bh][:, cols].astype(np.int64))
        while len(preds_out) < 3:
            preds_out.append(None)
        self._inter_pred[cu.idx] = preds_out
        # HMVP: IBC LUT, skipped for blocks <= 16 pels (DecCu.cpp:884)
        if cu.w * cu.h > 16:
            self._hist.add_ibc(bv)

    def _ibc_line_buf(self, line: int) -> list:
        if getattr(self, "_ibc_line", None) != line:
            cs = self.cs
            ctu = cs.sps.ctu_size
            ibc_w = (256 * 128) // ctu  # g_IBCBufferSize / ctuSize (Rom.h:210)
            self._ibc_line = line
            self._ibc_buf = [np.zeros((ctu, ibc_w), dtype=np.int32)]
            if cs.num_comp > 1:
                self._ibc_buf += [
                    np.zeros((ctu // cs.sub_h, ibc_w // cs.sub_w),
                             dtype=np.int32) for _ in range(2)]
        return self._ibc_buf

    def _ibc_fill(self, cu: CodingUnit) -> None:
        """fillIBCbuffer (CodingStructure.cpp:554): copy the reconstructed
        CU into the virtual buffer at the wrapped position."""
        cs = self.cs
        ctu = cs.sps.ctu_size
        bufs = self._ibc_line_buf(cu.y // ctu)
        for comp in range(cs.num_comp):
            if comp == 0:
                if not cu.has_luma:
                    continue
                bx, by, bw, bh = cu.x, cu.y, cu.w, cu.h
            else:
                if not cu.has_chroma:
                    continue
                bx, by, bw, bh = cu.cx, cu.cy, cu.cw, cu.ch
            buf = bufs[comp]
            px = bx & (buf.shape[1] - 1)
            py = by & (buf.shape[0] - 1)
            buf[py:py + bh, px:px + bw] = \
                self.reco[comp][by:by + bh, bx:bx + bw]

    def _bdof_mc(self, cu: CodingUnit) -> list:
        """BDOF bi-prediction over 16x16 application regions
        (xSubPuBio, InterPrediction.cpp:551)."""
        from refdec.frame import dmvr_np as D
        from refdec.frame import inter_np as I
        cs = self.cs
        bd = self.bit_depth
        out = [np.zeros((cu.h, cu.w), dtype=np.int64)]
        if cs.num_comp > 1:
            out += [np.zeros((cu.ch, cu.cw), dtype=np.int64)
                    for _ in range(2)]
        tw = min(D.BDOF_REGION, cu.w)
        th = min(D.BDOF_REGION, cu.h)
        alt = cu.alt_hpel
        for ty in range(0, cu.h, th):
            for tx in range(0, cu.w, tw):
                exts = []
                chroma = []
                for lst in range(2):
                    plane = cs.ref_planes[lst][cu.ref_idx[lst]]
                    # clipMv uses the FULL CU area (m_currCuArea)
                    mvc = I.clip_mv(tuple(cu.mv[lst]), cu.x, cu.y, cs,
                                    size=(cu.w, cu.h))
                    mvc, woff = self._wrap(mvc, cu.x, cu.y, cu.w, cu.h)
                    view = D.RefView(plane[0], wrap_off=woff)
                    _, ext = D.mc_from_view(
                        view, cu.x + tx, cu.y + ty, tw, th,
                        mvc[0] >> 4, mvc[1] >> 4, mvc[0] & 15, mvc[1] & 15,
                        0, bd, True, bio_ext=True, alt_hpel=alt)
                    exts.append(ext)
                    if cs.num_comp > 1:
                        cpart = []
                        for comp in (1, 2):
                            sx = 4 + (cs.sub_w - 1)
                            sy = 4 + (cs.sub_h - 1)
                            fx = (mvc[0] & ((1 << sx) - 1)) << (5 - sx)
                            fy = (mvc[1] & ((1 << sy) - 1)) << (5 - sy)
                            cpart.append(D.mc_from_view(
                                D.RefView(plane[comp],
                                          wrap_off=None if woff is None
                                          else woff >> (cs.sub_w - 1)),
                                (cu.x + tx) // cs.sub_w,
                                (cu.y + ty) // cs.sub_h,
                                tw // cs.sub_w, th // cs.sub_h,
                                mvc[0] >> sx, mvc[1] >> sy, fx, fy,
                                comp, bd, True))
                        chroma.append(cpart)
                out[0][ty:ty + th, tx:tx + tw] = D.bdof_blend(
                    exts[0], exts[1], tw, th, bd)
                if cs.num_comp > 1:
                    for k, comp in enumerate((1, 2)):
                        cy0, cx0 = ty // cs.sub_h, tx // cs.sub_w
                        out[comp][cy0:cy0 + th // cs.sub_h,
                                  cx0:cx0 + tw // cs.sub_w] = I.bi_average(
                            chroma[0][k], chroma[1][k], bd)
        return out

    def _dmvr_mc(self, cu: CodingUnit, bio_applied: bool) -> list:
        """DMVR: bilinear pre-MC, 25-point SAD search per 16x16 subblock,
        padded final MC, optional per-subblock BDOF
        (xProcessDMVR, InterPrediction.cpp:1847)."""
        from refdec.frame import dmvr_np as D
        from refdec.frame import inter_np as I
        cs = self.cs
        bd = self.bit_depth
        merge_mv = (tuple(cu.mv[0]), tuple(cu.mv[1]))
        # CU-wide bilinear buffers with 2-sample margin (xinitMC)
        bl = []
        for lst in range(2):
            plane = cs.ref_planes[lst][cu.ref_idx[lst]][0]
            mvc = I.clip_mv(merge_mv[lst], cu.x, cu.y, cs,
                            size=(cu.w, cu.h))
            mvc, woff_bl = self._wrap(mvc, cu.x, cu.y, cu.w, cu.h)
            mvc = (mvc[0] - (D.DMVR_ITER << 4), mvc[1] - (D.DMVR_ITER << 4))
            bl.append(D.bilinear_pred(D.RefView(plane, wrap_off=woff_bl),
                                      cu.x, cu.y,
                                      cu.w + 2 * D.DMVR_ITER,
                                      cu.h + 2 * D.DMVR_ITER, mvc, bd))
        dx = min(cu.w, D.DMVR_SUBCU)
        dy = min(cu.h, D.DMVR_SUBCU)
        out = [np.zeros((cu.h, cu.w), dtype=np.int64)]
        if cs.num_comp > 1:
            out += [np.zeros((cu.ch, cu.cw), dtype=np.int64)
                    for _ in range(2)]
        bio_thres = 2 * dx * dy
        for ys in range(0, cu.h, dy):
            for xs in range(0, cu.w, dx):
                dmv, min_cost = D.dmvr_search(bl[0], bl[1], xs, ys, dx, dy)
                mv0 = (D._clip18(merge_mv[0][0] + dmv[0]),
                       D._clip18(merge_mv[0][1] + dmv[1]))
                mv1 = (D._clip18(merge_mv[1][0] - dmv[0]),
                       D._clip18(merge_mv[1][1] - dmv[1]))
                bio_sub = bio_applied and min_cost >= bio_thres
                sx_abs, sy_abs = cu.x + xs, cu.y + ys
                exts = []
                parts = []
                for lst, rmv in ((0, mv0), (1, mv1)):
                    planes = cs.ref_planes[lst][cu.ref_idx[lst]]
                    mvc = I.clip_mv(rmv, sx_abs, sy_abs, cs,
                                    size=(cu.w, cu.h))
                    mvc, woff = self._wrap(mvc, cu.x, cu.y, cu.w, cu.h)
                    part = []
                    ext = None
                    for comp in range(cs.num_comp):
                        if comp == 0:
                            shx = shy = 4
                            bx, by = sx_abs, sy_abs
                            bw, bh = dx, dy
                            taps = 8
                        else:
                            shx = 4 + (cs.sub_w - 1)
                            shy = 4 + (cs.sub_h - 1)
                            bx, by = sx_abs // cs.sub_w, sy_abs // cs.sub_h
                            bw, bh = dx // cs.sub_w, dy // cs.sub_h
                            taps = 4
                        d_int_x = (rmv[0] >> shx) - (merge_mv[lst][0] >> shx)
                        d_int_y = (rmv[1] >> shy) - (merge_mv[lst][1] >> shy)
                        fx = mvc[0] & ((1 << shx) - 1)
                        fy = mvc[1] & ((1 << shy) - 1)
                        if comp:
                            fx <<= 5 - shx
                            fy <<= 5 - shy
                        if d_int_x or d_int_y:
                            # padded prefetch window from the merge MV
                            # (xPrefetchPad + altSrc MC)
                            half = taps // 2 - 1
                            wmv = (merge_mv[lst][0] - (half << shx),
                                   merge_mv[lst][1] - (half << shy))
                            wmv = I.clip_mv(wmv, sx_abs, sy_abs, cs,
                                            size=(cu.w, cu.h))
                            wmv, _ = self._wrap(wmv, cu.x, cu.y, cu.w, cu.h)
                            wx = bx + (wmv[0] >> shx)
                            wy = by + (wmv[1] >> shy)
                            view = D.RefView.window(
                                planes[comp], wx, wy,
                                bw + taps - 1, bh + taps - 1,
                                wrap_off=None if woff is None else
                                (woff if comp == 0
                                 else woff >> (cs.sub_w - 1)))
                            int_x = (wmv[0] >> shx) + d_int_x + half
                            int_y = (wmv[1] >> shy) + d_int_y + half
                        else:
                            view = D.RefView(
                                planes[comp],
                                wrap_off=None if woff is None else
                                (woff if comp == 0
                                 else woff >> (cs.sub_w - 1)))
                            int_x = mvc[0] >> shx
                            int_y = mvc[1] >> shy
                        if comp == 0 and bio_sub:
                            blk, ext = D.mc_from_view(
                                view, bx, by, bw, bh, int_x, int_y, fx, fy,
                                0, bd, True, bio_ext=True,
                                alt_hpel=cu.alt_hpel)
                        else:
                            blk = D.mc_from_view(view, bx, by, bw, bh,
                                                 int_x, int_y, fx, fy,
                                                 comp, bd, True,
                                                 alt_hpel=cu.alt_hpel)
                        part.append(blk)
                    parts.append(part)
                    exts.append(ext)
                if bio_sub:
                    out[0][ys:ys + dy, xs:xs + dx] = D.bdof_blend(
                        exts[0], exts[1], dx, dy, bd)
                else:
                    out[0][ys:ys + dy, xs:xs + dx] = I.bi_average(
                        parts[0][0], parts[1][0], bd)
                for comp in range(1, cs.num_comp):
                    cy0, cx0 = ys // cs.sub_h, xs // cs.sub_w
                    out[comp][cy0:cy0 + dy // cs.sub_h,
                              cx0:cx0 + dx // cs.sub_w] = I.bi_average(
                        parts[0][comp], parts[1][comp], bd)
                # refined-MV writeback positions (TaskFinishMotionInfo)
                y2 = ((sy_abs - 1) & ~7) + 8
                while y2 < sy_abs + dy:
                    x2 = ((sx_abs - 1) & ~7) + 8
                    while x2 < sx_abs + dx:
                        cs.dmvr_fixups.append((x2, y2, mv0, mv1))
                        x2 += 8
                    y2 += 8
        return out

    def _derive_affine_motion(self, cu: CodingUnit) -> None:
        """Affine merge/AMVP motion + subblock MC (DecCu.cpp:746-849;
        InterPrediction.cpp:934 xPredAffineBlk, :438 xSubPuMC)."""
        from refdec.frame import affine_np as A
        from refdec.frame import inter_np as I
        cs = self.cs
        cu.cpmv = [[(0, 0)] * 3, [(0, 0)] * 3]
        if cu.merge_flag:
            cands = A.derive_affine_merge(cs, cu, cu.merge_idx)
            cand = cands[cu.merge_idx]
            cu.inter_dir = cand.inter_dir
            cu.affine_type = cand.aff_type
            cu.bcw_idx = cand.bcw
            cu.merge_type = 1 if cand.subpu else 0
            if cand.subpu:
                cu.ref_idx = list(cand.ref)
            else:
                for lst in range(2):
                    if cs.sh_of(cu).num_ref_idx_active[lst] > 0:
                        cu.ref_idx[lst] = cand.ref[lst]
                        A.set_all_affine_mv(cs, cu, cand.mvf[lst][0],
                                            cand.mvf[lst][1],
                                            cand.mvf[lst][2], lst)
                A.span_affine_motion(cs, cu)
        else:
            for lst in range(2):
                if not (cs.sh_of(cu).num_ref_idx_active[lst] > 0
                        and (cu.inter_dir & (1 << lst))):
                    cu.ref_idx[lst] = -1
                    continue
                amvp = A.fill_affine_mvp(cs, cu, lst, cu.ref_idx[lst])
                plt, prt, plb = amvp[cu.mvp_idx[lst]]
                sh_imv = 2 if cu.imv == 2 else 0
                d0 = (cu.mvd[lst][0] << sh_imv, cu.mvd[lst][1] << sh_imv)
                d1 = (cu.mvd_aff[lst][0][0] << sh_imv,
                      cu.mvd_aff[lst][0][1] << sh_imv)
                lt = (plt[0] + d0[0], plt[1] + d0[1])
                rt = (prt[0] + d1[0] + d0[0], prt[1] + d1[1] + d0[1])
                if cu.imv != 1:
                    lt = (lt[0] << 2, lt[1] << 2)
                    rt = (rt[0] << 2, rt[1] << 2)
                lb = (0, 0)
                if cu.affine_type == 1:
                    d2 = (cu.mvd_aff[lst][1][0] << sh_imv,
                          cu.mvd_aff[lst][1][1] << sh_imv)
                    lb = (plb[0] + d2[0] + d0[0], plb[1] + d2[1] + d0[1])
                    if cu.imv != 1:
                        lb = (lb[0] << 2, lb[1] << 2)
                A.set_all_affine_mv(cs, cu, lt, rt, lb, lst, clip_cpmvs=True)
            A.span_affine_motion(cs, cu)

        if getattr(self, "derive_only", False):
            # device pipeline: CPMVs + spanned subblock field are enough
            # for the device affine/SbTMVP MC stage
            return
        # motion compensation
        if cu.merge_type == 1:
            preds = self._sbtmvp_mc(cu)
        else:
            wp_on = self._wp_on(cu)
            parts = []
            for lst in range(2):
                if cu.inter_dir & (1 << lst):
                    parts.append(A.affine_pred(cs, cu, lst, self.bit_depth,
                                               force_intermediate=wp_on))
            if wp_on:
                preds = self._apply_wp(cu, parts)
            elif cu.inter_dir == 3:
                preds = []
                for comp in range(cs.num_comp):
                    if cu.bcw_idx != 0:
                        preds.append(I.bi_weighted(parts[0][comp],
                                                   parts[1][comp],
                                                   self.bit_depth,
                                                   cu.bcw_idx))
                    else:
                        preds.append(I.bi_average(parts[0][comp],
                                                  parts[1][comp],
                                                  self.bit_depth))
            else:
                preds = parts[0]
        while len(preds) < 3:
            preds.append(None)
        self._store_inter_pred(cu, preds)
        # affine CUs never update the HMVP table (DecCu.cpp:884)

    def _sbtmvp_mc(self, cu: CodingUnit) -> list:
        """SbTMVP MC: regular MC per 8x8 subblock with the spanned motion
        field (xSubPuMC, InterPrediction.cpp:438)."""
        from refdec.frame import inter_np as I
        cs = self.cs
        sh = cs.sh_of(cu)
        wp_on = (cs.pps.weighted_pred and sh.is_p) or \
            (cs.pps.weighted_bipred and sh.is_b)
        out = [np.zeros((cu.h, cu.w), dtype=np.int64)]
        if cs.num_comp > 1:
            out += [np.zeros((cu.ch, cu.cw), dtype=np.int64)
                    for _ in range(2)]
        for by in range(0, cu.h, 8):
            for bx in range(0, cu.w, 8):
                y4, x4 = (cu.y + by) >> 2, (cu.x + bx) >> 2
                r0 = int(cs.mi_ref[y4, x4, 0])
                r1 = int(cs.mi_ref[y4, x4, 1])
                d = (1 if r0 >= 0 else 0) + (2 if r1 >= 0 else 0)
                bi = d == 3 or wp_on
                parts = []
                for lst in range(2):
                    if not (d & (1 << lst)):
                        continue
                    mv = (int(cs.mi_mv[y4, x4, lst, 0]),
                          int(cs.mi_mv[y4, x4, lst, 1]))
                    mvc = I.clip_mv(mv, cu.x + bx, cu.y + by, cs,
                                    size=(8, 8))
                    mvc, woff = self._wrap(mvc, cu.x + bx, cu.y + by, 8, 8)
                    planes = cs.ref_planes[lst][r0 if lst == 0 else r1]
                    part = [I.mc_block(planes[0], cu.x + bx, cu.y + by, 8, 8,
                                       mvc, 0, self.bit_depth,
                                       (cs.sub_w, cs.sub_h), bi,
                                       wrap_off=woff)]
                    if cs.num_comp > 1:
                        cbx = (cu.x + bx) // cs.sub_w - cu.cx
                        cby = (cu.y + by) // cs.sub_h - cu.cy
                        for comp in (1, 2):
                            part.append(I.mc_block(
                                planes[comp], cu.cx + cbx, cu.cy + cby,
                                8 // cs.sub_w, 8 // cs.sub_h, mvc, comp,
                                self.bit_depth, (cs.sub_w, cs.sub_h), bi,
                                wrap_off=None if woff is None
                                else woff >> (cs.sub_w - 1)))
                    parts.append(part)
                if wp_on:
                    wl = None if d == 3 else (0 if d == 1 else 1)
                    parts_wp = self._apply_wp(cu, parts, uni_lst=wl,
                                              refs=[r0, r1])
                for comp in range(cs.num_comp):
                    if comp == 0:
                        sx, sy, sw, sh_ = bx, by, 8, 8
                    else:
                        sx, sy = bx // cs.sub_w, by // cs.sub_h
                        sw, sh_ = 8 // cs.sub_w, 8 // cs.sub_h
                    if wp_on:
                        blk = parts_wp[comp]
                    elif bi:
                        blk = I.bi_average(parts[0][comp], parts[1][comp],
                                           self.bit_depth)
                    else:
                        blk = parts[0][comp]
                    out[comp][sy:sy + sh_, sx:sx + sw] = blk
        return out

    def _derive_geo_motion(self, cu: CodingUnit) -> None:
        """GPM: two uni-predicted parts blended with the geometric mask
        (motionCompensationGeo, InterPrediction.cpp:1461)."""
        from refdec.frame import inter_np as I
        from refdec.frame.geo_np import geo_weight_block
        cs = self.cs
        merge = I.derive_merge(cs, cu, self._hist, cs.sh_of(cu).is_b)
        geo_cands = I.derive_geo(cs, cu, merge)
        if getattr(self, "derive_only", False):
            # device pipeline: record the two parts' motion for the
            # device GPM MC stage, span the field, skip pixel work
            cu._geo_parts = []
            for k in range(2):
                c = geo_cands[cu.geo_idx[k]]
                lst = 0 if c[0] == 1 else 1
                cu._geo_parts.append((lst, c[3 + lst], tuple(c[1 + lst])))
            I.span_geo_motion(cs, cu, geo_cands)
            c0 = geo_cands[cu.geo_idx[0]]
            cu.inter_dir = c0[0]
            cu.mv = [list(c0[1]), list(c0[2])]
            cu.ref_idx = [c0[3], c0[4]]
            return
        parts = []
        for k in range(2):
            c = geo_cands[cu.geo_idx[k]]
            lst = 0 if c[0] == 1 else 1
            ref = c[3 + lst]
            planes = cs.ref_planes[lst][ref]
            scl = getattr(cs, "ref_scaled", None)
            scaled = scl[lst][ref] if scl and 0 <= ref < len(scl[lst]) \
                else None
            if scaled is not None:
                # each GPM part routes through the regular uni MC, so a
                # scaled reference uses RPR interpolation with the
                # unclipped MV (motionCompensationGeo -> xPredInterUni)
                from refdec.frame.rpr_np import rpr_mc_block
                scaling, ref_pps = scaled
                part = []
                for comp in range(cs.num_comp):
                    bx, by = (cu.x, cu.y) if comp == 0 else (cu.cx, cu.cy)
                    bw, bh = (cu.w, cu.h) if comp == 0 else (cu.cw, cu.ch)
                    part.append(rpr_mc_block(
                        planes[comp], scaling, cs.pps, ref_pps,
                        cs.sps.chroma_format_idc, comp, bx, by, bw, bh,
                        tuple(c[1 + lst]), self.bit_depth, True,
                        hor_collocated=cs.sps.chroma_hor_collocated,
                        ver_collocated=cs.sps.chroma_ver_collocated))
                parts.append(part)
                continue
            mvc = I.clip_mv(c[1 + lst], cu.x, cu.y, cs, size=(cu.w, cu.h))
            mvc, woff = self._wrap(mvc, cu.x, cu.y, cu.w, cu.h)
            # treated-as-pic subpicture: gather window = subpic rect
            sp = cs.subpic_at(cu.x, cu.y) if cs.subpics else None
            bl = bc = None
            if sp is not None and sp[4]:
                bl = (sp[0], sp[1], sp[2], sp[3])
                bc = (sp[0] // cs.sub_w, sp[1] // cs.sub_h,
                      sp[2] // cs.sub_w, sp[3] // cs.sub_h)
            part = []
            for comp in range(cs.num_comp):
                if comp == 0:
                    part.append(I.mc_block(planes[0], cu.x, cu.y, cu.w, cu.h,
                                           mvc, 0, self.bit_depth,
                                           (cs.sub_w, cs.sub_h), True,
                                           wrap_off=woff, bounds=bl))
                else:
                    part.append(I.mc_block(planes[comp], cu.cx, cu.cy,
                                           cu.cw, cu.ch, mvc, comp,
                                           self.bit_depth,
                                           (cs.sub_w, cs.sub_h), True,
                                           wrap_off=None if woff is None
                                           else woff >> (cs.sub_w - 1),
                                           bounds=bc))
            parts.append(part)
        shift = max(2, I.IF_INTERNAL_PREC - self.bit_depth) + 3
        offset = (1 << (shift - 1)) + (I.IF_INTERNAL_OFFS << 3)
        preds = [None] * cs.num_comp
        for comp in range(cs.num_comp):
            sx = (self.cs.sub_w - 1) if comp else 0
            sy = (self.cs.sub_h - 1) if comp else 0
            wgt = geo_weight_block(cu.geo_split_dir,
                                   cu.cw if comp else cu.w,
                                   cu.ch if comp else cu.h, sx, sy)
            blk = (wgt * parts[0][comp] + (8 - wgt) * parts[1][comp]
                   + offset) >> shift
            preds[comp] = np.clip(blk, 0, self.pel_max)
        self._store_inter_pred(cu, preds)
        # motion field + CU-level fields (for availability/BS bookkeeping)
        I.span_geo_motion(cs, cu, geo_cands)
        c0 = geo_cands[cu.geo_idx[0]]
        cu.inter_dir = c0[0]
        cu.mv = [list(c0[1]), list(c0[2])]
        cu.ref_idx = [c0[3], c0[4]]
        # GPM CUs do not update the HMVP table (DecCu.cpp:884 geoFlag)

    def _wp_on(self, cu: CodingUnit) -> bool:
        """Explicit weighted prediction applies to this CU
        (xPredInterBi weighting selection, InterPrediction.cpp:735-746)."""
        cs = self.cs
        if cu.geo_flag or cu.pred_mode == MODE_IBC:
            return False
        sh = cs.sh_of(cu)
        if cu.inter_dir == 3:
            return cs.pps.weighted_bipred and sh.is_b and cu.bcw_idx == 0
        return (cs.pps.weighted_pred and sh.is_p) or \
            (cs.pps.weighted_bipred and sh.is_b)

    def _wrap(self, mvc, x, y, w, h):
        """Second-stage wrapClipMv (xPredInterUni, InterPrediction.cpp:656):
        returns (mv, luma wrap offset or None) — the offset selects the
        wraparound-padded reference for the fetch."""
        cs = self.cs
        if not (cs.sps.ref_wraparound_enabled and cs.pps.ref_wraparound_enabled):
            return mvc, None
        from refdec.frame import inter_np as I
        mvc, wrap_ref = I.wrap_clip_mv(mvc, x, y, w, h, cs)
        return mvc, (cs.pps.wraparound_offset if wrap_ref else None)

    def _apply_wp(self, cu: CodingUnit, parts: list, uni_lst=None,
                  refs=None) -> list:
        """addWeightUni / addWeightBi (WeightPrediction.cpp:164,240) on
        14-bit intermediate predictions."""
        from refdec.hls.weight_table import resolve_wp
        cs = self.cs
        bd = self.bit_depth
        wt = cs.sh_of(cu).weight_table
        refs = refs if refs is not None else cu.ref_idx
        shift_num = max(2, 14 - bd)
        offs = 1 << 13
        out = []
        if len(parts) == 2:
            wp0 = resolve_wp(wt, 0, refs[0], bd, cs.num_comp)
            wp1 = resolve_wp(wt, 1, refs[1], bd, cs.num_comp)
            for comp in range(len(parts[0])):
                denom = wp0[comp]["denom"]
                shift = denom + 1 + shift_num
                rnd = (1 << shift) >> 1
                off = wp0[comp]["o"] + wp1[comp]["o"]
                v = (wp0[comp]["w"] * (parts[0][comp] + offs)
                     + wp1[comp]["w"] * (parts[1][comp] + offs)
                     + rnd + (off << (shift - 1))) >> shift
                out.append(np.clip(v, 0, self.pel_max))
        else:
            lst = uni_lst if uni_lst is not None else \
                (0 if cu.inter_dir == 1 else 1)
            wp = resolve_wp(wt, lst, refs[lst], bd, cs.num_comp)
            for comp in range(len(parts[0])):
                denom = wp[comp]["denom"]
                shift = denom + shift_num
                rnd = (1 << shift) >> 1 if shift > 0 else 0
                v = ((wp[comp]["w"] * (parts[0][comp] + offs) + rnd)
                     >> shift) + wp[comp]["o"]
                out.append(np.clip(v, 0, self.pel_max))
        return out

    def _store_inter_pred(self, cu: CodingUnit, preds: list) -> None:
        """Finish an inter prediction: LMCS forward mapping of luma
        (DecCu.cpp:460-476 rspBufFwd) before the CIIP intra blend."""
        from refdec.frame.structure import MODE_IBC
        sh = self.cs.sh_of(cu)
        if self.lmcs_fwd and sh.lmcs_enabled and not sh.is_intra \
                and cu.pred_mode != MODE_IBC:
            preds[0] = self.reshaper.fwd_map(preds[0])
        if cu.ciip_flag:
            self._ciip_blend(cu, preds)
        self._inter_pred[cu.idx] = preds

    def _ciip_blend(self, cu: CodingUnit, preds: list) -> None:
        """CIIP: blend the inter prediction with planar intra
        (predBlendIntraCiip, IntraPrediction.cpp:884)."""
        cs = self.cs
        left = cs.cu_at_restricted(cu.x - 1, cu.y + cu.h - 1, cu, 0)
        above = cs.cu_at_restricted(cu.x + cu.w - 1, cu.y - 1, cu, 0)
        n0 = bool(left and left.pred_mode == MODE_INTRA
                  and left.idx < cu.idx)
        n1 = bool(above and above.pred_mode == MODE_INTRA
                  and above.idx < cu.idx)
        w_intra = 3 - (not n0) - (not n1)
        w_merge = 3 - n0 - n1
        max_comp = cs.num_comp if (cs.num_comp > 1 and cu.cw > 2) else 1
        tu0 = cu.tus[0]
        for comp in range(max_comp):
            # temp TU covering the CU for reference construction
            t = TransformUnit()
            t.cu_idx = cu.idx
            t.order = tu0.order
            if comp == 0:
                t.blocks[0] = (cu.x, cu.y, cu.w, cu.h)
                w, h = cu.w, cu.h
            else:
                t.blocks[comp] = (cu.cx, cu.cy, cu.cw, cu.ch)
                if t.blocks[1] is None:
                    t.blocks[1] = t.blocks[comp]
                w, h = cu.cw, cu.ch
            top, left_r = self.fill_reference(t, cu, comp)
            filtered = comp == 0 and not cu.multi_ref_idx and w * h > 32
            if filtered:
                top, left_r = self.filter_reference(top, left_r)
            intra = self.pred_planar(top, left_r, w, h)
            if self._pdpc_enabled(w, h):
                intra = self.pdpc_dc_planar(intra, top, left_r)
            preds[comp] = (w_merge * preds[comp].astype(np.int64)
                           + w_intra * intra + 2) >> 2


def reconstruct_frame(cs: CodingStructure) -> list[np.ndarray]:
    """Reconstruct one parsed frame; returns uint16 planes (no in-loop filters
    yet — deblocking/SAO/ALF arrive as separate stages)."""
    r = IntraReconstructor(cs)
    planes = r.run()
    return [p.astype(np.uint16) for p in planes]
