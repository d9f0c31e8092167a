"""Batched residual stages (dequant + inverse transform, transform skip,
LFNST), the ALF diamond filter and the deblocking tables.

Subset of vvdec_tpu/ops/pipeline.py.  Each `_*_fn` factory returns a
function over torch tensors; constants are placed on the input's device
on first use.  Integer products go through float64 (`_exact_dot`): CUDA
has no int32 matmul and float32 is not exact at these magnitudes.  TUs
without transform skip, LFNST or a scaling list do not come here: the
ITX stage runs them all in one launch of the hand-written kernel
(ops/cuda/itx.itx_frame_cuda), where the JAX package sends them to
Pallas.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops import rom
from vvdec_tpu_torch.ops.cuda.itx import _dequant, _exact_dot, dequant_params
from vvdec_tpu_torch.ops.tables import tr_matrix

MAX_LOG2_TR_RANGE = 15


class _DeviceConsts:
    """Constant tensors of one stage, materialised once per device."""

    def __init__(self, **arrays):
        self._np = arrays
        self._per_dev: dict = {}

    def on(self, device) -> dict:
        key = str(device)
        d = self._per_dev.get(key)
        if d is None:
            d = {k: torch.as_tensor(v, dtype=torch.int32, device=device)
                 for k, v in self._np.items()}
            self._per_dev[key] = d
        return d


def _sl_dequant(levels, qp, smat, scales, i_transform_shift, dep_quant):
    """Dequant with a scaling-list matrix (Quant.cpp:335-338): the
    per-coefficient matrix multiplies the QP scale and the right shift
    grows by LOG2_SCALING_LIST_NEUTRAL_VALUE."""
    tr_max = (1 << MAX_LOG2_TR_RANGE) - 1
    if dep_quant:
        qp_per = (qp + 1) // 6
        qp_rem = qp + 1 - 6 * qp_per
    else:
        qp_per, qp_rem = qp // 6, qp % 6
    right_shift = 6 + (1 if dep_quant else 0) \
        - (i_transform_shift + qp_per) + 4
    scale = scales[qp_rem.long()]
    target_bd = torch.clamp(64 + right_shift - 7, max=MAX_LOG2_TR_RANGE + 1)
    input_max = ((1 << (target_bd - 1)) - 1)[:, None, None]
    clipped = torch.clamp(levels, -input_max - 1, input_max)
    prod = clipped * scale[:, None, None] * smat[None, :, :]
    rs = right_shift[:, None, None]
    pos = (prod + (1 << torch.clamp(rs - 1, min=0))) \
        >> torch.clamp(rs, min=0)
    neg = prod << torch.clamp(-rs, min=0)
    deq = torch.where(rs > 0, pos, neg)
    return torch.where(levels != 0, torch.clamp(deq, -tr_max - 1, tr_max),
                       torch.zeros_like(deq))


def _shifts(h: int, w: int, bit_depth: int):
    log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
    transform_shift = MAX_LOG2_TR_RANGE - bit_depth - ((log2_w + log2_h) >> 1)
    needs_sqrt2 = ((log2_w + log2_h) & 1) == 1
    return (transform_shift + (-1 if needs_sqrt2 else 0),
            rom.INV_QUANT_SCALES[1 if needs_sqrt2 else 0])


@functools.lru_cache(maxsize=None)
def _itx_fn(h: int, w: int, tr_hor: str, tr_ver: str, bit_depth: int,
            dep_quant: bool):
    """Batched scaling-list dequant + ITX for one TU shape (the
    reference's _itx_fn with use_sl): (levels [N,h,w] int32, qp [N]
    int32, smat [h,w] int32) -> residual [N,h,w] int32."""
    i_transform_shift, scale_tab = _shifts(h, w, bit_depth)
    consts = _DeviceConsts(mv=tr_matrix(tr_ver, h), mh=tr_matrix(tr_hor, w),
                           scales=scale_tab)
    s1 = 7
    s2 = (6 + MAX_LOG2_TR_RANGE - 1) - bit_depth
    clip_min = -(1 << MAX_LOG2_TR_RANGE)
    clip_max = (1 << MAX_LOG2_TR_RANGE) - 1

    def run(levels: torch.Tensor, qp: torch.Tensor,
            smat: torch.Tensor) -> torch.Tensor:
        c = consts.on(levels.device)
        levels = levels.to(torch.int32)
        qp = qp.to(torch.int32)
        deq = _sl_dequant(levels, qp, smat.to(torch.int32), c["scales"],
                          i_transform_shift, dep_quant)
        tmp = _exact_dot("nkx,ky->nxy", deq, c["mv"])
        tmp = torch.clamp((tmp + (1 << (s1 - 1))) >> s1, clip_min, clip_max)
        blk = _exact_dot("nky,kx->nyx", tmp, c["mh"])
        return torch.clamp((blk + (1 << (s2 - 1))) >> s2, clip_min, clip_max)

    return run


@functools.lru_cache(maxsize=None)
def _ts_fn(h: int, w: int, bit_depth: int, imi: int):
    """Transform-skip dequant (no transform): parity with
    recon_np.dequant_block(ts=True) / Quant.cpp DeQuant."""
    consts = _DeviceConsts(scales=rom.INV_QUANT_SCALES[0])

    def run(levels, qp):
        scales = consts.on(levels.device)["scales"]
        lv = levels.to(torch.int32)
        qp2 = torch.clamp(qp.to(torch.int32), min=4 + 6 * imi)[:, None, None]
        qp_per = qp2 // 6
        qp_rem = qp2 - 6 * qp_per
        right_shift = 6 - qp_per
        scale = scales[qp_rem.long()]
        target_bd = torch.clamp(57 + right_shift, max=16)
        input_max = (1 << (target_bd - 1)) - 1
        clipped = torch.clamp(lv, -input_max - 1, input_max)
        rs_p = torch.clamp(right_shift, 0, 31)
        deq_p = (clipped * scale
                 + (1 << torch.clamp(right_shift - 1, 0, 31))) >> rs_p
        deq_n = (clipped * scale) << torch.clamp(-right_shift, 0, 31)
        deq = torch.where(right_shift > 0, deq_p, deq_n)
        return torch.where(lv != 0, torch.clamp(deq, -32768, 32767),
                           torch.zeros_like(deq))

    return run


@functools.lru_cache(maxsize=None)
def _itx_lfnst_fn(h: int, w: int, tr_hor: str, tr_ver: str,
                  bit_depth: int, dep_quant: bool, sb: int, zero_out: int,
                  use_sl: bool = False):
    """Batched dequant + inverse LFNST + ITX for one TU shape
    (TrQuant::xInvLfnst between dequant and the primary transform,
    TrQuant.cpp:201/:290): (levels [N,h,w], qp [N], kern [N,48|16,zo]
    int32, trans [N] bool[, smat]) -> residual [N,h,w] int32."""
    i_transform_shift, scale_tab = _shifts(h, w, bit_depth)
    consts = _DeviceConsts(mv=tr_matrix(tr_ver, h), mh=tr_matrix(tr_hor, w),
                           scales=scale_tab,
                           scan16=np.asarray(rom.scan_grouped(w, h)[:16]))
    s1 = 7
    s2 = (6 + MAX_LOG2_TR_RANGE - 1) - bit_depth
    clip_min = -(1 << MAX_LOG2_TR_RANGE)
    clip_max = (1 << MAX_LOG2_TR_RANGE) - 1

    def run(levels, qp, kern, trans, smat=None):
        c = consts.on(levels.device)
        levels = levels.to(torch.int32)
        qp = qp.to(torch.int32)
        if use_sl:
            deq = _sl_dequant(levels, qp, smat.to(torch.int32), c["scales"],
                              i_transform_shift, dep_quant)
        else:
            deq = _dequant(levels, *dequant_params(qp, w, h, bit_depth,
                                                   dep_quant))
        # ---- inverse LFNST on the first 16 scan coefficients ----
        n = deq.shape[0]
        src = deq.reshape(n, -1)[:, c["scan16"].long()]
        out = _exact_dot("nij,nj->ni", kern.to(torch.int32),
                         src[:, :zero_out])
        out = torch.clamp((out + 64) >> 7, -(1 << 15), (1 << 15) - 1)
        tsel = trans.to(torch.bool)[:, None, None]
        deq = deq.clone()
        if sb == 4:
            blk = out.reshape(n, 4, 4)
            deq[:, :4, :4] = torch.where(tsel, blk.transpose(1, 2), blk)
        else:
            top = out[:, :32].reshape(n, 4, 8)
            bot = out[:, 32:48].reshape(n, 4, 4)
            norm = deq[:, :8, :8].clone()
            norm[:, :4, :8] = top
            norm[:, 4:8, :4] = bot
            tr8 = deq[:, :8, :8].clone()
            tr8[:, :8, :4] = top.transpose(1, 2)
            tr8[:, :4, 4:8] = bot.transpose(1, 2)
            deq[:, :8, :8] = torch.where(tsel, tr8, norm)
        tmp = _exact_dot("nkx,ky->nxy", deq, c["mv"])
        tmp = torch.clamp((tmp + (1 << (s1 - 1))) >> s1, clip_min, clip_max)
        blk = _exact_dot("nky,kx->nyx", tmp, c["mh"])
        return torch.clamp((blk + (1 << (s2 - 1))) >> s2, clip_min, clip_max)

    return run


# ---- ALF: the clipped diamond filter (AdaptiveLoopFilter::filterBlk) ----
_LUMA_TAPS = ((3, 0), (2, 1), (2, 0), (2, -1), (1, 2), (1, 1), (1, 0),
              (1, -1), (1, -2), (0, 3), (0, 2), (0, 1))
_CHROMA_TAPS = ((2, 0), (1, 1), (1, 0), (1, -1), (0, 2), (0, 1))


def _vb_row_tables(h: int, vb_ctu_h: int, vb_pos: int, chroma: bool):
    """Per-row clipped vertical tap distances + near-VB flag
    (frame/alf_np._vb_row_offsets, row by row)."""
    from vvdec_tpu_torch.frame.alf_np import _vb_row_offsets
    d = np.zeros((h, 4), dtype=np.int32)
    near = np.zeros(h, dtype=bool)
    for y in range(h):
        d1, d2, d3, nr = _vb_row_offsets(y, vb_ctu_h, vb_pos, chroma)
        d[y] = (0, d1, d2, d3)
        near[y] = nr
    return d, near


@functools.lru_cache(maxsize=None)
def _alf_diamond_dense_core(h: int, w: int, bd: int, n_taps: int,
                            vb_h: int, vb_pos: int, chroma: bool,
                            device: str):
    """Whole-frame clipped-diamond ALF (7x7 luma with n_taps=12, 5x5
    chroma with n_taps=6): apply(src, co, cl, mask) with per-pixel
    coefficients and clip bounds co / cl [h, w, n_taps].  Each tap pair
    reads src at rows y +- d(y) (the per-row virtual-boundary distance)
    and columns x +- dx, clamped to the picture: the row and column
    tables are built once per device.  Bit-exact int32 (parity:
    AdaptiveLoopFilter::filterBlk; the reference's dense core)."""
    taps = _LUMA_TAPS[:n_taps] if n_taps == 12 else _CHROMA_TAPS[:n_taps]
    pel_max = (1 << bd) - 1
    dmap, near = _vb_row_tables(h, vb_h, vb_pos, chroma)
    ys = np.arange(h)
    xs = np.arange(w)

    def t(a, hi):
        return torch.as_tensor(np.clip(a, 0, hi), dtype=torch.int64,
                               device=device)

    index = [(t(ys + dmap[:, dy], h - 1), t(xs + dx, w - 1),
              t(ys - dmap[:, dy], h - 1), t(xs - dx, w - 1))
             for dy, dx in taps]
    near_rows = torch.as_tensor(near[:, None], device=device)

    def apply(src, co, cl, mask):
        s = src.to(torch.int32)
        acc = torch.zeros_like(s)
        for k, (ra, ca, rb, cb) in enumerate(index):
            a = s.index_select(0, ra).index_select(1, ca)
            b = s.index_select(0, rb).index_select(1, cb)
            ck = cl[:, :, k]
            diff = torch.clamp(a - s, -ck, ck) + torch.clamp(b - s, -ck, ck)
            acc = acc + co[:, :, k] * diff
        out = torch.where(near_rows, (acc + (1 << 9)) >> 10, (acc + 64) >> 7)
        out = torch.clamp(out + s, 0, pel_max)
        return torch.where(mask, out, s).to(src.dtype)

    return apply


# ---- deblocking tables (LoopFilter.cpp; shared with deblock_dense) ----
_DB_TC = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 4, 4, 4, 4, 5,
    5, 5, 5, 7, 7, 8, 9, 10, 10, 11, 13, 14, 15, 17, 19, 21, 24, 25, 29, 33,
    36, 41, 45, 51, 57, 64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198,
    222, 250, 280, 314, 352, 395], dtype=np.int32)
_DB_BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78,
    80, 82, 84, 86, 88], dtype=np.int32)
# long-filter blend coefficients per length class (3/5/7) x position
_DB_DB = np.array([[53, 32, 11, 0, 0, 0, 0],
                   [58, 45, 32, 19, 6, 0, 0],
                   [59, 50, 41, 32, 23, 14, 5]], dtype=np.int32)
_DB_TCC = np.array([[6, 4, 2, 0, 0, 0, 0],
                    [6, 5, 4, 3, 2, 1, 1],
                    [6, 5, 4, 3, 2, 1, 1]], dtype=np.int32)
