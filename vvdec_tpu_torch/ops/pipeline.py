"""Batched reconstruction stages over torch tensors: dequant + inverse
transform (with transform skip and LFNST), SAO, ALF / CC-ALF and the
deblocking cell filters, each as whole-frame work on one device.

Port of vvdec_tpu/ops/pipeline.py.  The public names change `_jax` to
`_torch`:

  itx_frame_jax         -> itx_frame_torch
  reconstruct_frame_jax -> reconstruct_frame_torch
  sao_frame_jax         -> sao_frame_torch
  alf_frame_jax         -> alf_frame_torch
  deblock_frame_jax     -> deblock_frame_torch

and the cores keep their names and arguments.  Each entry point takes
`device=None`, resolved by device.resolve_device: CUDA unless the caller
asks for the CPU.  The filters' `_*_fn` jit wrappers have no
counterpart: a core here is already the function over tensors.  Each
`_*_fn` factory of the ITX stage returns a function over torch tensors
whose constants are placed on the input's device on first use.  Integer products go through
float64 (`_exact_dot`): CUDA has no int32 matmul and float32 is not
exact at these magnitudes.  Plain 2-D TU groups without a scaling list
go to the hand-written kernel through ops/cuda/itx.itx_batch_cuda, one
launch a group, where the reference sends them to Pallas; on CPU
tensors that wrapper runs its plain version.  The decoder's own ITX
stage (ops/frame_device.py) runs all such TUs of a frame in one launch
of the same kernel (itx_frame_cuda) instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.device import resolve_device
from vvdec_tpu_torch.ops import rom
from vvdec_tpu_torch.ops.cuda.itx import (
    _dequant,
    _exact_dot,
    dequant_params,
    itx_batch_cuda,
)
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
            dep_quant: bool, use_sl: bool = False):
    """Batched dequant + ITX for one TU shape: (levels [N,h,w] int32,
    qp [N] int32[, smat [h,w] int32]) -> residual [N,h,w] int32.

    With use_sl the per-coefficient scaling-list matrix multiplies the
    QP scale and the right shift grows by LOG2_SCALING_LIST_NEUTRAL_VALUE
    (Quant.cpp:335-338).  Without one, a 2-D shape runs the hand-written
    kernel through itx_batch_cuda.  A side of 1 (ISP subpartitions) is a
    1-D transform; only the matrix it uses is built (the reference builds
    both and raises on tr_matrix(kind, 1) before reaching its 1-D code)."""
    i_transform_shift, scale_tab = _shifts(h, w, bit_depth)
    mats = {}
    if h > 1:
        mats["mv"] = tr_matrix(tr_ver, h)
    if w > 1:
        mats["mh"] = tr_matrix(tr_hor, w)
    consts = _DeviceConsts(scales=scale_tab, **mats)
    s1 = 7
    s2 = (6 + MAX_LOG2_TR_RANGE - 1) - bit_depth
    clip_min = -(1 << MAX_LOG2_TR_RANGE)
    clip_max = (1 << MAX_LOG2_TR_RANGE) - 1

    if not use_sl and w > 1 and h > 1:
        def run_kernel(levels: torch.Tensor, qp: torch.Tensor,
                       smat=None) -> torch.Tensor:
            c = consts.on(levels.device)
            scale, rshift, imax = dequant_params(qp, w, h, bit_depth,
                                                 dep_quant)
            return itx_batch_cuda(levels.to(torch.int32).contiguous(),
                                  scale, rshift, imax, c["mv"], c["mh"],
                                  h=h, w=w, bit_depth=bit_depth)

        return run_kernel

    def run(levels: torch.Tensor, qp: torch.Tensor,
            smat: torch.Tensor | None = None) -> torch.Tensor:
        c = consts.on(levels.device)
        levels = levels.to(torch.int32)
        qp = qp.to(torch.int32)
        if use_sl:
            deq = _sl_dequant(levels, qp, smat.to(torch.int32), c["scales"],
                              i_transform_shift, dep_quant)
        else:
            deq = _dequant(levels, *dequant_params(qp, w, h, bit_depth,
                                                   dep_quant))
        if w > 1 and h > 1:
            tmp = _exact_dot("nkx,ky->nxy", deq, c["mv"])
            tmp = torch.clamp((tmp + (1 << (s1 - 1))) >> s1, clip_min,
                              clip_max)
            blk = _exact_dot("nky,kx->nyx", tmp, c["mh"])
            return torch.clamp((blk + (1 << (s2 - 1))) >> s2, clip_min,
                               clip_max)
        # 1-D transforms
        s = s2 + 1
        if w == 1:
            blk = _exact_dot("nk,ky->ny", deq[:, :, 0], c["mv"])
            res = torch.clamp((blk + (1 << (s - 1))) >> s, clip_min, clip_max)
            return res[:, :, None]
        blk = _exact_dot("nk,kx->nx", deq[:, 0, :], c["mh"])
        res = torch.clamp((blk + (1 << (s - 1))) >> s, clip_min, clip_max)
        return res[:, None, :]

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


def _readback(tensors) -> list[np.ndarray]:
    """Device tensors -> numpy arrays of the same shapes, in one copy
    (one synchronisation) when there is more than one."""
    if len(tensors) <= 1:
        return [t.cpu().numpy() for t in tensors]
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors]).cpu()
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[pos:pos + n].numpy().reshape(t.shape))
        pos += n
    return out


def itx_frame_torch(cs, device=None) -> list[np.ndarray]:
    """Stage 1 (dequant + inverse transform) for a whole frame on
    `device` (default CUDA; "cpu" on request).

    Returns per-component residual planes (int32 numpy, exact picture
    size) positioned at TU locations.  Grouping as in the reference:
    transform-skip / BDPCM TUs take the host dequant (recon_np
    .ts_residual); the others are grouped by (chroma, w, h, transform
    pair, scaling-list type, dep_quant[, LFNST sb, zero-out]).  LFNST
    groups run _itx_lfnst_fn, scaling-list and 1-D groups _itx_fn's
    PyTorch paths, and every plain 2-D group one itx_batch_cuda launch.
    The groups' inputs go up in one copy and the residuals come back in
    one (the frame's one synchronisation besides the ITX wrapper's own
    int8 check per launch)."""
    from vvdec_tpu_torch.frame.recon_np import (
        CHROMA422_MAP,
        co_located_luma_mode_of,
        get_tr_types,
        lfnst_params,
        scaling_matrix_for,
        ts_residual,
        tu_qp,
    )
    from vvdec_tpu_torch.frame.structure import (
        DM_CHROMA_IDX,
        MODE_INTRA,
        MTS_SKIP,
    )

    dev = resolve_device(device)

    def fm(cu_, comp_):
        if comp_ == 0:
            return cu_.intra_dir[0]
        m = cu_.intra_dir[1]
        if m == DM_CHROMA_IDX:
            m = co_located_luma_mode_of(cs, cu_)
        if cs.sps.chroma_format_idc == 2 and m < 67:
            m = CHROMA422_MAP[m]
        return m

    resi = [np.zeros((h, w), dtype=np.int32) for (w, h) in cs.comp_size]
    groups: dict[tuple, list] = {}
    for tu in cs.tus:
        cu = cs.cus[tu.cu_idx]
        comps = []
        if tu.blocks[0] is not None and tu.cbf[0]:
            comps.append(0)
        if tu.blocks[1] is not None:
            if tu.joint_cbcr:
                # joint Cb-Cr: only the coded plane runs the transform;
                # the other is derived during reconstruction
                comps.append(1 if (tu.joint_cbcr >> 1) else 2)
            else:
                comps += [c for c in (1, 2) if tu.cbf[c]]
        for comp in comps:
            x, y, w, h = tu.blocks[comp]
            if tu.mts_idx[comp] == MTS_SKIP:
                # transform skip / BDPCM: host dequant only (no matmul)
                resi[comp][y: y + h, x: x + w] = ts_residual(cs, tu, cu, comp)
                continue
            lf_prm = None
            if cu.lfnst_idx:
                lf_prm = lfnst_params(cs, tu, cu, comp, fm)
            hor, ver = get_tr_types(cs, tu, cu, comp)
            qp = tu_qp(cs, tu, cu, comp)
            if cs.scaling_list is not None:
                smat = scaling_matrix_for(cs, tu, cu, comp)
                lt = (0 if cu.pred_mode == MODE_INTRA else 3) + comp \
                    if smat is not None else None
            else:
                smat, lt = None, None
            dq = bool(cs.sh_of(cu).dep_quant_used)
            if lf_prm is not None:
                mat, transpose, sb, zero = lf_prm
                key = (comp != 0, w, h, hor, ver, lt, dq, sb, zero)
                groups.setdefault(key, []).append(
                    (comp, x, y, qp, smat, mat[:, :zero], transpose))
            else:
                key = (comp != 0, w, h, hor, ver, lt, dq)
                groups.setdefault(key, []).append((comp, x, y, qp, smat))
    if not groups:
        return resi

    # every group's levels, QPs, LFNST kernels and scaling matrix in one
    # int32 buffer, uploaded once and sliced on the device
    parts: list = []
    slots: list = []
    pos = 0

    def put(a) -> tuple:
        nonlocal pos
        a = np.ascontiguousarray(a, dtype=np.int32)
        parts.append(a.reshape(-1))
        pos += a.size
        return pos - a.size, a.shape

    for key, items in groups.items():
        w, h = key[1], key[2]
        levels = np.stack([cs.coef[it[0]][it[2]: it[2] + h, it[1]: it[1] + w]
                           for it in items])
        slot = [put(levels), put([it[3] for it in items])]
        if len(key) == 9:
            slot += [put(np.stack([it[5] for it in items])),
                     put([bool(it[6]) for it in items])]
        if key[5] is not None:
            slot.append(put(items[0][4]))
        slots.append(slot)
    buf = torch.from_numpy(np.concatenate(parts)).to(dev)

    def view(off_shape):
        off, shape = off_shape
        return buf[off: off + int(np.prod(shape))].view(shape)

    bd = cs.sps.bit_depth
    outs = []
    for (key, items), slot in zip(groups.items(), slots):
        (_, w, h, hor, ver, lt, dep_quant) = key[:7]
        args = [view(s) for s in slot]
        if len(key) == 9:
            fn = _itx_lfnst_fn(h, w, hor, ver, bd, dep_quant, key[7], key[8],
                               use_sl=lt is not None)
        else:
            fn = _itx_fn(h, w, hor, ver, bd, dep_quant, use_sl=lt is not None)
        outs.append(fn(*args))
    for (key, items), host in zip(groups.items(), _readback(outs)):
        for it, blk in zip(items, host):
            comp, x, y = it[0], it[1], it[2]
            bh, bw = blk.shape
            resi[comp][y: y + bh, x: x + bw] = blk
    return resi


def reconstruct_frame_torch(cs, device=None) -> list[np.ndarray]:
    """Frame reconstruction with stage 1 on `device`, intra/inter
    prediction on the host (recon_np.IntraReconstructor) and deblocking
    on `device`.  An inter picture needs the reference planes a decoder
    sets on cs."""
    from vvdec_tpu_torch.frame.recon_np import IntraReconstructor

    dev = resolve_device(device)
    resi = itx_frame_torch(cs, dev)
    planes = IntraReconstructor(cs, residual_planes=resi).run()
    deblock_frame_torch(cs, planes, dev)
    return planes


# ---- SAO: whole-frame classification and offsets ----
@functools.lru_cache(maxsize=None)
def _sao_apply_core(h: int, w: int, bd: int):
    """Whole-frame SAO: per-pixel edge classification for all four EO
    classes + band offset, parameter lookup via the per-pixel CTU index
    (parity: SampleAdaptiveOffset::offsetBlock_core, vectorized).
    apply(src, typ, ctu_idx, tables, mask) over [h, w] tensors and the
    [n_ctu, 37] table; all int32, bit-exact."""
    pel_max = (1 << bd) - 1
    band_shift = bd - 5

    def apply(src, typ, ctu_idx, tables, mask):
        c = src.to(torch.int32)
        dev = c.device
        rows = torch.clamp(torch.arange(-1, h + 1, device=dev), 0, h - 1)
        cols = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
        pad = c.index_select(0, rows).index_select(1, cols)
        n = [
            (pad[1:-1, :-2], pad[1:-1, 2:]),    # EO 0 deg
            (pad[:-2, 1:-1], pad[2:, 1:-1]),    # EO 90
            (pad[:-2, :-2], pad[2:, 2:]),       # EO 135
            (pad[:-2, 2:], pad[2:, :-2]),       # EO 45
        ]
        edges = [torch.sign(c - a) + torch.sign(c - b) + 2 for a, b in n]
        edge = edges[0]
        for t in range(1, 4):
            edge = torch.where(typ == t, edges[t], edge)
        band = c >> band_shift
        idx = torch.where(typ == 4, 5 + band, edge)
        n_ctu, n_idx = tables.shape
        off = tables[torch.clamp(ctu_idx.long(), 0, n_ctu - 1),
                     torch.clamp(idx.long(), 0, n_idx - 1)]
        out = torch.clamp(c + off, 0, pel_max)
        return torch.where(mask, out, c).to(src.dtype)

    return apply


def sao_frame_torch(cs, planes: list[np.ndarray], device=None) -> None:
    """In-place SAO with the pixel work on `device` (default CUDA);
    parameter maps built on the host (frame/sao_np.sao_prepare_maps)."""
    dev = resolve_device(device)
    if not any(s_.sao_enabled_luma or s_.sao_enabled_chroma
               for s_ in cs.shs):
        return
    from vvdec_tpu_torch.frame.sao_np import sao_prepare_maps
    bd = cs.sps.bit_depth
    done, outs = [], []
    for comp, maps in enumerate(sao_prepare_maps(cs)):
        if not maps[3].any():
            continue
        src, typ, ctu_idx, tables, mask = (
            torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (planes[comp].astype(np.int32), *maps))
        outs.append(_sao_apply_core(*planes[comp].shape, bd)(
            src, typ, ctu_idx, tables, mask))
        done.append(comp)
    for comp, out in zip(done, _readback(outs)):
        planes[comp][:] = out


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


def _window_gather(flat, ry, rx, lo_y, hi_y, lo_x, hi_x, h: int, w: int):
    """flat[ry, rx] of an [h, w] plane with (ry, rx) clamped to the
    per-pixel window [lo, hi] first and to the plane second (the
    reference's gather clamps out-of-range indices; PyTorch raises)."""
    ry = torch.clamp(torch.minimum(torch.maximum(ry, lo_y), hi_y), 0, h - 1)
    rx = torch.clamp(torch.minimum(torch.maximum(rx, lo_x), hi_x), 0, w - 1)
    return flat[(ry * w + rx).long()]


@functools.lru_cache(maxsize=None)
def _alf_diamond_core(h: int, w: int, bd: int, n_taps: int):
    """Clipped-diamond ALF filter (7x7 luma with n_taps=12, 5x5 chroma
    with n_taps=6): per-pixel coefficients/clips co / cl [h, w, n_taps],
    per-row virtual-boundary tap distances dmap [h, 4] and near-VB flags
    near [h], per-pixel sample clamp windows lo_x/lo_y/hi_x/hi_y [h, w].
    Bit-exact int32 (parity: AdaptiveLoopFilter::filterBlk)."""
    taps = _LUMA_TAPS[:n_taps] if n_taps == 12 else _CHROMA_TAPS[:n_taps]
    pel_max = (1 << bd) - 1

    def apply(src, co, cl, dmap, near, lo_x, lo_y, hi_x, hi_y, mask):
        s = src.to(torch.int32)
        flat = s.reshape(-1)
        ys = torch.arange(h, dtype=torch.int32, device=s.device)[:, None]
        xs = torch.arange(w, dtype=torch.int32, device=s.device)[None, :]
        acc = torch.zeros((h, w), dtype=torch.int32, device=s.device)
        for k, (dy, dx) in enumerate(taps):
            dd = dmap[:, dy][:, None]
            a = _window_gather(flat, ys + dd, xs + dx, lo_y, hi_y, lo_x,
                               hi_x, h, w)
            b = _window_gather(flat, ys - dd, xs - dx, lo_y, hi_y, lo_x,
                               hi_x, h, w)
            ck = cl[:, :, k]
            diff = torch.clamp(a - s, -ck, ck) + torch.clamp(b - s, -ck, ck)
            acc = acc + co[:, :, k] * diff
        nr = near[:, None]
        out = torch.where(nr, (acc + (1 << 9)) >> 10, (acc + 64) >> 7)
        out = torch.clamp(out + s, 0, pel_max)
        return torch.where(mask, out, s).to(src.dtype)

    return apply


@functools.lru_cache(maxsize=None)
def _ccalf_core(hc: int, wc: int, bd: int, scale_x: int, scale_y: int):
    """CC-ALF correction from the pre-ALF luma (filterBlkCcAlf,
    AdaptiveLoopFilter.cpp:1348): coeff [hc, wc, 7], off_rows [hc, 3]
    (off1, off2, off3), skip_rows [hc], luma-coordinate clamp windows
    gathered at each chroma pixel, active [hc, wc]."""
    pel_max = (1 << bd) - 1
    half = (1 << bd) >> 1

    def apply(luma, dst, coeff, off_rows, skip_rows, lo_x, lo_y, hi_x,
              hi_y, active):
        sl = luma.to(torch.int32)
        lh, lw = sl.shape
        flat = sl.reshape(-1)
        ys = torch.arange(hc, dtype=torch.int32, device=sl.device)[:, None]
        xs = torch.arange(wc, dtype=torch.int32, device=sl.device)[None, :]
        ly = ys << scale_y
        lx = xs << scale_x

        def lat(ry, rx):
            return _window_gather(flat, ry, rx, lo_y, hi_y, lo_x, hi_x,
                                  lh, lw)

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
        acc = torch.clamp(acc + half, 0, pel_max) - half
        d = dst.to(torch.int32)
        out = torch.clamp(acc + d, 0, pel_max)
        use = active & ~skip_rows[:, None]
        return torch.where(use, out, d).to(dst.dtype)

    return apply


def alf_frame_torch(cs, planes: list[np.ndarray], device=None
                    ) -> list[np.ndarray]:
    """Whole-frame ALF and CC-ALF with the pixel work on `device`
    (default CUDA; m_alfBuf swap semantics: returns new planes, CC-ALF
    reads the pre-ALF luma); parameter maps built on the host
    (alf_np.alf_prepare_maps), per-pixel coefficients and clips expanded
    from its 4x4 maps there."""
    from vvdec_tpu_torch.frame.alf_np import alf_prepare_maps
    dev = resolve_device(device)
    bd = cs.sps.bit_depth
    maps = alf_prepare_maps(cs, planes, bd)
    if maps is None:
        return planes
    vb_luma_h, vb_luma_pos, vb_chma_h, vb_chma_pos = maps["vb"]
    out = [p.copy() for p in planes]

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def per_pixel(a4, n, hh, ww):
        return np.repeat(np.repeat(a4[:, :, :n], 4, 0), 4, 1)[:hh, :ww] \
            .astype(np.int32)

    luma = up(planes[0].astype(np.int32))
    done, outs = [], []
    if maps["any_luma"]:
        h, w = planes[0].shape
        sets, tr4, cls4 = maps["set_map"], maps["tr"], maps["cls"]
        co = per_pixel(maps["banks_co"][sets, tr4, cls4], 12, h, w)
        cl = per_pixel(maps["banks_cl"][sets, tr4, cls4], 12, h, w)
        dmap, near = _vb_row_tables(h, vb_luma_h, vb_luma_pos, False)
        fn = _alf_diamond_core(h, w, bd, 12)
        outs.append(fn(luma, *map(up, (
            co, cl, dmap, near, maps["lo_x"], maps["lo_y"], maps["hi_x"],
            maps["hi_y"], maps["mask_y"]))))
        done.append(0)

    if cs.num_comp > 1 and (maps["any_chroma"] or maps["any_cc"]):
        hc, wc = planes[1].shape
        dmap_c, near_c = _vb_row_tables(hc, vb_chma_h, vb_chma_pos, True)
        for comp in (1, 2):
            cur = None
            if maps["any_chroma"] and maps["mask_c"][comp - 1].any():
                alt4 = maps["chroma_alt"][comp - 1]
                co = per_pixel(maps["chroma_co"][alt4], 6, hc, wc)
                cl = per_pixel(maps["chroma_cl"][alt4], 6, hc, wc)
                fn = _alf_diamond_core(hc, wc, bd, 6)
                cur = fn(up(planes[comp].astype(np.int32)), *map(up, (
                    co, cl, dmap_c, near_c, maps["lo_xc"], maps["lo_yc"],
                    maps["hi_xc"], maps["hi_yc"], maps["mask_c"][comp - 1])))
            if maps["any_cc"] and (maps["cc_idx"][comp - 1] != 0).any():
                coeff = maps["cc_banks"][maps["cc_idx"][comp - 1]] \
                    .astype(np.int32)
                scale_x, scale_y = cs.sub_w - 1, cs.sub_h - 1
                # luma-coord clamp windows gathered at each chroma pixel's
                # collocated luma position
                lyi = (np.arange(hc) << scale_y)[:, None]
                lxi = (np.arange(wc) << scale_x)[None, :]
                windows = [maps[k][lyi, lxi]
                           for k in ("lo_x", "lo_y", "hi_x", "hi_y")]
                off_rows = np.zeros((hc, 3), dtype=np.int32)
                skip_rows = np.zeros(hc, dtype=bool)
                for y in range(hc):
                    ly = y << scale_y
                    pos = ly & (vb_luma_h - 1)
                    if scale_y == 0 and pos in (vb_luma_pos,
                                                vb_luma_pos + 1):
                        skip_rows[y] = True
                        continue
                    o1, o2, o3 = 1, -1, 2
                    if pos in (vb_luma_pos - 2, vb_luma_pos + 1):
                        o3 = o1
                    elif pos in (vb_luma_pos - 1, vb_luma_pos):
                        o1 = o2 = o3 = 0
                    off_rows[y] = (o1, o2, o3)
                if cur is None:
                    cur = up(out[comp].astype(np.int32))
                fn = _ccalf_core(hc, wc, bd, scale_x, scale_y)
                cur = fn(luma, cur, *map(up, (
                    coeff, off_rows, skip_rows, *windows,
                    maps["cc_idx"][comp - 1] != 0)))
            if cur is not None:
                outs.append(cur)
                done.append(comp)
    for comp, host in zip(done, _readback(outs)):
        out[comp] = host.astype(planes[comp].dtype)
    return out


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


# ---- deblocking: batched edge cells ----
# VVC guarantees per-direction non-overlap of deblocking operations, so
# each direction's active 4-sample edge cells are processed as one batch:
# gather 4x16 windows, run the decision tree + all filter variants
# vectorized over cells, scatter the selected results back
# (parity: the cell kernels in native/cabac.c / LoopFilter.cpp).
def _db_round(a, s):
    return (a + (1 << (s - 1))) >> s


def _scatter_cells(flat, idx, val):
    """flat[idx] = val for the written samples of one direction's cells:
    index_put_ without accumulate on the selected flat indices only.
    The indices are distinct (deblocking writes of one direction do not
    overlap), which keeps the result deterministic on CUDA."""
    flat.index_put_((idx,), val)


def _window_scatter(p32, ryc, rxc, win, new_win, wmask, H: int, W: int):
    """The plane with the cells' written window samples replaced."""
    flat = p32.reshape(-1).clone()
    do = wmask.reshape(-1)
    idx = (ryc * W + rxc).reshape(-1)[do].long()
    _scatter_cells(flat, idx, torch.where(wmask, new_win, win).reshape(-1)[do])
    return flat.reshape(H, W)


def _col(v, like):
    """A python bool as a bool tensor shaped like `like`."""
    return torch.full_like(like, bool(v), dtype=torch.bool)


@functools.lru_cache(maxsize=None)
def _deblock_luma_cells_core(H: int, W: int, direction: int, bd: int,
                             ctu_size: int, n_pad: int):
    """Batched luma edge-cell filter for one direction (xEdgeFilterLuma,
    reference LoopFilter.cpp:851-1070; all active 4-line cells run as
    one gather / filter / masked scatter).

    cells: [N,2] (x, y) luma positions of the 4-line edge segments;
    params: [N,6] (bs, qp, max_fl_p, max_fl_q, tc_off, beta_off); entries
    beyond n_valid have bs == 0 and are not written."""
    pel_max = (1 << bd) - 1

    def apply(plane, cells, params, n_valid):
        N = n_pad
        p32 = plane.to(torch.int32)
        dev = p32.device
        i32 = dict(dtype=torch.int32, device=dev)
        cells = cells.to(torch.int32)
        params = params.to(torch.int32)
        xs = cells[:, 0]
        ys = cells[:, 1]
        lines = torch.arange(4, **i32)
        ks = torch.arange(-8, 8, **i32)
        if direction == 0:
            ry = (ys[:, None, None] + lines[None, :, None]).expand(N, 4, 16)
            rx = (xs[:, None, None] + ks[None, None, :]).expand(N, 4, 16)
        else:
            ry = (ys[:, None, None] + ks[None, None, :]).expand(N, 4, 16)
            rx = (xs[:, None, None] + lines[None, :, None]).expand(N, 4, 16)
        ryc = torch.clamp(ry, 0, H - 1)
        rxc = torch.clamp(rx, 0, W - 1)
        # win[:, line, 8 + k] = cget(line, k)
        win = p32.reshape(-1)[(ryc * W + rxc).long()]
        arange_n = torch.arange(N, device=dev)

        def g(line, k):
            return win[:, line, 8 + k]

        def at(line, k):
            """win[n, line, 8 + k[n]] with k clipped to the window."""
            return win[arange_n, line, (8 + torch.clamp(k, -8, 7)).long()]

        bs = params[:, 0]
        qp = params[:, 1]
        mfp = params[:, 2]
        mfq = params[:, 3]
        tc_off = params[:, 4]
        beta_off = params[:, 5]
        sp_large = mfp > 3
        sq_large = mfq > 3
        if direction == 1:
            sp_large = sp_large & ((ys & (ctu_size - 1)) != 0)

        idx_tc = torch.clamp(qp + 2 * (bs - 1) + 2 * tc_off, 0, 65).long()
        idx_b = torch.clamp(qp + 2 * beta_off, 0, 63).long()
        tc_tab = torch.as_tensor(_DB_TC, device=dev)
        if bd >= 10:
            tc = tc_tab[idx_tc] << (bd - 10)
        else:
            tc = (tc_tab[idx_tc] + (1 << (9 - bd))) >> (10 - bd)
        beta = torch.as_tensor(_DB_BETA, device=dev)[idx_b] << (bd - 8)
        side_thresh = (beta + (beta >> 1)) >> 3
        thr_cut = tc * 10
        inactive = (beta == 0) & (tc == 0)

        def calc_dp(line, base):
            return torch.abs(g(line, base - 3) - 2 * g(line, base - 2)
                             + g(line, base - 1))

        def calc_dq(line, base):
            return torch.abs(g(line, base) - 2 * g(line, base + 1)
                             + g(line, base + 2))

        dp0, dq0 = calc_dp(0, 0), calc_dq(0, 0)
        dp3, dq3 = calc_dp(3, 0), calc_dq(3, 0)
        d0, d3 = dp0 + dq0, dp3 + dq3

        # large-side decision (use_strong with use_large)
        def use_strong_large(line, d2):
            m3, m4 = g(line, -1), g(line, 0)
            ok0 = (d2 < (beta >> 2)) & (torch.abs(m3 - m4)
                                        < ((tc * 5 + 1) >> 1))
            m0, m7 = g(line, -4), g(line, 3)
            sp3 = torch.abs(m0 - m3)
            sq3 = torch.abs(m7 - m4)
            # P side
            mp4 = at(line, -mfp - 1)
            sp3_7 = sp3 + torch.abs(g(line, -5) - g(line, -6) - g(line, -7)
                                    + mp4)
            sp3l = torch.where(mfp == 7, sp3_7, sp3)
            sp3l = (sp3l + torch.abs(m0 - mp4) + 1) >> 1
            sp3 = torch.where(sp_large, sp3l, sp3)
            # Q side
            m11 = at(line, mfq)
            sq3_7 = sq3 + torch.abs(g(line, 4) - g(line, 5) - g(line, 6)
                                    + m11)
            sq3l = torch.where(mfq == 7, sq3_7, sq3)
            sq3l = (sq3l + torch.abs(m11 - m7) + 1) >> 1
            sq3 = torch.where(sq_large, sq3l, sq3)
            return ok0 & ((sp3 + sq3) < (beta * 3 >> 5)) \
                & (d2 < (beta >> 4)) \
                & (torch.abs(m3 - m4) < ((tc * 5 + 1) >> 1))

        dp0l = torch.where(sp_large, (dp0 + calc_dp(0, -3) + 1) >> 1, dp0)
        dq0l = torch.where(sq_large, (dq0 + calc_dq(0, 3) + 1) >> 1, dq0)
        dp3l = torch.where(sp_large, (dp3 + calc_dp(3, -3) + 1) >> 1, dp3)
        dq3l = torch.where(sq_large, (dq3 + calc_dq(3, 3) + 1) >> 1, dq3)
        d0l, d3l = dp0l + dq0l, dp3l + dq3l
        sw_l = (sp_large | sq_large) & ((d0l + d3l) < beta) \
            & use_strong_large(0, 2 * d0l) & use_strong_large(3, 2 * d3l)

        # ---- long bilinear filter (per line, both sides up to 7) ----
        n_p = torch.where(sp_large, mfp, 3)
        n_q = torch.where(sq_large, mfq, 3)
        np_cls = torch.clamp((n_p - 3) >> 1, 0, 2).long()  # 3/5/7 -> 0/1/2
        nq_cls = torch.clamp((n_q - 3) >> 1, 0, 2).long()
        pos7 = torch.arange(7, **i32)[None, :]
        pos8 = torch.arange(8, **i32)[None, :]
        db_db = torch.as_tensor(_DB_DB, device=dev)
        db_tcc = torch.as_tensor(_DB_TCC, device=dev)

        def side_val(line, is_p):
            k = -1 - pos8 if is_p else pos8
            return win[arange_n[:, None], line,
                       (8 + torch.clamp(k, -8, 7)).long()]

        def pick8(v8, i):
            return v8[arange_n, torch.clamp(i, 0, 7).long()]

        def long_filter_line(line):
            P8 = side_val(line, True)   # [N, 8]; P8[:, k] = P(k)
            Q8 = side_val(line, False)
            P, Q = P8[:, :7], Q8[:, :7]
            # endpoint reference: (P(n_p-1) + P(n_p) + 1) >> 1 - P(7) is
            # offset -8, inside the 16-wide window
            ref_p = (pick8(P8, n_p - 1) + pick8(P8, n_p) + 1) >> 1
            ref_q = (pick8(Q8, n_q - 1) + pick8(Q8, n_q) + 1) >> 1
            # middle reference, 5 variants
            rm_55 = (2 * (P[:, 0] + Q[:, 0] + P[:, 1] + Q[:, 1]
                          + P[:, 2] + Q[:, 2])
                     + P[:, 3] + Q[:, 3] + P[:, 4] + Q[:, 4] + 8) >> 4
            rm_77 = (2 * (P[:, 0] + Q[:, 0]) + P[:, 1] + Q[:, 1]
                     + P[:, 2] + Q[:, 2] + P[:, 3] + Q[:, 3]
                     + P[:, 4] + Q[:, 4] + P[:, 5] + Q[:, 5]
                     + P[:, 6] + Q[:, 6] + 8) >> 4
            rm_75 = (2 * (P[:, 0] + Q[:, 0] + P[:, 1] + Q[:, 1])
                     + P[:, 2] + Q[:, 2] + P[:, 3] + Q[:, 3]
                     + P[:, 4] + Q[:, 4] + P[:, 5] + Q[:, 5] + 8) >> 4
            # 7 & 3 with pl = larger side, ql = smaller side
            q_larger = (n_q > n_p)[:, None]
            pl = torch.where(q_larger, Q, P)
            ql = torch.where(q_larger, P, Q)
            rm_73 = (2 * (pl[:, 0] + ql[:, 0]) + ql[:, 0]
                     + 2 * (ql[:, 1] + ql[:, 2]) + pl[:, 1] + ql[:, 1]
                     + pl[:, 2] + pl[:, 3] + pl[:, 4] + pl[:, 5]
                     + pl[:, 6] + 8) >> 4
            rm_53 = (P[:, 0] + Q[:, 0] + P[:, 1] + Q[:, 1] + P[:, 2]
                     + Q[:, 2] + P[:, 3] + Q[:, 3] + 4) >> 3
            n_l = torch.maximum(n_p, n_q)
            n_s = torch.minimum(n_p, n_q)
            ref_m = torch.where(
                (n_p == n_q) & (n_p == 5), rm_55,
                torch.where((n_p == n_q), rm_77,
                            torch.where((n_l == 7) & (n_s == 5), rm_75,
                                        torch.where((n_l == 7) & (n_s == 3),
                                                    rm_73, rm_53))))
            dbp = db_db[np_cls]     # [N, 7]
            dbq = db_db[nq_cls]
            cvp = (tc[:, None] * db_tcc[np_cls]) >> 1
            cvq = (tc[:, None] * db_tcc[nq_cls]) >> 1
            valp = (ref_m[:, None] * dbp + ref_p[:, None] * (64 - dbp)
                    + 32) >> 6
            valq = (ref_m[:, None] * dbq + ref_q[:, None] * (64 - dbq)
                    + 32) >> 6
            newp = torch.maximum(P - cvp, torch.minimum(P + cvp, valp))
            newq = torch.maximum(Q - cvq, torch.minimum(Q + cvq, valq))
            usep = pos7 < n_p[:, None]
            useq = pos7 < n_q[:, None]
            return newp, newq, usep, useq

        # ---- regular decisions ----
        dp, dq, d = dp0 + dp3, dq0 + dq3, d0 + d3
        filt_pq = (mfp > 1) & (mfq > 1)
        filter_p = filt_pq & (dp < side_thresh)
        filter_q = filt_pq & (dq < side_thresh)

        def use_strong_small(line, d2):
            m3, m4 = g(line, -1), g(line, 0)
            ok0 = (d2 < (beta >> 2)) & (torch.abs(m3 - m4)
                                        < ((tc * 5 + 1) >> 1))
            m0, m7 = g(line, -4), g(line, 3)
            return ok0 & ((torch.abs(m0 - m3) + torch.abs(m7 - m4))
                          < (beta >> 3))

        sw = (mfp > 2) & (mfq > 2) & use_strong_small(0, 2 * d0) \
            & use_strong_small(3, 2 * d3)

        # ---- per-line regular filters (strong + weak) ----
        def regular_line(line):
            m0, m1, m2 = g(line, -4), g(line, -3), g(line, -2)
            m3, m4 = g(line, -1), g(line, 0)
            m5, m6, m7 = g(line, 1), g(line, 2), g(line, 3)

            def c3(v, ref, t):
                return torch.maximum(ref - t, torch.minimum(ref + t, v))
            s_m1 = c3((2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3, m1, tc)
            s_m2 = c3((m1 + m2 + m3 + m4 + 2) >> 2, m2, 2 * tc)
            s_m3 = c3((m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3, m3,
                      3 * tc)
            s_m4 = c3((m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3, m4,
                      3 * tc)
            s_m5 = c3((m3 + m4 + m5 + m6 + 2) >> 2, m5, 2 * tc)
            s_m6 = c3((m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3, m6, tc)

            delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
            wk_on = torch.abs(delta) < thr_cut
            dcl = torch.clamp(delta, -tc, tc)
            tc2 = tc >> 1
            w_m3 = torch.clamp(m3 + dcl, 0, pel_max)
            w_m4 = torch.clamp(m4 - dcl, 0, pel_max)
            d1 = torch.clamp((((m1 + m3 + 1) >> 1) - m2 + dcl) >> 1, -tc2,
                             tc2)
            w_m2 = torch.clamp(m2 + d1, 0, pel_max)
            d2_ = torch.clamp((((m6 + m4 + 1) >> 1) - m5 - dcl) >> 1, -tc2,
                              tc2)
            w_m5 = torch.clamp(m5 + d2_, 0, pel_max)
            # outputs at offsets -3..2: (value, written) per variant
            strong_vals = torch.stack([s_m1, s_m2, s_m3, s_m4, s_m5, s_m6],
                                      dim=-1)
            weak_vals = torch.stack(
                [m1, torch.where(filter_p, w_m2, m2), w_m3, w_m4,
                 torch.where(filter_q, w_m5, m5), m6], dim=-1)
            no = torch.zeros_like(wk_on)
            weak_write = torch.stack(
                [no, wk_on & filter_p, wk_on, wk_on, wk_on & filter_q, no],
                dim=-1)
            vals = torch.where(sw[:, None], strong_vals, weak_vals)
            write = sw[:, None] | weak_write
            return vals, write

        # assemble final per-sample window updates [N, 4, 16]
        new_win = win.clone()
        wmask = torch.zeros((N, 4, 16), dtype=torch.bool, device=dev)
        reg_ok = (~sw_l) & (d < beta)
        for line in range(4):
            lp, lq, up, uq = long_filter_line(line)
            rv, rw = regular_line(line)
            # long: offsets -1-pos (p) and +pos (q)
            for pos in range(7):
                kp = 8 + (-1 - pos)
                kq = 8 + pos
                sel_p = sw_l & up[:, pos]
                sel_q = sw_l & uq[:, pos]
                new_win[:, line, kp] = torch.where(sel_p, lp[:, pos],
                                                   new_win[:, line, kp])
                new_win[:, line, kq] = torch.where(sel_q, lq[:, pos],
                                                   new_win[:, line, kq])
                wmask[:, line, kp] |= sel_p
                wmask[:, line, kq] |= sel_q
            for j, k in enumerate(range(8 - 3, 8 + 3)):
                sel = reg_ok & rw[:, j]
                new_win[:, line, k] = torch.where(sel, rv[:, j],
                                                  new_win[:, line, k])
                wmask[:, line, k] |= sel

        valid = (arange_n < n_valid) & (bs > 0) & (~inactive)
        wmask &= valid[:, None, None]
        return _window_scatter(p32, ryc, rxc, win, new_win, wmask, H,
                               W).to(plane.dtype)

    return apply


@functools.lru_cache(maxsize=None)
def _deblock_chroma_cells_core(H: int, W: int, direction: int, bd: int,
                               loop_len: int, sub_shift: int, n_pad: int):
    """Batched chroma edge-cell filter (xEdgeFilterChroma, reference
    LoopFilter.cpp:1072-1210; parity with the host C cell kernel
    mod_deblock_chroma).
    params: [N,6] (bs, qp, large, tc_off, beta_off, hor_ctb)."""
    pel_max = (1 << bd) - 1

    def apply(plane, cells, params, n_valid):
        N = n_pad
        p32 = plane.to(torch.int32)
        dev = p32.device
        cells = cells.to(torch.int32)
        params = params.to(torch.int32)
        xs = cells[:, 0]
        ys = cells[:, 1]
        lines = torch.arange(loop_len, dtype=torch.int32, device=dev)
        ks = torch.arange(-4, 4, dtype=torch.int32, device=dev)
        if direction == 0:
            ry = (ys[:, None, None] + lines[None, :, None]) \
                .expand(N, loop_len, 8)
            rx = (xs[:, None, None] + ks[None, None, :]) \
                .expand(N, loop_len, 8)
        else:
            ry = (ys[:, None, None] + ks[None, None, :]) \
                .expand(N, loop_len, 8)
            rx = (xs[:, None, None] + lines[None, :, None]) \
                .expand(N, loop_len, 8)
        ryc = torch.clamp(ry, 0, H - 1)
        rxc = torch.clamp(rx, 0, W - 1)
        # win[:, l, 4 + k] = cget(l, k)
        win = p32.reshape(-1)[(ryc * W + rxc).long()]

        def g(line, k):
            return win[:, line, 4 + k]

        bs = params[:, 0]
        qp = params[:, 1]
        large = params[:, 2] != 0
        tc_off = params[:, 3]
        beta_off = params[:, 4]
        hor_ctb = params[:, 5] != 0

        idx_tc = torch.clamp(qp + 2 * (bs - 1) + 2 * tc_off, 0, 65).long()
        tc_tab = torch.as_tensor(_DB_TC, device=dev)
        if bd >= 10:
            tc = tc_tab[idx_tc] << (bd - 10)
        else:
            tc = (tc_tab[idx_tc] + (1 << (9 - bd))) >> (10 - bd)
        inactive = (tc == 0) & (~large)

        idx_b = torch.clamp(qp + 2 * beta_off, 0, 63).long()
        beta = torch.as_tensor(_DB_BETA, device=dev)[idx_b] << (bd - 8)
        line3 = 1 if sub_shift == 1 else 3

        def calc_dp(line):
            return torch.where(hor_ctb,
                               torch.abs(g(line, -2) - 2 * g(line, -2)
                                         + g(line, -1)),
                               torch.abs(g(line, -3) - 2 * g(line, -2)
                                         + g(line, -1)))

        def calc_dq(line):
            return torch.abs(g(line, 0) - 2 * g(line, 1) + g(line, 2))

        def chroma_strong(line, d2):
            m3, m4 = g(line, -1), g(line, 0)
            ok0 = (d2 < (beta >> 2)) & (torch.abs(m3 - m4)
                                        < ((tc * 5 + 1) >> 1))
            m0, m7 = g(line, -4), g(line, 3)
            m2 = g(line, -2)
            sp3 = torch.where(hor_ctb, torch.abs(m2 - m3),
                              torch.abs(m0 - m3))
            sq3 = torch.abs(m7 - m4)
            return ok0 & ((sp3 + sq3) < (beta >> 3))

        d0 = calc_dp(0) + calc_dq(0)
        d3 = calc_dp(line3) + calc_dq(line3)
        sw = large & ((d0 + d3) < beta) & chroma_strong(0, 2 * d0) \
            & chroma_strong(line3, 2 * d3)

        new_win = win.clone()
        wmask = torch.zeros_like(win, dtype=torch.bool)
        write_h = (False, False, True, True, True, True)
        write_f = (True, True, True, True, True, True)
        write_w = (False, False, True, True, False, False)
        for line in range(loop_len):
            m0, m1, m2 = g(line, -4), g(line, -3), g(line, -2)
            m3, m4 = g(line, -1), g(line, 0)
            m5, m6, m7 = g(line, 1), g(line, 2), g(line, 3)

            def c3(v, ref):
                return torch.maximum(ref - tc, torch.minimum(ref + tc, v))
            # strong, hor_ctb variant (writes -1..2)
            h_m3 = c3((3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3)
            h_m4 = c3((2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4)
            h_m5 = c3((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5)
            h_m6 = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6)
            # strong, full variant (writes -3..2)
            f_m1 = c3((3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3, m1)
            f_m2 = c3((2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3, m2)
            f_m3 = c3((m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3)
            f_m4 = c3((m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4)
            f_m5 = c3((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5)
            f_m6 = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6)
            # weak (writes -1, 0)
            delta = torch.clamp(((m4 - m3) * 4 + m2 - m5 + 4) >> 3, -tc, tc)
            w_m3 = torch.clamp(m3 + delta, 0, pel_max)
            w_m4 = torch.clamp(m4 - delta, 0, pel_max)

            offs = (-3, -2, -1, 0, 1, 2)
            strong_h = (m1, m2, h_m3, h_m4, h_m5, h_m6)
            strong_f = (f_m1, f_m2, f_m3, f_m4, f_m5, f_m6)
            weak = (m1, m2, w_m3, w_m4, m5, m6)
            for j, k in enumerate(offs):
                sv = torch.where(hor_ctb, strong_h[j], strong_f[j])
                sm = torch.where(hor_ctb, _col(write_h[j], hor_ctb),
                                 _col(write_f[j], hor_ctb))
                val = torch.where(sw, sv, weak[j])
                wm = torch.where(sw, sm, _col(write_w[j], sw))
                new_win[:, line, 4 + k] = torch.where(
                    wm, val, new_win[:, line, 4 + k])
                wmask[:, line, 4 + k] |= wm

        valid = (torch.arange(N, device=dev) < n_valid) & (bs > 0) \
            & (~inactive)
        wmask &= valid[:, None, None]
        return _window_scatter(p32, ryc, rxc, win, new_win, wmask, H,
                               W).to(plane.dtype)

    return apply


def _pad_pow2(n: int, lo: int = 64) -> int:
    m = lo
    while m < n:
        m <<= 1
    return m


def deblock_frame_torch(cs, planes: list[np.ndarray], device=None) -> None:
    """In-place deblocking: strength derivation on the host
    (deblock_np.Deblocker, native) and the per-direction cell filtering
    on `device` (default CUDA), with per-slice offsets when the picture
    has more than one slice.  The planes go up once and come back once."""
    from vvdec_tpu_torch.frame.deblock_np import Deblocker
    dev = resolve_device(device)
    if all(s.deblocking_disabled for s in cs.shs):
        return
    db = Deblocker(cs, planes)
    db.derive_strengths()
    bd = cs.sps.bit_depth
    multi = len(cs.shs) > 1
    dplanes = [torch.as_tensor(np.ascontiguousarray(p, dtype=np.int32),
                               device=dev) for p in planes[:cs.num_comp]]
    for dir_ in (0, 1):
        ep = db.edges[dir_]
        cells4 = np.argwhere(ep.bs_y > 0)
        if len(cells4):
            ys4, xs4 = cells4[:, 0], cells4[:, 1]
            n = len(cells4)
            n_pad = _pad_pow2(n)
            cells = np.zeros((n_pad, 2), dtype=np.int32)
            cells[:n, 0] = xs4 * 4
            cells[:n, 1] = ys4 * 4
            prm = np.zeros((n_pad, 6), dtype=np.int32)
            prm[:n, 0] = ep.bs_y[ys4, xs4]
            prm[:n, 1] = ep.qp_y[ys4, xs4]
            prm[:n, 2] = ep.max_fl_p[ys4, xs4]
            prm[:n, 3] = ep.max_fl_q[ys4, xs4]
            if not multi:
                prm[:n, 4] = cs.sh.tc_offset_div2
                prm[:n, 5] = cs.sh.beta_offset_div2
            else:
                si = np.clip(cs.slice_map[ys4, xs4], 0, len(cs.shs) - 1)
                prm[:n, 4] = np.array([s_.tc_offset_div2
                                       for s_ in cs.shs])[si]
                prm[:n, 5] = np.array([s_.beta_offset_div2
                                       for s_ in cs.shs])[si]
            fn = _deblock_luma_cells_core(planes[0].shape[0],
                                          planes[0].shape[1], dir_, bd,
                                          cs.sps.ctu_size, n_pad)
            dplanes[0] = fn(dplanes[0], torch.as_tensor(cells, device=dev),
                            torch.as_tensor(prm, device=dev), n)
        if cs.num_comp > 1:
            _deblock_chroma_dir_torch(cs, db, dplanes, dir_, bd, multi)
    for p, host in zip(planes, _readback(dplanes)):
        p[:] = host


def _deblock_chroma_dir_torch(cs, db, dplanes, dir_, bd, multi):
    """Chroma cell assembly (mirrors Deblocker._filter_chroma's native
    table) + the cell filter on the planes' device."""
    ep = db.edges[dir_]
    sh = cs.sh
    sub_w, sub_h = cs.sub_w, cs.sub_h
    cw, chh = cs.comp_size[1]
    perp_step = 8
    par_step = 4 // sub_h if dir_ == 0 else 4 // sub_w
    sub_shift = sub_h - 1 if dir_ == 0 else sub_w - 1
    ctu_c_mask = (cs.sps.ctu_size // cs.sub_h) - 1
    c0s = np.arange(perp_step, (cw if dir_ == 0 else chh), perp_step)
    c1s = np.arange(0, (chh if dir_ == 0 else cw), par_step)
    if len(c0s) == 0 or len(c1s) == 0:
        return
    if dir_ == 0:
        ccx_g = np.broadcast_to(c0s[None, :], (len(c1s), len(c0s)))
        ccy_g = np.broadcast_to(c1s[:, None], (len(c1s), len(c0s)))
    else:
        ccx_g = np.broadcast_to(c1s[:, None], (len(c1s), len(c0s)))
        ccy_g = np.broadcast_to(c0s[None, :], (len(c1s), len(c0s)))
    cx4_g = (ccx_g * sub_w) >> 2
    cy4_g = (ccy_g * sub_h) >> 2
    bs_cb_g = ep.bs_cb[cy4_g, cx4_g]
    bs_cr_g = ep.bs_cr[cy4_g, cx4_g]
    mask = (bs_cb_g > 0) | (bs_cr_g > 0)
    if not mask.any():
        return
    ccx_a = ccx_g[mask].astype(np.int32)
    ccy_a = ccy_g[mask].astype(np.int32)
    cx4_a = cx4_g[mask]
    cy4_a = cy4_g[mask]
    hor_ctb = ((dir_ == 1) & ((ccy_a & ctu_c_mask) == 0)).astype(np.int32)
    if multi:
        si = np.clip(cs.slice_map[cy4_a, cx4_a], 0, len(cs.shs) - 1)
    dev = dplanes[0].device
    for comp in (1, 2):
        bs_col = (bs_cb_g if comp == 1 else bs_cr_g)[mask]
        large_col = ep.cmfl[cy4_a, cx4_a]
        sel = (bs_col == 2) | ((large_col != 0) & (bs_col == 1))
        if not sel.any():
            continue
        n = int(sel.sum())
        n_pad = _pad_pow2(n)
        cells = np.zeros((n_pad, 2), dtype=np.int32)
        cells[:n, 0] = ccx_a[sel]
        cells[:n, 1] = ccy_a[sel]
        prm = np.zeros((n_pad, 6), dtype=np.int32)
        prm[:n, 0] = bs_col[sel]
        prm[:n, 1] = (ep.qp_cb if comp == 1 else ep.qp_cr)[cy4_a, cx4_a][sel]
        prm[:n, 2] = large_col[sel]
        if not multi:
            prm[:n, 3] = sh.cb_tc_offset_div2 if comp == 1 \
                else sh.cr_tc_offset_div2
            prm[:n, 4] = sh.cb_beta_offset_div2 if comp == 1 \
                else sh.cr_beta_offset_div2
        else:
            attr_tc = "cb_tc_offset_div2" if comp == 1 \
                else "cr_tc_offset_div2"
            attr_b = "cb_beta_offset_div2" if comp == 1 \
                else "cr_beta_offset_div2"
            prm[:n, 3] = np.array([getattr(s_, attr_tc)
                                   for s_ in cs.shs])[si[sel]]
            prm[:n, 4] = np.array([getattr(s_, attr_b)
                                   for s_ in cs.shs])[si[sel]]
        prm[:n, 5] = hor_ctb[sel]
        fn = _deblock_chroma_cells_core(dplanes[comp].shape[0],
                                        dplanes[comp].shape[1], dir_, bd,
                                        par_step, sub_shift, n_pad)
        dplanes[comp] = fn(dplanes[comp], torch.as_tensor(cells, device=dev),
                           torch.as_tensor(prm, device=dev), n)
