"""Device-resident whole-frame reconstruction.

Port of the intra path of vvdec_tpu/ops/frame_device.py: dequant +
inverse transform (the ITX stage: every plain TU of the frame in one
launch of the hand-written kernel on CUDA, transform-skip, LFNST and
scaling-list TUs batched per shape in PyTorch), the intra wavefront scan
(ops/intra_device.py; with LMCS, in the reshaped domain, followed by the
inverse luma map), then the in-loop filter chain (deblocking, SAO, ALF,
CC-ALF) + 10-bit output packing (ops/device_pipeline.py), all in device
memory.  The host uploads one int16 coefficient plane per component and
a few descriptor and parameter arrays per frame and reads back one
packed buffer.

Differences from the JAX stage, none of which changes a decoded sample:
the plain TUs run in one launch instead of one per shape group, the
other TU batches are not padded to powers of two (PyTorch runs eagerly
and compiles nothing per shape), and the residual planes are updated in
place.  Pictures outside the ported tool set are rejected by
`plan_frame_device` with a named reason; there is no host fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.device import resolve_device
from vvdec_tpu_torch.frame.structure import MODE_INTRA, MTS_SKIP
from vvdec_tpu_torch.ops.cuda.itx import (
    frame_table,
    itx_frame_cuda,
    matrix_pool,
)
from vvdec_tpu_torch.ops.device_pipeline import (
    device_filter_reject_reason,
    filter_frame_device,
    timed_stage,
)
from vvdec_tpu_torch.ops.intra_device import (
    PB,
    _win_start,
    build_intra_descriptors,
    build_lmcs_params,
    lmcs_inv_map,
    run_intra_scan,
    scan_key,
)

# the descriptor mode class the port does not run yet: the CIIP blend
_CIIP = 5


def _tile_index(ys, xs, h: int, w: int, dims):
    """Row / column index grids [n, h, w] of n (h, w) tiles at (ys, xs),
    starts placed as lax.dynamic_slice / dynamic_update_slice place
    them (`_win_start`)."""
    dev = ys.device
    y0 = _win_start(ys.long(), h, dims[0])
    x0 = _win_start(xs.long(), w, dims[1])
    iy = y0[:, None, None] + torch.arange(h, device=dev)[None, :, None]
    ix = x0[:, None, None] + torch.arange(w, device=dev)[None, None, :]
    return iy, ix


@functools.lru_cache(maxsize=None)
def _extract_fn(h: int, w: int, n: int):
    """Batch-extract n (h, w) tiles of a device-resident int16
    coefficient plane, widened to int32."""

    def run(plane, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, plane.shape)
        return plane[iy, ix].to(torch.int32)

    return run


@functools.lru_cache(maxsize=None)
def _scatter_fn(hp: int, wp: int, h: int, w: int, n: int):
    """Block scatter: write n (h, w) blocks into a padded plane at
    (ys, xs), in place; rectangles are disjoint per component (TU
    layout)."""

    def run(plane, blocks, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, (hp, wp))
        plane[iy, ix] = blocks.to(plane.dtype)
        return plane

    return run


@functools.lru_cache(maxsize=None)
def _jccr_fn(hp: int, wp: int, h: int, w: int, n: int, mode: int,
             neg: bool):
    """Joint-CbCr derivation, in place: dst[rect] = ICT(src[rect]) per
    block (mode 1/2: +-src >> 1; mode 3: +-src), rects disjoint."""

    def run(dst, src, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, (hp, wp))
        r = src[iy, ix]
        if mode == 3:
            v = -r if neg else r
        else:
            v = ((-r) >> 1) if neg else (r >> 1)
        dst[iy, ix] = v
        return dst

    return run


def itx_residual_device(cs, device=None) -> list:
    """Stage 1 on device: dequant + inverse (LFNST +) transform for every
    coded TU, scattered into padded per-component int32 residual planes
    [h + PB, w + PB] on `device` (default CUDA; "cpu" on request), where
    the intra scan reads them in place.
    Parity: TrQuant::invTransformNxN (TrQuant.cpp:290); grouping as in
    vvdec_tpu.ops.frame_device.itx_residual_device."""
    from vvdec_tpu_torch.frame.recon_np import (
        CHROMA422_MAP,
        co_located_luma_mode_of,
        get_tr_types,
        lfnst_params,
        scaling_matrix_for,
        tu_qp,
    )
    from vvdec_tpu_torch.frame.structure import DM_CHROMA_IDX
    from vvdec_tpu_torch.ops.pipeline import _itx_fn, _itx_lfnst_fn, _ts_fn

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

    def up(a):
        return torch.as_tensor(a, device=dev)

    bd = cs.sps.bit_depth
    resi = []
    coefd = []
    for comp in range(3):
        if comp < cs.num_comp:
            w_c, h_c = cs.comp_size[comp]
        else:
            w_c, h_c = 1, 1
        resi.append(torch.zeros((h_c + PB, w_c + PB), dtype=torch.int32,
                                device=dev))
        if comp < cs.num_comp:
            # one int16 upload per plane, as the reference does; levels
            # outside int16 wrap exactly as they do there
            coefd.append(up(cs.coef[comp].astype(np.int16)))
        else:
            coefd.append(None)

    # plain TUs (no transform skip, LFNST or scaling list), for the ITX
    # kernel, and the other groups, which keep their PyTorch paths
    plain: dict[tuple, list] = {}
    groups: dict[tuple, list] = {}
    jccr_ops: dict[tuple, list] = {}
    for tu in cs.tus:
        cu = cs.cus[tu.cu_idx]
        comps = []
        if tu.blocks[0] is not None and tu.cbf[0]:
            comps.append(0)
        if tu.blocks[1] is not None:
            if tu.joint_cbcr:
                # joint Cb-Cr: one coded chroma plane; the other plane is
                # derived by the ICT post-pass below
                # (TrQuant::invTransformCbCr, TrQuant.cpp:108)
                coded = 1 if (tu.joint_cbcr >> 1) else 2
                comps.append(coded)
                x1, y1, w1, h1 = tu.blocks[coded]
                jccr_ops.setdefault((w1, h1, tu.joint_cbcr), []).append(
                    (x1, y1))
            else:
                comps += [c for c in (1, 2) if tu.cbf[c]]
        for comp in comps:
            x, y, w, h = tu.blocks[comp]
            if tu.mts_idx[comp] == MTS_SKIP:
                # transform-skip: dequant only (recon_np.ts_residual)
                qp = tu_qp(cs, tu, cu, comp)
                groups.setdefault(("ts", comp, w, h), []).append(
                    (x, y, qp, None))
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
                key = (comp, w, h, hor, ver, lt, dq, sb, zero)
                groups.setdefault(key, []).append(
                    (x, y, qp, smat, mat[:, :zero], transpose))
            elif lt is None:
                plain.setdefault((comp, w, h, hor, ver, dq), []).append(
                    (x, y, qp))
            else:
                key = (comp, w, h, hor, ver, lt, dq)
                groups.setdefault(key, []).append((x, y, qp, smat))

    # every plain TU goes to the ITX kernel in one launch, driven by a
    # work table; the other groups write disjoint rectangles, so their
    # order against it does not matter.  The work table and the other
    # groups' (y, x, qp) ride one upload, sliced on the device: a
    # host->device copy synchronises the stream, so one per group would
    # hold the host at each group of a frame
    table, n_tasks = frame_table(plain.items(), bd)
    meta = np.array([[it[k] for items in groups.values() for it in items]
                     for k in (1, 0, 2)], dtype=np.int32).reshape(-1)
    buf = up(np.concatenate([meta, table]))
    meta = buf[:meta.size].view(3, -1)
    resi = itx_frame_cuda(coefd, resi, buf[meta.numel():], matrix_pool(dev),
                          n_tasks=n_tasks, bit_depth=bd)
    pos = 0
    for key, items in groups.items():
        n = len(items)
        ys, xs, qps = meta[:, pos:pos + n]
        pos += n
        if key[0] == "ts":
            comp, w, h = key[1], key[2], key[3]
            levels = _extract_fn(h, w, n)(coefd[comp], ys, xs)
            out = _ts_fn(h, w, bd, cs.sps.internal_minus_input_bit_depth)(
                levels, qps)
        else:
            comp, w, h, hor, ver, lt, dep_quant = key[:7]
            levels = _extract_fn(h, w, n)(coefd[comp], ys, xs)
            if len(key) == 9:
                sb, zero = key[7], key[8]
                kern = np.stack([it[4] for it in items]).astype(np.int32)
                trans = np.array([it[5] for it in items], dtype=bool)
                fn = _itx_lfnst_fn(h, w, hor, ver, bd, dep_quant, sb, zero,
                                   use_sl=lt is not None)
                args = (levels, qps, up(kern), up(trans))
            else:
                fn = _itx_fn(h, w, hor, ver, bd, dep_quant)
                args = (levels, qps)
            out = fn(*args, up(items[0][3])) if lt is not None \
                else fn(*args)
        sc = _scatter_fn(resi[comp].shape[0], resi[comp].shape[1],
                         out.shape[1], out.shape[2], n)
        resi[comp] = sc(resi[comp], out, ys, xs)
    # joint Cb-Cr ICT: derive the uncoded chroma residual plane from the
    # coded one, batched per (shape, mode) (invTransformCbCr)
    if jccr_ops:
        neg = bool(cs.ph.joint_cbcr_sign)
        for (w, h, mode), items in jccr_ops.items():
            coded = 1 if (mode >> 1) else 2
            other = 3 - coded
            ys = up(np.array([y1 for _, y1 in items], dtype=np.int32))
            xs = up(np.array([x1 for x1, _ in items], dtype=np.int32))
            fn = _jccr_fn(resi[other].shape[0], resi[other].shape[1],
                          h, w, len(items), mode, neg)
            resi[other] = fn(resi[other], resi[coded], ys, xs)
    return resi


def plan_frame_device(cs):
    """(intra descriptor array, None) when this picture can run the
    port's device pipeline, else (None, reason).  The reasons are the
    reference's gates (filter_*, the descriptor builder's, lmcs_inter),
    then the tools this port does not carry yet: ciip, and inter (an
    inter slice or a non-intra CU)."""
    reason = device_filter_reject_reason(cs)
    if reason is not None:
        return None, f"filter_{reason}"
    desc, reason = build_intra_descriptors(cs)
    if reason is not None:
        return None, reason
    if _lmcs_on(cs) and any(cu.pred_mode != MODE_INTRA for cu in cs.cus):
        return None, "lmcs_inter"
    if (desc[:, 7] == _CIIP).any():
        return None, "ciip"
    if any(not s.is_intra for s in cs.shs) \
            or any(cu.pred_mode != MODE_INTRA for cu in cs.cus):
        return None, "inter"
    return desc, None


def reconstruct_frame_device(cs, desc, device=None):
    """Run the device pipeline for one picture that `plan_frame_device`
    accepted, on `device` (default CUDA); returns the PendingFrame with
    device-resident output planes and the packed readback in flight."""
    dev = resolve_device(device)
    bd = cs.sps.bit_depth
    with timed_stage("itx", dev):
        resi = itx_residual_device(cs, dev)
    with timed_stage("intra", dev):
        lmcs = None
        if _lmcs_on(cs):
            from vvdec_tpu_torch.frame.lmcs_np import Reshaper
            rs = Reshaper(cs.lmcs_info, bd, bool(cs.ph.chroma_residual_scale))
            # one upload of the LMCS table per frame
            lmcs = torch.as_tensor(build_lmcs_params(rs, cs), device=dev)
        recon = [torch.zeros_like(r) for r in resi]
        recon = run_intra_scan(recon, resi, desc, scan_key(cs), lmcs)
    planes = []
    for comp in range(cs.num_comp):
        w_c, h_c = cs.comp_size[comp]
        planes.append(recon[comp][:h_c, :w_c])
    if lmcs is not None:
        # the RSP stage: inverse-map luma back to the original domain
        # before the in-loop filters (Reshape::rspCtuBcw, Reshape.cpp:377)
        with timed_stage("lmcs inverse map", dev):
            planes[0] = lmcs_inv_map(planes[0], lmcs, bd)
    return filter_frame_device(cs, planes)


def _lmcs_on(cs) -> bool:
    return bool(cs.ph.lmcs_enabled
                and getattr(cs, "lmcs_info", None) is not None
                and cs.shs and cs.shs[0].lmcs_enabled)
