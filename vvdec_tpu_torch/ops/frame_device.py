"""Device-resident whole-frame reconstruction.

Port of vvdec_tpu/ops/frame_device.py: dequant + inverse transform (the
ITX stage: every plain TU of the frame in one launch of the hand-written
kernel on CUDA, transform-skip, LFNST and scaling-list TUs batched per
shape in PyTorch), motion compensation of the inter CUs off the
device-resident reference planes (translational uni / bi / BCW /
weighted, SbTMVP, GPM, affine with PROF, DMVR and BDOF; CIIP CUs keep
their raw inter prediction for the intra scan's blend), the intra
wavefront scan (ops/intra_device.py; with LMCS, in the reshaped domain,
followed by the inverse luma map), then the in-loop filter chain
(deblocking, SAO, ALF, CC-ALF) + 10-bit output packing
(ops/device_pipeline.py), all in device memory.  The host uploads one
int16 coefficient plane per component, one packed MC parameter buffer
and a few descriptor and parameter arrays per frame and reads back one
packed buffer (and the refined DMVR MVs).

Differences from the JAX stages, none of which changes a decoded sample:
the plain TUs run in one launch instead of one per shape group; the MC
batches run both lists of a (component, shape) class in one gather and
combine every block of the class in one pass; no batch is padded to a
power of two (PyTorch runs eagerly and compiles nothing per shape); the
residual and reconstruction planes are updated in place.  Pictures
outside the device tool set are rejected by `plan_frame_device` with a
named reason; the decoder reconstructs them on the host and counts the
reason.
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
from vvdec_tpu_torch.ops.dmvr_device import (
    LazyDmvrFixups,
    plan_bdof,
    plan_dmvr,
    run_bdof_groups,
    run_dmvr_groups,
)
from vvdec_tpu_torch.ops.device_pipeline import (
    device_filter_reject_reason,
    filter_frame_device,
    timed_stage,
    upload,
)
from vvdec_tpu_torch.ops.intra_device import (
    PB,
    _win_start,
    build_lmcs_params,
    lmcs_inv_map,
    plan_intra_descriptors,
    run_intra_scan,
    scan_key,
)
from vvdec_tpu_torch.ops.mc_device import (
    bi_combine_core,
    mc_batch_core,
    mc_coeff_rows,
    pad_ref,
    ref_windows,
    wp_combine_core,
)
from vvdec_tpu_torch.utils.trace import profiler


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
def _extract_fn(h: int, w: int):
    """Batch-extract (h, w) tiles of a device-resident int16
    coefficient plane, widened to int32."""

    def run(plane, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, plane.shape)
        return plane[iy, ix].to(torch.int32)

    return run


@functools.lru_cache(maxsize=None)
def _scatter_fn(h: int, w: int):
    """Block scatter: write (h, w) blocks into a padded plane at
    (ys, xs), in place; rectangles are disjoint per component (TU
    layout)."""

    def run(plane, blocks, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, plane.shape)
        plane[iy, ix] = blocks.to(plane.dtype)
        return plane

    return run


@functools.lru_cache(maxsize=None)
def _jccr_fn(h: int, w: int, mode: int, neg: bool):
    """Joint-CbCr derivation, in place: dst[rect] = ICT(src[rect]) per
    block (mode 1/2: +-src >> 1; mode 3: +-src), rects disjoint."""

    def run(dst, src, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, dst.shape)
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

    def up(a, site="wait: upload itx groups"):
        return upload(a, dev, site)

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
            coefd.append(up(cs.coef[comp].astype(np.int16),
                            "wait: upload coefficients"))
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
    buf = up(np.concatenate([meta, table]), "wait: upload itx table")
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
            levels = _extract_fn(h, w)(coefd[comp], ys, xs)
            out = _ts_fn(h, w, bd, cs.sps.internal_minus_input_bit_depth)(
                levels, qps)
        else:
            comp, w, h, hor, ver, lt, dep_quant = key[:7]
            levels = _extract_fn(h, w)(coefd[comp], ys, xs)
            if len(key) == 9:
                sb, zero = key[7], key[8]
                kern = np.stack([it[4] for it in items]).astype(np.int32)
                trans = np.array([it[5] for it in items], dtype=bool)
                fn = _itx_lfnst_fn(h, w, hor, ver, bd, dep_quant, sb, zero,
                                   use_sl=lt is not None)
                args = (levels, qps, up(kern), up(trans))
            else:
                fn = _itx_fn(h, w, hor, ver, bd, dep_quant, use_sl=True)
                args = (levels, qps)
            out = fn(*args, up(items[0][3])) if lt is not None \
                else fn(*args)
        resi[comp] = _scatter_fn(out.shape[1], out.shape[2])(
            resi[comp], out, ys, xs)
    # joint Cb-Cr ICT: derive the uncoded chroma residual plane from the
    # coded one, batched per (shape, mode) (invTransformCbCr)
    if jccr_ops:
        neg = bool(cs.ph.joint_cbcr_sign)
        for (w, h, mode), items in jccr_ops.items():
            coded = 1 if (mode >> 1) else 2
            other = 3 - coded
            ys = up(np.array([y1 for _, y1 in items], dtype=np.int32))
            xs = up(np.array([x1 for x1, _ in items], dtype=np.int32))
            fn = _jccr_fn(h, w, mode, neg)
            resi[other] = fn(resi[other], resi[coded], ys, xs)
    return resi




def derive_frame_motion(cs) -> None:
    """Host motion-derivation pass: resolves merge/MMVD/AMVP/SMVD,
    affine, SbTMVP and GPM motion per inter CU in parse order, spans the
    4x4 motion field and updates HMVP; no pixel work
    (DecCu::TaskDeriveCtuMotionInfo, DecCu.cpp:62)."""
    from vvdec_tpu_torch.frame.inter_np import MotionHist
    from vvdec_tpu_torch.frame.recon_np import IntraReconstructor

    r = IntraReconstructor(cs)
    r._hist = MotionHist()
    r.derive_only = True
    if type(cs.tus) is list:
        for i, tu in enumerate(cs.tus):
            tu.order = i
    last_row = None
    seen = -1
    ctu_log2 = cs.sps.ctu_log2
    side = getattr(cs, "_mctx_side", None)
    for tu in cs.tus:
        cu = cs.cus[tu.cu_idx]
        if cu.idx == seen:
            continue
        seen = cu.idx
        row = (cu.y >> ctu_log2, cu.tile_idx)
        if row != last_row:
            r._hist.reset()
            last_row = row
        if cu.pred_mode != MODE_INTRA:
            r._derive_motion(cu)
            side = getattr(cs, "_mctx_side", side)
            if side is not None and cu.idx >= 0:
                side[cu.idx, 0] = cu.bcw_idx
                side[cu.idx, 1] = cu.imv


class _SubBlk:
    """Duck-typed CU fragment for subblock MC expansion (SbTMVP 8x8)."""

    __slots__ = ("x", "y", "w", "h", "cx", "cy", "cw", "ch", "inter_dir",
                 "mv", "ref_idx", "slice_idx", "bcw_idx", "alt_hpel")

    def __init__(self, **kw):
        self.bcw_idx = 0
        self.alt_hpel = False
        for k, v in kw.items():
            setattr(self, k, v)


@functools.lru_cache(maxsize=None)
def _prof_core(bd: int):
    """PROF refinement over batched 4x4 affine subblocks: border
    extension from integer reference samples, gradients, dMv dot product
    (xPredAffineBlk PROF, InterPrediction.cpp:1045; host golden
    affine_np.affine_luma_4x4).  blk: [N, 4, 4], the 14-bit intermediate
    for prof / bi / wp items, final samples for plain-uni non-prof items
    (passed through)."""
    shift = max(2, 14 - bd)
    offs = 1 << 13
    offn = (1 << (shift - 1)) + offs
    lim = 1 << max(bd + 1, 13)
    pel_max = (1 << bd) - 1

    def apply(refs, yb, xb, ridx, blk, dmvh, dmvv, prof, inter):
        ext = (ref_windows(refs, ridx, yb, xb, 6, 6) << shift) - offs
        ext[:, 1:5, 1:5] = blk
        gx = (ext[:, 1:5, 2:6] >> 6) - (ext[:, 1:5, 0:4] >> 6)
        gy = (ext[:, 2:6, 1:5] >> 6) - (ext[:, 0:4, 1:5] >> 6)
        di = torch.clamp(dmvh * gx + dmvv * gy, -lim, lim - 1)
        pm = prof[:, None, None]
        out = blk + torch.where(pm, di, 0)
        fin = torch.clamp((out + offn) >> shift, 0, pel_max)
        return torch.where(inter[:, None, None], out,
                           torch.where(pm, fin, blk))

    return apply


@functools.lru_cache(maxsize=None)
def _scatter_recon_fn(h: int, w: int, bd: int):
    """Inter reconstruct scatter, in place: recon[rect] = clip(pred +
    resi) per block (predAndReco for inter CUs, DecCu.cpp:378)."""
    pel_max = (1 << bd) - 1

    def run(recon, resi, blocks, ys, xs):
        iy, ix = _tile_index(ys, xs, h, w, recon.shape)
        recon[iy, ix] = torch.clamp(blocks + resi[iy, ix], 0, pel_max)
        return recon

    return run


class _Upload:
    """int32 host arrays that ride one host->device copy: `add` returns a
    handle, `send` makes the copy, `get` gives the handle's device view.
    A host->device copy synchronises the stream, so a frame makes one."""

    def __init__(self):
        self._arrays: list = []
        self._size = 0
        self._buf = None

    def add(self, a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        handle = (self._size, a.shape)
        self._arrays.append(a.reshape(-1))
        self._size += a.size
        return handle

    def send(self, device) -> None:
        self._buf = upload(np.concatenate(self._arrays), device,
                           "wait: upload mc params")

    def get(self, handle):
        off, shape = handle
        return self._buf[off:off + int(np.prod(shape))].view(shape)


def _columns(cols, n: int) -> list:
    """n rows (lists) whose k-th entries are cols[k], a scalar or an
    array of n values."""
    out = np.empty((n, len(cols)), np.int64)
    for k, v in enumerate(cols):
        out[:, k] = v
    return out.tolist()


# block kinds of an MC batch: how a block's parts make its prediction
_UNI, _BI, _WP, _GEO = 0, 1, 2, 3
# _Batch.blocks columns
_BX, _BY, _PA, _PB, _KIND, _BCW, _W0, _O0, _W1, _O1, _DEN, _ISBI, _RAW = \
    range(13)


class _Batch:
    """The blocks of one (component, shape, family) class and the MC parts
    they combine.  A part is one list's prediction of one block; a block
    takes its part pa (uni), pa and pb averaged or BCW-weighted (bi), the
    explicit weights (wp), or pa and pb blended with GPM weights."""

    def __init__(self, comp: int, cw: int, ch: int, family: str):
        self.comp, self.cw, self.ch, self.family = comp, cw, ch, family
        self.parts: list = []    # y0, x0, ridx, inter[, yb, xb, prof, comb]
        self.fx: list = []
        self.fy: list = []
        self.alt: list = []
        self.dmv: list = []      # affine luma: [2, 4, 4] PROF dMv grids
        self.blocks: list = []   # the _Batch.blocks columns
        self.wgt: list = []      # GPM: [ch, cw] weights
        self.cu_idx: list = []


class McFrame:
    """One picture's inter prediction: the host plans every MC part and
    block, batched per (component, shape, family), and every DMVR
    subblock and BDOF region, batched per shape (`plan_refinement`);
    `predict` uploads the plan in one copy, pads each reference plane
    once per component and runs each batch as one MC launch (both lists
    together), PROF for affine luma, and one combine, then the DMVR and
    BDOF classes (ops/dmvr_device.py).  The reference planes are keyed
    by POC (`refs`), not by object identity, and padded by the CTU size
    + 24 (the reach of a clipped MV, its filter taps and the DMVR
    search), chroma by that margin // sub_h.
    Grouping and arithmetic as vvdec_tpu's _mc_reconstruct_device
    (regular / SbTMVP, GPM, affine + PROF and DMVR / BDOF sections)."""

    FAMILY_STAGE = {"regular": "mc: regular", "GPM": "mc: GPM",
                    "affine": "mc: affine+PROF", "DMVR": "mc: DMVR",
                    "BDOF": "mc: BDOF"}

    def __init__(self, cs):
        self.cs = cs
        self.margin = cs.sps.ctu_size + 24
        self.bd = cs.sps.bit_depth
        self.batches: dict = {}
        self.refs: dict = {}     # poc -> (index, lst, ref_idx)
        self.up = _Upload()
        self.dmvr: list = []     # (cu, bdof flag) of the DMVR CUs
        self.bdof: list = []     # the standalone BDOF CUs
        self.dmvr_plans: list = []
        self.bdof_plans: list = []
        self.fixups = LazyDmvrFixups()

    def _ref_index(self, lst, ref_idx) -> int:
        """The index of reference (lst, ref_idx) in the stacked planes:
        one per POC."""
        poc = self.cs.ref_pocs[lst][ref_idx]
        if poc not in self.refs:
            self.refs[poc] = (len(self.refs), lst, ref_idx)
        return self.refs[poc][0]

    def _batch(self, comp, cw, ch, family) -> _Batch:
        key = (family, comp, cw, ch)
        b = self.batches.get(key)
        if b is None:
            b = self.batches[key] = _Batch(comp, cw, ch, family)
        return b

    def _part(self, b: _Batch, bx, by, mvx, mvy, lst, ref_idx, alt, inter,
              prof=None):
        """Add one list's MC of the block at (bx, by) (component
        coordinates) with the clipped MV (mvx, mvy); returns its part
        index.  With numpy arrays for bx, by, mvx and mvy it adds one part
        per block (affine subblocks) and returns their indices."""
        cs = self.cs
        comp = b.comp
        half = 3 if comp == 0 else 1
        fxb = 4 + (cs.sub_w - 1) if comp else 4
        fyb = 4 + (cs.sub_h - 1) if comp else 4
        m = self.margin // (cs.sub_h if comp else 1)
        ix, iy = mvx >> fxb, mvy >> fyb
        f_x = mvx & ((1 << fxb) - 1)
        f_y = mvy & ((1 << fyb) - 1)
        if comp:
            f_x <<= (5 - fxb)
            f_y <<= (5 - fyb)
        row = [by + iy - half + m, bx + ix - half + m,
               self._ref_index(lst, ref_idx), int(inter)]
        dmv = None
        if prof is not None:
            # affine luma: the PROF window's origin, flags and dMv grids
            on, comb, dmv = prof
            row += [by + iy + (f_y >> 3) - 1 + m,
                    bx + ix + (f_x >> 3) - 1 + m, int(on), int(comb)]
            dmv = dmv if on else np.zeros((2, 4, 4), np.int32)
        start = len(b.parts)
        if np.ndim(bx) == 0:
            b.parts.append(row)
            b.fx.append(f_x)
            b.fy.append(f_y)
            b.alt.append(alt)
            if dmv is not None:
                b.dmv.append(dmv)
            return start
        n = len(bx)
        b.parts += _columns(row, n)
        b.fx += f_x.tolist()
        b.fy += f_y.tolist()
        b.alt += [alt] * n
        if dmv is not None:
            b.dmv += [dmv] * n
        return np.arange(start, start + n)

    def _block(self, b: _Batch, cu, bx, by, parts, kind, bcw=4, wp=None,
               raw=False, wgt=None) -> None:
        """Add the block(s) at (bx, by) (scalars, or numpy arrays with
        per-block part indices) made from `parts` by `kind`."""
        w0 = o0 = w1 = o1 = den = 0
        if wp is not None:
            w0, o0, w1, o1, den = wp
        row = [bx, by, parts[0], parts[-1], kind, bcw, w0, o0, w1, o1, den,
               int(cu.inter_dir == 3), int(raw)]
        if np.ndim(bx) == 0:
            b.blocks.append(row)
            b.cu_idx.append(getattr(cu, "idx", -1))
        else:
            b.blocks += _columns(row, len(bx))
            b.cu_idx += [cu.idx] * len(bx)
        if wgt is not None:
            b.wgt.append(wgt)

    def _wp(self, cu, comp):
        """(w0, o0, w1, o1, denom) of the CU's explicit weights."""
        from vvdec_tpu_torch.hls.weight_table import resolve_wp
        cs = self.cs
        wt = cs.sh_of(cu).weight_table
        lst = 0 if cu.inter_dir in (1, 3) else 1
        wp0 = resolve_wp(wt, lst, cu.ref_idx[lst], self.bd,
                         cs.num_comp)[comp]
        w1 = o1 = 0
        if cu.inter_dir == 3:
            wp1 = resolve_wp(wt, 1, cu.ref_idx[1], self.bd,
                             cs.num_comp)[comp]
            w1, o1 = wp1["w"], wp1["o"]
        return wp0["w"], wp0["o"], w1, o1, wp0["denom"]

    @staticmethod
    def _bcw(cu) -> int:
        from vvdec_tpu_torch.frame.inter_np import BCW_INTERN, BCW_WEIGHTS
        return 4 if cu.bcw_idx == 0 else BCW_WEIGHTS[BCW_INTERN[cu.bcw_idx]]

    def add_regular(self, cu, comps=None) -> None:
        """A whole-CU translational block (or an SbTMVP 8x8 subblock):
        uni, bi (average / BCW) or explicit WP; a CIIP CU keeps its raw
        inter prediction for the intra scan's blend.  comps: the
        components to plan (default all)."""
        from vvdec_tpu_torch.frame.dmvr_np import _wp_present
        from vvdec_tpu_torch.frame.inter_np import clip_mv
        cs = self.cs
        wp_on = _wp_present(cs, cu)
        bi = cu.inter_dir == 3
        ciip = getattr(cu, "ciip_flag", False)
        kind = _WP if wp_on else (_BI if bi else _UNI)
        mvs = [clip_mv(tuple(cu.mv[lst]), cu.x, cu.y, cs, size=(cu.w, cu.h))
               if cu.inter_dir & (1 << lst) else None for lst in (0, 1)]
        for comp in range(cs.num_comp) if comps is None else comps:
            cw = cu.w if comp == 0 else cu.w // cs.sub_w
            ch = cu.h if comp == 0 else cu.h // cs.sub_h
            bx, by = (cu.x, cu.y) if comp == 0 else (cu.cx, cu.cy)
            b = self._batch(comp, cw, ch, "regular")
            parts = [self._part(b, bx, by, *mvs[lst], lst, cu.ref_idx[lst],
                                cu.alt_hpel and comp == 0, bi or wp_on)
                     for lst in (0, 1) if mvs[lst] is not None]
            self._block(b, cu, bx, by, parts, kind,
                        bcw=4 if ciip else self._bcw(cu),
                        wp=self._wp(cu, comp) if wp_on else None,
                        raw=ciip and (comp == 0 or cu.cw > 2))

    def add_sbtmvp(self, cu) -> None:
        """SbTMVP: regular MC per 8x8 subblock off the spanned motion
        field (xSubPuMC, InterPrediction.cpp:438)."""
        cs = self.cs
        for by in range(0, cu.h, 8):
            for bx in range(0, cu.w, 8):
                y4, x4 = (cu.y + by) >> 2, (cu.x + bx) >> 2
                r0 = int(cs.mi_ref[y4, x4, 0])
                r1 = int(cs.mi_ref[y4, x4, 1])
                self.add_regular(_SubBlk(
                    x=cu.x + bx, y=cu.y + by, w=8, h=8,
                    cx=(cu.x + bx) // cs.sub_w, cy=(cu.y + by) // cs.sub_h,
                    cw=8 // cs.sub_w, ch=8 // cs.sub_h,
                    inter_dir=(1 if r0 >= 0 else 0) + (2 if r1 >= 0 else 0),
                    mv=[[int(v) for v in cs.mi_mv[y4, x4, 0]],
                        [int(v) for v in cs.mi_mv[y4, x4, 1]]],
                    ref_idx=[r0, r1], slice_idx=cu.slice_idx))

    def add_geo(self, cu) -> None:
        """GPM: two 14-bit uni parts blended with the geometric mask
        (motionCompensationGeo, InterPrediction.cpp:1461)."""
        from vvdec_tpu_torch.frame.geo_np import geo_weight_block
        from vvdec_tpu_torch.frame.inter_np import clip_mv
        cs = self.cs
        mvs = [clip_mv(mv, cu.x, cu.y, cs, size=(cu.w, cu.h))
               for _, _, mv in cu._geo_parts]
        for comp in range(cs.num_comp):
            cw = cu.w if comp == 0 else cu.w // cs.sub_w
            ch = cu.h if comp == 0 else cu.h // cs.sub_h
            bx, by = (cu.x, cu.y) if comp == 0 else (cu.cx, cu.cy)
            b = self._batch(comp, cw, ch, "GPM")
            parts = [self._part(b, bx, by, *mvs[k], lst, ref, False, True)
                     for k, (lst, ref, _) in enumerate(cu._geo_parts)]
            sx = (cs.sub_w - 1) if comp else 0
            sy = (cs.sub_h - 1) if comp else 0
            self._block(b, cu, bx, by, parts, _GEO, wgt=geo_weight_block(
                cu.geo_split_dir, cw, ch, sx, sy))

    def add_affine(self, cu) -> None:
        """Affine: per-4x4 subblock MC, PROF on luma (xPredAffineBlk,
        InterPrediction.cpp:934; host golden affine_np.affine_pred)."""
        from vvdec_tpu_torch.frame.affine_np import (
            _deltas, prof_dmv_grid, round_affine, spread_over_limit)
        from vvdec_tpu_torch.frame.dmvr_np import _wp_present
        from vvdec_tpu_torch.frame.inter_np import clip_mv
        cs = self.cs
        bi = cu.inter_dir == 3
        wp_on = _wp_present(cs, cu) and not (bi and cu.bcw_idx != 0)
        kind = _WP if wp_on else (_BI if bi else _UNI)
        lists = [lst for lst in (0, 1) if cu.inter_dir & (1 << lst)]
        profs = [False, False]
        dmvs = [None, None]
        for lst in lists:
            lt, rt, lb = [tuple(v) for v in cu.cpmv[lst]]
            is6 = cu.affine_type == 1
            dhx, dhy, dvx, dvy = _deltas(lt, rt, lb, cu.w, cu.h, is6)
            spread = spread_over_limit(dhx, dhy, dvx, dvy, cu.inter_dir)
            profs[lst] = (cs.sps.prof_enabled and not cs.ph.prof_disabled
                          and not spread
                          and not (lt == rt if not is6
                                   else (lt == rt and lt == lb)))
            if profs[lst]:
                dmvs[lst] = np.stack(prof_dmv_grid(lt, rt, lb, cu.w, cu.h,
                                                   is6))

        # the CU's 4x4 luma motion field [h4, w4, list, xy]; clip_mv's
        # window depends only on the CU's origin
        h4, w4 = cu.h >> 2, cu.w >> 2
        field = cs.mi_mv[cu.y >> 2:(cu.y >> 2) + h4,
                         cu.x >> 2:(cu.x >> 2) + w4].astype(np.int64)
        big = 1 << 30
        lo = np.array(clip_mv((-big, -big), cu.x, cu.y, cs))
        hi = np.array(clip_mv((big, big), cu.x, cu.y, cs))

        def blocks(comp, bx, by, mvs):
            """The 4x4 blocks at (bx, by) of one component; mvs [n, 2]
            per list, unclipped."""
            b = self._batch(comp, 4, 4, "affine")
            parts = []
            for lst in lists:
                mv = np.clip(mvs[..., lst, :].reshape(-1, 2), lo, hi)
                prof = (profs[lst], bi or wp_on, dmvs[lst]) if comp == 0 \
                    else None
                parts.append(self._part(
                    b, bx, by, mv[:, 0], mv[:, 1], lst, cu.ref_idx[lst],
                    False, bi or wp_on or (comp == 0 and profs[lst]), prof))
            self._block(b, cu, bx, by, parts, kind, bcw=self._bcw(cu),
                        wp=self._wp(cu, comp) if wp_on else None)

        r, c = np.mgrid[0:h4, 0:w4]
        blocks(0, cu.x + 4 * c.ravel(), cu.y + 4 * r.ravel(), field)
        if cs.num_comp == 1:
            return
        # chroma subblock MVs (xPredAffineBlk): 4:2:0 averages the
        # diagonal pair, 4:2:2 the horizontal pair, 4:4:4 takes the MV
        if cs.sub_w == 2:
            pair = field[0::cs.sub_h, 0::2] + field[cs.sub_h - 1::cs.sub_h,
                                                    1::2]
            cmv = np.stack(round_affine(pair[..., 0], pair[..., 1], 1), -1)
        else:
            cmv = field
        r, c = np.mgrid[0:cu.ch >> 2, 0:cu.cw >> 2]
        for comp in (1, 2):
            blocks(comp, cu.cx + 4 * c.ravel(), cu.cy + 4 * r.ravel(), cmv)

    def add_dmvr(self, cu, bio: bool) -> None:
        """A CU that DMVR refines (with BDOF on its subblocks when
        `bio`): planned with the others in `plan_refinement`."""
        self.dmvr.append((cu, bio))

    def add_bdof(self, cu) -> None:
        """A standalone BDOF CU: its luma regions are planned in
        `plan_refinement`; its chroma is the regular bi-average (BDOF
        refines luma only; the CU has default weights and no WP)."""
        self.bdof.append(cu)
        self.add_regular(cu, comps=range(1, self.cs.num_comp))

    def plan_refinement(self) -> None:
        """Plan the DMVR subblocks and BDOF regions (numpy, into the
        upload)."""
        if self.dmvr:
            self.dmvr_plans = plan_dmvr(self.cs, self.dmvr, self._ref_index,
                                        self.margin, self.up)
        if self.bdof:
            self.bdof_plans = plan_bdof(self.cs, self.bdof, self._ref_index,
                                        self.margin, self.up)

    def empty(self) -> bool:
        return not (self.batches or self.dmvr or self.bdof)

    def _pack(self) -> None:
        """Per batch, its arrays into the upload (handles on the batch)."""
        from vvdec_tpu_torch.frame.inter_np import LUMA_IF_4X4
        for b in self.batches.values():
            comp = min(b.comp, 1)
            table = LUMA_IF_4X4 if (b.family == "affine" and comp == 0) \
                else None
            alt = np.array(b.alt, bool)
            cfy = mc_coeff_rows(np.array(b.fy), comp, alt, table)
            cfx = mc_coeff_rows(np.array(b.fx), comp, alt, table)
            b.h_parts = self.up.add(np.array(b.parts))
            b.h_coef = self.up.add(np.concatenate([cfy, cfx], 1))
            b.h_dmv = self.up.add(np.stack(b.dmv)) if b.dmv else None
            blocks = np.array(b.blocks, np.int32)
            b.h_blocks = self.up.add(blocks)
            b.h_wgt = self.up.add(np.stack(b.wgt)) if b.wgt else None
            b.kinds = set(blocks[:, _KIND].tolist())
            # CIIP blocks store the raw prediction; the others add the
            # residual and clip
            raw = blocks[:, _RAW] == 1
            b.raw = b.cooked = None
            if raw.any():
                b.raw = self.up.add(np.flatnonzero(raw))
                b.cooked = self.up.add(np.flatnonzero(~raw))

    def _refs_stacked(self, get_ref, dev) -> dict:
        """comp -> [R, hp, wp]: every reference plane of the picture, padded
        once and stacked once per component."""
        comps = {b.comp for b in self.batches.values()}
        if self.bdof:
            comps.add(0)
        if self.dmvr:
            comps.update(range(self.cs.num_comp))
        order = sorted(self.refs.values())
        out = {}
        for comp in sorted(comps):
            m = self.margin // (self.cs.sub_h if comp else 1)
            out[comp] = torch.stack([pad_ref(get_ref(lst, ri, comp), m)
                                     for _, lst, ri in order])
        return out

    def _run(self, b: _Batch, refs):
        """One batch on the device -> [N, ch, cw] predictions."""
        up = self.up
        bd = self.bd
        taps = 8 if b.comp == 0 else 4
        P = up.get(b.h_parts)
        cf = up.get(b.h_coef)
        parts = mc_batch_core(b.cw, b.ch, taps, bd)(
            refs, P[:, 0], P[:, 1], P[:, 2], cf[:, :taps], cf[:, taps:],
            P[:, 3] != 0)
        if b.h_dmv is not None:
            dmv = up.get(b.h_dmv)
            parts = _prof_core(bd)(
                refs, P[:, 4], P[:, 5], P[:, 2], parts, dmv[:, 0], dmv[:, 1],
                P[:, 6] != 0, P[:, 7] != 0)
        B = up.get(b.h_blocks)
        a = parts[B[:, _PA].long()]
        pb = parts[B[:, _PB].long()]
        if b.family == "GPM":
            shift = max(2, 14 - bd) + 3
            offset = (1 << (shift - 1)) + ((1 << 13) << 3)
            wgt = up.get(b.h_wgt)
            return torch.clamp((wgt * a + (8 - wgt) * pb + offset) >> shift,
                               0, (1 << bd) - 1)
        pred = a
        kind = B[:, _KIND, None, None]
        if _BI in b.kinds:
            v = bi_combine_core(b.cw, b.ch, bd)(a, pb, B[:, _BCW])
            pred = torch.where(kind == _BI, v, pred)
        if _WP in b.kinds:
            v = wp_combine_core(b.cw, b.ch, bd)(
                a, pb, B[:, _W0], B[:, _O0], B[:, _W1], B[:, _O1],
                B[:, _DEN], B[:, _ISBI] != 0)
            pred = torch.where(kind == _WP, v, pred)
        return pred

    def predict(self, get_ref, dev) -> list:
        """[(batch, [N, ch, cw] prediction)] of every batch, on `dev`;
        get_ref(lst, ref_idx, comp) serves the reference planes."""
        with timed_stage("mc: upload + refs", dev):
            self._pack()
            self.up.send(dev)
            refs = self._refs_stacked(get_ref, dev)
        out = []
        for b in sorted(self.batches.values(), key=lambda b: b.family):
            with timed_stage(self.FAMILY_STAGE[b.family], dev):
                out.append((b, self._run(b, refs[b.comp])))
        if self.dmvr_plans:
            with timed_stage(self.FAMILY_STAGE["DMVR"], dev):
                out += run_dmvr_groups(self.cs, self.dmvr_plans, self.up,
                                       refs, self.margin, self.fixups)
        if self.bdof_plans:
            with timed_stage(self.FAMILY_STAGE["BDOF"], dev):
                out += run_bdof_groups(self.cs, self.bdof_plans, self.up,
                                       refs)
        return out


def _mc_reconstruct_device(cs, recon, resi, get_ref):
    """Batched device MC for every inter CU + residual reconstruction,
    written in place into the padded recon planes (CIIP components keep
    the raw prediction: the intra scan blends and reconstructs them).
    Reference planes come from get_ref(lst, ref_idx, comp), device-
    resident DPB entries, so no pixel upload happens here.  A CU that
    DMVR refines carries its BDOF flag into the DMVR stage, a standalone
    BDOF CU goes to the BDOF stage (the split of the host recon driver,
    recon_np.py:1619-1636), and cs.dmvr_fixups receives the refined MVs
    for the decoder's motion-field fixups."""
    from vvdec_tpu_torch.frame.dmvr_np import bdof_condition, dmvr_condition
    dev = recon[0].device
    bd = cs.sps.bit_depth
    with profiler.stage("mc: plan (host)"):
        mf = McFrame(cs)
        for cu in cs.cus:
            if cu is None or cu.pred_mode == MODE_INTRA:
                continue
            if cu.geo_flag:
                mf.add_geo(cu)
            elif cu.merge_type == 1:
                mf.add_sbtmvp(cu)
            elif cu.affine_flag:
                mf.add_affine(cu)
            elif dmvr_condition(cs, cu):
                mf.add_dmvr(cu, bdof_condition(cs, cu))
            elif bdof_condition(cs, cu):
                mf.add_bdof(cu)
            else:
                mf.add_regular(cu)
        mf.plan_refinement()
    if mf.empty():
        return recon
    preds = mf.predict(get_ref, dev)
    if mf.dmvr:
        # the decoder applies these to the motion field after the
        # deblocking strengths are derived (TaskFinishMotionInfo order)
        cs.dmvr_fixups = mf.fixups
    with timed_stage("mc: scatter", dev):
        for b, pred in preds:
            comp = b.comp
            B = mf.up.get(b.h_blocks)
            ys, xs = B[:, _BY], B[:, _BX]
            if b.raw is None:
                recon[comp] = _scatter_recon_fn(b.ch, b.cw, bd)(
                    recon[comp], resi[comp], pred, ys, xs)
                continue
            raw, cooked = mf.up.get(b.raw).long(), mf.up.get(b.cooked).long()
            recon[comp] = _scatter_fn(b.ch, b.cw)(
                recon[comp], pred[raw], ys[raw], xs[raw])
            recon[comp] = _scatter_recon_fn(b.ch, b.cw, bd)(
                recon[comp], resi[comp], pred[cooked], ys[cooked],
                xs[cooked])
    return recon


def plan_frame_device(cs):
    """(intra descriptor array, None) when this picture can run the
    port's device pipeline, else (None, reason): the decoder then
    reconstructs it on the host and counts the reason in its census.
    The reasons are the reference's gates, in its order (filter_*,
    per_slice_rpl, the descriptor builder's, lmcs_inter, mc_tool).  A
    CU that DMVR or BDOF refines takes the device refinement stage
    (ops/dmvr_device.py); with scaled references it is mc_tool, as every
    other CU outside the device batches is.  For inter pictures this
    runs the host motion derivation (timed as "motion (host)"), which
    the MC stage reads."""
    from vvdec_tpu_torch.frame.dmvr_np import bdof_condition, dmvr_condition
    from vvdec_tpu_torch.ops.mc_device import _cu_mc_eligible

    def _reject():
        # an aborted motion pass: drop the per-picture motion context so
        # that the host reconstruction derives it again with its own
        # HMVP buffers
        if hasattr(cs, "_mctx"):
            del cs._mctx
        return None, "mc_tool"

    with profiler.stage("plan (host)"):
        reason = device_filter_reject_reason(cs)
        if reason is not None:
            return None, f"filter_{reason}"
        if getattr(cs, "per_slice_rpl", False):
            return None, "per_slice_rpl"
        desc, reason, inter = plan_intra_descriptors(cs)
        if reason is not None:
            return None, reason
        if inter is None:
            inter = any(cu.pred_mode != MODE_INTRA for cu in cs.cus)
        if not inter:
            return desc, None
        if _lmcs_on(cs):
            # inter LMCS needs decode-order chroma scaling interleaved
            # with the MC stage (and forward-mapped luma predictions)
            return None, "lmcs_inter"
        # parse-time global gates first, before the motion pass
        if cs.sps.ref_wraparound_enabled or cs.subpics:
            return None, "mc_tool"
    with profiler.stage("motion (host)"):
        derive_frame_motion(cs)
        any_scaled = any(s is not None for lst in cs.ref_scaled for s in lst)
        for cu in cs.cus:
            if cu.pred_mode == MODE_INTRA:
                continue
            if cu.geo_flag or cu.affine_flag or cu.merge_type == 1 \
                    or cu.ciip_flag:
                # GPM / affine (+PROF) / SbTMVP subblock batches; scaled
                # references stay out of scope
                if any_scaled:
                    return _reject()
                continue
            if dmvr_condition(cs, cu) or bdof_condition(cs, cu):
                # the device refinement stage; the scaled-reference
                # gather windows stay out of scope
                if any_scaled:
                    return _reject()
                continue
            if not _cu_mc_eligible(cs, cu):
                return _reject()
    return desc, None


def reconstruct_frame_device(cs, desc, get_ref=None, device=None):
    """Run the device pipeline for one picture that `plan_frame_device`
    accepted, on `device` (default CUDA): ITX, then MC and the inter
    reconstruct off get_ref(lst, ref_idx, comp) (device-resident
    reference planes; needed when the picture has inter CUs), then the
    intra scan (CIIP blends included), the inverse LMCS map and the
    filter chain.  Returns the PendingFrame with device-resident output
    planes and the packed readback in flight."""
    dev = resolve_device(device)
    bd = cs.sps.bit_depth
    with timed_stage("itx", dev):
        resi = itx_residual_device(cs, dev)
    recon = [torch.zeros_like(r) for r in resi]
    if any(cu.pred_mode != MODE_INTRA for cu in cs.cus):
        recon = _mc_reconstruct_device(cs, recon, resi, get_ref)
    with timed_stage("intra", dev):
        lmcs = None
        if _lmcs_on(cs):
            from vvdec_tpu_torch.frame.lmcs_np import Reshaper
            rs = Reshaper(cs.lmcs_info, bd, bool(cs.ph.chroma_residual_scale))
            # one upload of the LMCS table per frame
            lmcs = upload(build_lmcs_params(rs, cs), dev,
                          "wait: upload lmcs table")
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
