"""Device inter prediction: batched motion compensation in PyTorch.

Port of vvdec_tpu/ops/mc_device.py: the MC, bi-combine and explicit
weighted-prediction cores, the DMVR 25-point SAD and the BDOF blend
(their drivers are ops/dmvr_device.py), the coefficient-row selection,
the whole-CU eligibility test and the `mc_frame_device` batch driver.
All blocks of one (w, h, taps) class run as one batch: the windows are
one gather from pre-padded reference planes, placed as
lax.dynamic_slice places them (`_win_start`), and the separable FIR and
every rounding and clipping step are int32 multiply-adds on shifted
slices at the reference's 14-bit intermediate precision.  Fractional position 0 runs the identity row
([..,64,..]) through the same two passes, which is bit-exact with the
reference's copy and single-pass branches, so one kernel covers copy,
H-only, V-only, HV and the alternate half-pel filter.

Parity targets: InterpolationFilter::filter{Hor,Ver} 14-bit pipeline
(InterpolationFilter.h:65-120), AreaBuf::addAvg / addWeightedAvg,
WeightPrediction::addWeightUni / addWeightBi (WeightPrediction.cpp:
164,240), xProcessDMVR's SAD and applyBiOptFlow (InterPrediction.cpp:
1847, 1290); the host goldens are frame/inter_np.mc_block, bi_average,
bi_weighted and frame/dmvr_np.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.device import resolve_device
from vvdec_tpu_torch.ops.intra_device import _powers_of_two, _win_start

IF_INTERNAL_PREC = 14
IF_FILTER_PREC = 6
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)


def pad_ref(plane, margin: int):
    """Edge-replicated reference padding by `margin` on every side
    (Picture border extension, Picture.h:140), as an index gather: the
    replicate mode of torch's pad is float-only on some devices."""
    hh, ww = plane.shape
    dev = plane.device
    rows = torch.arange(-margin, hh + margin, device=dev).clamp(0, hh - 1)
    cols = torch.arange(-margin, ww + margin, device=dev).clamp(0, ww - 1)
    return plane.index_select(0, rows).index_select(1, cols)


def ref_windows(refs, ridx, y0, x0, eh: int, ew: int):
    """[N, eh, ew] windows of the stacked planes refs [R, hp, wp] at
    (ridx, y0, x0), every start placed as lax.dynamic_slice places it."""
    n_r, hp, wp = refs.shape
    dev = refs.device
    r = _win_start(ridx.long(), 1, n_r)[:, None, None]
    iy = _win_start(y0.long(), eh, hp)[:, None, None] \
        + torch.arange(eh, device=dev)[None, :, None]
    ix = _win_start(x0.long(), ew, wp)[:, None, None] \
        + torch.arange(ew, device=dev)[None, None, :]
    return refs[r, iy, ix].to(torch.int32)


@functools.lru_cache(maxsize=None)
def mc_batch_core(w: int, h: int, taps: int, bd: int):
    """Batched MC for one block class.

    apply(refs [R, hp, wp] int32 (pre-padded), y0, x0 [N] int32
    (window origin in padded coordinates), ridx [N], cfy, cfx [N, taps]
    int32, inter [N] bool) -> pred [N, h, w] int32: the 14-bit
    intermediate where inter, else the final clipped sample."""
    head = max(2, IF_INTERNAL_PREC - bd)
    s1 = IF_FILTER_PREC - head
    s2 = IF_FILTER_PREC + head
    off2 = (1 << (s2 - 1)) + (IF_INTERNAL_OFFS << IF_FILTER_PREC)
    pel_max = (1 << bd) - 1
    eh, ew = h + taps - 1, w + taps - 1

    def apply(refs, y0, x0, ridx, cfy, cfx, inter):
        win = ref_windows(refs, ridx, y0, x0, eh, ew)
        # pass 1: horizontal FIR (isFirst, !isLast)
        tmp = win[:, :, 0:w] * cfx[:, 0, None, None]
        for k in range(1, taps):
            tmp = tmp + win[:, :, k:k + w] * cfx[:, k, None, None]
        tmp = (tmp - (IF_INTERNAL_OFFS << s1)) >> s1
        # pass 2: vertical FIR
        blk = tmp[:, 0:h, :] * cfy[:, 0, None, None]
        for k in range(1, taps):
            blk = blk + tmp[:, k:k + h, :] * cfy[:, k, None, None]
        interm = blk >> IF_FILTER_PREC                 # (!isFirst, !isLast)
        final = torch.clamp((blk + off2) >> s2, 0, pel_max)
        return torch.where(inter[:, None, None], interm, final)

    return apply


@functools.lru_cache(maxsize=None)
def bi_combine_core(w: int, h: int, bd: int):
    """Bi-prediction combine: the default average and the BCW weighted
    average in one pass (AreaBuf::addAvg / addWeightedAvg).  apply(a, b
    [N, h, w] int32 14-bit, w1 [N] int32 BCW weight, 4 = the default
    average) -> [N, h, w] clipped samples."""
    head = max(2, IF_INTERNAL_PREC - bd)
    sh_avg = head + 1
    off_avg = (1 << (sh_avg - 1)) + 2 * IF_INTERNAL_OFFS
    sh_bcw = head + 3
    off_bcw = (1 << (sh_bcw - 1)) + (IF_INTERNAL_OFFS << 3)
    pel_max = (1 << bd) - 1

    def apply(a, b, w1):
        avg = torch.clamp((a + b + off_avg) >> sh_avg, 0, pel_max)
        w1e = w1[:, None, None]
        bcw = torch.clamp((a * (8 - w1e) + b * w1e + off_bcw) >> sh_bcw,
                          0, pel_max)
        return torch.where(w1e == 4, avg, bcw)

    return apply


@functools.lru_cache(maxsize=None)
def wp_combine_core(w: int, h: int, bd: int):
    """Explicit weighted prediction on 14-bit intermediates
    (WeightPrediction::addWeightUni / addWeightBi).  apply(a, b
    [N, h, w], w0, o0, w1, o1, denom [N] int32, bi [N] bool) -> clipped
    samples; uni blocks ignore b, w1 and o1."""
    shift_num = max(2, IF_INTERNAL_PREC - bd)
    offs = 1 << 13
    pel_max = (1 << bd) - 1

    def apply(a, b, w0, o0, w1, o1, denom, bi):
        one = torch.ones_like(denom)
        sh_u = (denom + shift_num)[:, None, None]
        rnd_u = torch.where(sh_u > 0, one[:, None, None]
                            << torch.clamp(sh_u - 1, min=0), 0)
        uni = ((w0[:, None, None] * (a + offs) + rnd_u) >> sh_u) \
            + o0[:, None, None]
        sh_b = (denom + 1 + shift_num)[:, None, None]
        rnd_b = one[:, None, None] << torch.clamp(sh_b - 1, min=0)
        off = (o0 + o1)[:, None, None]
        bi_v = (w0[:, None, None] * (a + offs)
                + w1[:, None, None] * (b + offs)
                + rnd_b + (off << (sh_b - 1))) >> sh_b
        v = torch.where(bi[:, None, None], bi_v, uni)
        return torch.clamp(v, 0, pel_max)

    return apply


# DMVR search offsets, raster order (xProcessDMVR's 25-point pattern)
_DMVR_OFFS = tuple((hor, ver) for ver in range(-2, 3)
                   for hor in range(-2, 3))


@functools.lru_cache(maxsize=None)
def dmvr_sad25_core(dx: int, dy: int):
    """25-point DMVR SAD: bl0, bl1 [N, dy+4, dx+4] 10-bit bilinear blocks
    (centre at (2, 2)) -> [N, 25] int32, raster (ver -2..2) x (hor
    -2..2): the SAD over the even rows (subShift=1, RdCost SAD with the
    callers' >>1 pre-applied) of bl0 at (ver, hor) against bl1 at the
    mirrored offset.  All 25 windows are one strided view of each
    block."""

    def apply(bl0, bl1):
        # [N, 5, 5, dy, dx]: window (ver, hor) of each block; list 1
        # reads the mirrored offset, so its window grid is flipped
        a = bl0.unfold(1, dy, 1).unfold(2, dx, 1)
        b = bl1.unfold(1, dy, 1).unfold(2, dx, 1).flip(1, 2)
        d = (a[..., 0::2, :] - b[..., 0::2, :]).abs()
        return d.sum((3, 4)).reshape(-1, 25).to(torch.int32)

    return apply


def _bitlen(v, maxbits: int = 22):
    """int.bit_length for v >= 0 (exact, via compares; at most
    maxbits)."""
    pw = _powers_of_two(maxbits, v.dtype, v.device)
    return (v[..., None] >= pw).sum(-1).to(v.dtype)


def _rshift_msb(numer, denom):
    """rightShiftMSB (InterPrediction.cpp:92): arithmetic shift by
    floor(log2(denom)); denom >= 1."""
    return numer >> (_bitlen(denom) - 1)


@functools.lru_cache(maxsize=None)
def bdof_blend_core(w: int, h: int, bd: int):
    """Batched BDOF blend (applyBiOptFlow / BiOptFlowCore): apply(ext0,
    ext1 [N, h+2, w+2] int32, 14-bit blocks with integer-sample borders)
    -> [N, h, w] clipped samples.  The per-4x4 flow windows (6x6, stride
    4) are one strided view, so every 4x4 unit of the batch runs in the
    same ops (h, w <= 16: the BDOF application region)."""
    shift_num = IF_INTERNAL_PREC + 1 - bd
    offset = (1 << (shift_num - 1)) + 2 * IF_INTERNAL_OFFS
    limit = 15
    pel_max = (1 << bd) - 1

    def edge(a):
        """Replicate the interior's outer rows and columns into the
        1-sample border."""
        a[:, 1:h + 1, 0] = a[:, 1:h + 1, 1]
        a[:, 1:h + 1, w + 1] = a[:, 1:h + 1, w]
        a[:, 0, :] = a[:, 1, :]
        a[:, h + 1, :] = a[:, h, :]
        return a

    def grads(ext):
        gx = torch.zeros_like(ext)
        gy = torch.zeros_like(ext)
        gx[:, 1:h + 1, 1:w + 1] = (ext[:, 1:h + 1, 2:w + 2] >> 6) \
            - (ext[:, 1:h + 1, 0:w] >> 6)
        gy[:, 1:h + 1, 1:w + 1] = (ext[:, 2:h + 2, 1:w + 1] >> 6) \
            - (ext[:, 0:h, 1:w + 1] >> 6)
        return edge(gx), edge(gy), edge(ext.clone())

    def units(a):
        # [N, h/4, w/4, 6, 6]: the 6x6 window of each 4x4 unit
        return a.unfold(1, 6, 4).unfold(2, 6, 4)

    def per_sample(v):
        # [N, h/4, w/4] -> [N, h, w]: each unit's value on its 4x4
        return v.repeat_interleave(4, 1).repeat_interleave(4, 2)

    def apply(ext0, ext1):
        gx0, gy0, e0 = grads(ext0)
        gx1, gy1, e1 = grads(ext1)
        tgx = units((gx0 + gx1) >> 1)
        tgy = units((gy0 + gy1) >> 1)
        tdi = units((e1 >> 4) - (e0 >> 4))
        sgx = torch.sign(tgx)
        sgy = torch.sign(tgy)
        sum_abs_gx = tgx.abs().sum((3, 4)).to(torch.int32)
        sum_abs_gy = tgy.abs().sum((3, 4)).to(torch.int32)
        sum_dix = (sgx * tdi).sum((3, 4)).to(torch.int32)
        sum_diy = (sgy * tdi).sum((3, 4)).to(torch.int32)
        sum_sgygx = (sgy * tgx).sum((3, 4)).to(torch.int32)
        tmpx = torch.where(
            sum_abs_gx == 0, 0,
            _rshift_msb(sum_dix * 4, torch.clamp(sum_abs_gx, min=1)))
        tmpx = torch.clamp(tmpx, -limit, limit)
        mains = sum_sgygx >> 12
        secs = sum_sgygx & 4095
        tmp_data = ((tmpx * mains) * (1 << 12) + tmpx * secs) >> 1
        tmpy = torch.where(
            sum_abs_gy == 0, 0,
            _rshift_msb(sum_diy * 4 - tmp_data,
                        torch.clamp(sum_abs_gy, min=1)))
        tmpy = torch.clamp(tmpy, -limit, limit)
        inner = (slice(None), slice(1, h + 1), slice(1, w + 1))
        bterm = per_sample(tmpx) * (gx0[inner] - gx1[inner]) \
            + per_sample(tmpy) * (gy0[inner] - gy1[inner])
        return torch.clamp((e0[inner] + e1[inner] + bterm + offset)
                           >> shift_num, 0, pel_max)

    return apply


def mc_coeff_rows(fracs, comp: int, alt_hpel=None, luma_table=None):
    """Per-block FIR coefficient rows (numpy [N, taps] int32).  fracs: [N]
    fraction indices (1/16 luma, 1/32 chroma); 0 maps to the identity
    row.  alt_hpel: optional [N] bool (frac 8 -> the 6-tap alternate
    half-pel filter)."""
    from vvdec_tpu_torch.frame.inter_np import ALT_HPEL_IF, CHROMA_IF, LUMA_IF
    table = (luma_table if luma_table is not None else LUMA_IF) \
        if comp == 0 else CHROMA_IF
    taps = table.shape[1]
    rows = np.asarray(table, dtype=np.int32)[np.asarray(fracs)]
    ident = np.zeros(taps, dtype=np.int32)
    ident[taps // 2 - 1] = 64
    rows[np.asarray(fracs) == 0] = ident
    if comp == 0 and alt_hpel is not None:
        sel = np.asarray(alt_hpel) & (np.asarray(fracs) == 8)
        rows[sel] = ALT_HPEL_IF[:taps]
    return rows


def _cu_mc_eligible(cs, cu) -> bool:
    """Translational whole-CU MC in the regular batches: everything with
    subblock motion, pixel-adaptive refinement or special gather windows
    is out (the same split walk9.c's ix_cu_eligible makes).  A CU that
    DMVR or BDOF refines is not eligible here: it takes the refinement
    stage (ops/dmvr_device.py) instead; GPM, affine, SbTMVP and CIIP CUs
    take their own batches."""
    from vvdec_tpu_torch.frame.dmvr_np import bdof_condition, dmvr_condition
    from vvdec_tpu_torch.frame.structure import MODE_INTER
    if cu.pred_mode != MODE_INTER or cu.inter_dir not in (1, 2, 3):
        return False
    if cu.affine_flag or cu.geo_flag or cu.ciip_flag or cu.merge_type:
        return False
    if dmvr_condition(cs, cu) or bdof_condition(cs, cu):
        return False
    if cs.sps.ref_wraparound_enabled or cs.subpics:
        return False
    for lst in (0, 1):
        if cu.inter_dir & (1 << lst):
            if cu.ref_idx[lst] < 0 or \
                    cs.ref_scaled[lst][cu.ref_idx[lst]] is not None:
                return False
    return True


def mc_frame_device(cs, device=None) -> dict:
    """Batched MC of every eligible inter CU of one picture, off the host
    reference planes cs.ref_planes, on `device` (default CUDA).

    Groups CUs by (w, h), pads each reference plane once, and runs one
    mc_batch_core launch per (size class, component) and the combine of
    the decode path (ops/frame_device.McFrame).  Returns {cu_idx: [pred
    planes]} of final clipped samples as numpy; the test-only readback
    of the reference's driver (tests/test_torch_mc.py holds it to
    vvdec_tpu's mc_frame_device)."""
    from vvdec_tpu_torch.ops.frame_device import McFrame
    dev = resolve_device(device)
    mf = McFrame(cs)
    for cu in cs.cus:
        if cu is not None and _cu_mc_eligible(cs, cu):
            mf.add_regular(cu)
    if not mf.batches:
        return {}

    def get_ref(lst, ref_idx, comp):
        return torch.as_tensor(np.asarray(
            cs.ref_planes[lst][ref_idx][comp], dtype=np.int32), device=dev)

    out: dict = {}
    for b, pred in mf.predict(get_ref, dev):
        pred = pred.cpu().numpy()
        for j, idx in enumerate(b.cu_idx):
            out.setdefault(idx, [None] * cs.num_comp)[b.comp] = pred[j]
    return out
