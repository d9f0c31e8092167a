"""Device DMVR + BDOF: decoder-side MV refinement and bi-directional
optical flow inside the device decode path, in PyTorch.

Port of vvdec_tpu/ops/dmvr_device.py.  DMVR's refined motion is
data-dependent: the 25-point SAD search and the parametric sub-pel fit
decide the final gather positions.  The search, the argmin / threshold
decision, the sub-pel error-surface fit, the final 8/4-tap MC at the
refined MV and the per-subblock BDOF blend all run on the device as
integer tensor programs; the refined MVs never visit the host
mid-frame.  The one readback is a small [Nsub, 4] refined-MV tensor per
subblock class, copied without blocking into pinned memory as soon as
it is decided and read when the decoder writes the motion-field fixups
(the analog of DecCu::TaskFinishMotionInfo, DecCu.cpp:161-213).

The reference re-reads the refined position through a pad-limited
prefetch window around the ORIGINAL merge MV (xPrefetchPad,
InterPrediction.cpp:1525 + paddingCore<2> :283): sample coordinates
clamp to that window first, then to the picture.  Both clamps are index
arithmetic on a device patch, selected per subblock between the window
path (the integer position moved) and the plain picture-clamped path.

Differences from the JAX drivers, none of which changes a decoded
sample: the host plans every DMVR subblock and BDOF region of a picture
in numpy (`plan_dmvr`, `plan_bdof`) into the picture's one MC upload;
subblocks and regions are batched by their shape, across CU sizes (the
JAX drivers batch per CU size), with both lists in one launch; the
bilinear pre-MC reads each subblock's window directly instead of
slicing a CU-wide buffer (the CU-wide window never reaches the padded
plane's edge, so the samples are the same); a standalone BDOF CU's
chroma is the regular bi-average of the whole CU, planned in the
regular batches.  Reference planes are McFrame's, keyed by POC.

Bit-exact parity targets: InterPrediction::xProcessDMVR
(InterPrediction.cpp:1847), xBIPMVRefine (:1709), xSubPelErrorSrfc
(:1656), xFinalPaddedMCForDMVR (:1736), applyBiOptFlow (:1290),
xSubPuBio (:551).  Host golden: frame/dmvr_np.py + frame/recon_np.py
_dmvr_mc / _bdof_mc.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.intra_device import _win_start
from vvdec_tpu_torch.ops.mc_device import (
    IF_INTERNAL_OFFS,
    bdof_blend_core,
    bi_combine_core,
    dmvr_sad25_core,
    mc_coeff_rows,
    ref_windows,
)
from vvdec_tpu_torch.utils.trace import profiler

DMVR_ITER = 2
DMVR_SUBCU = 16
BDOF_REGION = 16


def _tables():
    from vvdec_tpu_torch.frame.inter_np import (
        ALT_HPEL_IF, BILINEAR_IF, CHROMA_IF, LUMA_IF)
    return LUMA_IF, CHROMA_IF, BILINEAR_IF, ALT_HPEL_IF


@functools.lru_cache(maxsize=None)
def _filter_rows(comp: int, device):
    """(coefficient table [fractions, taps], alternate half-pel row) of a
    component class as int32 tensors on `device`, uploaded once."""
    luma_t, chroma_t, _, alt_t = _tables()
    tab = luma_t if comp == 0 else chroma_t
    return (torch.as_tensor(np.asarray(tab, np.int32), device=device),
            torch.as_tensor(np.asarray(alt_t, np.int32), device=device))


def _clip18(v):
    return torch.clamp(v, -(1 << 17), (1 << 17) - 1)


def _clip(v, lo, hi):
    """jnp.clip with tensor bounds: max with lo, then min with hi."""
    return torch.minimum(torch.maximum(v, lo), hi)


# ----------------------------------------------------------------------
# bilinear pre-MC (xinitMC; 2-tap at 10-bit precision)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def bilin_cu_core(bw: int, bh: int, bd: int):
    """Bilinear buffers [N, bh, bw] (bh, bw include the 2*ITER margin):
    apply(refs [R, hp, wp], y0, x0 [N] (window origin, padded
    coordinates), ridx [N], cfy, cfx [N, 2]).  Fraction 0 rides the
    identity row (16, 0), bit-exact with the copy / H-only / V-only
    branches of dmvr_np.bilinear_pred for bd <= 10."""
    sh1 = 4 - (10 - bd)  # IF_PREC_BILINEAR - (10-bit prec - bd)

    def apply(refs, y0, x0, ridx, cfy, cfx):
        win = ref_windows(refs, ridx, y0, x0, bh + 1, bw + 1)
        tmp = (win[:, :, 0:bw] * cfx[:, 0, None, None]
               + win[:, :, 1:bw + 1] * cfx[:, 1, None, None]
               + (1 << (sh1 - 1))) >> sh1
        return (tmp[:, 0:bh, :] * cfy[:, 0, None, None]
                + tmp[:, 1:bh + 1, :] * cfy[:, 1, None, None] + 8) >> 4

    return apply


# ----------------------------------------------------------------------
# 25-point decision + parametric sub-pel (xBIPMVRefine/xSubPelErrorSrfc)
# ----------------------------------------------------------------------
def _div_for_maxq7(n, d):
    """xDivForMaxq7 (3-step non-restoring divide), int32."""
    sign = n < 0
    n = n.abs()
    d = d << 3
    ge = n >= d
    q = ge.to(torch.int32)
    n = n - torch.where(ge, d, 0)
    q = q << 1
    d = d >> 1
    ge = n >= d
    q = q + ge
    n = n - torch.where(ge, d, 0)
    q = q << 1
    q = q + (n >= (d >> 1))
    return torch.where(sign, -q, q)


def _subpel_axis(sc, s1, s3):
    num = (s1 - s3) * 16
    den = s1 + s3 - 2 * sc
    q = _div_for_maxq7(num, torch.where(den == 0, 1, den))
    edge = torch.where(s1 == sc, -8, 8).to(torch.int32)
    inner = (s1 != sc) & (s3 != sc)
    return torch.where(den == 0, 0, torch.where(inner, q, edge))


@functools.lru_cache(maxsize=None)
def dmvr_decide_core(dx: int, dy: int):
    """sads [N, 25] (raster, centre at 12) -> (dmv [N, 2] 1/16-pel,
    min_cost [N]), as dmvr_np.dmvr_search: the reduced-centre early
    exit, the strict-less raster scan (the first minimum wins, and the
    centre wins its ties) and no sub-pel fit for a ring cell.  The scan
    is the minimum of one composite key (doubled cost, centre less one,
    times 32, plus the raster index), so no tie rule of argmin is
    relied on."""
    thres = dx * dy

    def apply(sads):
        center = sads[:, 12]
        mc0 = center - (center >> 2)
        early = mc0 < thres
        s = sads.clone()
        s[:, 12] = mc0
        s2 = s.long() * 2
        s2[:, 12] -= 1
        key = (s2 + 1) * 32 + torch.arange(25, device=sads.device)
        bidx = (key.min(1).values % 32).to(torch.int32)
        bcost = s.gather(1, bidx.long()[:, None])[:, 0]
        bhor = bidx % 5 - 2
        bver = bidx // 5 - 2
        inner = (bhor.abs() < 2) & (bver.abs() < 2)
        bi = torch.where(inner, bidx, 12).long()

        def at(off):
            return s.gather(1, (bi + off)[:, None])[:, 0]

        dmx = _subpel_axis(at(0), at(-1), at(1))
        dmy = _subpel_axis(at(0), at(-5), at(5))
        tx = bhor * 16 + torch.where(inner, dmx, 0)
        ty = bver * 16 + torch.where(inner, dmy, 0)
        dmv = torch.stack([torch.where(early, 0, tx),
                           torch.where(early, 0, ty)], 1)
        cost = torch.where(early, mc0, bcost)
        return dmv, cost

    return apply


# ----------------------------------------------------------------------
# final MC at the refined MV (xFinalPaddedMCForDMVR)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def dmvr_final_core(bw: int, bh: int, comp: int, shx: int, shy: int,
                    bd: int, with_ext: bool):
    """Final MC of one DMVR subblock class and one component class at
    the refined MV.  comp 0: luma, 8-tap (+ the BDOF border samples when
    with_ext); otherwise chroma: 4-tap, fractions in 1/32.

    apply(refs [R, hp, wp] (padded by m), ridx, bx, by (component
    coordinates), mv0x, mv0y (merge MV), bxmin, bxmax, bymin, bymax
    (the subblock's MV clip window), dmvx, dmvy (refinement), alt
    [N], m, W, H (the component's padding and size)) -> blk [N, bh, bw]
    14-bit (and ext [N, bh+2, bw+2] when with_ext)."""
    taps = 8 if comp == 0 else 4
    half = taps // 2 - 1
    head = max(2, 14 - bd)
    s1 = 6 - head
    Kw, Kh = bw + taps - 1, bh + taps - 1
    fsc = 5 - shx if comp else 0   # chroma fraction upscale (per axis)
    fsy = 5 - shy if comp else 0

    def coords(base, w0, d, mvc, sh, K, lim, use):
        # FIR window positions, both paths, then the picture clamp
        j = torch.arange(K, device=base.device)
        w0 = w0[:, None]
        pw = _clip(w0 + d[:, None] + j, w0, w0 + K - 1)
        pp = base[:, None] + (mvc >> sh)[:, None] - half + j
        return torch.clamp(torch.where(use[:, None], pw, pp), 0, lim - 1)

    def apply(refs, ridx, bx, by, mv0x, mv0y, bxmin, bxmax, bymin, bymax,
              dmvx, dmvy, alt, m: int, W: int, H: int):
        dev = refs.device
        tab, alt_row = _filter_rows(comp, dev)
        rmvx = _clip18(mv0x + dmvx)
        rmvy = _clip18(mv0y + dmvy)
        mvcx = _clip(rmvx, bxmin, bxmax)
        mvcy = _clip(rmvy, bymin, bymax)
        dix = (rmvx >> shx) - (mv0x >> shx)
        diy = (rmvy >> shy) - (mv0y >> shy)
        fx = (mvcx & ((1 << shx) - 1)) << fsc
        fy = (mvcy & ((1 << shy) - 1)) << fsy
        use_win = (dix != 0) | (diy != 0)
        # pad-limited window around the merge MV (xPrefetchPad)
        wmx = _clip(mv0x - (half << shx), bxmin, bxmax)
        wmy = _clip(mv0y - (half << shy), bymin, bymax)
        wx = bx + (wmx >> shx)
        wy = by + (wmy >> shy)
        cols = coords(bx, wx, dix, mvcx, shx, Kw, W, use_win)
        rows = coords(by, wy, diy, mvcy, shy, Kh, H, use_win)
        if with_ext:
            # BDOF border coordinates, computed before the patch origin:
            # the window path's integer position carries the golden's
            # +half (xPrefetchPad passes int_x = (wmv>>sh) + d_int + half
            # and mc_from_view's x0 subtracts it again), and the border
            # origin can sit below the FIR window start, so the patch
            # starts at the minimum of both index sets
            intx = torch.where(use_win, (wmx >> shx) + dix + half,
                               mvcx >> shx)
            inty = torch.where(use_win, (wmy >> shy) + diy + half,
                               mvcy >> shy)
            rx = bx + intx - 1 + (fx >= 8)
            ry = by + inty - 1 + (fy >= 8)
            je = rx[:, None] + torch.arange(bw + 2, device=dev)
            ie = ry[:, None] + torch.arange(bh + 2, device=dev)
            cew = _clip(je, wx[:, None], wx[:, None] + Kw - 1)
            ce = torch.clamp(torch.where(use_win[:, None], cew, je), 0,
                             W - 1)
            rew = _clip(ie, wy[:, None], wy[:, None] + Kh - 1)
            re = torch.clamp(torch.where(use_win[:, None], rew, ie), 0,
                             H - 1)
            py = torch.minimum(rows[:, 0], re[:, 0])
            px = torch.minimum(cols[:, 0], ce[:, 0])
        else:
            py = rows[:, 0]
            px = cols[:, 0]
        # the (Kh+2, Kw+2) patch at (py, px), placed as lax.dynamic_slice
        # places it (+2: the min-origin shift can push the FIR rows up to
        # 2 beyond K relative to the patch start; the margin covers it),
        # read at the positions relative to (py, px)
        n_r, hp, wp = refs.shape
        r = _win_start(ridx.long(), 1, n_r)[:, None, None]
        y0 = _win_start((py + m).long(), Kh + 2, hp)
        x0 = _win_start((px + m).long(), Kw + 2, wp)

        def patch(ri, ci):
            return refs[r, (y0[:, None] + (ri - py[:, None]))[:, :, None],
                        (x0[:, None] + (ci - px[:, None]))[:, None, :]]

        win = patch(rows, cols).to(torch.int32)
        cfx = tab[fx.long()]
        cfy = tab[fy.long()]
        if comp == 0:
            cfx = torch.where((alt & (fx == 8))[:, None], alt_row, cfx)
            cfy = torch.where((alt & (fy == 8))[:, None], alt_row, cfy)
        tmp = win[:, :, 0:bw] * cfx[:, 0, None, None]
        for k in range(1, taps):
            tmp = tmp + win[:, :, k:k + bw] * cfx[:, k, None, None]
        tmp = (tmp - (IF_INTERNAL_OFFS << s1)) >> s1
        blk = tmp[:, 0:bh, :] * cfy[:, 0, None, None]
        for k in range(1, taps):
            blk = blk + tmp[:, k:k + bh, :] * cfy[:, k, None, None]
        blk = blk >> 6
        if not with_ext:
            return blk
        # BDOF integer-sample borders at the nearest-integer position
        # (xPredInterBlk bio tail, InterPrediction.cpp:863-889)
        ext = (patch(re, ce).to(torch.int32) << head) - IF_INTERNAL_OFFS
        ext[:, 1:bh + 1, 1:bw + 1] = blk
        return blk, ext

    return apply


@functools.lru_cache(maxsize=None)
def _fixup_mv_core():
    """The refined MVs of both lists: [N, 4] (mv0 + dmv, mv1 - dmv),
    each clipped to 18 bits."""

    def apply(m0x, m0y, m1x, m1y, dmv):
        return torch.stack([_clip18(m0x + dmv[:, 0]),
                            _clip18(m0y + dmv[:, 1]),
                            _clip18(m1x - dmv[:, 0]),
                            _clip18(m1y - dmv[:, 1])], 1)

    return apply


@functools.lru_cache(maxsize=None)
def _bdof_select_core(dx: int, dy: int, bd: int):
    """where(bio_sub, bdof_blend, bi_average) for DMVR subblocks."""
    blend = bdof_blend_core(dx, dy, bd)
    head = max(2, 14 - bd)
    sh = head + 1
    off = (1 << (sh - 1)) + 2 * IF_INTERNAL_OFFS
    pel_max = (1 << bd) - 1

    def apply(blk0, blk1, ext0, ext1, bio):
        avg = torch.clamp((blk0 + blk1 + off) >> sh, 0, pel_max)
        return torch.where(bio[:, None, None], blend(ext0, ext1), avg)

    return apply


@functools.lru_cache(maxsize=None)
def mc_ext_core(bw: int, bh: int, bd: int):
    """14-bit MC + BDOF border samples at static positions (standalone
    BDOF regions: the merge MV unrefined, fractions known on the host).
    apply(refs, y0, x0 (FIR origin, padded), yb, xb (border origin,
    padded), ridx, cfy, cfx [N, 8]) -> ext [N, bh+2, bw+2]."""
    taps = 8
    head = max(2, 14 - bd)
    s1 = 6 - head
    Kw, Kh = bw + taps - 1, bh + taps - 1

    def apply(refs, y0, x0, yb, xb, ridx, cfy, cfx):
        win = ref_windows(refs, ridx, y0, x0, Kh, Kw)
        tmp = win[:, :, 0:bw] * cfx[:, 0, None, None]
        for k in range(1, taps):
            tmp = tmp + win[:, :, k:k + bw] * cfx[:, k, None, None]
        tmp = (tmp - (IF_INTERNAL_OFFS << s1)) >> s1
        blk = tmp[:, 0:bh, :] * cfy[:, 0, None, None]
        for k in range(1, taps):
            blk = blk + tmp[:, k:k + bh, :] * cfy[:, k, None, None]
        s = ref_windows(refs, ridx, yb, xb, bh + 2, bw + 2)
        ext = (s << head) - IF_INTERNAL_OFFS
        ext[:, 1:bh + 1, 1:bw + 1] = blk >> 6
        return ext

    return apply


class LazyDmvrFixups:
    """cs.dmvr_fixups for the device path: iterating yields the
    (x2, y2, mv0, mv1) records of the refined MVs, subblock by subblock.
    Each subblock class's [Nsub, 4] refined MVs are copied to pinned
    host memory without blocking as soon as they are decided, behind a
    CUDA event; iterating waits on those events only, not on the rest
    of the picture queued after them."""

    def __init__(self):
        self._parts: list = []  # (positions [P, 3], host [N, 4], event)

    def add(self, positions, dev_arr) -> None:
        """positions: numpy [P, 3] (x2, y2, subblock index); dev_arr:
        the refined MVs [Nsub, 4] on the device."""
        event = None
        if dev_arr.is_cuda:
            host = torch.empty(dev_arr.shape, dtype=dev_arr.dtype,
                               pin_memory=True)
            host.copy_(dev_arr, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = dev_arr
        self._parts.append((positions, host, event))

    def __iter__(self):
        for positions, host, event in self._parts:
            if event is not None:
                with profiler.stage("wait: dmvr fixups"):
                    event.synchronize()
            a = host.numpy().tolist()
            for x2, y2, k in positions.tolist():
                yield (x2, y2, (a[k][0], a[k][1]), (a[k][2], a[k][3]))

    def __bool__(self):
        return bool(self._parts)


# ----------------------------------------------------------------------
# host plans (numpy) and the picture-level drivers
# ----------------------------------------------------------------------
class ScatterTarget:
    """Where a refined prediction goes: blocks of (cw, ch) of component
    comp at the (x, y) rows of the upload handle h_blocks (the columns
    the MC scatter reads); no CIIP raw blocks."""

    __slots__ = ("comp", "cw", "ch", "h_blocks", "raw", "family")

    def __init__(self, comp, cw, ch, h_blocks, family):
        self.comp, self.cw, self.ch = comp, cw, ch
        self.h_blocks, self.family = h_blocks, family
        self.raw = None


def _mv_window(cs, x, y):
    """clip_mv's window (xmin, xmax, ymin, ymax) for blocks at (x, y), 1/16
    pel (no wraparound, no subpictures: the device path rejects them)."""
    ctu = cs.sps.ctu_size
    return (((-ctu - 8 - x + 1) << 4), ((cs.w + 8 - x - 1) << 4),
            ((-ctu - 8 - y + 1) << 4), ((cs.h + 8 - y - 1) << 4))


def _cu_rows(cs, cus, ref_index) -> np.ndarray:
    """[N, 10] int64: x, y, w, h, mv0 (x, y), mv1 (x, y), the stacked
    reference index of each list, per CU."""
    return np.array([[cu.x, cu.y, cu.w, cu.h,
                      int(cu.mv[0][0]), int(cu.mv[0][1]),
                      int(cu.mv[1][0]), int(cu.mv[1][1]),
                      ref_index(0, cu.ref_idx[0]),
                      ref_index(1, cu.ref_idx[1])] for cu in cus],
                    dtype=np.int64).reshape(-1, 10)


def _tiles(rows, tw, th):
    """Expand CUs into their (tw, th) tiles, raster order within a CU:
    (CU index, x offset, y offset) per tile."""
    nx, ny = rows[:, 2] // tw, rows[:, 3] // th
    cnt = nx * ny
    cu = np.repeat(np.arange(len(rows)), cnt)
    k = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return cu, (k % nx[cu]) * tw, (k // nx[cu]) * th


def _fixup_positions(sbx, sby, dx, dy) -> np.ndarray:
    """[P, 3] (x2, y2, subblock index): the 8x8-grid points inside each
    subblock, y outer and x inner (TaskFinishMotionInfo's loop)."""
    kx = np.arange(dx // 8 + 1)
    ky = np.arange(dy // 8 + 1)
    x2 = (((sbx - 1) & ~7) + 8)[:, None] + 8 * kx
    y2 = (((sby - 1) & ~7) + 8)[:, None] + 8 * ky
    ok = (y2 < (sby + dy)[:, None])[:, :, None] \
        & (x2 < (sbx + dx)[:, None])[:, None, :]
    k, iy, ix = np.nonzero(ok)
    return np.stack([x2[k, ix], y2[k, iy], k], 1)


class _Plan:
    """One shape class of DMVR subblocks or BDOF regions: its shape, its
    count and its upload handles."""

    def __init__(self, w, h, n):
        self.w, self.h, self.n = w, h, n


def plan_dmvr(cs, entries, ref_index, margin, up) -> list:
    """The DMVR subblocks of a picture, batched by subblock shape: per
    class the bilinear windows and coefficients, the final-MC parameters
    of both lists (list 0's rows, then list 1's), the BDOF flags, the
    scatter positions and the fixup positions, added to the upload `up`.
    entries: [(cu, bio)] of the DMVR CUs; ref_index(lst, ref_idx) ->
    the index of the reference in the stacked planes."""
    _, _, bilinear_t, _ = _tables()
    bilinear_t = np.asarray(bilinear_t, np.int64)
    cus = [cu for cu, _ in entries]
    rows = _cu_rows(cs, cus, ref_index)
    alt = np.array([int(cu.alt_hpel) for cu in cus], np.int64)
    bio = np.array([int(b) for _, b in entries], np.int64)
    dxs = np.minimum(rows[:, 2], DMVR_SUBCU)
    dys = np.minimum(rows[:, 3], DMVR_SUBCU)
    plans = []
    for dx, dy in sorted(set(zip(dxs.tolist(), dys.tolist()))):
        sel = np.flatnonzero((dxs == dx) & (dys == dy))
        r = rows[sel]
        ci, xs, ys = _tiles(r, dx, dy)
        r = r[ci]
        sbx, sby = r[:, 0] + xs, r[:, 1] + ys
        n = len(sbx)
        # the CU's MV clip (clip_mv at the CU origin) for the bilinear
        # search windows; the subblock's for the final MC
        cxmin, cxmax, cymin, cymax = _mv_window(cs, r[:, 0], r[:, 1])
        bxmin, bxmax, bymin, bymax = _mv_window(cs, sbx, sby)
        bil, fin = [], []
        for lst in (0, 1):
            mvx, mvy = r[:, 4 + 2 * lst], r[:, 5 + 2 * lst]
            mbx = np.clip(mvx, cxmin, cxmax) - (DMVR_ITER << 4)
            mby = np.clip(mvy, cymin, cymax) - (DMVR_ITER << 4)
            ridx = r[:, 8 + lst]
            bil.append(np.stack([ridx, sby + (mby >> 4) + margin,
                                 sbx + (mbx >> 4) + margin], 1))
            bil.append(np.concatenate([bilinear_t[mby & 15],
                                       bilinear_t[mbx & 15]], 1))
            fin.append(np.stack([ridx, sbx, sby, mvx, mvy, bxmin, bxmax,
                                 bymin, bymax, alt[sel][ci]], 1))
        p = _Plan(dx, dy, n)
        p.h_bil = up.add(np.concatenate([
            np.concatenate(bil[0:2], 1), np.concatenate(bil[2:4], 1)]))
        p.h_fin = up.add(np.concatenate(fin))
        p.h_bio = up.add(bio[sel][ci])
        p.h_pos = [up.add(np.stack([sbx, sby], 1))]
        if cs.num_comp > 1:
            p.h_pos.append(up.add(np.stack([sbx // cs.sub_w,
                                            sby // cs.sub_h], 1)))
        p.positions = _fixup_positions(sbx, sby, dx, dy)
        plans.append(p)
    return plans


def run_dmvr_groups(cs, plans, up, refs, margin,
                    fixups: LazyDmvrFixups) -> list:
    """Device DMVR (+ per-subblock BDOF) of every planned subblock class:
    [(ScatterTarget, prediction)] for the luma and chroma scatter; the
    refined MVs go to `fixups`.  refs: comp -> stacked padded planes."""
    bd = cs.sps.bit_depth
    out = []
    for p in plans:
        dx, dy, n = p.w, p.h, p.n
        B = up.get(p.h_bil)
        bl = bilin_cu_core(dx + 2 * DMVR_ITER, dy + 2 * DMVR_ITER, bd)(
            refs[0], B[:, 1], B[:, 2], B[:, 0], B[:, 3:5], B[:, 5:7])
        sads = dmvr_sad25_core(dx, dy)(bl[:n], bl[n:])
        dmv, cost = dmvr_decide_core(dx, dy)(sads)
        F = up.get(p.h_fin)
        fixups.add(p.positions, _fixup_mv_core()(
            F[:n, 3], F[:n, 4], F[n:, 3], F[n:, 4], dmv))
        bio = (up.get(p.h_bio) != 0) & (cost >= 2 * dx * dy)
        dmv2 = torch.cat([dmv, -dmv])

        def final(comp, bw, bh, shx, shy, with_ext, sub_w=1, sub_h=1):
            # the core is keyed on the component class (luma / chroma)
            core = dmvr_final_core(bw, bh, min(comp, 1), shx, shy, bd,
                                   with_ext)
            return core(
                refs[comp], F[:, 0], F[:, 1] // sub_w, F[:, 2] // sub_h,
                F[:, 3], F[:, 4], F[:, 5], F[:, 6], F[:, 7], F[:, 8],
                dmv2[:, 0], dmv2[:, 1], F[:, 9] != 0, margin // sub_h,
                *cs.comp_size[comp])

        blk, ext = final(0, dx, dy, 4, 4, True)
        out.append((ScatterTarget(0, dx, dy, p.h_pos[0], "DMVR"),
                    _bdof_select_core(dx, dy, bd)(blk[:n], blk[n:], ext[:n],
                                                  ext[n:], bio)))
        if cs.num_comp == 1:
            continue
        cdx, cdy = dx // cs.sub_w, dy // cs.sub_h
        shx, shy = 4 + (cs.sub_w - 1), 4 + (cs.sub_h - 1)
        four = torch.full((n,), 4, dtype=torch.int32, device=dmv.device)
        for comp in (1, 2):
            part = final(comp, cdx, cdy, shx, shy, False, cs.sub_w, cs.sub_h)
            out.append((ScatterTarget(comp, cdx, cdy, p.h_pos[1], "DMVR"),
                        bi_combine_core(cdx, cdy, bd)(part[:n], part[n:],
                                                      four)))
    return out


def plan_bdof(cs, cus, ref_index, margin, up) -> list:
    """The luma BDOF regions (16x16 at most) of the standalone BDOF CUs,
    batched by region shape: the FIR and border origins, reference index
    and coefficient rows of both lists (list 0's rows, then list 1's)
    and the scatter positions, added to the upload `up`.  Their chroma
    is the regular bi-average, planned with the regular batches."""
    rows = _cu_rows(cs, cus, ref_index)
    alt = np.array([bool(cu.alt_hpel) for cu in cus], bool)
    tws = np.minimum(rows[:, 2], BDOF_REGION)
    ths = np.minimum(rows[:, 3], BDOF_REGION)
    plans = []
    for tw, th in sorted(set(zip(tws.tolist(), ths.tolist()))):
        sel = np.flatnonzero((tws == tw) & (ths == th))
        ci, xs, ys = _tiles(rows[sel], tw, th)
        r = rows[sel][ci]
        a = alt[sel][ci]
        rx, ry = r[:, 0] + xs, r[:, 1] + ys
        xmin, xmax, ymin, ymax = _mv_window(cs, r[:, 0], r[:, 1])
        parts = []
        for lst in (0, 1):
            mvx = np.clip(r[:, 4 + 2 * lst], xmin, xmax)
            mvy = np.clip(r[:, 5 + 2 * lst], ymin, ymax)
            ix, iy, fx, fy = mvx >> 4, mvy >> 4, mvx & 15, mvy & 15
            parts.append(np.concatenate([
                np.stack([ry + iy - 3 + margin, rx + ix - 3 + margin,
                          ry + iy - 1 + (fy >= 8) + margin,
                          rx + ix - 1 + (fx >= 8) + margin,
                          r[:, 8 + lst]], 1),
                mc_coeff_rows(fy, 0, alt_hpel=a),
                mc_coeff_rows(fx, 0, alt_hpel=a)], 1))
        p = _Plan(tw, th, len(rx))
        p.h_mc = up.add(np.concatenate(parts))
        p.h_pos = up.add(np.stack([rx, ry], 1))
        plans.append(p)
    return plans


def run_bdof_groups(cs, plans, up, refs) -> list:
    """Standalone BDOF (no DMVR) of every planned region class, merge
    MVs unrefined (xSubPuBio): [(ScatterTarget, luma prediction)]."""
    bd = cs.sps.bit_depth
    out = []
    for p in plans:
        tw, th, n = p.w, p.h, p.n
        P = up.get(p.h_mc)
        ext = mc_ext_core(tw, th, bd)(refs[0], P[:, 0], P[:, 1], P[:, 2],
                                      P[:, 3], P[:, 4], P[:, 5:13],
                                      P[:, 13:21])
        out.append((ScatterTarget(0, tw, th, p.h_pos, "BDOF"),
                    bdof_blend_core(tw, th, bd)(ext[:n], ext[n:])))
    return out
