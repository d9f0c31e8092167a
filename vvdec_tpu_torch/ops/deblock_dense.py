"""Dense whole-frame deblocking: the PyTorch port of
vvdec_tpu/ops/deblock_dense.py.

Every pixel evaluates the full VVC edge-filter decision tree as if an
edge sat at its own column; results are then routed from the true 4-grid
(8-grid chroma) edge positions to the written pixels by constant phase
masks and shifts.  All reads are constant-offset column windows of an
edge-replicated plane; all per-cell parameters ride one packed int16
grid per direction, expanded to pixels by repeats.  Horizontal edges run
the same core on transposed planes and grids.

The edge padding is built from clamped column indices: torch's
`replicate` pad does not take integer tensors on CUDA.

Parity targets: LoopFilter::xEdgeFilterLuma / xEdgeFilterChroma
(LoopFilter.cpp:851-1210).

On the card the filter chain deblocks with the kernel csrc/deblock.cu
(ops/cuda/deblock.deblock_dense_cuda); these cores, composed by
ops/cuda/deblock.deblock_dense_ref, are its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.pipeline import _DB_BETA, _DB_DB, _DB_TC, _DB_TCC

# ---------------------------------------------------------------------
# packed per-cell grid layouts (int16, one per direction)
#   luma:   bs(2) | qp(7)<<2 | max_fl_p(3)<<9 | max_fl_q(3)<<12
#   chroma: bs(2) | qp(7)<<2 | large(1)<<9          (one grid per comp)
# slice-level tc/beta offsets ride a tiny [n_sl, 6] table selected by a
# per-cell slice-index grid (cols: y_tc, y_beta, cb_tc, cb_beta, cr_tc,
# cr_beta).
# ---------------------------------------------------------------------


def pack_luma_grid(ep) -> np.ndarray:
    """EdgeParams -> packed int16 [h4, w4] luma grid."""
    return (ep.bs_y.astype(np.int32)
            | (ep.qp_y.astype(np.int32) << 2)
            | (ep.max_fl_p.astype(np.int32) << 9)
            | (ep.max_fl_q.astype(np.int32) << 12)).astype(np.int16)


def pack_chroma_grid(ep, comp: int) -> np.ndarray:
    """EdgeParams -> packed int16 [h4, w4] chroma grid for comp (1|2)."""
    bs = (ep.bs_cb if comp == 1 else ep.bs_cr).astype(np.int32)
    qp = (ep.qp_cb if comp == 1 else ep.qp_cr).astype(np.int32)
    return (bs | (qp << 2)
            | ((ep.cmfl.astype(np.int32) != 0) << 9)).astype(np.int16)


def _seg(v, r: int, L: int):
    """Broadcast row r of every L-row segment to the whole segment."""
    H, W = v.shape
    v3 = v.reshape(H // L, L, W)
    return v3[:, r: r + 1, :].expand(H // L, L, W).reshape(H, W)


def _sh(a, r: int):
    """S[y, x] = a[y, x - r], zero fill outside."""
    if r == 0:
        return a
    H, W = a.shape
    z = torch.zeros((H, abs(r)), dtype=a.dtype, device=a.device)
    if r > 0:
        return torch.cat([z, a[:, :W - r]], 1)
    return torch.cat([a[:, -r:], z], 1)


def _sel3(cls_, v0, v1, v2):
    return torch.where(cls_ == 0, v0, torch.where(cls_ == 1, v1, v2))


def _sl_sel(si, sltab, col: int, n_sl: int):
    acc = sltab[0, col].expand(si.shape)
    for s in range(1, n_sl):
        acc = torch.where(si == s, sltab[s, col], acc)
    return acc


def _tc_of(idx, bd: int, tc_tab):
    t = tc_tab[idx.long()]
    if bd >= 10:
        return t << (bd - 10)
    return (t + (1 << (9 - bd))) >> (10 - bd)


def _edge_cols(W: int, pad: int, device):
    """Column indices of the plane padded by `pad` edge columns a side."""
    return torch.clamp(torch.arange(-pad, W + pad, device=device), 0, W - 1)


def _rep(v, fy: int, fx: int):
    return v.repeat_interleave(fy, 0).repeat_interleave(fx, 1)


@functools.lru_cache(maxsize=None)
def deblock_luma_dense_core(H: int, W: int, bd: int, ctu: int, dir1: bool,
                            n_sl: int, device: str):
    """Dense luma edge filter; edges vertical on 4-grid columns.

    apply(plane [H, W], grid [H4, W4] int16, si [H4, W4] int16,
          sltab [n_sl, 6] int32) -> filtered plane, on `device`.
    For the horizontal direction the caller transposes plane and grids
    (dir1 only toggles the no-large-P-at-CTU-boundary rule)."""
    dev = torch.device(device)
    pel_max = (1 << bd) - 1
    W4 = W // 4
    xs = torch.arange(W, device=dev)
    phase_m = [((xs & 3) == p)[None, :] for p in range(4)]
    # dir 1: P side never "large" when the edge sits on a CTU row
    cell_ctb = (((4 * torch.arange(W4, device=dev)) % ctu) == 0)[None, :]
    cols = _edge_cols(W, 8, dev)
    tc_tab = torch.as_tensor(_DB_TC, device=dev)
    beta_tab = torch.as_tensor(_DB_BETA, device=dev)

    def E(v):
        return _rep(v, 4, 4)

    def apply(plane, grid, si, sltab):
        P = plane.to(torch.int32)
        pad = P[:, cols]

        def A(k):
            return pad[:, 8 + k: 8 + k + W]

        g = grid.to(torch.int32)
        si = si.to(torch.int32)
        bs4 = g & 3
        qp4 = (g >> 2) & 127
        mfp4 = (g >> 9) & 7
        mfq4 = (g >> 12) & 7
        tco4 = _sl_sel(si, sltab, 0, n_sl)
        bto4 = _sl_sel(si, sltab, 1, n_sl)
        sp_l4 = mfp4 > 3
        if dir1:
            sp_l4 = sp_l4 & (~cell_ctb)
        sq_l4 = mfq4 > 3
        idx_tc4 = torch.clamp(qp4 + 2 * (bs4 - 1) + 2 * tco4, 0, 65)
        idx_b4 = torch.clamp(qp4 + 2 * bto4, 0, 63)
        tc4 = _tc_of(idx_tc4, bd, tc_tab)
        beta4 = beta_tab[idx_b4.long()] << (bd - 8)
        n_p4 = torch.where(sp_l4, mfp4, 3)
        n_q4 = torch.where(sq_l4, mfq4, 3)
        np_cls4 = torch.clamp((n_p4 - 3) >> 1, 0, 2)
        nq_cls4 = torch.clamp((n_q4 - 3) >> 1, 0, 2)
        valid4 = (bs4 > 0) & ~((beta4 == 0) & (tc4 == 0))

        # pixel-resolution parameter maps
        bs_v = E(valid4)
        tc = E(tc4)
        beta = E(beta4)
        sp_large = E(sp_l4)
        sq_large = E(sq_l4)
        mfp = E(mfp4)
        mfq = E(mfq4)
        n_p = E(n_p4)
        n_q = E(n_q4)
        np_cls = E(np_cls4)
        nq_cls = E(nq_cls4)
        side_thresh = (beta + (beta >> 1)) >> 3
        thr_cut = tc * 10
        tc5 = (tc * 5 + 1) >> 1

        m3, m4 = A(-1), A(0)
        absm34 = torch.abs(m3 - m4)

        # ---- decisions (per-pixel, then segment-row broadcast) ----
        dp = torch.abs(A(-3) - 2 * A(-2) + A(-1))
        dq = torch.abs(A(0) - 2 * A(1) + A(2))
        dpx = torch.abs(A(-6) - 2 * A(-5) + A(-4))
        dqx = torch.abs(A(3) - 2 * A(4) + A(5))
        dpl = torch.where(sp_large, (dp + dpx + 1) >> 1, dp)
        dql = torch.where(sq_large, (dq + dqx + 1) >> 1, dq)
        dl = dpl + dql
        d0l, d3l = _seg(dl, 0, 4), _seg(dl, 3, 4)

        sp3 = torch.abs(A(-4) - m3)
        sq3 = torch.abs(A(3) - m4)
        mp4 = torch.where(mfp == 7, A(-8), A(-6))
        m11 = torch.where(mfq == 7, A(7), A(5))
        sp3_7 = sp3 + torch.abs(A(-5) - A(-6) - A(-7) + mp4)
        sp3l = torch.where(mfp == 7, sp3_7, sp3)
        sp3l = (sp3l + torch.abs(A(-4) - mp4) + 1) >> 1
        sp3f = torch.where(sp_large, sp3l, sp3)
        sq3_7 = sq3 + torch.abs(A(4) - A(5) - A(6) + m11)
        sq3l = torch.where(mfq == 7, sq3_7, sq3)
        sq3l = (sq3l + torch.abs(m11 - A(3)) + 1) >> 1
        sq3f = torch.where(sq_large, sq3l, sq3)
        d2 = 2 * dl
        usl = (d2 < (beta >> 2)) & (absm34 < tc5) \
            & ((sp3f + sq3f) < (beta * 3 >> 5)) & (d2 < (beta >> 4))
        sw_l = (sp_large | sq_large) & ((d0l + d3l) < beta) \
            & _seg(usl, 0, 4) & _seg(usl, 3, 4)

        dp0, dp3 = _seg(dp, 0, 4), _seg(dp, 3, 4)
        dq0, dq3 = _seg(dq, 0, 4), _seg(dq, 3, 4)
        d = dp0 + dq0 + dp3 + dq3
        filt_pq = (mfp > 1) & (mfq > 1)
        filter_p = filt_pq & ((dp0 + dp3) < side_thresh)
        filter_q = filt_pq & ((dq0 + dq3) < side_thresh)
        uss = (2 * (dp + dq) < (beta >> 2)) & (absm34 < tc5) \
            & ((sp3 + sq3) < (beta >> 3))
        sw = (mfp > 2) & (mfq > 2) & _seg(uss, 0, 4) & _seg(uss, 3, 4)
        reg_ok = (~sw_l) & (d < beta)

        # ---- long bilinear filter values ----
        ref_p = _sel3(np_cls, (A(-3) + A(-4) + 1) >> 1,
                      (A(-5) + A(-6) + 1) >> 1, (A(-7) + A(-8) + 1) >> 1)
        ref_q = _sel3(nq_cls, (A(2) + A(3) + 1) >> 1,
                      (A(4) + A(5) + 1) >> 1, (A(6) + A(7) + 1) >> 1)
        Pv = [A(-1 - j) for j in range(7)]
        Qv = [A(j) for j in range(7)]
        rm_55 = (2 * (Pv[0] + Qv[0] + Pv[1] + Qv[1] + Pv[2] + Qv[2])
                 + Pv[3] + Qv[3] + Pv[4] + Qv[4] + 8) >> 4
        rm_77 = (2 * (Pv[0] + Qv[0]) + Pv[1] + Qv[1] + Pv[2] + Qv[2]
                 + Pv[3] + Qv[3] + Pv[4] + Qv[4] + Pv[5] + Qv[5]
                 + Pv[6] + Qv[6] + 8) >> 4
        rm_75 = (2 * (Pv[0] + Qv[0] + Pv[1] + Qv[1]) + Pv[2] + Qv[2]
                 + Pv[3] + Qv[3] + Pv[4] + Qv[4] + Pv[5] + Qv[5] + 8) >> 4
        swapq = n_q > n_p
        pl = [torch.where(swapq, Qv[j], Pv[j]) for j in range(7)]
        ql = [torch.where(swapq, Pv[j], Qv[j]) for j in range(3)]
        rm_73 = (2 * (pl[0] + ql[0]) + ql[0] + 2 * (ql[1] + ql[2])
                 + pl[1] + ql[1] + pl[2] + pl[3] + pl[4] + pl[5]
                 + pl[6] + 8) >> 4
        rm_53 = (Pv[0] + Qv[0] + Pv[1] + Qv[1] + Pv[2] + Qv[2]
                 + Pv[3] + Qv[3] + 4) >> 3
        n_l = torch.maximum(n_p, n_q)
        n_s = torch.minimum(n_p, n_q)
        ref_m = torch.where(
            (n_p == n_q) & (n_p == 5), rm_55,
            torch.where(n_p == n_q, rm_77,
                        torch.where((n_l == 7) & (n_s == 5), rm_75,
                                    torch.where((n_l == 7) & (n_s == 3),
                                                rm_73, rm_53))))

        def long_side(pos, refs, cls_, nn, vals):
            db = _sel3(cls_, int(_DB_DB[0][pos]), int(_DB_DB[1][pos]),
                       int(_DB_DB[2][pos]))
            tcc = _sel3(cls_, int(_DB_TCC[0][pos]), int(_DB_TCC[1][pos]),
                        int(_DB_TCC[2][pos]))
            cv = (tc * tcc) >> 1
            val = (ref_m * db + refs * (64 - db) + 32) >> 6
            new = torch.maximum(vals[pos] - cv,
                                torch.minimum(vals[pos] + cv, val))
            return new, nn > pos

        # ---- regular (strong / weak) filter values, offsets -3..2 ----
        m0, m1, m2 = A(-4), A(-3), A(-2)
        m5, m6, m7 = A(1), A(2), A(3)

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
        d1_ = torch.clamp((((m1 + m3 + 1) >> 1) - m2 + dcl) >> 1, -tc2, tc2)
        w_m2 = torch.clamp(m2 + d1_, 0, pel_max)
        d2_ = torch.clamp((((m6 + m4 + 1) >> 1) - m5 - dcl) >> 1, -tc2, tc2)
        w_m5 = torch.clamp(m5 + d2_, 0, pel_max)

        reg_vals = (
            (s_m1, sw),
            (torch.where(sw, s_m2, w_m2), sw | (wk_on & filter_p)),
            (torch.where(sw, s_m3, w_m3), sw | wk_on),
            (torch.where(sw, s_m4, w_m4), sw | wk_on),
            (torch.where(sw, s_m5, w_m5), sw | (wk_on & filter_q)),
            (s_m6, sw),
        )

        # ---- per-offset outputs O_k / write masks M_k, k = -7..6 ----
        O: dict = {}
        M: dict = {}
        for k in range(-7, 7):
            if k < 0:
                lv, lu = long_side(-1 - k, ref_p, np_cls, n_p, Pv)
            else:
                lv, lu = long_side(k, ref_q, nq_cls, n_q, Qv)
            val = torch.where(sw_l & lu, lv, A(k))
            wr = sw_l & lu
            if -3 <= k <= 2:
                rv, rw = reg_vals[k + 3]
                use_r = reg_ok & rw
                val = torch.where(sw_l, val, torch.where(use_r, rv, A(k)))
                wr = wr | use_r
            O[k] = val
            M[k] = wr & bs_v

        # ---- route edge-position results to written pixels ----
        out = P
        for p in range(4):
            pm = phase_m[p]
            for r in (p, p + 4, p - 4, p - 8):
                if r < -7 or r > 6:
                    continue
                out = torch.where(pm & _sh(M[r], r), _sh(O[r], r), out)
        return out.to(plane.dtype)

    return apply


@functools.lru_cache(maxsize=None)
def deblock_chroma_dense_core(H: int, W: int, bd: int, ctu_c: int,
                              L: int, dir1: bool, fy: int, fx: int,
                              n_sl: int, comp: int, device: str):
    """Dense chroma edge filter; edges vertical on 8-grid columns,
    segments of L parallel rows (L = 4/sub along the edge direction).

    apply(plane [H, W] chroma, grid [h4, w4] int16 (luma-cell grid,
    transposed for dir1), si, sltab) -> filtered plane, on `device`."""
    dev = torch.device(device)
    pel_max = (1 << bd) - 1
    xs = torch.arange(W, device=dev)
    phase_m = [((xs & 7) == p)[None, :] for p in range(8)]
    in_pic = (xs >= 8)[None, :]  # first edge at 8
    hc_col = ((xs % ctu_c) == 0)[None, :]
    line3 = 1 if L == 2 else 3
    oc = 2 if comp == 1 else 4  # sltab column base (tc, beta)
    cols = _edge_cols(W, 4, dev)
    tc_tab = torch.as_tensor(_DB_TC, device=dev)
    beta_tab = torch.as_tensor(_DB_BETA, device=dev)

    def E(v):
        return _rep(v, fy, fx)[:H, :W]

    def apply(plane, grid, si, sltab):
        P = plane.to(torch.int32)
        pad = P[:, cols]

        def A(k):
            return pad[:, 4 + k: 4 + k + W]

        g = grid.to(torch.int32)
        si = si.to(torch.int32)
        bs4 = g & 3
        qp4 = (g >> 2) & 127
        lg4 = ((g >> 9) & 1) != 0
        tco4 = _sl_sel(si, sltab, oc, n_sl)
        bto4 = _sl_sel(si, sltab, oc + 1, n_sl)
        idx_tc4 = torch.clamp(qp4 + 2 * (bs4 - 1) + 2 * tco4, 0, 65)
        idx_b4 = torch.clamp(qp4 + 2 * bto4, 0, 63)
        tc4 = _tc_of(idx_tc4, bd, tc_tab)
        beta4 = beta_tab[idx_b4.long()] << (bd - 8)
        sel4 = (bs4 == 2) | (lg4 & (bs4 == 1))
        valid4 = sel4 & ~((tc4 == 0) & (~lg4))

        bs_v = E(valid4) & in_pic
        tc = E(tc4)
        beta = E(beta4)
        large = E(lg4)
        tc5 = (tc * 5 + 1) >> 1
        hor_ctb = hc_col if dir1 else torch.zeros((1, W), dtype=torch.bool,
                                                  device=dev)

        m0, m1, m2 = A(-4), A(-3), A(-2)
        m3, m4 = A(-1), A(0)
        m5, m6, m7 = A(1), A(2), A(3)
        absm34 = torch.abs(m3 - m4)

        dp = torch.where(hor_ctb, torch.abs(m3 - m2),
                         torch.abs(m1 - 2 * m2 + m3))
        dq = torch.abs(m4 - 2 * m5 + m6)
        d = dp + dq
        sp3 = torch.where(hor_ctb, torch.abs(m2 - m3), torch.abs(m0 - m3))
        sq3 = torch.abs(m7 - m4)
        cstr = (2 * d < (beta >> 2)) & (absm34 < tc5) \
            & ((sp3 + sq3) < (beta >> 3))
        d0, d3 = _seg(d, 0, L), _seg(d, line3, L)
        sw = large & ((d0 + d3) < beta) & _seg(cstr, 0, L) \
            & _seg(cstr, line3, L)

        def c3(v, ref):
            return torch.maximum(ref - tc, torch.minimum(ref + tc, v))

        h_m3 = c3((3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3)
        h_m4 = c3((2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4)
        h_m5 = c3((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5)
        h_m6 = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6)
        f_m1 = c3((3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3, m1)
        f_m2 = c3((2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3, m2)
        f_m3 = c3((m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3)
        f_m4 = c3((m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4)
        f_m5 = c3((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5)
        f_m6 = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6)
        delta = torch.clamp(((m4 - m3) * 4 + m2 - m5 + 4) >> 3, -tc, tc)
        w_m3 = torch.clamp(m3 + delta, 0, pel_max)
        w_m4 = torch.clamp(m4 - delta, 0, pel_max)

        strong_h = (m1, m2, h_m3, h_m4, h_m5, h_m6)
        strong_f = (f_m1, f_m2, f_m3, f_m4, f_m5, f_m6)
        weak = (m1, m2, w_m3, w_m4, m5, m6)
        write_h = (False, False, True, True, True, True)
        write_w = (False, False, True, True, False, False)

        out = P
        O: dict = {}
        M: dict = {}
        for j, k in enumerate((-3, -2, -1, 0, 1, 2)):
            sv = torch.where(hor_ctb, strong_h[j], strong_f[j])
            # the full filter writes every offset; the CTU-row variant
            # skips the two outer P samples
            sm = (~hor_ctb) | write_h[j]
            O[k] = torch.where(sw, sv, weak[j])
            M[k] = torch.where(sw, sm, write_w[j]) & bs_v

        for p in range(8):
            pm = phase_m[p]
            for r in (p, p - 8):
                if r < -3 or r > 2:
                    continue
                out = torch.where(pm & _sh(M[r], r), _sh(O[r], r), out)
        return out.to(plane.dtype)

    return apply
