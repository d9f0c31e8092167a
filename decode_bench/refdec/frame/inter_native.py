"""Native fast path for inter CU execution (native/walk9.c).

Runs whole inter CUs — motion derivation, MC (incl. DMVR/BDOF/BCW/weighted
prediction), residual reconstruction — in C over the flat walk records,
sharing the motion field / HMVP / side-table buffers with the Python
golden path so ineligible CUs (affine, GPM, CIIP, IBC) fall back per CU
in parse order.

Reference parity targets: DecCu::xDeriveCUMV (DecCu.cpp:720),
InterPrediction::motionCompensation (InterPrediction.cpp:1372).
"""

from __future__ import annotations

import numpy as np

# params vector indices — must match the IP_* enum in native/walk9.c
(IP_BIT_DEPTH, IP_SUB_W, IP_SUB_H, IP_NUM_COMP, IP_CTU_SIZE,
 IP_DMVR_EN, IP_BDOF_EN, IP_BCW_EN, IP_FPEL_MMVD, IP_JCCR_SIGN,
 IP_INTERNAL_MINUS_INPUT, IP_QP_BD_OFFSET, IP_MTS_EN, IP_N_SLICES,
 IP_COUNT) = range(15)

_TR_KINDS = ("DCT2", "DST7", "DCT8")
_IF_CACHE: list | None = None


def _if_tables():
    """Contiguous int32 interpolation-filter tables, built once."""
    global _IF_CACHE
    if _IF_CACHE is None:
        from refdec.frame.inter_np import (
            ALT_HPEL_IF, BILINEAR_IF, CHROMA_IF, LUMA_IF)
        _IF_CACHE = [np.ascontiguousarray(t, dtype=np.int32)
                     for t in (LUMA_IF, CHROMA_IF, BILINEAR_IF,
                               ALT_HPEL_IF)]
    return _IF_CACHE


def _tr_offsets(ids, offs) -> np.ndarray:
    """[kind][log2 size] -> flat bank offset (or -1)."""
    t = np.full((3, 8), -1, dtype=np.int32)
    for (kind, n), idx in ids.items():
        t[_TR_KINDS.index(kind), n.bit_length() - 1] = offs[idx]
    return t


class InterFastPath:
    """Per-frame native inter engine, or inactive."""

    def __init__(self, recon) -> None:
        self.active = False
        self.reason = None  # why inactive (fallback census key)
        import os
        if os.environ.get("REFDEC_NO_NATIVE_INTER") == "1":
            self.reason = "env_disabled"
            return
        cs = recon.cs
        from refdec.native import native_cabac
        nc = native_cabac()
        if nc is None or not hasattr(nc, "InterCtx"):
            self.reason = "no_toolchain"
            return
        nw = getattr(cs, "_nw", None)
        if nw is None or len(cs.tus) != int(nw["counts"][1]):
            self.reason = "no_walk_records"
            return
        if all(s.is_intra for s in cs.shs):
            return
        # frame-level gates: tools the C driver does not model
        for flag, why in ((recon.reshaper is not None, "lmcs"),
                          (cs.scaling_list is not None, "scaling_list"),
                          (cs.sps.ibc_enabled, "ibc"),
                          (cs.sps.ref_wraparound_enabled, "wraparound"),
                          (bool(cs.subpics), "subpics"),
                          (cs.sps.act_enabled, "act"),
                          (getattr(cs, "per_slice_rpl", False),
                           "per_slice_rpl")):
            if flag:
                self.reason = why
                return
        ref_scaled = getattr(cs, "ref_scaled", None)
        if ref_scaled and any(s is not None
                              for lst in ref_scaled for s in lst):
            self.reason = "rpr"
            return
        from refdec.frame.inter_np import _motion_ctx
        mc = _motion_ctx(cs, recon._hist)
        if mc is None:
            self.reason = "no_motion_ctx"
            return
        # reference planes: distinct triples + (lst, ref) -> triple map
        triples: list[tuple] = []
        tri_ids: dict[int, int] = {}
        ref_map = np.full((2, 17), -1, dtype=np.int32)
        num_comp = cs.num_comp
        self.reason = "ref_plane_layout"
        for lst in range(2):
            if len(cs.ref_planes[lst]) > 17:
                return
            for i, planes in enumerate(cs.ref_planes[lst]):
                if len(planes) < num_comp:
                    return
                for comp in range(num_comp):
                    p = planes[comp]
                    w_c, h_c = cs.comp_size[comp]
                    if p.dtype != np.int32 \
                            or not p.flags["C_CONTIGUOUS"] \
                            or p.shape != (h_c, w_c):
                        return
                ti = tri_ids.get(id(planes))
                if ti is None:
                    p0 = planes[0]
                    p1 = planes[1] if num_comp > 1 else p0
                    p2 = planes[2] if num_comp > 1 else p0
                    ti = len(triples)
                    triples.append((p0, p1, p2))
                    tri_ids[id(planes)] = ti
                ref_map[lst, i] = ti
        self.reason = None
        # per-slice tables
        n_slices = len(cs.shs)
        from refdec.hls.weight_table import resolve_wp, wp_present_any
        slice_ex = np.zeros((n_slices, nc.INTER_SLICE_NF), dtype=np.int32)
        wp_prm = np.zeros((n_slices, 2, 16, 3, 3), dtype=np.int32)
        wp_pres = np.zeros((n_slices, 2, 16), dtype=np.uint8)
        bd = cs.sps.bit_depth
        for si, sh in enumerate(cs.shs):
            slice_ex[si, 0] = int(sh.dep_quant_used)
            slice_ex[si, 1] = int(cs.pps.weighted_pred and sh.is_p)
            slice_ex[si, 2] = int(cs.pps.weighted_bipred and sh.is_b)
            slice_ex[si, 3] = int(sh.is_b)
            if sh.is_intra:
                continue
            wt = sh.weight_table
            for lst in range(2):
                for ref in range(16):
                    wp_pres[si, lst, ref] = wp_present_any(wt, lst, ref)
                    if wt is None:
                        continue
                    wp = resolve_wp(wt, lst, ref, bd, num_comp)
                    for comp in range(num_comp):
                        wp_prm[si, lst, ref, comp] = (
                            wp[comp]["w"], wp[comp]["o"],
                            wp[comp]["denom"])
        params = np.zeros(nc.INTER_PARAM_COUNT, dtype=np.int32)
        params[IP_BIT_DEPTH] = bd
        params[IP_SUB_W] = cs.sub_w
        params[IP_SUB_H] = cs.sub_h
        params[IP_NUM_COMP] = num_comp
        params[IP_CTU_SIZE] = cs.sps.ctu_size
        params[IP_DMVR_EN] = int(cs.sps.dmvr_enabled
                                 and not cs.ph.dmvr_disabled)
        params[IP_BDOF_EN] = int(cs.sps.bdof_enabled
                                 and not cs.ph.bdof_disabled)
        params[IP_BCW_EN] = int(cs.sps.bcw_enabled)
        params[IP_FPEL_MMVD] = int(cs.ph.fpel_mmvd)
        params[IP_JCCR_SIGN] = int(cs.ph.joint_cbcr_sign)
        params[IP_INTERNAL_MINUS_INPUT] = \
            cs.sps.internal_minus_input_bit_depth
        params[IP_QP_BD_OFFSET] = cs.sps.qp_bd_offset
        params[IP_MTS_EN] = int(cs.sps.mts_enabled)
        params[IP_N_SLICES] = n_slices
        from refdec.frame.recon_native import _matrix_bank
        bank, offs, ids = _matrix_bank()
        troff = _tr_offsets(ids, offs)
        if_luma, if_chroma, if_bilin, if_alt = _if_tables()
        # DMVR refined-MV writeback buffer (decoder applies post-deblock)
        fix_cap = ((cs.w >> 3) + 2) * ((cs.h >> 3) + 2) * 2
        self.fix = np.zeros((max(fix_cap, 16), 6), dtype=np.int32)
        self.state = np.array([-(1 << 30), -1, 0, 0], dtype=np.int32)
        reco = recon.reco
        z32 = np.zeros((1, 1), dtype=np.int32)
        has_c = num_comp > 1
        dims = (reco[0].shape[1], reco[0].shape[0],
                reco[1].shape[1] if has_c else 0,
                reco[1].shape[0] if has_c else 0,
                reco[2].shape[1] if has_c else 0,
                reco[2].shape[0] if has_c else 0)
        hist = recon._hist
        self._keep = (mc, triples, wp_prm, wp_pres, slice_ex, params,
                      bank, troff, if_luma, if_chroma, if_bilin, if_alt,
                      ref_map, reco, cs.coef, hist)
        self.ctx = nc.InterCtx(
            mc, nw["tu_rec"], self.fix, self.state, params, slice_ex,
            reco[0], reco[1] if has_c else z32,
            reco[2] if has_c else z32,
            cs.coef[0], cs.coef[1] if has_c else z32,
            cs.coef[2] if has_c else z32,
            dims, recon.tu_order_map, wp_prm, wp_pres, bank, troff,
            if_luma, if_chroma, if_bilin, if_alt,
            triples, ref_map,
            cs.mi_ref, cs.mi_mv, hist.buf, hist.nbuf, cs._mctx_side)
        self.hist = hist
        self.cs = cs
        self.n_tus = int(nw["counts"][1])
        self.active = True

    def run_from(self, start: int) -> int:
        """Process whole eligible inter CUs from TU index `start`; returns
        the first unhandled TU index.  Syncs the Python HMVP mirror."""
        j = self.ctx.run_from(start, self.n_tus)
        if j > start:
            self.hist.sync_from_buf()
        return j

    def flush_fixups(self) -> None:
        """Publish DMVR refined-MV writebacks into cs.dmvr_fixups."""
        n = int(self.state[2])
        if n:
            for x2, y2, m0x, m0y, m1x, m1y in self.fix[:n].tolist():
                self.cs.dmvr_fixups.append(
                    (x2, y2, (m0x, m0y), (m1x, m1y)))
            self.state[2] = 0
