"""Native fast path for intra frame reconstruction.

Builds flat TU/CU descriptor tensors and drives the C recon engine
(native/recon.c); TUs using tools outside the engine's fast set are handed
back to the Python golden path one at a time, preserving parse order (the
availability rules depend on it).

This is the host-plane counterpart of the reference's scalar kernel layer:
the same descriptor tensors are the device pipeline's input format.
"""

from __future__ import annotations

import numpy as np

from refdec.frame.structure import (
    MODE_INTRA,
    MTS_SKIP,
    NUM_LUMA_MODE,
)

TD_STRIDE = 54
TD_COMP_BASE = 6
TD_COMP_STRIDE = 16
F_ELIG, F_COMP0, F_CHROMA, F_DEPQ = 1, 2, 4, 8

_BANK = None  # (flat int32 bank, offsets int32[n_ids], {(kind, n): id})
_LFNST_BANK = None  # flat int32: 4x4 sets then 8x8 sets
_MIP_BANK = None    # (mip4, mip8, mip16) contiguous int32


def _lfnst_bank():
    global _LFNST_BANK
    if _LFNST_BANK is None:
        from refdec.ops.tables import LFNST_4x4, LFNST_8x8
        _LFNST_BANK = np.concatenate(
            [np.ascontiguousarray(LFNST_4x4, dtype=np.int32).ravel(),
             np.ascontiguousarray(LFNST_8x8, dtype=np.int32).ravel()])
    return _LFNST_BANK


def _mip_bank():
    global _MIP_BANK
    if _MIP_BANK is None:
        from refdec.ops.tables import MIP_4x4, MIP_8x8, MIP_16x16
        _MIP_BANK = tuple(np.ascontiguousarray(t, dtype=np.int32)
                          for t in (MIP_4x4, MIP_8x8, MIP_16x16))
    return _MIP_BANK


def _lfnst_td(cs, tu, cu, comp, mode_basis):
    """(bank offset, meta) for the TD, or (-1, 0) when LFNST does not
    apply to this component (lfnst_params parity on the index side)."""
    from refdec.ops.tables import LFNST_LUT
    sep_tree = cu.tree_type != 0
    if not (sep_tree or comp == 0):
        return -1, 0
    _, _, w, h = tu.blocks[comp]
    wide = mode_basis
    if mode_basis >= 2:
        mode_shift = (0, 6, 10, 12, 14, 15)
        delta = abs((w.bit_length() - 1) - (h.bit_length() - 1))
        if w > h and mode_basis < 2 + mode_shift[delta]:
            wide = mode_basis + 65
        elif h > w and mode_basis > 66 - mode_shift[delta]:
            wide = mode_basis - 67
    if wide < 0:
        lfnst_mode = wide + 14 + 67
    elif wide >= 67:
        lfnst_mode = wide + 14
    else:
        lfnst_mode = wide
    transpose = (lfnst_mode >= 81) or (34 < lfnst_mode < 67)
    sb8 = w >= 8 and h >= 8
    zero16 = not ((w == 4 and h == 4) or (w == 8 and h == 8))
    s = int(LFNST_LUT[lfnst_mode])
    off = (2048 + (s * 2 + cu.lfnst_idx - 1) * 768) if sb8 \
        else (s * 2 + cu.lfnst_idx - 1) * 256
    return off, int(transpose) | (int(sb8) << 1) | (int(zero16) << 2)


def _matrix_bank():
    global _BANK
    if _BANK is None:
        from refdec.ops.tables import tr_matrix
        ids = {}
        parts = []
        offs = []
        pos = 0
        for kind in ("DCT2", "DST7", "DCT8"):
            for n in (2, 4, 8, 16, 32, 64):
                if kind != "DCT2" and not (4 <= n <= 32):
                    continue
                m = np.ascontiguousarray(tr_matrix(kind, n), dtype=np.int32)
                ids[(kind, n)] = len(offs)
                offs.append(pos)
                parts.append(m.ravel())
                pos += m.size
        _BANK = (np.concatenate(parts).astype(np.int32),
                 np.asarray(offs, dtype=np.int32), ids)
    return _BANK


class NativeFastPath:
    """Descriptor tensors + C engine driver for one frame, or inactive."""

    def __init__(self, recon) -> None:
        self.active = False
        self.reason = None  # why inactive (fallback census key)
        cs = recon.cs
        from refdec.native import native_recon
        eng = native_recon()
        if eng is None:
            self.reason = "no_toolchain"
            return
        # frame-level gates: intra TUs only (inter/IBC TUs are ineligible in
        # the descriptor tensor and fall back per TU, preserving parse
        # order); IBC needs the virtual-buffer fill ordering and LMCS the
        # reshaped-domain handling, both Python-side
        if cs.sps.ibc_enabled or recon.reshaper is not None \
                or cs.scaling_list is not None:
            self.reason = "ibc" if cs.sps.ibc_enabled else (
                "lmcs" if recon.reshaper is not None else "scaling_list")
            return
        self.eng = eng
        self.recon = recon
        self.cs = cs
        bank, offs, ids = _matrix_bank()
        self.bank, self.offs = bank, offs

        if self._init_from_records(recon, cs):
            return

        n = len(cs.tus)
        td = np.zeros((n, TD_STRIDE), dtype=np.int32)
        from refdec.frame.recon_np import get_tr_types
        sub_w, sub_h = cs.sub_w, cs.sub_h
        for i, tu in enumerate(cs.tus):
            cu = cs.cus[tu.cu_idx]
            d = td[i]
            d[1] = tu.cu_idx
            # order-map rect in luma coords
            if tu.blocks[0] is not None:
                d[2:6] = tu.blocks[0]
            else:
                cxx, cyy, cww, chh = tu.blocks[1]
                d[2:6] = (cxx * sub_w, cyy * sub_h, cww * sub_w, chh * sub_h)
            if cu.pred_mode != MODE_INTRA or cu.isp_mode \
                    or cu.multi_ref_idx or cu.bdpcm_mode \
                    or cu.bdpcm_mode_chroma \
                    or cu.color_transform or tu.joint_cbcr:
                continue
            flags = F_ELIG
            if cs.sh_of(cu).dep_quant_used:
                flags |= F_DEPQ
            comps = []
            if tu.blocks[0] is not None and cu.has_luma:
                comps.append(0)
                flags |= F_COMP0
            if tu.blocks[1] is not None and cu.has_chroma and cs.num_comp > 1:
                comps += [1, 2]
                flags |= F_CHROMA
            ok = bool(comps)
            for comp in comps:
                x, y, w, h = tu.blocks[comp]
                if w < 2 or h < 2 or w > 64 or h > 64:
                    ok = False
                    break
                is_mip = comp == 0 and cu.mip_flag
                if is_mip:
                    mode = cu.intra_dir[0]
                    special = 2
                else:
                    mode = recon.final_mode(cu, comp)
                    special = 0
                    if mode >= NUM_LUMA_MODE:
                        if not 67 <= mode <= 69:  # CCLM only
                            ok = False
                            break
                        special = 3
                cbf = bool(tu.cbf[comp])
                is_ts = cbf and tu.mts_idx[comp] == MTS_SKIP
                if is_ts:
                    special |= 16
                cd = d[TD_COMP_BASE + comp * TD_COMP_STRIDE:]
                cd[0], cd[1], cd[2], cd[3] = x, y, w, h
                cd[4] = 1 if cbf else 0
                cd[5] = mode
                cd[6] = 0 if is_mip \
                    else (1 if recon.use_filtered_refs(cu, comp, w, h)
                          else 0)
                cd[7] = (tu.qp + cs.sps.qp_bd_offset) if comp == 0 \
                    else tu.chroma_qp[comp - 1]
                cd[8] = tu.max_scan_x[comp]
                cd[9] = tu.max_scan_y[comp]
                cd[12] = special
                cd[13] = -1
                if is_mip:
                    from refdec.frame.recon_np import mip_size_id
                    cd[15] = (1 if cu.mip_transpose else 0) \
                        | (mip_size_id(w, h) << 1)
                if cbf and not is_ts:
                    hor, ver = get_tr_types(cs, tu, cu, comp)
                    cd[10] = ids[(hor, w)]
                    cd[11] = ids[(ver, h)]
                    if cu.lfnst_idx:
                        from refdec.frame.recon_np import \
                            co_located_luma_mode_of
                        if is_mip:
                            basis = 0
                        elif special & 15 == 3:
                            basis = co_located_luma_mode_of(cs, cu)
                        else:
                            basis = mode
                        cd[13], cd[14] = _lfnst_td(cs, tu, cu, comp,
                                                   basis)
            if ok:
                d[0] = flags

        self.td = np.ascontiguousarray(td)
        cu_meta = np.zeros((max(1, len(cs.cus)), 6), dtype=np.int32)
        for cu in cs.cus:
            cu_meta[cu.idx] = (cu.x, cu.y, cu.cx, cu.cy,
                               cu.slice_idx, cu.tile_idx)
        self.cu_meta = np.ascontiguousarray(cu_meta)
        # contiguous planes shared with the engine
        self._z32 = np.zeros(1, dtype=np.int32)
        self.active = True

    def _init_from_records(self, recon, cs) -> bool:
        """Build the TD tensor in C from the syntax walk's flat records
        (native/walk5.c) — no per-TU Python loop."""
        nw = getattr(cs, "_nw", None)
        if nw is None or len(cs.tus) != int(nw["counts"][1]):
            return False
        from refdec.native import native_cabac
        nc = native_cabac()
        if nc is None or not hasattr(nc, "build_intra_td"):
            return False
        n_cus, n_tus = int(nw["counts"][0]), int(nw["counts"][1])
        td = np.zeros((max(1, n_tus), TD_STRIDE), dtype=np.int32)
        cu_meta = np.zeros((max(1, n_cus), 6), dtype=np.int32)
        sl_dq = np.fromiter((1 if s.dep_quant_used else 0 for s in cs.shs),
                            dtype=np.uint8, count=len(cs.shs))
        nc.build_intra_td(
            td, cu_meta, nw["cu_rec"], nw["tu_rec"], n_cus, n_tus,
            sl_dq.tobytes(), len(cs.shs), cs.cu_map,
            cs.sps.chroma_format_idc, cs.w, cs.h, cs.sub_w, cs.sub_h,
            cs.num_comp, int(cs.sps.mts_enabled),
            int(cs.sps.explicit_mts_intra), cs.sps.qp_bd_offset)
        self.td = td
        self.cu_meta = cu_meta
        self._z32 = np.zeros(1, dtype=np.int32)
        self.active = True
        return True

    def run_from(self, start: int) -> int:
        """Process TUs [start, r) natively; returns r (first unhandled)."""
        r = self.recon
        cs = self.cs
        reco = r.reco
        coef = cs.coef
        has_c = cs.num_comp > 1
        z = self._z32
        m4, m8, m16 = _mip_bank()
        return self.eng.run_from(
            start, len(cs.tus), self.td, self.cu_meta,
            reco[0], coef[0],
            reco[1] if has_c else z, coef[1] if has_c else z,
            reco[2] if has_c else z, coef[2] if has_c else z,
            reco[0].shape[1], reco[0].shape[0],
            reco[1].shape[1] if has_c else 0,
            reco[1].shape[0] if has_c else 0,
            cs.cu_map, cs.cu_map_c if cs.cu_map_c is not None else z,
            r.tu_order_map, self.bank, self.offs,
            r.bit_depth, 1 if cs.sps.entropy_coding_sync_enabled else 0,
            cs.ctu_log2, cs.sub_w, cs.sub_h, cs.num_comp,
            _lfnst_bank(), m4, m8, m16, cs.sps.chroma_format_idc,
            1 if cs.sps.chroma_ver_collocated else 0,
            cs.sps.internal_minus_input_bit_depth)
