"""Python glue for the native CABAC syntax walk (native/walk*.c).

The C walk decodes one CTU's full syntax per call, writing flat int32 CU/TU
records plus the whole-frame maps (coefficient planes, cu/qp/slice maps) in
place.  This module builds the parameter vector, manages per-picture record
buffers on the CodingStructure, and materializes the records into the Python
CodingUnit/TransformUnit objects the reconstruction stage consumes.

The pure-Python walk in ctu_decoder.py stays as the golden reference and the
encoder; the oracle tests (stream MD5 vs the reference vvdecapp binary) pin
both paths.
"""

from __future__ import annotations

import os

import numpy as np

from refdec.frame.structure import CodingUnit, TransformUnit

_GROW = 8192
_HEADROOM = 4100  # worst-case CUs/TUs of one 128x128 CTU, with margin


class LazyRecList(list):
    """List whose elements materialize from flat records on first access.

    Slots hold None until touched; __iter__ materializes everything (for
    legacy full-scan consumers).  Mutations of materialized objects persist
    (the object is cached in its slot)."""

    def __init__(self, mat) -> None:
        super().__init__()
        self._mat = mat

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        v = list.__getitem__(self, i)
        if v is None:
            if i < 0:
                i += len(self)
            v = self._mat(i)
            list.__setitem__(self, i, v)
        return v

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def materialized(self):
        """(index, obj) pairs of already-materialized slots only."""
        for i, v in enumerate(list.__iter__(self)):
            if v is not None:
                yield i, v


# CU/TU record field indices — order must match the enums in native/walk.c
CU_FIELDS = (
    "x", "y", "w", "h", "cx", "cy", "cw", "ch",
    "has_luma", "has_chroma", "ch_type", "tree_type", "mode_type",
    "qt_depth", "mt_depth", "depth", "pred_mode", "skip", "qp",
    "chroma_qp_adj", "intra_dir0", "intra_dir1", "bdpcm", "bdpcm_c",
    "mip_flag", "mip_transpose", "multi_ref", "isp", "lfnst",
    "root_cbf", "pcbf0", "pcbf1", "pcbf2", "sbt_info",
    "merge_flag", "merge_idx", "inter_dir",
    "mvd0x", "mvd0y", "mvd1x", "mvd1y",
    "mvda00x", "mvda00y", "mvda01x", "mvda01y",
    "mvda10x", "mvda10y", "mvda11x", "mvda11y",
    "ref0", "ref1", "mvp0", "mvp1", "smvd", "mmvd_flag", "mmvd_idx",
    "imv", "bcw", "affine", "aff_type", "ciip", "geo", "geo_dir",
    "geo_idx0", "geo_idx1", "slice_idx", "tile_idx",
    "first_tu", "num_tu",
)
CU_F = {name: i for i, name in enumerate(CU_FIELDS)}


def _materialize_cu(cs, nw, idx):
    r = nw["cu_rec"][idx].tolist()
    (x, y, w, h, cx, cy, cw, ch, has_l, has_c, ch_type, tree,
     mode_type, qt, mt, depth, pred, skip, qp, cqa, dir0, dir1,
     bdpcm, bdpcm_c, mip, mip_t, mrl, isp, lfnst, root, p0, p1, p2,
     sbt, mrg, mrg_idx, inter_dir, m0x, m0y, m1x, m1y,
     a00x, a00y, a01x, a01y, a10x, a10y, a11x, a11y,
     ref0, ref1, mvp0, mvp1, smvd, mmvd_f, mmvd_i, imv, bcw,
     aff, aff_t, ciip, geo, geo_dir, g0, g1, slice_idx, tile_idx,
     first_tu, num_tu) = r
    cu = CodingUnit.__new__(CodingUnit)
    is_intra_cu = pred == 1
    cu.__dict__ = {
        "idx": idx, "x": x, "y": y, "w": w, "h": h,
        "cx": cx, "cy": cy, "cw": cw, "ch": ch,
        "has_luma": bool(has_l), "has_chroma": bool(has_c),
        "ch_type": ch_type, "tree_type": tree,
        "mode_type": mode_type, "qt_depth": qt, "mt_depth": mt,
        "depth": depth, "pred_mode": pred, "skip": bool(skip),
        "qp": qp, "chroma_qp_adj": cqa,
        "intra_dir": [dir0, dir1],
        "bdpcm_mode": bdpcm, "bdpcm_mode_chroma": bdpcm_c,
        "mip_flag": bool(mip), "mip_transpose": bool(mip_t),
        "mip_mode": 0, "multi_ref_idx": mrl, "isp_mode": isp,
        "lfnst_idx": lfnst, "color_transform": False,
        "root_cbf": bool(root),
        "plane_cbf": [bool(p0), bool(p1), bool(p2)],
        "sbt_info": sbt, "merge_flag": bool(mrg),
        "merge_idx": mrg_idx, "inter_dir": inter_dir,
        "mv": [] if is_intra_cu else [[0, 0], [0, 0]],
        "mvd": [] if is_intra_cu else [[m0x, m0y], [m1x, m1y]],
        "mvd_aff": [] if is_intra_cu else
        [[[a00x, a00y], [a01x, a01y]],
         [[a10x, a10y], [a11x, a11y]]],
        "ref_idx": [ref0, ref1], "mvp_idx": [mvp0, mvp1],
        "smvd_mode": smvd, "mmvd_flag": bool(mmvd_f),
        "mmvd_idx": mmvd_i, "imv": imv, "bcw_idx": bcw,
        "alt_hpel": False, "affine_flag": bool(aff),
        "affine_type": aff_t, "merge_type": 0, "cpmv": [],
        "ciip_flag": bool(ciip), "geo_flag": bool(geo),
        "geo_split_dir": geo_dir, "geo_idx": [g0, g1],
        "split_hist": (),
        "tus": [cs.tus[k] for k in range(first_tu, first_tu + num_tu)],
        "slice_idx": slice_idx, "tile_idx": tile_idx,
    }
    return cu


def _materialize_tu(cs, nw, idx):
    (cu_idx, part_idx,
     bx0, by0, bw0, bh0, bx1, by1, bw1, bh1, bx2, by2, bw2, bh2,
     cbf0, cbf1, cbf2, mts0, mts1, mts2, joint, qp, cqp0, cqp1,
     msx0, msx1, msx2, msy0, msy1, msy2) = nw["tu_rec"][idx].tolist()
    tu = TransformUnit.__new__(TransformUnit)
    tu.__dict__ = {
        "cu_idx": cu_idx,
        "blocks": [(bx0, by0, bw0, bh0) if bw0 else None,
                   (bx1, by1, bw1, bh1) if bw1 else None,
                   (bx2, by2, bw2, bh2) if bw2 else None],
        "cbf": [bool(cbf0), bool(cbf1), bool(cbf2)],
        "mts_idx": [mts0, mts1, mts2],
        "joint_cbcr": joint, "qp": qp,
        "chroma_qp": [cqp0, cqp1],
        "max_scan_x": [msx0, msx1, msx2],
        "max_scan_y": [msy0, msy1, msy2],
        "part_idx": part_idx, "order": idx,
    }
    return tu


def native_walk_ok(coder) -> bool:
    """Whether the native walk can decode this slice."""
    if os.environ.get("REFDEC_PY_WALK") == "1":
        return False
    if coder.dec is None or not hasattr(coder.dec, "_d"):
        return False
    if not hasattr(coder.dec._d, "walk_begin"):
        return False
    if coder.sps.act_enabled:
        return False  # ACT (4:4:4) decodes via the Python walk for now
    return True


def _build_params(coder, m) -> np.ndarray:
    """Parameter vector — order must match the WP_* enum in native/walk.c."""
    sps, pps, ph, sh, cs = coder.sps, coder.pps, coder.ph, coder.sh, coder.cs
    c0, c1 = coder.constraints[0], coder.constraints[1]
    n_alts = 0
    if (sh.alf_enabled[1] or sh.alf_enabled[2]) and cs.alf_apss:
        n_alts = cs.alf_apss[sh.alf_aps_id_chroma].alf.num_alternatives_chroma
    cc_cb = cs.alf_apss[sh.ccalf_cb_aps_id].cc_alf.filter_count[0] \
        if sh.ccalf_cb_enabled else 0
    cc_cr = cs.alf_apss[sh.ccalf_cr_aps_id].cc_alf.filter_count[1] \
        if sh.ccalf_cr_enabled else 0
    p = [
        sps.ctu_size, cs.ctu_log2, sps.log2_min_cb_size, sps.log2_max_tb_size,
        sps.log2_max_ts_size, sps.chroma_format_idc, cs.sub_w, cs.sub_h,
        cs.num_comp, cs.w, cs.h, pps.pic_width_in_ctu, sps.bit_depth,
        sps.qp_bd_offset, int(coder.dual_tree),
        int(sps.entropy_coding_sync_enabled),
        int(sps.ibc_enabled), int(sps.mip_enabled), int(sps.mrl_enabled),
        int(sps.isp_enabled), int(sps.cclm_enabled), int(sps.bdpcm_enabled),
        int(sps.mts_enabled), int(sps.explicit_mts_intra),
        int(sps.explicit_mts_inter), int(sps.lfnst_enabled),
        int(sps.sbt_enabled), int(sps.smvd_enabled), int(sps.affine_enabled),
        int(sps.affine_6param), int(sps.affine_amvr), int(sps.amvr_enabled),
        int(sps.mmvd_enabled), int(sps.gpm_enabled), int(sps.ciip_enabled),
        int(sps.bcw_enabled), int(sps.joint_cbcr_enabled),
        int(sps.transform_skip_enabled), int(sps.act_enabled),
        sps.max_num_merge_cand, sps.max_num_ibc_merge_cand,
        sps.max_num_gpm_cand, ph.max_num_affine_merge_cand,
        int(ph.mvd_l1_zero), coder.cu_qp_delta_subdiv,
        coder.cu_chroma_qp_offset_subdiv,
        int(pps.cu_qp_delta_enabled), int(pps.no_pic_partition),
        int(sh.is_intra), int(sh.is_p), int(sh.is_b), coder.slice_idx,
        sh.qp_y, sh.num_ref_idx_active[0], sh.num_ref_idx_active[1],
        int(sh.dep_quant_used), int(sh.sign_data_hiding_used),
        int(sh.ts_residual_coding_disabled),
        int(sh.cu_chroma_qp_offset_enabled),
        len(pps.chroma_qp_offset_list),
        int(sh.sao_enabled_luma), int(sh.sao_enabled_chroma),
        int(sh.alf_enabled[0]), int(sh.alf_enabled[1]),
        int(sh.alf_enabled[2]), int(sh.ccalf_cb_enabled),
        int(sh.ccalf_cr_enabled), sh.num_alf_aps_ids_luma, n_alts,
        cc_cb, cc_cr,
        int(cs.check_ldc), int(cs.bi_dir_pred),
        cs.sym_ref_idx[0], cs.sym_ref_idx[1],
        pps.cb_qp_offset, pps.cr_qp_offset, pps.joint_cbcr_qp_offset,
        sh.cb_qp_offset, sh.cr_qp_offset, sh.joint_cbcr_qp_offset,
        c0.min_qt_size, c0.max_bt_depth, c0.max_bt_size, c0.max_tt_size,
        c0.min_bt_size, c0.min_tt_size, c0.min_cb_size,
        c1.min_qt_size, c1.max_bt_depth, c1.max_bt_size, c1.max_tt_size,
        c1.min_bt_size, c1.min_tt_size, c1.min_cb_size,
        (1 << (min(sps.bit_depth, 10) - 5)) - 1,
        coder.max_log2_tr_range,
    ]
    assert len(p) == m.WALK_PARAM_COUNT, (len(p), m.WALK_PARAM_COUNT)
    return np.asarray(p, dtype=np.int32)


_rec_hwm = [_GROW, _GROW]  # record-count high-water mark across pictures


def _picture_buffers(cs, m):
    """Per-picture native-walk record buffers, created once per picture.
    Sized to the high-water mark of earlier pictures so steady-state
    decoding never re-grows (growth costs a copy per doubling)."""
    nw = getattr(cs, "_nw", None)
    if nw is None:
        n_ctus = cs.pps.pic_width_in_ctu * cs.pps.pic_height_in_ctu
        nw = cs._nw = {
            # records are memset field-complete at allocation in C
            # (w_code_cu / w_add_tu), so uninitialized backing is fine
            "cu_rec": np.empty((_rec_hwm[0], m.WALK_CU_NF), dtype=np.int32),
            "tu_rec": np.empty((_rec_hwm[1], m.WALK_TU_NF), dtype=np.int32),
            "counts": np.zeros(2, dtype=np.int32),
            "sao": np.zeros(n_ctus * m.WALK_SAO_STRIDE, dtype=np.int32),
            "alf": np.zeros(n_ctus * m.WALK_ALF_STRIDE, dtype=np.int32),
            "flags": np.zeros(n_ctus, dtype=np.int32),
            "state": np.zeros(4, dtype=np.int32),
            "dummy": np.zeros(1, dtype=np.int32),
        }
    return nw


class SliceWalk:
    """Drives the native walk for one slice's CTUs."""

    def __init__(self, coder) -> None:
        from refdec.native import native_cabac
        from refdec.hls.weight_table import wp_present_any

        m = native_cabac()
        self.coder = coder
        cs = coder.cs
        self.cs = cs
        self.nw = nw = _picture_buffers(cs, m)
        assert len(cs.cus) == int(nw["counts"][0]), \
            "native/python walk mixed within one picture"
        self.cu_lo = int(nw["counts"][0])
        self.tu_lo = int(nw["counts"][1])
        self.params = _build_params(coder, m)

        sps, pps, sh = coder.sps, coder.pps, coder.sh
        qp_bd = sps.qp_bd_offset
        cqp = np.zeros((3, 64 + qp_bd), dtype=np.int8)
        for comp_idx in range(3):
            for base in range(-qp_bd, 64):
                cqp[comp_idx, base + qp_bd] = sps.chroma_qp_table.map_qp(
                    comp_idx, base)
        self.cqp = cqp.tobytes()
        wp = np.zeros((2, 16), dtype=np.uint8)
        if not sh.is_intra and sh.weight_table is not None:
            for lst in range(2):
                for ref in range(16):
                    wp[lst, ref] = wp_present_any(sh.weight_table, lst, ref)
        self.wp = wp.tobytes()
        tcs = np.zeros(pps.pic_width_in_ctu, dtype=np.uint8)
        if pps.no_pic_partition:
            tcs[0] = 1
        else:
            for ctu_x in range(pps.pic_width_in_ctu):
                col = pps.ctu_to_tile_col[ctu_x]
                tcs[ctu_x] = int(pps.tile_col_bd[col] == ctu_x)
        self.tcs = tcs.tobytes()

        nw["state"][0] = sh.qp_y
        nw["state"][1] = cs.chroma_qp_adj
        self._begin()

    def _begin(self) -> None:
        cs, nw = self.cs, self.nw
        dummy = nw["dummy"]
        has_c = cs.num_comp > 1
        self.sess = self.coder.dec._d.walk_begin(
            self.params, cs.cu_map,
            cs.cu_map_c if cs.cu_map_c is not None else dummy,
            cs.qp_map, cs.slice_map, cs.tile_map.tobytes(),
            cs.coef[0],
            cs.coef[1] if has_c else dummy,
            cs.coef[2] if has_c else dummy,
            nw["cu_rec"], nw["tu_rec"], nw["counts"],
            nw["sao"], nw["alf"], nw["flags"],
            self.cqp, self.wp, self.tcs, nw["state"])

    def reset_qp(self) -> None:
        """Substream boundary: QP predictor restarts (code_slice parity)."""
        self.nw["state"][0] = self.coder.sh.qp_y

    def ctu(self, cx: int, cy: int) -> None:
        nw = self.nw
        n_cu, n_tu = int(nw["counts"][0]), int(nw["counts"][1])
        grew = False
        if n_cu + _HEADROOM > nw["cu_rec"].shape[0]:
            nw["cu_rec"] = np.vstack(
                [nw["cu_rec"],
                 np.empty_like(nw["cu_rec"])])
            grew = True
        if n_tu + _HEADROOM > nw["tu_rec"].shape[0]:
            nw["tu_rec"] = np.vstack(
                [nw["tu_rec"],
                 np.empty_like(nw["tu_rec"])])
            grew = True
        if grew:
            self.sess.close()
            self._begin()
        self.sess.ctu(cx, cy)

    def ctu_run(self, xy: np.ndarray) -> None:
        """Walk a run of CTUs ((x, y) int32 pairs) in one native call per
        record-capacity window — one GIL release for the whole run."""
        pos = 0
        n = len(xy)
        while pos < n:
            done = int(self.sess.ctu_run(
                np.ascontiguousarray(xy[pos:]).tobytes(), n - pos,
                _HEADROOM))
            pos += done
            if pos < n:
                nw = self.nw
                nw["cu_rec"] = np.vstack([nw["cu_rec"],
                                          np.empty_like(nw["cu_rec"])])
                nw["tu_rec"] = np.vstack([nw["tu_rec"],
                                          np.empty_like(nw["tu_rec"])])
                self.sess.close()
                self._begin()

    def finish(self) -> None:
        """Publish this slice's records: CU/TU objects materialize lazily
        on first Python access (the C stages read the records directly)."""
        self.sess.close()
        cs, nw = self.cs, self.nw
        cs.chroma_qp_adj = int(nw["state"][1])
        n_cus, n_tus = int(nw["counts"][0]), int(nw["counts"][1])
        _rec_hwm[0] = max(_rec_hwm[0], n_cus + _HEADROOM)
        _rec_hwm[1] = max(_rec_hwm[1], n_tus + _HEADROOM)
        if not isinstance(cs.cus, LazyRecList):
            assert not cs.cus and not cs.tus
            cs.cus = LazyRecList(lambda i: _materialize_cu(cs, nw, i))
            cs.tus = LazyRecList(lambda i: _materialize_tu(cs, nw, i))
        cs.cus.extend([None] * (n_cus - len(cs.cus)))
        cs.tus.extend([None] * (n_tus - len(cs.tus)))
        self._materialize_ctu_params()

    def _materialize_ctu_params(self) -> None:
        """Register LAZY per-CTU SAO/ALF dict builders over this walk's
        flat records (frame/structure.LazyCtuParams) — the C filter
        stages read the records directly; the dicts materialize only for
        the Python/device fallback paths that index them."""
        coder, cs, nw = self.coder, self.cs, self.nw
        sao_rec, alf_rec, flags = nw["sao"], nw["alf"], nw["flags"]

        def sao_build(addr):
            if not (int(flags[addr]) & 1):
                return None
            params = []
            for c in range(3):
                base = addr * 24 + c * 8
                mode = int(sao_rec[base])
                typ = int(sao_rec[base + 1])
                band = int(sao_rec[base + 2])
                offs = [int(sao_rec[base + 3 + k]) for k in range(4)]
                p = {"mode": mode, "type": typ, "offsets": None,
                     "band": band}
                if mode:
                    if typ == 4:
                        table = np.zeros(32, dtype=np.int32)
                        for k in range(4):
                            table[(band + k) % 32] = offs[k]
                        p["offsets"] = table
                    else:
                        p["offsets"] = np.array(
                            [offs[0], offs[1], 0, -offs[2], -offs[3]],
                            dtype=np.int32)
                params.append(p)
            return params

        def alf_build(addr):
            if not (int(flags[addr]) & 2):
                return None
            base = addr * 8
            return {
                "enable": [int(alf_rec[base + k]) for k in range(3)],
                "filt_idx": int(alf_rec[base + 3]),
                "alt": [int(alf_rec[base + 4]), int(alf_rec[base + 5])],
                "cc": [int(alf_rec[base + 6]), int(alf_rec[base + 7])],
            }

        from refdec.frame.structure import LazyCtuParams
        if not isinstance(cs.sao_params, LazyCtuParams):
            cs.sao_params = LazyCtuParams(cs.sao_params)
        if not isinstance(cs.alf_params, LazyCtuParams):
            cs.alf_params = LazyCtuParams(cs.alf_params)
        cs.sao_params.register(coder.sh.ctu_addrs, sao_build)
        cs.alf_params.register(coder.sh.ctu_addrs, alf_build)
