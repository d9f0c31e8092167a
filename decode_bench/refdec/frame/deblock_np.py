"""Numpy golden deblocking filter (H.266 clause 8.8.3), intra tool scope.

Behavioral parity: vvdec LoopFilter (source/Lib/CommonLib/LoopFilter.cpp —
strength derivation xSetMaxFilterLengthPQFromTransformSizes :780 /
xGetBoundaryStrengthSingle :1094, luma filter xEdgeFilterLuma :1464 +
xPelFilterLumaCorePel :213 + xFilteringPandQCore :129, chroma filter
xEdgeFilterChroma :1620 + xPelFilterChroma :281, decision helpers
xCalcDP/DQ :1393 / xUseStrongFiltering :1410, tables :84-104).

VVC guarantees non-overlapping filter operations per direction, so each
direction is applied as an embarrassingly parallel whole-frame pass
(vertical edges first, then horizontal) — this maps directly onto the
TPU whole-frame kernel later.

Current scope: intra CUs (BS=2 everywhere on filtered edges), single tree,
no BDPCM/ISP; inter BS derivation arrives with inter support.
"""

from __future__ import annotations

import numpy as np

from refdec.frame.structure import CodingStructure, MODE_INTRA

TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 3, 4, 4, 4, 4, 5,
    5, 5, 5, 7, 7, 8, 9, 10, 10, 11, 13, 14, 15, 17, 19, 21, 24, 25, 29, 33,
    36, 41, 45, 51, 57, 64, 71, 80, 89, 100, 112, 125, 141, 157, 177, 198,
    222, 250, 280, 314, 352, 395], dtype=np.int32)
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
    44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78,
    80, 82, 84, 86, 88], dtype=np.int32)

DB_COEFFS = {7: (59, 50, 41, 32, 23, 14, 5), 5: (58, 45, 32, 19, 6),
             3: (53, 32, 11)}
TC_COEFFS = {7: (6, 5, 4, 3, 2, 1, 1), 5: (6, 5, 4, 3, 2), 3: (6, 4, 2)}
# NOTE: tcP table is tc7 for sides 5 and 7, tc3 only for side 3
DEFAULT_INTRA_TC_OFFSET = 2
MAX_QP = 63


class EdgeParams:
    """Per-4x4-cell edge parameter maps for one direction.

    All planes are views into one packed int16 tensor [10, h4, w4] (plane
    order matches the EP_* enum in native/walk4.c) so the native strength
    derivation fills them in one call."""

    PLANES = ("bs_y", "bs_cb", "bs_cr", "qp_y", "qp_cb", "qp_cr",
              "max_fl_p", "max_fl_q", "cmfl", "te")

    def __init__(self, h4: int, w4: int, buf: np.ndarray | None = None):
        self.buf = np.zeros((len(self.PLANES), h4, w4), dtype=np.int16) \
            if buf is None else buf
        for i, name in enumerate(self.PLANES):
            setattr(self, name, self.buf[i])


class Deblocker:
    def __init__(self, cs: CodingStructure, reco: list[np.ndarray]):
        self.cs = cs
        self.reco = reco
        self.bit_depth = cs.sps.bit_depth
        self.pel_max = (1 << self.bit_depth) - 1
        h4, w4 = cs.h >> 2, cs.w >> 2
        self.ep_buf = np.zeros((2, len(EdgeParams.PLANES), h4, w4),
                               dtype=np.int16)
        self.edges = [EdgeParams(h4, w4, self.ep_buf[0]),
                      EdgeParams(h4, w4, self.ep_buf[1])]  # [VER, HOR]
        self.tu_map = None
        self.tu_map_c = None

    def _build_tu_maps(self) -> None:
        # per-4x4 (luma units) TU index maps, separately per plane — local
        # dual tree produces luma-only and chroma-only TUs.  Only needed by
        # the Python derivation path; the native path builds its own.
        cs = self.cs
        h4, w4 = cs.h >> 2, cs.w >> 2
        self.tu_map = np.full((h4, w4), -1, dtype=np.int32)
        self.tu_map_c = np.full((h4, w4), -1, dtype=np.int32)
        for i, tu in enumerate(cs.tus):
            if tu.blocks[0] is not None:
                x, y, w, h = tu.blocks[0]
                self.tu_map[y >> 2:(y + h) >> 2, x >> 2:(x + w) >> 2] = i
            if tu.blocks[1] is not None:
                cx, cy, cw, chh = tu.blocks[1]
                x, y = cx * cs.sub_w, cy * cs.sub_h
                w, h = cw * cs.sub_w, chh * cs.sub_h
                self.tu_map_c[y >> 2:(y + h) >> 2, x >> 2:(x + w) >> 2] = i

    # ---------------- strength derivation ----------------
    def _native_derive(self) -> bool:
        """Derive strengths from the syntax walk's flat records in C."""
        cs = self.cs
        nw = getattr(cs, "_nw", None)
        if nw is None or len(cs.cus) != int(nw["counts"][0]):
            return False
        if getattr(cs, "per_slice_rpl", False):
            # the C derivation models one ref-POC table per picture
            return False
        from refdec.native import native_cabac
        nc = native_cabac()
        if nc is None or not hasattr(nc, "deblock_strengths"):
            return False
        n_cus, n_tus = int(nw["counts"][0]), int(nw["counts"][1])
        # subblock-motion flag: affine from the parse records; SbTMVP
        # (merge_type == 1) is recon-derived and only exists on
        # materialized (inter) CU objects
        from refdec.cabac.native_walk import CU_F, LazyRecList
        cu_extra = (nw["cu_rec"][:n_cus, CU_F["affine"]] != 0) \
            .astype(np.uint8)
        if isinstance(cs.cus, LazyRecList):
            for i, cu in cs.cus.materialized():
                if cu.merge_type == 1 or cu.affine_flag:
                    cu_extra[i] = 1
        else:
            for i, cu in enumerate(cs.cus):
                if cu.merge_type == 1 or cu.affine_flag:
                    cu_extra[i] = 1
        sl_flags = np.fromiter(
            ((1 if s.deblocking_disabled else 0) | (2 if s.is_b else 0)
             for s in cs.shs), dtype=np.uint8, count=len(cs.shs))
        pocs = np.full((2, 16), np.iinfo(np.int32).min, dtype=np.int32)
        ref_pocs = getattr(cs, "ref_pocs", [[], []])
        for lst in range(2):
            for ri, p in enumerate(ref_pocs[lst][:16]):
                pocs[lst, ri] = p
        subpics = np.asarray(
            [[sp[0], sp[1], sp[2], sp[3], int(sp[4]), int(sp[5])]
             for sp in cs.subpics], dtype=np.int32) \
            if cs.subpics else np.zeros((0, 6), dtype=np.int32)
        dummy = np.zeros(1, dtype=np.int32)
        nc.deblock_strengths(
            self.ep_buf, nw["cu_rec"], nw["tu_rec"], n_cus, n_tus,
            cu_extra.tobytes(), sl_flags.tobytes(), len(cs.shs),
            cs.cu_map, cs.cu_map_c if cs.cu_map_c is not None else dummy,
            cs.mi_mv, cs.mi_ref, pocs, subpics.tobytes(), len(cs.subpics),
            cs.w, cs.h, cs.sub_w, cs.sub_h, cs.num_comp,
            cs.sps.qp_bd_offset,
            int(cs.pps.loop_filter_across_slices),
            int(cs.pps.loop_filter_across_tiles))
        return True

    def _apply_virtual_boundaries(self) -> None:
        """Edges coinciding with a virtual boundary are not deblocked
        (xDeriveEdgefilterParam, LoopFilter.cpp): clear the edge cells at
        each boundary position in the respective direction."""
        vbx, vby = self.cs.virtual_boundaries()
        for v in vbx:
            ep = self.edges[0]
            col = v >> 2
            if 0 < col < ep.bs_y.shape[1]:
                for name in ("bs_y", "bs_cb", "bs_cr", "te",
                             "max_fl_p", "max_fl_q", "cmfl"):
                    getattr(ep, name)[:, col] = 0
        for v in vby:
            ep = self.edges[1]
            row = v >> 2
            if 0 < row < ep.bs_y.shape[0]:
                for name in ("bs_y", "bs_cb", "bs_cr", "te",
                             "max_fl_p", "max_fl_q", "cmfl"):
                    getattr(ep, name)[row, :] = 0

    def derive_strengths(self) -> None:
        cs = self.cs
        if all(s.deblocking_disabled for s in cs.shs):
            return
        if self._native_derive():
            self._apply_virtual_boundaries()
            return
        self._build_tu_maps()
        for tu in cs.tus:
            cu = cs.cus[tu.cu_idx]
            if cs.sh_of(cu).deblocking_disabled:
                continue
            self._tu_edges(tu, cu, 0)  # EDGE_VER
            self._tu_edges(tu, cu, 1)  # EDGE_HOR
        # subblock-motion CUs (affine / SbTMVP): internal 8x8 motion edges +
        # max-filter-length refinement (LoopFilter.cpp:567-604,707)
        for cu in cs.cus:
            if cs.sh_of(cu).deblocking_disabled:
                continue
            if cu.affine_flag or cu.merge_type == 1:
                self._subblock_edges(cu, 0)
                self._subblock_edges(cu, 1)
        self._apply_virtual_boundaries()

    def _cu_filter_edge_allowed(self, cu, dir_: int) -> bool:
        """CU-boundary edge filterable? (xGetLoopfilterParam)."""
        cs = self.cs
        x, y = cu.x, cu.y
        if dir_ == 0:
            if x == 0:
                return False
            nb = cs.cu_at(x - 1, y, 0)
        else:
            if y == 0:
                return False
            nb = cs.cu_at(x, y - 1, 0)
        if nb is None:
            return False
        pps = cs.pps
        if nb.slice_idx != cu.slice_idx and not pps.loop_filter_across_slices:
            return False
        if nb.tile_idx != cu.tile_idx and not pps.loop_filter_across_tiles:
            return False
        if cs.subpics:
            # across a subpic boundary only when enabled for BOTH subpics
            nx, ny = (x - 1, y) if dir_ == 0 else (x, y - 1)
            sp_q = cs.subpic_at(x, y)
            sp_p = cs.subpic_at(nx, ny)
            if sp_q is not sp_p and not (
                    (sp_q is None or sp_q[5]) and (sp_p is None or sp_p[5])):
                return False
        return True

    def _tu_edges(self, tu, cu, dir_: int) -> None:
        """Set edge params along the leading edge of this TU."""
        cs = self.cs
        ep = self.edges[dir_]
        if tu.blocks[0] is not None:
            x, y, w, h = tu.blocks[0]
        else:
            cx, cy, cw, chh = tu.blocks[1]
            x, y = cx * cs.sub_w, cy * cs.sub_h
            w, h = cw * cs.sub_w, chh * cs.sub_h
        # edge at TU start; interior CU edges always filtered, CU-boundary
        # edges subject to availability.  Sub-4x4 ISP partition edges round
        # down to the 4x4 lfp grid (vvdec maskBlkX/Y, LoopFilter.cpp:545),
        # so an edge inside the CU's first grid row/col counts as boundary.
        at_cu_edge = ((x & ~3) == cu.x) if dir_ == 0 else ((y & ~3) == cu.y)
        if at_cu_edge:
            if not self._cu_filter_edge_allowed(cu, dir_):
                filter_edge = False
            else:
                filter_edge = True
        else:
            filter_edge = True
        edge_pos = x if dir_ == 0 else y
        if edge_pos == 0 or not filter_edge:
            luma_edge = False
        else:
            luma_edge = True

        if tu.blocks[0] is None:
            luma_edge = False
        if luma_edge:
            # one lfp cell per 4 samples along the edge; TUs narrower than 4
            # (ISP partitions) still claim their containing cell, and later
            # TUs overwrite earlier ones — mirroring vvdec's per-TU writes
            # into the shared 4x4 lfp map (xSetMaxFilterLengthPQFromTransform-
            # Sizes, LoopFilter.cpp:780).
            n_cells = max(1, (h if dir_ == 0 else w) >> 2)
            for d in range(n_cells):
                if dir_ == 0:
                    cx4, cy4 = x >> 2, (y >> 2) + d
                    px, py = x - 1, y + 4 * d
                    # BS/QP derive at the grid-aligned edge position
                    bx, by = (cx4 << 2) - 1, cy4 << 2
                else:
                    cx4, cy4 = (x >> 2) + d, y >> 2
                    px, py = x + 4 * d, y - 1
                    bx, by = cx4 << 2, (cy4 << 2) - 1
                cu_p = cs.cu_at(bx, by, 0)
                tu_p = cs.tus[int(self.tu_map[py >> 2, px >> 2])]
                size_q = w if dir_ == 0 else h
                pblk = tu_p.blocks[0]
                size_p = pblk[2] if dir_ == 0 else pblk[3]
                # marker semantics (BsSet(x, MAX_NUM_COMPONENT) in
                # LoopFilter.cpp:900): motion-based BS applies only on TU
                # edges coinciding with the CU edge; internal TU edges are
                # cbf-only.
                same_cu_tu = (x == cu.x) if dir_ == 0 else (y == cu.y)
                if cu.pred_mode == MODE_INTRA or cu_p.pred_mode == MODE_INTRA:
                    # intra: BS 2 unless both-side BDPCM
                    bs = 0 if (cu.bdpcm_mode and cu_p.bdpcm_mode) else 2
                elif cu.ciip_flag or cu_p.ciip_flag:
                    bs = 2
                else:
                    if tu.cbf[0] or tu_p.cbf[0]:
                        bs = 1
                    elif same_cu_tu:
                        # motion at the two 4x4 cells adjacent to the edge
                        if dir_ == 0:
                            qx, qy = cx4 << 2, cy4 << 2
                            px_m, py_m = qx - 1, qy
                        else:
                            qx, qy = cx4 << 2, cy4 << 2
                            px_m, py_m = qx, qy - 1
                        bs = self._mv_bs(cu, cu_p, (qx, qy), (px_m, py_m))
                    else:
                        bs = 0
                ep.bs_y[cy4, cx4] = bs
                ep.qp_y[cy4, cx4] = (cu.qp + cu_p.qp + 1) >> 1
                ep.te[cy4, cx4] = 1
                if size_p <= 4 or size_q <= 4:
                    flp = flq = 1
                else:
                    flp = (5 if cu_p.affine_flag else 7) if size_p >= 32 else 3
                    flq = 7 if size_q >= 32 else 3
                ep.max_fl_p[cy4, cx4] = flp
                ep.max_fl_q[cy4, cx4] = flq

        # chroma edges (from the chroma TU block)
        if tu.blocks[1] is None or cs.num_comp == 1:
            return
        cx0, cy0, cw, chh = tu.blocks[1]
        edge_pos_c = cx0 if dir_ == 0 else cy0
        if edge_pos_c == 0 or not filter_edge:
            return
        sub_w, sub_h = cs.sub_w, cs.sub_h
        qp_bd2 = cs.sps.qp_bd_offset * 2
        inc_c = 4 // (sub_h if dir_ == 0 else sub_w)  # chroma samples per cell
        n_cells_c = (chh if dir_ == 0 else cw) // inc_c
        for d in range(n_cells_c):
            if dir_ == 0:
                pcx, pcy = cx0 - 1, cy0 + inc_c * d
                lx, ly = (cx0 * sub_w) >> 2, ((cy0 + inc_c * d) * sub_h) >> 2
                cy4, cx4 = ly, lx
            else:
                pcx, pcy = cx0 + inc_c * d, cy0 - 1
                cy4 = (cy0 * sub_h) >> 2
                cx4 = ((cx0 + inc_c * d) * sub_w) >> 2
            plx, ply = pcx * sub_w, pcy * sub_h
            cu_p = cs.cu_at(pcx, pcy, 1) or cs.cu_at(plx, ply, 0)
            tu_p = cs.tus[int(self.tu_map_c[ply >> 2, plx >> 2])]
            if cu.pred_mode == MODE_INTRA or cu_p.pred_mode == MODE_INTRA:
                bs = 0 if (cu.bdpcm_mode_chroma and cu_p.bdpcm_mode_chroma) \
                    else 2
                bs_cb = bs_cr = bs
            elif cu.ciip_flag or cu_p.ciip_flag:
                bs_cb = bs_cr = 2
            else:
                # inter-inter chroma BS is cbf/jointCbCr-based only
                jc = bool(tu.joint_cbcr or tu_p.joint_cbcr)
                bs_cb = int(tu.cbf[1] or tu_p.cbf[1] or jc)
                bs_cr = int(tu.cbf[2] or tu_p.cbf[2] or jc)
            ep.bs_cb[cy4, cx4] = bs_cb
            ep.bs_cr[cy4, cx4] = bs_cr
            ep.qp_cb[cy4, cx4] = (tu_p.chroma_qp[0] + tu.chroma_qp[0] - qp_bd2 + 1) >> 1
            ep.qp_cr[cy4, cx4] = (tu_p.chroma_qp[1] + tu.chroma_qp[1] - qp_bd2 + 1) >> 1
            size_q = cw if dir_ == 0 else chh
            pblk = tu_p.blocks[1]
            size_p = pblk[2] if dir_ == 0 else pblk[3]
            ep.cmfl[cy4, cx4] = 1 if (size_p >= 8 and size_q >= 8) else 0

    def _subblock_edges(self, cu, dir_: int) -> None:
        """Internal 8x8 subblock motion edges of affine/SbTMVP CUs
        (xSetEdgeFilterInsidePu LoopFilter.cpp:1032 + marker upgrade :567,
        maxFilterLength refinement xSetMaxFilterLengthPQForCodingSubBlocks
        :707)."""
        ep = self.edges[dir_]
        perp_size = cu.w if dir_ == 0 else cu.h
        parl_size = cu.h if dir_ == 0 else cu.w

        # internal 8-grid edges: filter-edge + BS from the motion field
        for off in range(8, perp_size, 8):
            for par in range(0, parl_size, 4):
                x = cu.x + (off if dir_ == 0 else par)
                y = cu.y + (par if dir_ == 0 else off)
                cx4, cy4 = x >> 2, y >> 2
                if ep.te[cy4, cx4]:
                    # TU edge upgraded to motion-checking (marker 1 -> 3)
                    if ep.bs_y[cy4, cx4] != 0:
                        continue
                else:
                    ep.qp_y[cy4, cx4] = cu.qp
                pos_p = (x - 1, y) if dir_ == 0 else (x, y - 1)
                ep.bs_y[cy4, cx4] = self._mv_bs(cu, cu, (x, y), pos_p)

        # max-filter-length refinement over the (8-perp x 4-parl) grid
        for off in range(0, perp_size, 8):
            for par in range(0, parl_size, 4):
                x = cu.x + (off if dir_ == 0 else par)
                y = cu.y + (par if dir_ == 0 else off)
                cx4, cy4 = x >> 2, y >> 2

                def te_at(k):
                    if dir_ == 0:
                        return bool(ep.te[cy4, cx4 + k])
                    return bool(ep.te[cy4 + k, cx4])

                if ep.te[cy4, cx4]:
                    q = min(int(ep.max_fl_q[cy4, cx4]), 5)
                    p = int(ep.max_fl_p[cy4, cx4])
                    if off > 0:
                        p = min(p, 5)
                elif off > 0 and (te_at(-1) or off + 4 >= perp_size
                                  or te_at(1)):
                    p = q = 1
                elif off > 0 and (off == 8 or te_at(-2)
                                  or off + 8 >= perp_size or te_at(2)):
                    p = q = 2
                else:
                    p = q = 3
                ep.max_fl_p[cy4, cx4] = p
                ep.max_fl_q[cy4, cx4] = q

    def _slice_pocs(self, cu):
        """This CU's slice's resolved ref-POC lists (per-slice RPLs)."""
        cs = self.cs
        if getattr(cs, "per_slice_rpl", False):
            st = cs.slice_ref_sets[cu.slice_idx]
            if st is not None:
                return st[0]
        return cs.ref_pocs

    def _ref_poc(self, cu, lst: int):
        if cu.ref_idx[lst] < 0:
            return None
        return self._slice_pocs(cu)[lst][cu.ref_idx[lst]]

    def _mi_at(self, x: int, y: int):
        cs = self.cs
        y4, x4 = y >> 2, x >> 2
        r0 = int(cs.mi_ref[y4, x4, 0])
        r1 = int(cs.mi_ref[y4, x4, 1])
        return ((int(cs.mi_mv[y4, x4, 0, 0]), int(cs.mi_mv[y4, x4, 0, 1])),
                (int(cs.mi_mv[y4, x4, 1, 0]), int(cs.mi_mv[y4, x4, 1, 1])),
                r0, r1)

    def _mv_bs(self, cu_q, cu_p, pos_q, pos_p) -> int:
        """MV/reference-based BS for inter-inter edges
        (xGetBoundaryStrengthSingle tail, LoopFilter.cpp:1215)."""
        from refdec.frame.structure import MODE_IBC
        thr = 8  # half-pel in 1/16 units
        cs = self.cs

        # prediction-mode mismatch (INTER vs IBC): BS 1 (LoopFilter.cpp:1219)
        if cu_q.pred_mode != cu_p.pred_mode:
            return 1

        def diff(a, b):
            return abs(a[0] - b[0]) >= thr or abs(a[1] - b[1]) >= thr

        mvq0, mvq1, rq0, rq1 = self._mi_at(*pos_q)
        mvp0, mvp1, rp0, rp1 = self._mi_at(*pos_p)
        is_ibc = cu_q.pred_mode == MODE_IBC
        pocs_q = self._slice_pocs(cu_q)
        pocs_p = self._slice_pocs(cu_p)

        def poc(lst, ri, pocs=None):
            if lst == 0 and is_ibc:
                return "self"  # IBC references the current picture
            if pocs is None:
                pocs = pocs_q
            return pocs[lst][ri] if ri >= 0 else None

        if cs.sh_of(cu_q).is_b:
            p0, p1 = poc(0, rp0, pocs_p), poc(1, rp1, pocs_p)
            q0, q1 = poc(0, rq0, pocs_q), poc(1, rq1, pocs_q)
            if not ((p0 == q0 and p1 == q1) or (p0 == q1 and p1 == q0)):
                return 1
            zero = (0, 0)
            mv_p = [mvp0 if p0 is not None else zero,
                    mvp1 if p1 is not None else zero]
            mv_q = [mvq0 if q0 is not None else zero,
                    mvq1 if q1 is not None else zero]
            if p0 != p1:
                if p0 == q0:
                    return int(diff(mv_q[0], mv_p[0]) or diff(mv_q[1], mv_p[1]))
                return int(diff(mv_q[1], mv_p[0]) or diff(mv_q[0], mv_p[1]))
            return int((diff(mv_q[0], mv_p[0]) or diff(mv_q[1], mv_p[1]))
                       and (diff(mv_q[1], mv_p[0]) or diff(mv_q[0], mv_p[1])))
        if poc(0, rp0, pocs_p) != poc(0, rq0, pocs_q):
            return 1
        return int(diff(mvq0, mvp0))

    # ---------------- application ----------------
    def apply(self) -> None:
        if all(s.deblocking_disabled for s in self.cs.shs):
            return
        self.derive_strengths()
        if self._native_filter_frame():
            return
        for dir_ in (0, 1):
            self._filter_luma(dir_)
            if self.cs.num_comp > 1:
                self._filter_chroma(dir_)

    def _native_filter_frame(self) -> bool:
        """Whole-frame directional filtering in one C call (both
        directions, luma + chroma) straight off the packed edge tensor —
        no per-cell Python dispatch."""
        from refdec.native import native_cabac
        nc = native_cabac()
        cs = self.cs
        if (nc is None or not hasattr(nc, "deblock_filter_frame")
                or any(p.dtype != np.int32 or not p.flags["C_CONTIGUOUS"]
                       for p in self.reco)):
            return False
        sl_prm = np.array(
            [[s.tc_offset_div2, s.beta_offset_div2,
              s.cb_tc_offset_div2, s.cr_tc_offset_div2,
              s.cb_beta_offset_div2, s.cr_beta_offset_div2]
             for s in cs.shs], dtype=np.int32)
        y = self.reco[0]
        cb = self.reco[1] if cs.num_comp > 1 else y
        cr = self.reco[2] if cs.num_comp > 1 else y
        nc.deblock_filter_frame(
            y, cb, cr, cs.w, cs.h, cs.sub_w, cs.sub_h, self.ep_buf,
            cs.slice_map, sl_prm.tobytes(), len(cs.shs), self.bit_depth,
            cs.sps.ctu_size, cs.num_comp)
        return True

    # -- luma --
    def _filter_luma(self, dir_: int) -> None:
        cs = self.cs
        ep = self.edges[dir_]
        plane = self.reco[0]
        h4, w4 = ep.bs_y.shape
        cells = np.argwhere(ep.bs_y > 0)
        if not len(cells):
            return
        multi = len(cs.shs) > 1
        from refdec.native import native_cabac
        nc = native_cabac()
        if nc is not None and plane.dtype == np.int32 \
                and plane.flags["C_CONTIGUOUS"]:
            n = len(cells)
            ys, xs = cells[:, 0], cells[:, 1]
            xy = np.empty((n, 2), dtype=np.int32)
            xy[:, 0] = xs * 4
            xy[:, 1] = ys * 4
            prm = np.empty((n, 6), dtype=np.int32)
            prm[:, 0] = ep.bs_y[ys, xs]
            prm[:, 1] = ep.qp_y[ys, xs]
            prm[:, 2] = ep.max_fl_p[ys, xs]
            prm[:, 3] = ep.max_fl_q[ys, xs]
            if not multi:
                prm[:, 4] = cs.sh.tc_offset_div2
                prm[:, 5] = cs.sh.beta_offset_div2
            else:
                si = np.clip(cs.slice_map[ys, xs], 0, len(cs.shs) - 1)
                prm[:, 4] = np.array([s_.tc_offset_div2
                                      for s_ in cs.shs])[si]
                prm[:, 5] = np.array([s_.beta_offset_div2
                                      for s_ in cs.shs])[si]
            nc.deblock_luma(plane, plane.shape[1], plane.shape[0], dir_, n,
                            xy.tobytes(), prm.tobytes(), self.bit_depth,
                            cs.sps.ctu_size)
            return
        sh = cs.sh
        for cy4, cx4 in cells:
            if multi:
                # per-slice tc/beta offsets: the Q-side block's slice
                cu_q = cs.cu_at(int(cx4) * 4, int(cy4) * 4, 0)
                sh = cs.sh_of(cu_q) if cu_q is not None else cs.sh
            self._luma_edge_cell(plane, dir_, int(cx4) * 4, int(cy4) * 4,
                                 ep, int(cy4), int(cx4), sh)

    def _luma_edge_cell(self, plane, dir_, x, y, ep, cy4, cx4, sh) -> None:
        """Filter one 4-line edge segment (xEdgeFilterLuma).

        The cell's 4 lines are processed on a contiguous window (rows =
        lines, cols = across-edge offsets) so the per-line filter kernels
        vectorize; decisions and arithmetic are identical to the scalar
        form."""
        bs = int(ep.bs_y[cy4, cx4])
        qp = int(ep.qp_y[cy4, cx4])
        max_fl_p = int(ep.max_fl_p[cy4, cx4])
        max_fl_q = int(ep.max_fl_q[cy4, cx4])
        bd = self.bit_depth

        if dir_ == 0:
            lo = max(0, x - 8)
            hi = min(plane.shape[1], x + 8)
            win = plane[y: y + 4, lo: hi].astype(np.int64)
            base = x - lo
        else:
            lo = max(0, y - 8)
            hi = min(plane.shape[0], y + 8)
            win = plane[lo: hi, x: x + 4].T.astype(np.int64)
            base = y - lo

        def get(line, k):
            return int(win[line, base + k])

        def put(line, k, v):
            win[line, base + k] = v

        side_p_large = max_fl_p > 3
        side_q_large = max_fl_q > 3
        if dir_ == 1 and (y & (self.cs.sps.ctu_size - 1)) == 0:
            side_p_large = False

        idx_tc = max(0, min(MAX_QP + DEFAULT_INTRA_TC_OFFSET,
                            qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1)
                            + 2 * sh.tc_offset_div2))
        idx_b = max(0, min(MAX_QP, qp + 2 * sh.beta_offset_div2))
        tc = (TC_TABLE[idx_tc] << (bd - 10)) if bd >= 10 else \
            ((TC_TABLE[idx_tc] + (1 << (9 - bd))) >> (10 - bd))
        tc = int(tc)
        beta = int(BETA_TABLE[idx_b]) << (bd - 8)
        side_thresh = (beta + (beta >> 1)) >> 3
        thr_cut = tc * 10
        if beta == 0 and tc == 0:
            return

        def calc_dp(line, base):
            return abs(get(line, base - 3) - 2 * get(line, base - 2) + get(line, base - 1))

        def calc_dq(line, base):
            return abs(get(line, base) - 2 * get(line, base + 1) + get(line, base + 2))

        dp0, dq0 = calc_dp(0, 0), calc_dq(0, 0)
        dp3, dq3 = calc_dp(3, 0), calc_dq(3, 0)
        d0, d3 = dp0 + dq0, dp3 + dq3

        def use_strong(line, d2, use_large, mfp, mfq):
            m3, m4 = get(line, -1), get(line, 0)
            if not (d2 < (beta >> 2) and abs(m3 - m4) < ((tc * 5 + 1) >> 1)):
                return False
            m0, m7 = get(line, -4), get(line, 3)
            sp3 = abs(m0 - m3)
            sq3 = abs(m7 - m4)
            if use_large:
                sp_l, sq_l = side_p_large, side_q_large
                if sp_l:
                    mp4 = get(line, -mfp - 1)
                    if mfp == 7:
                        sp3 += abs(get(line, -5) - get(line, -6) - get(line, -7) + mp4)
                    sp3 = (sp3 + abs(m0 - mp4) + 1) >> 1
                if sq_l:
                    m11 = get(line, mfq)
                    if mfq == 7:
                        sq3 += abs(get(line, 4) - get(line, 5) - get(line, 6) + m11)
                    sq3 = (sq3 + abs(m11 - m7) + 1) >> 1
                return ((sp3 + sq3) < (beta * 3 >> 5)) and (d2 < (beta >> 4)) \
                    and (abs(m3 - m4) < ((tc * 5 + 1) >> 1))
            return (sp3 + sq3) < (beta >> 3)

        if side_p_large or side_q_large:
            dp0l = ((dp0 + calc_dp(0, -3) + 1) >> 1) if side_p_large else dp0
            dq0l = ((dq0 + calc_dq(0, 3) + 1) >> 1) if side_q_large else dq0
            dp3l = ((dp3 + calc_dp(3, -3) + 1) >> 1) if side_p_large else dp3
            dq3l = ((dq3 + calc_dq(3, 3) + 1) >> 1) if side_q_large else dq3
            d0l, d3l = dp0l + dq0l, dp3l + dq3l
            if d0l + d3l < beta:
                sw_l = use_strong(0, 2 * d0l, True, max_fl_p, max_fl_q) and \
                    use_strong(3, 2 * d3l, True, max_fl_p, max_fl_q)
                if sw_l:
                    self._long_filter_v(win, base,
                                        max_fl_p if side_p_large else 3,
                                        max_fl_q if side_q_large else 3, tc)
                    self._writeback(plane, dir_, x, y, lo, hi, win)
                    return

        dp, dq, d = dp0 + dp3, dq0 + dq3, d0 + d3
        if d >= beta:
            return
        filter_p = filter_q = False
        if max_fl_p > 1 and max_fl_q > 1:
            filter_p = dp < side_thresh
            filter_q = dq < side_thresh
        sw = False
        if max_fl_p > 2 and max_fl_q > 2:
            sw = use_strong(0, 2 * d0, False, 7, 7) and use_strong(3, 2 * d3, False, 7, 7)
        self._pel_filter_luma_v(win, base, tc, sw, thr_cut,
                                filter_p, filter_q)
        self._writeback(plane, dir_, x, y, lo, hi, win)

    def _writeback(self, plane, dir_, x, y, lo, hi, win) -> None:
        if dir_ == 0:
            plane[y: y + 4, lo: hi] = win
        else:
            plane[lo: hi, x: x + 4] = win.T

    def _pel_filter_luma_v(self, win, b, tc, sw, thr_cut,
                           filter_p, filter_q) -> None:
        """All 4 lines at once (xPelFilterLumaCorePel vectorized)."""
        m1, m2, m3 = win[:, b - 3], win[:, b - 2], win[:, b - 1]
        m4, m5, m6 = win[:, b], win[:, b + 1], win[:, b + 2]
        m1, m2, m3 = m1.copy(), m2.copy(), m3.copy()
        m4, m5, m6 = m4.copy(), m5.copy(), m6.copy()
        if sw:
            m0, m7 = win[:, b - 4].copy(), win[:, b + 3].copy()

            def c3(v, ref, t):
                return np.maximum(ref - t, np.minimum(ref + t, v))
            win[:, b - 3] = c3((2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3,
                               m1, tc)
            win[:, b - 2] = c3((m1 + m2 + m3 + m4 + 2) >> 2, m2, 2 * tc)
            win[:, b - 1] = c3((m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3,
                               m3, 3 * tc)
            win[:, b] = c3((m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3,
                           m4, 3 * tc)
            win[:, b + 1] = c3((m3 + m4 + m5 + m6 + 2) >> 2, m5, 2 * tc)
            win[:, b + 2] = c3((m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3,
                               m6, tc)
        else:
            delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4
            mask = np.abs(delta) < thr_cut
            d = np.clip(delta, -tc, tc)
            tc2 = tc >> 1
            pm = self.pel_max
            win[:, b - 1] = np.where(mask, np.clip(m3 + d, 0, pm), m3)
            win[:, b] = np.where(mask, np.clip(m4 - d, 0, pm), m4)
            if filter_p:
                d1 = np.clip((((m1 + m3 + 1) >> 1) - m2 + d) >> 1, -tc2, tc2)
                win[:, b - 2] = np.where(mask, np.clip(m2 + d1, 0, pm), m2)
            if filter_q:
                d2 = np.clip((((m6 + m4 + 1) >> 1) - m5 - d) >> 1, -tc2, tc2)
                win[:, b + 1] = np.where(mask, np.clip(m5 + d2, 0, pm), m5)

    def _long_filter_v(self, win, b, n_p, n_q, tc) -> None:
        """Long bilinear filter, 4 lines at once
        (xFilteringPandQCore + xBilinearFilter)."""
        dbp, dbq = DB_COEFFS[n_p], DB_COEFFS[n_q]
        tc7 = (6, 5, 4, 3, 2, 1, 1)
        tc3 = (6, 4, 2)
        tcp = tc3 if n_p == 3 else tc7
        tcq = tc3 if n_q == 3 else tc7

        def p(k):
            return win[:, b - 1 - k]

        def q(k):
            return win[:, b + k]
        ref_p = (p(n_p - 1) + p(n_p) + 1) >> 1
        ref_q = (q(n_q - 1) + q(n_q) + 1) >> 1
        if n_p == n_q:
            if n_p == 5:
                ref_m = (2 * (p(0) + q(0) + p(1) + q(1) + p(2) + q(2))
                         + p(3) + q(3) + p(4) + q(4) + 8) >> 4
            else:
                ref_m = (2 * (p(0) + q(0)) + p(1) + q(1) + p(2) + q(2)
                         + p(3) + q(3) + p(4) + q(4) + p(5) + q(5)
                         + p(6) + q(6) + 8) >> 4
        else:
            if n_q > n_p:
                pl, ql = q, p  # pl = larger side
                n_l, n_s = n_q, n_p
            else:
                pl, ql = p, q
                n_l, n_s = n_p, n_q
            if n_l == 7 and n_s == 5:
                ref_m = (2 * (p(0) + q(0) + p(1) + q(1)) + p(2) + q(2)
                         + p(3) + q(3) + p(4) + q(4) + p(5) + q(5) + 8) >> 4
            elif n_l == 7 and n_s == 3:
                ref_m = (2 * (pl(0) + ql(0)) + ql(0) + 2 * (ql(1) + ql(2))
                         + pl(1) + ql(1) + pl(2) + pl(3) + pl(4) + pl(5)
                         + pl(6) + 8) >> 4
            else:  # 5 & 3
                ref_m = (p(0) + q(0) + p(1) + q(1) + p(2) + q(2)
                         + p(3) + q(3) + 4) >> 3
        new_p = []
        for pos in range(n_p):
            src = p(pos)
            cv = (tc * tcp[pos]) >> 1
            val = (ref_m * dbp[pos] + ref_p * (64 - dbp[pos]) + 32) >> 6
            new_p.append(np.maximum(src - cv, np.minimum(src + cv, val)))
        new_q = []
        for pos in range(n_q):
            src = q(pos)
            cv = (tc * tcq[pos]) >> 1
            val = (ref_m * dbq[pos] + ref_q * (64 - dbq[pos]) + 32) >> 6
            new_q.append(np.maximum(src - cv, np.minimum(src + cv, val)))
        for pos in range(n_p):
            win[:, b - 1 - pos] = new_p[pos]
        for pos in range(n_q):
            win[:, b + pos] = new_q[pos]

    def _clip_pel(self, v: int) -> int:
        return max(0, min(self.pel_max, v))

    # -- chroma --
    def _filter_chroma(self, dir_: int) -> None:
        cs = self.cs
        ep = self.edges[dir_]
        sh = cs.sh
        sub_w, sub_h = cs.sub_w, cs.sub_h
        cw, chh = cs.comp_size[1]
        # grid: edges every 8 chroma samples perpendicular, 2-chroma-line cells
        if dir_ == 0:
            perp_step = 8        # chroma columns between edges
            par_step = 4 // sub_h  # chroma rows per param cell
        else:
            perp_step = 8
            par_step = 4 // sub_w
        sub_shift = sub_h - 1 if dir_ == 0 else sub_w - 1  # 420: 1

        from refdec.native import native_cabac
        nc = native_cabac()
        use_native = (nc is not None and self.reco[1].dtype == np.int32
                      and self.reco[1].flags["C_CONTIGUOUS"])
        multi = len(cs.shs) > 1
        ctu_c_mask = (cs.sps.ctu_size // cs.sub_h) - 1
        # vectorized active-cell scan: gather the per-cell strengths for the
        # whole chroma edge grid at once and iterate active cells only
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
        if use_native:
            # assemble the whole active-cell table with numpy gathers
            ccx_a = ccx_g[mask].astype(np.int32)
            ccy_a = ccy_g[mask].astype(np.int32)
            cx4_a = cx4_g[mask]
            cy4_a = cy4_g[mask]
            n_act = len(ccx_a)
            arr = np.empty((n_act, 12), dtype=np.int32)
            arr[:, 0] = ccx_a
            arr[:, 1] = ccy_a
            arr[:, 2] = bs_cb_g[mask]
            arr[:, 3] = bs_cr_g[mask]
            arr[:, 4] = ep.qp_cb[cy4_a, cx4_a]
            arr[:, 5] = ep.qp_cr[cy4_a, cx4_a]
            arr[:, 6] = ep.cmfl[cy4_a, cx4_a]
            arr[:, 7] = (dir_ == 1) & ((ccy_a & ctu_c_mask) == 0)
            if not multi:
                arr[:, 8] = sh.cb_tc_offset_div2
                arr[:, 9] = sh.cr_tc_offset_div2
                arr[:, 10] = sh.cb_beta_offset_div2
                arr[:, 11] = sh.cr_beta_offset_div2
            else:
                si = np.clip(cs.slice_map[cy4_a, cx4_a], 0, len(cs.shs) - 1)
                for col, attr in ((8, "cb_tc_offset_div2"),
                                  (9, "cr_tc_offset_div2"),
                                  (10, "cb_beta_offset_div2"),
                                  (11, "cr_beta_offset_div2")):
                    arr[:, col] = np.array(
                        [getattr(s_, attr) for s_ in cs.shs])[si]
        else:
            for ai, aj in np.argwhere(mask):
                ccx, ccy = int(ccx_g[ai, aj]), int(ccy_g[ai, aj])
                cx4, cy4 = int(cx4_g[ai, aj]), int(cy4_g[ai, aj])
                if multi:
                    cu_q = cs.cu_at(ccx * sub_w, ccy * sub_h, 0)
                    sh = cs.sh_of(cu_q) if cu_q is not None else cs.sh
                self._chroma_edge_cell(dir_, ccx, ccy, ep, cy4, cx4, sh,
                                       par_step, sub_shift)
        if use_native:
            for k, comp in enumerate((1, 2)):
                bs_col = arr[:, 2 + k]
                large_col = arr[:, 6]
                sel = (bs_col == 2) | ((large_col != 0) & (bs_col == 1))
                if not sel.any():
                    continue
                a_ = arr[sel]
                n = len(a_)
                xy = np.ascontiguousarray(a_[:, 0:2])
                prm = np.empty((n, 6), dtype=np.int32)
                prm[:, 0] = a_[:, 2 + k]           # bs
                prm[:, 1] = a_[:, 4 + k]           # qp
                prm[:, 2] = a_[:, 6]               # cmfl
                prm[:, 3] = a_[:, 8 + k]           # tc offset
                prm[:, 4] = a_[:, 10 + k]          # beta offset
                prm[:, 5] = a_[:, 7]               # hor_ctb
                plane = self.reco[comp]
                nc.deblock_chroma(plane, plane.shape[1], plane.shape[0],
                                  dir_, n, xy.tobytes(), prm.tobytes(),
                                  self.bit_depth, par_step, sub_shift)

    def _chroma_edge_cell(self, dir_, ccx, ccy, ep, cy4, cx4, sh,
                          loop_len, sub_shift) -> None:
        cs = self.cs
        bd = self.bit_depth
        large = bool(ep.cmfl[cy4, cx4])
        ctu_c_mask = (cs.sps.ctu_size // cs.sub_h) - 1
        is_hor_ctb = dir_ == 1 and (ccy & ctu_c_mask) == 0
        for idx, comp in enumerate((1, 2)):
            bs = int((ep.bs_cb if comp == 1 else ep.bs_cr)[cy4, cx4])
            if not (bs == 2 or (large and bs == 1)):
                continue
            plane = self.reco[comp]
            qp = int((ep.qp_cb if comp == 1 else ep.qp_cr)[cy4, cx4])
            tc_off = sh.cb_tc_offset_div2 if comp == 1 else sh.cr_tc_offset_div2
            beta_off = sh.cb_beta_offset_div2 if comp == 1 else sh.cr_beta_offset_div2
            idx_tc = max(0, min(MAX_QP + DEFAULT_INTRA_TC_OFFSET,
                                qp + DEFAULT_INTRA_TC_OFFSET * (bs - 1) + 2 * tc_off))
            tc = (TC_TABLE[idx_tc] << (bd - 10)) if bd >= 10 else \
                ((TC_TABLE[idx_tc] + (1 << (9 - bd))) >> (10 - bd))
            tc = int(tc)
            if tc == 0 and not large:
                continue

            if dir_ == 0:
                lo = max(0, ccx - 4)
                hi = min(plane.shape[1], ccx + 4)
                win = plane[ccy: ccy + loop_len, lo: hi].astype(np.int64)
                base = ccx - lo
            else:
                lo = max(0, ccy - 4)
                hi = min(plane.shape[0], ccy + 4)
                win = plane[lo: hi, ccx: ccx + loop_len].T.astype(np.int64)
                base = ccy - lo

            def get(line, k):
                return int(win[line, base + k])

            sw = False
            if large:
                beta = int(BETA_TABLE[max(0, min(MAX_QP, qp + 2 * beta_off))]) \
                    << (bd - 8)

                def calc_dp(line, hor_ctb):
                    if hor_ctb:
                        return abs(get(line, -2) - 2 * get(line, -2) + get(line, -1))
                    return abs(get(line, -3) - 2 * get(line, -2) + get(line, -1))

                def calc_dq(line):
                    return abs(get(line, 0) - 2 * get(line, 1) + get(line, 2))

                line3 = 1 if sub_shift == 1 else 3
                dp0 = calc_dp(0, is_hor_ctb)
                dq0 = calc_dq(0)
                dp3 = calc_dp(line3, is_hor_ctb)
                dq3 = calc_dq(line3)
                d0, d3 = dp0 + dq0, dp3 + dq3
                if d0 + d3 < beta:
                    sw = self._chroma_strong(get, 0, 2 * d0, beta, tc, is_hor_ctb) \
                        and self._chroma_strong(get, line3, 2 * d3, beta, tc, is_hor_ctb)
            self._pel_filter_chroma_v(win, base, tc, sw, large, is_hor_ctb)
            if dir_ == 0:
                plane[ccy: ccy + loop_len, lo: hi] = win
            else:
                plane[lo: hi, ccx: ccx + loop_len] = win.T

    def _chroma_strong(self, get, line, d2, beta, tc, hor_ctb) -> bool:
        m3, m4 = get(line, -1), get(line, 0)
        if not (d2 < (beta >> 2) and abs(m3 - m4) < ((tc * 5 + 1) >> 1)):
            return False
        m0, m7 = get(line, -4), get(line, 3)
        m2 = get(line, -2)
        sp3 = abs(m2 - m3) if hor_ctb else abs(m0 - m3)
        sq3 = abs(m7 - m4)
        return (sp3 + sq3) < (beta >> 3)

    def _pel_filter_chroma_v(self, win, b, tc, sw, large, hor_ctb) -> None:
        """All lines of the chroma edge cell at once (xPelFilterChroma)."""
        m2, m3 = win[:, b - 2].copy(), win[:, b - 1].copy()
        m4, m5 = win[:, b].copy(), win[:, b + 1].copy()
        if sw:
            m6, m7 = win[:, b + 2].copy(), win[:, b + 3].copy()

            def c3(v, ref):
                return np.maximum(ref - tc, np.minimum(ref + tc, v))
            if hor_ctb:
                win[:, b - 1] = c3((3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3,
                                   m3)
                win[:, b] = c3((2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3,
                               m4)
                win[:, b + 1] = c3(
                    (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5)
                win[:, b + 2] = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3,
                                   m6)
            else:
                m0, m1 = win[:, b - 4].copy(), win[:, b - 3].copy()
                win[:, b - 3] = c3((3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3,
                                   m1)
                win[:, b - 2] = c3(
                    (2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3, m2)
                win[:, b - 1] = c3(
                    (m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3)
                win[:, b] = c3(
                    (m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4)
                win[:, b + 1] = c3(
                    (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5)
                win[:, b + 2] = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3,
                                   m6)
        else:
            delta = np.clip(((m4 - m3) * 4 + m2 - m5 + 4) >> 3, -tc, tc)
            pm = self.pel_max
            win[:, b - 1] = np.clip(m3 + delta, 0, pm)
            win[:, b] = np.clip(m4 - delta, 0, pm)


def deblock_frame(cs: CodingStructure, reco: list[np.ndarray]) -> None:
    """In-place deblocking of reconstructed planes."""
    Deblocker(cs, reco).apply()
