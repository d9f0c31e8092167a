"""CTU-level CABAC syntax codec: coding tree, intra CUs, residual coding.

Implements H.266 clauses 7.3.11 (coding tree / CU / TU syntax) and 7.3.11.11
(residual coding).  Behavioral parity: vvdec CABACReader
(source/Lib/DecoderLib/CABACReader.cpp: coding_tree_unit :128, coding_tree
:477, split_cu_mode :679, coding_unit :856, intra_luma_pred_mode :1270,
intra_chroma_pred_mode :1341, transform_tree :2012, transform_unit :2148,
residual_coding :2362, residual_coding_subblock :2704, last_sig_coeff :2640)
and CoeffCodingContext (CommonLib/ContextModelling.{h,cpp}).

**Dual mode**: the same control path runs as a decoder (CabacDecoder attached)
or as an encoder (CabacEncoder + a `decisions` provider).  Every syntax element
goes through the `_bin/_ep/_eps/_rem` wrappers, so context selection and state
update are identical in both directions — the encoder half powers the test
bitstream generator and is pinned against the reference decoder binary.

Tool scope: the complete Main10 syntax surface — QT/BT/TT partitioning
(incl. dual tree and local dual tree), all intra modes (MPM/angular,
MIP, ISP, MRL, CCLM, BDPCM), all inter modes (merge/MMVD/CIIP/GPM/
affine/SMVD/AMVR/BCW, IBC), transform trees with MTS/LFNST/SBT/
joint-CbCr/ACT, regular + transform-skip residual coding with dep-quant
and sign-data-hiding, SAO/ALF CTU syntax, WPP/tile/slice substreams.
"""

from __future__ import annotations

import functools

import numpy as np

from refdec.cabac import ctx_tables
from refdec.cabac.engine import CabacDecoder, CabacEncoder
from refdec.cabac.partitioner import (
    Area,
    CU_DONT_SPLIT,
    CU_HORZ_SPLIT,
    CU_QUAD_SPLIT,
    CU_TRIH_SPLIT,
    CU_TRIV_SPLIT,
    CU_VERT_SPLIT,
    TU_MAX_TR_SPLIT,
    PartNode,
    SplitConstraints,
    can_split,
    split_areas,
    can_use_isp_split,
    isp_split_dim,
    can_use_lfnst_with_isp,
)
from refdec.frame.structure import (
    CodingStructure,
    CodingUnit,
    MODE_IBC,
    DC_IDX,
    DM_CHROMA_IDX,
    HOR_IDX,
    HOR_INTRA_SUBPARTITIONS,
    VER_INTRA_SUBPARTITIONS,
    LM_CHROMA_IDX,
    MDLM_L_IDX,
    MDLM_T_IDX,
    MODE_INTER,
    MODE_INTRA,
    MODE_TYPE_ALL,
    MODE_TYPE_INTER,
    MODE_TYPE_INTRA,
    MTS_DCT2_DCT2,
    MTS_DST7_DST7,
    MTS_SKIP,
    NUM_LUMA_MODE,
    NUM_MPM,
    PLANAR_IDX,
    TREE_C,
    TREE_D,
    TREE_L,
    TransformUnit,
    VDIA_IDX,
    VER_IDX,
)
from refdec.ops import rom

_OFF = ctx_tables.CTX_OFFSETS


def ctx(name: str, inc: int = 0) -> int:
    off, size = _OFF[name]
    assert inc < size, (name, inc, size)
    return off + inc


COEF_REMAIN_BIN_REDUCTION = 5
SBH_THRESHOLD = 4
CU_DQP_TU_CMAX = 5
CU_DQP_EG_K = 0
MAX_QP = 63
# dep-quant state transition table packed into an int (CABACReader.cpp:2402)
DQ_STATE_TRANS_TABLE = 32040


class Decisions:
    """Decision provider for encode mode.  Override for custom encoders."""

    def split(self, node: PartNode, allowed: dict[int, bool]) -> int:
        return CU_DONT_SPLIT

    def intra_luma_mode(self, cu: CodingUnit, mpm: list[int]) -> int:
        return DC_IDX

    def multi_ref_line(self, cu: CodingUnit) -> int:
        return 0

    def intra_chroma_mode(self, cu: CodingUnit, cand_modes: list[int],
                          cclm_allowed: bool = False) -> int:
        return DM_CHROMA_IDX

    def qp_delta(self, cu: CodingUnit) -> int:
        return 0

    def mts_idx(self, cu: CodingUnit) -> int:
        return 0  # MTS_DCT2_DCT2 or MTS_DST7_DST7..MTS_DCT8_DCT8 (2..5)

    def lfnst_idx(self, cu: CodingUnit) -> int:
        return 0  # 0, 1 or 2

    def use_ts(self, tu: TransformUnit, cu: CodingUnit, comp: int) -> bool:
        return False

    def bdpcm_mode(self, cu: CodingUnit, comp_ch: int) -> int:
        return 0  # 0 off, 1 horizontal, 2 vertical

    def isp_mode(self, cu: CodingUnit, allowed: int) -> int:
        """0 off, 1 horizontal, 2 vertical; `allowed` is the permitted set
        (1 = hor only, 2 = ver only, 3 = both)."""
        return 0

    def mip(self, cu: CodingUnit) -> bool:
        return False

    def joint_cbcr(self, tu: TransformUnit, cu: CodingUnit,
                   cbf_mask: int) -> bool:
        return False

    def alf(self, cx: int, cy: int, coder) -> dict:
        return {"enable": [0, 0, 0], "filt_idx": 0, "alt": [0, 0],
                "cc": [0, 0]}

    def sao(self, cx: int, cy: int, luma_on: bool, chroma_on: bool,
            coder) -> dict:
        """SAO params for one CTU: {"merge": -1/0/1, "mode": [0|1|2]*3
        (0 off, 1 EO, 2 BO), "offsets": [[4 signed]*3], "band": [3],
        "eo_class": [3]}.  Offsets for EO are magnitudes."""
        return {"merge": -1, "mode": [0, 0, 0],
                "offsets": [[0] * 4] * 3, "band": [0] * 3,
                "eo_class": [0] * 3}

    def mip_mode(self, cu: CodingUnit, n_modes: int) -> tuple[int, bool]:
        """(mode index in [0, n_modes), transpose flag)."""
        return 0, False

    def coeffs(self, tu: TransformUnit, cu: CodingUnit, comp: int) -> np.ndarray | None:
        """Quantized levels for the TU component (h x w int array) or None."""
        return None

    # ---- inter decisions ----
    def cu_skip(self, cu: CodingUnit) -> bool:
        return False

    def pred_mode(self, cu: CodingUnit) -> int:
        return MODE_INTRA

    def merge_flag(self, cu: CodingUnit) -> bool:
        return False

    def merge_idx(self, cu: CodingUnit, n_cands: int) -> int:
        return 0

    def inter_dir(self, cu: CodingUnit) -> int:
        return 1  # 1 L0, 2 L1, 3 bi

    def ref_idx(self, cu: CodingUnit, lst: int, num_ref: int) -> int:
        return 0

    def mvd(self, cu: CodingUnit, lst: int) -> list[int]:
        return [0, 0]

    def mvp_idx(self, cu: CodingUnit, lst: int) -> int:
        return 0

    def root_cbf(self, cu: CodingUnit) -> bool:
        return False

    def mode_cons_intra(self, node: PartNode) -> bool:
        return True

    def ibc(self, cu: CodingUnit, coder) -> bool:
        return False

    def ibc_skip(self, cu: CodingUnit, coder) -> bool:
        return False

    def ibc_merge_idx(self, cu: CodingUnit, coder) -> int:
        return 0

    def affine(self, cu: CodingUnit) -> bool:
        return False

    def affine_type(self, cu: CodingUnit) -> int:
        return 0

    def subblock_merge(self, cu: CodingUnit) -> bool:
        return False

    def affine_imv(self, cu: CodingUnit) -> int:
        return 0

    def smvd(self, cu: CodingUnit) -> bool:
        return False

    def mmvd(self, cu: CodingUnit) -> bool:
        return False

    def mmvd_idx(self, cu: CodingUnit) -> tuple[int, int, int]:
        """(base 0-1, step 0-7, direction 0-3)."""
        return 0, 0, 0

    def imv(self, cu: CodingUnit) -> int:
        return 0

    def bcw_idx(self, cu: CodingUnit) -> int:
        """Parsing-order index 0..numBcw-1 (0 = equal weights)."""
        return 0

    def ciip(self, cu: CodingUnit) -> bool:
        return False

    def geo(self, cu: CodingUnit) -> tuple[int, int, int]:
        """(split_dir 0..63, cand0, cand1) with cand0 != cand1."""
        return 0, 0, 1

    def regular_merge(self, cu: CodingUnit, ciip_ok: bool) -> bool:
        return True

    def sbt(self, cu: CodingUnit) -> tuple[int, int]:
        """(sbt_idx 0=off/1=ver-half/2=hor-half/3=ver-quad/4=hor-quad,
        pos 0/1)."""
        return 0, 0


class CtuDecoder:
    """Parses (or writes) the slice data of one slice."""

    def __init__(self, cs: CodingStructure, dec: CabacDecoder | None = None,
                 enc: CabacEncoder | None = None,
                 decisions: Decisions | None = None, slice_idx: int = 0):
        assert (dec is None) != (enc is None)
        self.cs = cs
        self._slice_idx_arg = slice_idx
        self.dec = dec
        self.enc = enc
        self.decisions = decisions
        sps, pps, ph, sh = cs.sps, cs.pps, cs.ph, cs.sh
        self.sps, self.pps, self.ph, self.sh = sps, pps, ph, sh
        self.is_intra_slice = sh.is_intra
        self.dual_tree = sh.is_intra and sps.dual_tree_intra
        # encode-mode IBC candidate state (BV field lives in cs.mi_mv)
        if enc is not None:
            from refdec.frame.inter_np import MotionHist
            self.enc_hist = MotionHist()
            self._enc_hist_row = -1
        self.constraints = {}
        for ch in (0, 1):
            if sh.is_intra:
                val_idx = (ch << 1) if self.dual_tree else 0
            else:
                val_idx = 1
            self.constraints[ch] = SplitConstraints(
                min_qt_size=ph.min_qt_size[val_idx],
                max_bt_depth=ph.max_mtt_depth[val_idx],
                max_bt_size=ph.max_bt_size[val_idx],
                max_tt_size=ph.max_tt_size[val_idx],
                min_bt_size=1 << sps.log2_min_cb_size,
                min_tt_size=1 << sps.log2_min_cb_size,
                max_tr_size=1 << sps.log2_max_tb_size,
                min_cb_size=1 << sps.log2_min_cb_size,
            )
        # slice-level reference derivations needed during parsing
        # (DecLibParser.cpp:820 checkLDC / :851 SMVD sym refs)
        if not sh.is_intra:
            cs.ref_pocs = [
                [sh.poc + e.value for e in sh.rpl[lst].entries]
                if sh.rpl[lst] is not None else []
                for lst in range(2)]
            cs.check_ldc = all(
                p <= sh.poc
                for lst in range(2)
                for p in cs.ref_pocs[lst][: sh.num_ref_idx_active[lst]])
        else:
            cs.ref_pocs = [[], []]
            cs.check_ldc = False
        cs.bi_dir_pred = False
        cs.sym_ref_idx = [-1, -1]
        if sps.smvd_enabled and sh.is_b and not cs.check_ldc \
                and not ph.mvd_l1_zero:
            fwd = bwd = sh.poc
            r0 = r1 = -1
            for ref in range(sh.num_ref_idx_active[0]):
                p = cs.ref_pocs[0][ref]
                if p < sh.poc and (p > fwd or r0 == -1):
                    fwd, r0 = p, ref
            for ref in range(sh.num_ref_idx_active[1]):
                p = cs.ref_pocs[1][ref]
                if p > sh.poc and (p < bwd or r1 == -1):
                    bwd, r1 = p, ref
            if not (fwd < sh.poc and bwd > sh.poc):
                fwd = bwd = sh.poc
                r0 = r1 = -1
                for ref in range(sh.num_ref_idx_active[0]):
                    p = cs.ref_pocs[0][ref]
                    if p > sh.poc and (p < bwd or r0 == -1):
                        bwd, r0 = p, ref
                for ref in range(sh.num_ref_idx_active[1]):
                    p = cs.ref_pocs[1][ref]
                    if p < sh.poc and (p > fwd or r1 == -1):
                        fwd, r1 = p, ref
            if fwd < sh.poc and bwd > sh.poc:
                cs.bi_dir_pred = True
                cs.sym_ref_idx = [r0, r1]
        self.qps = [sh.qp_y, sh.qp_y]
        self.max_log2_tr_range = 15
        self.qg_start = False
        self.is_dqp_coded = False
        self.is_chroma_qp_adj_coded = False
        self.violates_lfnst = [False, False]
        self.lfnst_last_scan_pos = False
        self.violates_mts = False
        self.mts_last_scan_pos = False
        self._tpl = np.zeros(64 * 64, dtype=np.int32)
        self.slice_idx = self._slice_idx_arg
        self.cu_qp_delta_subdiv = (ph.cu_qp_delta_subdiv_intra if sh.is_intra
                                   else ph.cu_qp_delta_subdiv_inter)
        self.cu_chroma_qp_offset_subdiv = (
            ph.cu_chroma_qp_offset_subdiv_intra if sh.is_intra
            else ph.cu_chroma_qp_offset_subdiv_inter)

    # -- bin IO wrappers (single code path for decode and encode) ---------
    def _bin(self, ctx_id: int, want: int | None = None) -> int:
        if self.enc is None:
            return self.dec.decode_bin(ctx_id)
        self.enc.encode_bin(int(want), ctx_id)
        return int(want)

    def _ep(self, want: int | None = None) -> int:
        if self.enc is None:
            return self.dec.decode_bin_ep()
        self.enc.encode_bin_ep(int(want))
        return int(want)

    def _eps(self, n: int, want: int | None = None) -> int:
        if n == 0:
            return 0
        if self.enc is None:
            return self.dec.decode_bins_ep(n)
        self.enc.encode_bins_ep(int(want), n)
        return int(want)

    def _rem(self, rice: int, cutoff: int, maxlog2: int,
             want: int | None = None) -> int:
        if self.enc is None:
            return self.dec.decode_rem_abs_ep(rice, cutoff, maxlog2)
        self.enc.encode_rem_abs_ep(int(want), rice, cutoff, maxlog2)
        return int(want)

    def _trm(self, want: int | None = None) -> int:
        if self.enc is None:
            return self.dec.decode_bin_trm()
        self.enc.encode_bin_trm(int(want))
        return int(want)

    # ==================================================================
    # slice / CTU level
    # ==================================================================
    def code_slice(self) -> None:
        """Parse/write all CTUs of the slice with tile / WPP substreams.

        Substream boundaries get a terminating bit + byte realignment;
        tiles re-init the contexts, WPP rows sync from the state stored
        after the first CTU of the row above (parity: DecSlice::parseSlice,
        DecSlice.cpp:66-205)."""
        sps, pps = self.sps, self.pps
        ctu_size = sps.ctu_size
        w_ctu = pps.pic_width_in_ctu
        ctu_addrs = self.cs.sh.ctu_addrs
        wavefronts = sps.entropy_coding_sync_enabled
        sh = self.cs.sh

        def tile_of(addr):
            x, y = addr % w_ctu, addr // w_ctu
            return (pps.ctu_to_tile_col[x], pps.ctu_to_tile_row[y])

        def sub_of(addr):
            t = tile_of(addr)
            return (t, addr // w_ctu) if wavefronts else (t,)

        # decode-mode substream entry points (absolute byte offsets).
        # Signalled offsets count emulation prevention bytes; convert to
        # RBSP sizes (HLSyntaxReader.cpp:4033-4066).
        sub_start = None
        if self.dec is not None and len(ctu_addrs) > 1:
            n_subs = len({sub_of(a) for a in ctu_addrs})
            if n_subs > 1:
                assert len(sh.entry_point_offsets) == n_subs - 1, \
                    "tile/WPP decoding requires signalled entry points"
                base = sh.data_offset_bits // 8
                data = self.dec.data
                zeros = 0
                for b in data[:base]:
                    if zeros >= 2 and b <= 3:
                        zeros = 0
                    zeros = zeros + 1 if b == 0 else 0
                sub_start = [base]
                pos = base
                for target in sh.entry_point_offsets:
                    cnt = 0
                    while cnt < target:
                        b = data[pos]
                        if zeros >= 2 and b <= 3:
                            cnt += 1  # an emulation byte precedes this one
                            zeros = 0
                            if cnt == target:
                                break
                        cnt += 1
                        pos += 1
                        zeros = zeros + 1 if b == 0 else 0
                    sub_start.append(pos)
        if self.enc is not None:
            self.enc_substreams = []
        self._wpp_ctx: dict = {}
        sub_idx = 0

        # native C syntax walk (decode mode): same per-CTU loop, the tree /
        # CU / TU / residual syntax runs in native/walk*.c
        walk = None
        if self.dec is not None:
            from refdec.cabac.native_walk import SliceWalk, native_walk_ok
            if native_walk_ok(self):
                walk = SliceWalk(self)
        try:
            self._code_slice_ctus(ctu_addrs, sub_start, sub_of, tile_of,
                                  wavefronts, sh, walk)
        finally:
            if walk is not None:
                walk.finish()
        if self.dec is not None and not self.dec.finish_ok():
            raise ValueError("CABAC stop pattern check failed at end of slice")
        if self.enc is not None:
            self._flush_substream()

    def _code_slice_ctus(self, ctu_addrs, sub_start, sub_of, tile_of,
                         wavefronts, sh, walk) -> None:
        if walk is not None and self.enc is None:
            self._code_slice_ctus_walk(ctu_addrs, sub_start, sub_of,
                                       tile_of, wavefronts, sh, walk)
            return
        pps = self.pps
        ctu_size = self.sps.ctu_size
        w_ctu = pps.pic_width_in_ctu
        sub_idx = 0
        for i, addr in enumerate(ctu_addrs):
            cx = (addr % w_ctu) * ctu_size
            cy = (addr // w_ctu) * ctu_size
            if i > 0 and sub_of(addr) != sub_of(ctu_addrs[i - 1]):
                sub_idx += 1
                new_tile = tile_of(addr) != tile_of(ctu_addrs[i - 1])
                if self.enc is not None:
                    self._flush_substream()
                else:
                    self.dec.restart(sub_start[sub_idx],
                                     sub_start[sub_idx + 1]
                                     if sub_idx + 1 < len(sub_start)
                                     else None)
                ctx_state = self.enc.ctx if self.enc is not None \
                    else self.dec.ctx
                if new_tile:
                    ctx_state.init(sh.qp_y, sh.slice_type)
                else:
                    # WPP: sync from the stored state of the row above
                    key = (tile_of(addr), addr // w_ctu - 1)
                    saved = self._wpp_ctx.get(key)
                    if saved is not None:
                        restored = saved.copy()
                        if self.enc is not None:
                            self.enc.ctx = restored
                        else:
                            self.dec.ctx = restored
                    else:
                        ctx_state.init(sh.qp_y, sh.slice_type)
                # QP predictor restarts per tile / WPP row
                self.qps = [sh.qp_y, sh.qp_y]
                if walk is not None:
                    walk.reset_qp()
            if self.enc is not None \
                    and (addr // w_ctu, tile_of(addr)[0]) != self._enc_hist_row:
                # encode-mode IBC candidate state resets per CTU row/tile
                self._enc_hist_row = (addr // w_ctu, tile_of(addr)[0])
                self.enc_hist.reset()
            if walk is not None:
                walk.ctu(cx, cy)
            else:
                self.coding_tree_unit(cx, cy)
            if wavefronts:
                t = tile_of(addr)
                row = addr // w_ctu
                first_in_row = i == 0 or sub_of(ctu_addrs[i - 1]) != sub_of(addr)
                if first_in_row:
                    ctx_state = self.enc.ctx if self.enc is not None \
                        else self.dec.ctx
                    self._wpp_ctx[(t, row)] = ctx_state.copy()
            last = i == len(ctu_addrs) - 1
            if last or sub_of(ctu_addrs[i + 1]) != sub_of(addr):
                trm = self._trm(want=1)
                if not trm:
                    raise ValueError(f"expected terminating bit after CTU {addr}")

    def _code_slice_ctus_walk(self, ctu_addrs, sub_start, sub_of, tile_of,
                              wavefronts, sh, walk) -> None:
        """Decode-mode CTU loop over the native walk: per substream, walk
        the first CTU (then snapshot the WPP context), then batch the rest
        through one C call holding a single GIL release — behaviorally
        identical to the generic loop above."""
        pps = self.pps
        ctu_size = self.sps.ctu_size
        w_ctu = pps.pic_width_in_ctu
        # substream segments [a, b)
        segs = []
        start = 0
        for i in range(1, len(ctu_addrs)):
            if sub_of(ctu_addrs[i]) != sub_of(ctu_addrs[i - 1]):
                segs.append((start, i))
                start = i
        segs.append((start, len(ctu_addrs)))
        for sub_idx, (a, b) in enumerate(segs):
            addr0 = ctu_addrs[a]
            if sub_idx > 0:
                new_tile = tile_of(addr0) != tile_of(ctu_addrs[a - 1])
                self.dec.restart(sub_start[sub_idx],
                                 sub_start[sub_idx + 1]
                                 if sub_idx + 1 < len(sub_start) else None)
                if new_tile:
                    self.dec.ctx.init(sh.qp_y, sh.slice_type)
                else:
                    key = (tile_of(addr0), addr0 // w_ctu - 1)
                    saved = self._wpp_ctx.get(key)
                    if saved is not None:
                        self.dec.ctx = saved.copy()
                    else:
                        self.dec.ctx.init(sh.qp_y, sh.slice_type)
                self.qps = [sh.qp_y, sh.qp_y]
                walk.reset_qp()
            walk.ctu((addr0 % w_ctu) * ctu_size,
                     (addr0 // w_ctu) * ctu_size)
            if wavefronts:
                self._wpp_ctx[(tile_of(addr0), addr0 // w_ctu)] = \
                    self.dec.ctx.copy()
            rest = ctu_addrs[a + 1: b]
            if len(rest):
                arr = np.asarray(rest, dtype=np.int32)
                xy = np.empty((len(arr), 2), dtype=np.int32)
                xy[:, 0] = (arr % w_ctu) * ctu_size
                xy[:, 1] = (arr // w_ctu) * ctu_size
                walk.ctu_run(xy)
            trm = self._trm(want=1)
            if not trm:
                raise ValueError(
                    f"expected terminating bit after CTU {ctu_addrs[b - 1]}")

    def _flush_substream(self) -> None:
        """Finish the current encoder substream: arithmetic flush + stop
        bit + byte alignment (end_of_subset termination)."""
        body = self.enc.finish()
        tv, tn = self.enc.tail_bits
        acc = (tv << 1) | 1
        nbits = tn + 1
        pad = (-nbits) % 8
        acc <<= pad
        nbits += pad
        self.enc_substreams.append(bytes(body)
                                   + acc.to_bytes(nbits // 8, "big"))
        self.enc.restart_substream()

    decode_slice = code_slice

    def coding_tree_unit(self, cx: int, cy: int) -> None:
        sps = self.sps
        area = Area(cx, cy, sps.ctu_size, sps.ctu_size)

        if self.sh.sao_enabled_luma or self.sh.sao_enabled_chroma:
            self.sao_ctu(cx, cy)
        if any(self.sh.alf_enabled) or self.sh.ccalf_cb_enabled or self.sh.ccalf_cr_enabled:
            self.alf_ctu(cx, cy)

        node = PartNode(area=area, ch_type=0, tree_type=TREE_D,
                        mode_type=MODE_TYPE_ALL)
        if self.dual_tree and sps.chroma_format_idc != 0:
            node_c = PartNode(area=area, ch_type=1, tree_type=TREE_D,
                              mode_type=MODE_TYPE_ALL)
            self._dt_implicit_qt_split(node, node_c)
        else:
            self.coding_tree(node)

    def _dt_implicit_qt_split(self, node_l: PartNode, node_c: PartNode) -> None:
        if node_l.area.w > 64:
            if self.pps.cu_qp_delta_enabled:
                self.qg_start = True
                self.is_dqp_coded = False
            subs_l = split_areas(node_l.area, CU_QUAD_SPLIT)
            subs_c = split_areas(node_c.area, CU_QUAD_SPLIT)
            for i, (al, ac) in enumerate(zip(subs_l, subs_c)):
                if al.x < self.cs.w and al.y < self.cs.h:
                    self._dt_implicit_qt_split(
                        node_l.child(al, CU_QUAD_SPLIT, i, 4),
                        node_c.child(ac, CU_QUAD_SPLIT, i, 4))
            return
        self.coding_tree(node_l)
        self.coding_tree(node_c)

    # ==================================================================
    # coding tree
    # ==================================================================
    def coding_tree(self, node: PartNode) -> None:
        pps = self.pps
        mode_type_parent = node.mode_type

        if pps.cu_qp_delta_enabled and self._qg_enable(node) and node.ch_type == 0:
            self.qg_start = True
            self.is_dqp_coded = False
        if self.sh.cu_chroma_qp_offset_enabled and self._qg_chroma_enable(node):
            self.is_chroma_qp_adj_coded = False
            self.cs.chroma_qp_adj = 0

        split = self.split_cu_mode(node)

        if split != CU_DONT_SPLIT:
            child_mode_type = self.mode_constraint(node, split)
            chroma_not_split = (mode_type_parent == MODE_TYPE_ALL
                                and child_mode_type == MODE_TYPE_INTRA)
            tree_type = node.tree_type
            if tree_type == TREE_D:
                tree_type = TREE_L if chroma_not_split else TREE_D

            implicit = not (node.area.x + node.area.w <= self.cs.w
                            and node.area.y + node.area.h <= self.cs.h)
            subs = split_areas(node.area, split)
            for i, sub in enumerate(subs):
                if sub.x < self.cs.w and sub.y < self.cs.h:
                    child = node.child(sub, split, i, len(subs))
                    child.mode_type = child_mode_type
                    child.tree_type = tree_type
                    if implicit and split in (CU_HORZ_SPLIT, CU_VERT_SPLIT):
                        child.impl_bt_depth = node.impl_bt_depth + 1
                    self.coding_tree(child)

            if chroma_not_split:
                cnode = PartNode(
                    area=node.area, ch_type=1, tree_type=TREE_C,
                    mode_type=child_mode_type, qt_depth=node.qt_depth,
                    mt_depth=node.mt_depth, impl_bt_depth=node.impl_bt_depth,
                    depth=node.depth, subdiv=node.subdiv,
                    last_split=node.last_split, part_idx=node.part_idx)
                self.coding_tree(cnode)
            return

        self.code_cu(node)

    def _qg_enable(self, node: PartNode) -> bool:
        return node.subdiv <= self.cu_qp_delta_subdiv

    def _qg_chroma_enable(self, node: PartNode) -> bool:
        return node.subdiv <= self.cu_chroma_qp_offset_subdiv

    def _neighbors(self, node: PartNode):
        ch = 1 if node.tree_type == TREE_C else node.ch_type
        if ch == 1:
            x = node.area.x // self.cs.sub_w
            y = node.area.y // self.cs.sub_h
        else:
            x, y = node.area.x, node.area.y
        left = self._cu_query(x - 1, y, ch, node)
        above = self._cu_query(x, y - 1, ch, node)
        return left, above

    def _cu_query(self, x, y, ch, node):
        cu = self.cs.cu_at(x, y, ch)
        if cu is None:
            return None
        if cu.slice_idx != self.slice_idx:
            return None
        if not self.pps.no_pic_partition:
            lx = x * (self.cs.sub_w if ch else 1)
            ly = y * (self.cs.sub_h if ch else 1)
            if self._tile_at(lx, ly) != self._tile_at(node.area.x, node.area.y):
                return None
        return cu

    def _tile_at(self, x, y):
        if self.pps.no_pic_partition:
            return 0
        return int(self.cs.tile_map[min(y >> 2, self.cs.tile_map.shape[0] - 1),
                                    min(x >> 2, self.cs.tile_map.shape[1] - 1)])

    def split_cu_mode(self, node: PartNode) -> int:
        allowed = can_split(node, self.constraints[node.ch_type],
                            self.cs.w, self.cs.h, self.dual_tree,
                            self.cs.sub_w, self.cs.sub_h)
        can_no = allowed[CU_DONT_SPLIT]
        can_qt = allowed[CU_QUAD_SPLIT]
        can_bh, can_bv = allowed[CU_HORZ_SPLIT], allowed[CU_VERT_SPLIT]
        can_th, can_tv = allowed[CU_TRIH_SPLIT], allowed[CU_TRIV_SPLIT]

        target = None
        if self.enc is not None:
            target = self.decisions.split(node, allowed)
            assert allowed.get(target, False) or (target == CU_DONT_SPLIT and can_no), \
                (target, allowed, node)

        num_hor = can_bh + can_th
        num_ver = can_bv + can_tv
        num_split = (can_qt << 1) + num_hor + num_ver
        is_split = bool(num_split)
        if can_no and not is_split:
            return CU_DONT_SPLIT

        cu_left, cu_above = self._neighbors(node)
        ch = 1 if node.tree_type == TREE_C else node.ch_type
        wc = node.area.w // (self.cs.sub_w if ch else 1)
        hc = node.area.h // (self.cs.sub_h if ch else 1)

        def nb_dim(cu, dim):
            if cu is None:
                return 0
            if ch == 1:
                return cu.cw if dim == "w" else cu.ch
            return cu.w if dim == "w" else cu.h

        if can_no and is_split:
            ctx_split = int(bool(cu_left) and nb_dim(cu_left, "h") < hc)
            ctx_split += int(bool(cu_above) and nb_dim(cu_above, "w") < wc)
            ctx_split += (0, 0, 0, 3, 3, 6, 6)[num_split]
            is_split = bool(self._bin(ctx("SplitFlag", ctx_split),
                                      want=None if target is None
                                      else int(target != CU_DONT_SPLIT)))
        if not is_split:
            return CU_DONT_SPLIT

        can_btt = bool(num_hor) or bool(num_ver)
        is_qt = can_qt
        if is_qt and can_btt:
            ctx_qt = int(bool(cu_left) and cu_left.qt_depth > node.qt_depth)
            ctx_qt += int(bool(cu_above) and cu_above.qt_depth > node.qt_depth)
            ctx_qt += 0 if node.qt_depth < 2 else 3
            is_qt = bool(self._bin(ctx("SplitQtFlag", ctx_qt),
                                   want=None if target is None
                                   else int(target == CU_QUAD_SPLIT)))
        if is_qt:
            return CU_QUAD_SPLIT

        can_hor = bool(num_hor)
        is_ver = bool(num_ver)
        if is_ver and can_hor:
            ctx_hv = 0
            if num_ver == num_hor:
                if cu_left and cu_above:
                    w_above = nb_dim(cu_above, "w")
                    h_left = nb_dim(cu_left, "h")
                    dep_above = wc >> (w_above.bit_length() - 1)
                    dep_left = hc >> (h_left.bit_length() - 1)
                    ctx_hv = 0 if dep_above == dep_left else (
                        1 if dep_above < dep_left else 2)
            elif num_ver < num_hor:
                ctx_hv = 3
            else:
                ctx_hv = 4
            is_ver = bool(self._bin(ctx("SplitHvFlag", ctx_hv),
                                    want=None if target is None
                                    else int(target in (CU_VERT_SPLIT, CU_TRIV_SPLIT))))

        can14 = can_tv if is_ver else can_th
        is12 = can_bv if is_ver else can_bh
        if is12 and can14:
            ctx_12 = int(node.mt_depth <= 1) + (2 if is_ver else 0)
            is12 = bool(self._bin(ctx("Split12Flag", ctx_12),
                                  want=None if target is None
                                  else int(target in (CU_VERT_SPLIT, CU_HORZ_SPLIT))))

        if is_ver:
            return CU_VERT_SPLIT if is12 else CU_TRIV_SPLIT
        return CU_HORZ_SPLIT if is12 else CU_TRIH_SPLIT

    def mode_constraint(self, node: PartNode, split: int) -> int:
        from refdec.hls.params import CHROMA_400, CHROMA_444
        sps = self.sps
        if (self.dual_tree or node.mode_type != MODE_TYPE_ALL
                or sps.chroma_format_idc in (CHROMA_400, CHROMA_444)):
            return node.mode_type
        min_luma_area = node.area.w * node.area.h
        if split in (CU_QUAD_SPLIT, CU_TRIH_SPLIT, CU_TRIV_SPLIT):
            min_luma_area >>= 2
        elif split in (CU_VERT_SPLIT, CU_HORZ_SPLIT):
            min_luma_area >>= 1
        min_chroma_blk = min_luma_area >> (
            (self.cs.sub_w - 1) + (self.cs.sub_h - 1))
        cw = node.area.w // self.cs.sub_w
        is_2xn_chroma = (cw == 4 and split == CU_VERT_SPLIT) or \
                        (cw == 8 and split == CU_TRIV_SPLIT)
        if min_chroma_blk >= 16 and not is_2xn_chroma:
            return node.mode_type
        if min_luma_area < 32 or self.is_intra_slice:
            return MODE_TYPE_INTRA
        cu_left, cu_above = self._neighbors(node)
        ctx_id = 1 if ((cu_above and cu_above.pred_mode == MODE_INTRA)
                       or (cu_left and cu_left.pred_mode == MODE_INTRA)) else 0
        want = None
        if self.enc is not None:
            want = int(self.decisions.mode_cons_intra(node))
        flag = self._bin(ctx("ModeConsFlag", ctx_id), want=want)
        return MODE_TYPE_INTRA if flag else MODE_TYPE_INTER


    # ==================================================================
    # inter prediction syntax (minimal toolset: no IBC/affine/MMVD/GPM/
    # CIIP/SMVD/AMVR/BCW/SBT; gated by SPS flags)
    # ==================================================================
    def _skip_ctx(self, cu: CodingUnit) -> int:
        """DeriveCtx::CtxSkipFlag (ContextModelling.cpp:255)."""
        cs = self.cs
        left = cs.cu_at_restricted(cu.x - 1, cu.y, cu, 0)
        above = cs.cu_at_restricted(cu.x, cu.y - 1, cu, 0)
        return int(bool(left and left.skip)) + int(bool(above and above.skip))

    def prediction_unit(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::prediction_unit (CABACReader.cpp:1568)."""
        if cu.skip:
            cu.merge_flag = True
        else:
            want = None
            if self.enc is not None:
                want = int(self.decisions.merge_flag(cu))
            cu.merge_flag = bool(self._bin(ctx("MergeFlag"), want=want))
        cu.mv = [[0, 0], [0, 0]]
        cu.mvd = [[0, 0], [0, 0]]
        cu.mvd_aff = [[[0, 0], [0, 0]], [[0, 0], [0, 0]]]
        cu.ref_idx = [-1, -1]
        cu.mvp_idx = [0, 0]
        if cu.merge_flag:
            self.merge_data(cu)
            return
        if cu.pred_mode == MODE_IBC:
            # IBC AMVP: BV difference + predictor flag (CABACReader.cpp:1583)
            cu.inter_dir = 1
            cu.mvd[0] = self.mvd_coding(cu, 0)
            if self.sps.max_num_ibc_merge_cand == 1:
                cu.mvp_idx[0] = 0
            else:
                cu.mvp_idx[0] = self.mvp_flag(cu, 0)
            return
        self.inter_pred_idc(cu)
        self.affine_flag(cu)
        self.smvd_mode(cu)
        if cu.inter_dir != 2:
            if cu.smvd_mode:
                cu.ref_idx[0] = self.cs.sym_ref_idx[0]
            else:
                cu.ref_idx[0] = self.ref_idx(cu, 0)
            cu.mvd[0] = self.mvd_coding(cu, 0)
            if cu.affine_flag:
                cu.mvd_aff[0][0] = self.mvd_coding(cu, 0)
                if cu.affine_type == 1:
                    cu.mvd_aff[0][1] = self.mvd_coding(cu, 0)
            cu.mvp_idx[0] = self.mvp_flag(cu, 0)
        if cu.inter_dir != 1:
            if cu.smvd_mode != 1:
                cu.ref_idx[1] = self.ref_idx(cu, 1)
                if self.ph.mvd_l1_zero and cu.inter_dir == 3:
                    cu.mvd[1] = [0, 0]
                else:
                    cu.mvd[1] = self.mvd_coding(cu, 1)
                    if cu.affine_flag:
                        cu.mvd_aff[1][0] = self.mvd_coding(cu, 1)
                        if cu.affine_type == 1:
                            cu.mvd_aff[1][1] = self.mvd_coding(cu, 1)
            cu.mvp_idx[1] = self.mvp_flag(cu, 1)
        if cu.smvd_mode:
            cu.ref_idx[1] = self.cs.sym_ref_idx[1]
            cu.mvd[1] = [-cu.mvd[0][0], -cu.mvd[0][1]]

    def _affine_ctx(self, cu: CodingUnit) -> int:
        """DeriveCtx::CtxAffineFlag (ContextModelling.cpp:243)."""
        cs = self.cs
        left = cs.cu_at_restricted(cu.x - 1, cu.y, cu, 0)
        above = cs.cu_at_restricted(cu.x, cu.y - 1, cu, 0)
        return int(bool(left and left.affine_flag)) + \
            int(bool(above and above.affine_flag))

    def affine_flag(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::affine_flag (CABACReader.cpp:1694)."""
        if not (self.sps.affine_enabled and cu.w >= 16 and cu.h >= 16):
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.affine(cu))
        cu.affine_flag = bool(self._bin(ctx("AffineFlag",
                                            self._affine_ctx(cu)), want=want))
        if cu.affine_flag and self.sps.affine_6param:
            want = None
            if self.enc is not None:
                want = int(self.decisions.affine_type(cu))
            cu.affine_type = self._bin(ctx("AffineType"), want=want)

    def subblock_merge_flag(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::subblock_merge_flag (CABACReader.cpp:1681)."""
        if self.sh.is_intra or self.ph.max_num_affine_merge_cand <= 0 \
                or cu.w < 8 or cu.h < 8:
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.subblock_merge(cu))
        cu.affine_flag = bool(self._bin(ctx("SubblockMergeFlag",
                                            self._affine_ctx(cu)), want=want))

    def affine_merge_idx(self, cu: CodingUnit) -> None:
        """merge_idx affine path (CABACReader.cpp:1855)."""
        n_minus1 = self.ph.max_num_affine_merge_cand - 1
        want = None
        if self.enc is not None:
            want = min(self.decisions.merge_idx(cu, n_minus1 + 1), n_minus1)
        idx = 0
        if n_minus1 > 0 and self._bin(ctx("AffMergeIdx"),
                                      want=None if want is None
                                      else int(want > 0)):
            idx = 1
            while idx < n_minus1 and self._ep(want=None if want is None
                                              else int(want > idx)):
                idx += 1
        cu.merge_idx = idx

    def smvd_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::smvd_mode (CABACReader.cpp:1662)."""
        cu.smvd_mode = 0
        if cu.inter_dir != 3 or cu.affine_flag or not self.sps.smvd_enabled \
                or self.ph.mvd_l1_zero:
            return
        if not self.cs.bi_dir_pred:
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.smvd(cu))
        cu.smvd_mode = self._bin(ctx("SmvdFlag"), want=want)

    def merge_data(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::merge_data (CABACReader.cpp:1732)."""
        if cu.pred_mode == MODE_IBC:
            self.ibc_merge_idx(cu)
            return
        self.subblock_merge_flag(cu)
        if cu.affine_flag:
            self.affine_merge_idx(cu)
            return
        ciip_ok = (self.sps.ciip_enabled and not cu.skip and cu.w < 128
                   and cu.h < 128 and cu.w * cu.h >= 64)
        geo_ok = (self.sps.gpm_enabled and self.sh.is_b
                  and 8 <= cu.w <= 64 and 8 <= cu.h <= 64
                  and cu.w < 8 * cu.h and cu.h < 8 * cu.w)
        regular = True
        kind = "regular"
        if geo_ok or ciip_ok:
            if self.enc is not None:
                kind = self.decisions.merge_kind(cu, ciip_ok, geo_ok)
            regular = bool(self._bin(ctx("RegularMergeFlag",
                                         0 if cu.skip else 1),
                                     want=None if self.enc is None
                                     else int(kind == "regular")))
        if not regular:
            if geo_ok and ciip_ok:
                cu.ciip_flag = bool(self._bin(ctx("CiipFlag"),
                                              want=None if self.enc is None
                                              else int(kind == "ciip")))
            elif ciip_ok:
                cu.ciip_flag = True
            if cu.ciip_flag:
                cu.intra_dir = [PLANAR_IDX, DM_CHROMA_IDX]
                self.merge_idx(cu)
                return
            cu.geo_flag = True
            self.geo_merge_idx(cu)
            return
        if self.sps.mmvd_enabled:
            want = None
            if self.enc is not None:
                want = int(self.decisions.mmvd(cu))
            cu.mmvd_flag = bool(self._bin(ctx("MmvdFlag", 0), want=want))
        if cu.mmvd_flag:
            self.mmvd_merge_idx(cu)
        else:
            self.merge_idx(cu)

    def mmvd_merge_idx(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::mmvd_merge_idx (CABACReader.cpp:1846)."""
        want = None
        if self.enc is not None:
            want = self.decisions.mmvd_idx(cu)  # (base, step, pos)
        n_base = 1 if self.sps.max_num_merge_cand > 1 else 0
        var0 = 0
        if n_base > 0 and self._bin(ctx("MmvdMergeIdx"),
                                    want=None if want is None
                                    else int(want[0] > 0)):
            var0 = 1
        var1 = 0
        if self._bin(ctx("MmvdStepMvpIdx"),
                     want=None if want is None else int(want[1] > 0)):
            var1 = 1
            while var1 < 7 and self._ep(want=None if want is None
                                        else int(want[1] > var1)):
                var1 += 1
        var2 = 0
        if self._ep(want=None if want is None else (want[2] >> 1) & 1):
            var2 += 2
        if self._ep(want=None if want is None else want[2] & 1):
            var2 += 1
        cu.mmvd_idx = var0 * 32 + var1 * 4 + var2

    def geo_merge_idx(self, cu: CodingUnit) -> None:
        """GPM split dir + two uni candidate indices (merge_idx geo path,
        CABACReader.cpp:1808)."""
        want = None
        if self.enc is not None:
            want = self.decisions.geo(cu)  # (split_dir, cand0, cand1)
        cu.geo_split_dir = self.trunc_bin(
            64, want=None if want is None else want[0])
        n_minus2 = self.sps.max_num_gpm_cand - 2
        cand0 = 0
        if self._bin(ctx("MergeIdx"),
                     want=None if want is None else int(want[1] > 0)):
            cand0 = self.unary_max_eqprob(
                n_minus2, want=None if want is None else want[1] - 1) + 1
        cand1 = 0
        if n_minus2 > 0:
            w1 = None
            if want is not None:
                w1 = want[2] - (want[2] > cand0)
            if self._bin(ctx("MergeIdx"),
                         want=None if w1 is None else int(w1 > 0)):
                cand1 = self.unary_max_eqprob(
                    n_minus2 - 1, want=None if w1 is None else w1 - 1) + 1
        cand1 += int(cand1 >= cand0)
        cu.geo_idx = [cand0, cand1]

    def ibc_merge_idx(self, cu: CodingUnit) -> None:
        """merge_idx IBC path (CABACReader.cpp:1851)."""
        n_minus1 = self.sps.max_num_ibc_merge_cand - 1
        want = None
        if self.enc is not None:
            want = min(self.decisions.ibc_merge_idx(cu, self), n_minus1)
        idx = 0
        if n_minus1 > 0 and self._bin(ctx("MergeIdx"),
                                      want=None if want is None
                                      else int(want > 0)):
            idx = 1
            while idx < n_minus1 and self._ep(want=None if want is None
                                              else int(want > idx)):
                idx += 1
        cu.merge_idx = idx

    # ---- encode-mode IBC helpers: BV validity + candidate state ----
    def ibc_bv_valid(self, cu: CodingUnit, bvx: int, bvy: int) -> bool:
        """A BV (integer pel) is encoder-safe when the whole reference
        block lies in the already-coded part of the current CTU."""
        if bvx == 0 and bvy == 0:
            return False
        cs = self.cs
        ctu = self.sps.ctu_size
        rx, ry = cu.x + bvx, cu.y + bvy
        if rx < 0 or ry < 0 or rx + cu.w > cs.w or ry + cu.h > cs.h:
            return False
        # stay within the current CTU (deterministic virtual-buffer content)
        if rx < (cu.x // ctu) * ctu or rx + cu.w > (cu.x // ctu + 1) * ctu:
            return False
        if ry < (cu.y // ctu) * ctu or ry + cu.h > (cu.y // ctu + 1) * ctu:
            return False
        cur_idx = cu.idx if cu.idx >= 0 else len(cs.cus)
        for y4 in range(ry >> 2, (ry + cu.h) >> 2):
            for x4 in range(rx >> 2, (rx + cu.w) >> 2):
                idx = int(cs.cu_map[y4, x4])
                if idx < 0 or idx >= cur_idx:
                    return False
        return True

    def _with_cu_idx(self, cu, fn):
        """Run fn with a provisional cu.idx (candidate derivation happens
        before add_cu during encode-time planning)."""
        tmp = cu.idx
        if tmp < 0:
            cu.idx = len(self.cs.cus)
        try:
            return fn()
        finally:
            cu.idx = tmp

    def ibc_valid_merge_indices(self, cu: CodingUnit) -> list[int]:
        from refdec.frame import inter_np as I
        cands = self._with_cu_idx(
            cu, lambda: I.derive_ibc_merge(self.cs, cu, self.enc_hist))
        return [i for i, bv in enumerate(cands)
                if self.ibc_bv_valid(cu, bv[0] >> 4, bv[1] >> 4)]

    def ibc_merge_bv(self, cu: CodingUnit, idx: int) -> tuple:
        from refdec.frame import inter_np as I
        return self._with_cu_idx(
            cu, lambda: I.derive_ibc_merge(self.cs, cu, self.enc_hist))[idx]

    def ibc_mvp(self, cu: CodingUnit) -> list[tuple]:
        from refdec.frame import inter_np as I
        return self._with_cu_idx(
            cu, lambda: I.fill_ibc_mvp(self.cs, cu, self.enc_hist))

    def merge_idx(self, cu: CodingUnit) -> None:
        n_minus1 = self.sps.max_num_merge_cand - 1
        want = None
        if self.enc is not None:
            want = min(self.decisions.merge_idx(cu, n_minus1 + 1), n_minus1)
        idx = 0
        if n_minus1 > 0 and self._bin(ctx("MergeIdx"),
                                      want=None if want is None
                                      else int(want > 0)):
            idx = 1
            while idx < n_minus1 and self._ep(want=None if want is None
                                              else int(want > idx)):
                idx += 1
        cu.merge_idx = idx

    def inter_pred_idc(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::inter_pred_idc (CABACReader.cpp:1917)."""
        if self.sh.is_p:
            cu.inter_dir = 1
            return
        want = None if self.enc is None else self.decisions.inter_dir(cu)
        bipred_ok = not (cu.w + cu.h == 12)  # PU::isBipredRestriction
        if bipred_ok:
            # CtxInterDir: 7 - ((log2w + log2h + 1) >> 1)
            ctx_id = 7 - (((cu.w.bit_length() - 1)
                           + (cu.h.bit_length() - 1) + 1) >> 1)
            if self._bin(ctx("InterDir", ctx_id),
                         want=None if want is None else int(want == 3)):
                cu.inter_dir = 3
                return
        if self._bin(ctx("InterDir", 5),
                     want=None if want is None else int(want == 2)):
            cu.inter_dir = 2
            return
        cu.inter_dir = 1

    def ref_idx(self, cu: CodingUnit, lst: int) -> int:
        num_ref = self.sh.num_ref_idx_active[lst]
        want = None
        if self.enc is not None:
            want = min(self.decisions.ref_idx(cu, lst, num_ref), num_ref - 1)
        if num_ref <= 1:
            return 0
        if not self._bin(ctx("RefPic", 0),
                         want=None if want is None else int(want > 0)):
            return 0
        if num_ref <= 2 or not self._bin(ctx("RefPic", 1),
                                         want=None if want is None
                                         else int(want > 1)):
            return 1
        idx = 3
        while True:
            if num_ref <= idx or not self._ep(want=None if want is None
                                              else int(want > idx - 1)):
                return idx - 1
            idx += 1

    def mvd_coding(self, cu: CodingUnit, lst: int) -> list[int]:
        """Parity: CABACReader::mvd_coding (CABACReader.cpp:2095)."""
        want = None
        if self.enc is not None:
            want = self.decisions.mvd(cu, lst)
        out = []
        comps = []
        for i in range(2):
            wv = None if want is None else abs(int(want[i]))
            v = self._bin(ctx("Mvd", 0),
                          want=None if wv is None else int(wv > 0))
            comps.append((v, wv))
        for i in range(2):
            v, wv = comps[i]
            if v:
                v += self._bin(ctx("Mvd", 1),
                               want=None if wv is None else int(wv > 1))
            comps[i] = (v, wv)
        for i in range(2):
            v, wv = comps[i]
            if v:
                if v > 1:
                    v += self._rem(1, 0, 17,  # MV_BITS-1 = 17
                                   want=None if wv is None else wv - 2)
                neg = self._ep(want=None if want is None
                               else int(want[i] < 0))
                if neg:
                    v = -v
            out.append(v)
        return out

    def mvp_flag(self, cu: CodingUnit, lst: int) -> int:
        want = None
        if self.enc is not None:
            want = int(self.decisions.mvp_idx(cu, lst))
        return self._bin(ctx("MVPIdx"), want=want)

    def amvr_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::amvr_mode (CABACReader.cpp:991).
        imv: 0 quarter, 1 full, 2 four-pel, 3 half-pel."""
        if not self.sps.amvr_enabled:
            return
        has_mvd = any(cu.mvd[lst] != [0, 0] for lst in range(2)
                      if cu.inter_dir & (1 << lst))
        if not has_mvd:
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.imv(cu))
        if cu.pred_mode == MODE_IBC:
            # IBC: full-pel baseline, only the 4-pel refinement signalled
            v = self._bin(ctx("ImvFlag", 1),
                          want=None if want is None else int(want == 2))
            cu.imv = v + 1
            return
        v = self._bin(ctx("ImvFlag", 0),
                      want=None if want is None else int(want > 0))
        if not v:
            return
        cu.imv = 1
        v = self._bin(ctx("ImvFlag", 4),
                      want=None if want is None else int(want != 3))
        cu.imv = 1 if v else 3  # IMV_HPEL
        if v:
            v = self._bin(ctx("ImvFlag", 1),
                          want=None if want is None else int(want == 2))
            cu.imv = v + 1

    def affine_amvr_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::affine_amvr_mode (CABACReader.cpp:1031).
        imv: 0 quarter, 1 sixteenth (internal), 2 full-pel."""
        if not self.sps.affine_amvr:
            return
        # CU::hasSubCUNonZeroAffineMVd
        has_mvd = False
        for lst in range(2):
            if not (cu.inter_dir & (1 << lst)):
                continue
            if lst == 1 and self.ph.mvd_l1_zero and cu.inter_dir == 3:
                continue
            cps = [cu.mvd[lst]] + cu.mvd_aff[lst][:1 + cu.affine_type]
            if any(v != 0 for cp in cps for v in cp):
                has_mvd = True
        if not has_mvd:
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.affine_imv(cu))
        v = self._bin(ctx("ImvFlag", 2),
                      want=None if want is None else int(want > 0))
        if v:
            v = self._bin(ctx("ImvFlag", 3),
                          want=None if want is None else int(want == 2))
            v += 1
        cu.imv = v

    def cu_bcw_flag(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::cu_bcw_flag (CABACReader.cpp:1180)."""
        if not (self.sps.bcw_enabled and cu.pred_mode == MODE_INTER
                and cu.inter_dir == 3 and cu.w * cu.h >= 256
                and not self.sh.is_p):
            return
        # explicit weights on either reference disable BCW
        # (CU::isBcwIdxCoded, UnitTools.cpp:3512)
        from refdec.hls.weight_table import wp_present_any
        wt = self.sh.weight_table
        if wp_present_any(wt, 0, cu.ref_idx[0]) \
                or wp_present_any(wt, 1, cu.ref_idx[1]):
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.bcw_idx(cu))  # parsing-order index
        num_bcw = 5 if self.cs.check_ldc else 3
        idx = 0
        if self._bin(ctx("BcwIdx", 0),
                     want=None if want is None else int(want > 0)):
            idx = 1
            for ui in range(num_bcw - 2):
                if not self._ep(want=None if want is None
                                else int(want > idx)):
                    break
                idx += 1
        # parsing order -> forward-form index (g_BcwParsingOrder/InternFwd)
        parsing_order = (2, 3, 1, 4, 0)
        intern_fwd = (1, 2, 0, 3, 4)
        cu.bcw_idx = intern_fwd[parsing_order[idx]]

    def adaptive_color_transform(self, cu: CodingUnit) -> None:
        """cu_act_enabled_flag (CABACReader::adaptive_color_transform,
        CABACReader.cpp:1466): single-tree 4:4:4 only."""
        if not self.sps.act_enabled or cu.tree_type != TREE_D:
            return
        want = None
        if self.enc is not None:
            want = int(self.decisions.act_flag(cu))
        cu.color_transform = bool(self._bin(ctx("ACTFlag"), want=want))

    def rqt_root_cbf(self, cu: CodingUnit) -> bool:
        want = None
        if self.enc is not None:
            want = int(self.decisions.root_cbf(cu))
        return bool(self._bin(ctx("QtRootCbf"), want=want))

    def sbt_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::sbt_mode (CABACReader.cpp:1489)."""
        sps = self.sps
        if not sps.sbt_enabled or cu.pred_mode != MODE_INTER or cu.ciip_flag:
            return
        max_sbt = 1 << sps.log2_max_tb_size
        if cu.w > max_sbt or cu.h > max_sbt:
            return
        ver_half = cu.w >= 8
        hor_half = cu.h >= 8
        ver_quad = cu.w >= 16
        hor_quad = cu.h >= 16
        if not (ver_half or hor_half):
            return
        want = None
        if self.enc is not None:
            want = self.decisions.sbt(cu)
            # clamp to allowed set
            wi, wp = want
            allowed = {0}
            if ver_half:
                allowed.add(1)
            if hor_half:
                allowed.add(2)
            if ver_quad:
                allowed.add(3)
            if hor_quad:
                allowed.add(4)
            if wi not in allowed:
                wi = 0
            want = (wi, wp)
        if not self._bin(ctx("SbtFlag", 1 if cu.w * cu.h <= 256 else 0),
                         want=None if want is None else int(want[0] > 0)):
            return
        quad = False
        if (hor_half or ver_half) and (hor_quad or ver_quad):
            quad = bool(self._bin(ctx("SbtQuadFlag"),
                                  want=None if want is None
                                  else int(want[0] >= 3)))
        if quad:
            v_ok, h_ok = ver_quad, hor_quad
        else:
            v_ok, h_ok = ver_half, hor_half
        if v_ok and h_ok:
            ctx_hv = 0 if cu.w == cu.h else (1 if cu.w < cu.h else 2)
            hor = bool(self._bin(ctx("SbtHorFlag", ctx_hv),
                                 want=None if want is None
                                 else int(want[0] in (2, 4))))
        else:
            hor = h_ok
        idx = (2 if hor else 1) + (2 if quad else 0)
        pos = self._bin(ctx("SbtPosFlag"),
                        want=None if want is None else int(want[1]))
        cu.sbt_info = idx | (pos << 4)

    def _add_empty_tus(self, cu: CodingUnit, node: PartNode) -> None:
        """cs.addEmptyTUs: TU structure without coefficients (for deblock/
        QP maps)."""
        max_tr = 1 << self.sps.log2_max_tb_size
        a = node.area
        areas = split_areas(a, TU_MAX_TR_SPLIT, max_tr) \
            if (a.w > max_tr or a.h > max_tr) else [a]
        for i, sub in enumerate(areas):
            tu = TransformUnit()
            tu.cu_idx = cu.idx
            tu.part_idx = i
            if cu.has_luma:
                tu.blocks[0] = (sub.x, sub.y, sub.w, sub.h)
            if cu.has_chroma and self.cs.num_comp > 1:
                cx, cy, cw, chh = sub.chroma(self.cs.sub_w, self.cs.sub_h)
                tu.blocks[1] = (cx, cy, cw, chh)
                tu.blocks[2] = (cx, cy, cw, chh)
            tu.qp = cu.qp
            self._set_chroma_qp(tu, cu)
            cu.tus.append(tu)
            self.cs.add_tu(tu)

    def _enc_ibc_update(self, cu: CodingUnit) -> None:
        """Encode mode: resolve the coded IBC CU's final BV, span it into
        the motion field and update the IBC HMVP LUT so later CUs derive
        identical candidates to the decoder."""
        if self.enc is None or cu.pred_mode != MODE_IBC:
            return
        from refdec.frame import inter_np as I
        cs = self.cs
        if cu.merge_flag:
            bv = self.ibc_merge_bv(cu, cu.merge_idx)
        else:
            preds = I.fill_ibc_mvp(cs, cu, self.enc_hist)
            sh_amvr = 6 if cu.imv == 2 else 4
            p = preds[cu.mvp_idx[0]]
            bv = (p[0] + (cu.mvd[0][0] << sh_amvr),
                  p[1] + (cu.mvd[0][1] << sh_amvr))
        y4a, y4b = cu.y >> 2, (cu.y + cu.h) >> 2
        x4a, x4b = cu.x >> 2, (cu.x + cu.w) >> 2
        cs.mi_ref[y4a:y4b, x4a:x4b] = -1
        cs.mi_mv[y4a:y4b, x4a:x4b, 0] = bv
        cs.mi_mv[y4a:y4b, x4a:x4b, 1] = 0
        if cu.w * cu.h > 16:
            self.enc_hist.add_ibc(bv)

    def _update_hmvp(self, cu: CodingUnit) -> None:
        # motion derivation (incl. the HMVP table) lives in the recon stage;
        # nothing in the CABAC syntax depends on derived MVs
        pass

    # ==================================================================
    # coding unit
    # ==================================================================
    def code_cu(self, node: PartNode) -> None:
        cs = self.cs
        a = node.area
        cu = CodingUnit()
        cu.x, cu.y, cu.w, cu.h = a.x, a.y, a.w, a.h
        cu.cx, cu.cy = a.x // cs.sub_w, a.y // cs.sub_h
        cu.cw, cu.ch = a.w // cs.sub_w, a.h // cs.sub_h
        cu.ch_type = node.ch_type
        cu.tree_type = node.tree_type
        cu.mode_type = node.mode_type
        cu.qt_depth = node.qt_depth
        cu.mt_depth = node.mt_depth
        cu.depth = node.depth
        cu.slice_idx = self.slice_idx
        cu.tile_idx = self._tile_at(a.x, a.y)
        cu.split_hist = node.split_hist
        # global dual tree: CUs of the luma pass are TREE_L, of the chroma
        # pass TREE_C (CABACReader getArea, CABACReader.cpp:550); only the
        # partitioner stays TREE_D
        if self.dual_tree and node.tree_type == TREE_D:
            cu.tree_type = TREE_L if node.ch_type == 0 else TREE_C
        if cu.tree_type == TREE_C:
            cu.has_luma = False
            cu.ch_type = 1
        if cu.tree_type == TREE_L or cs.num_comp == 1:
            cu.has_chroma = False

        if self.qg_start:
            self.qg_start = False
            self.qps[0] = self.predict_qp(cu, self.qps[0])
        cu.qp = self.qps[0]
        cu.chroma_qp_adj = cs.chroma_qp_adj

        if not self.is_intra_slice or self.sps.ibc_enabled:
            # skip flag + prediction mode (CABACReader::coding_unit :856)
            skip = False
            if cu.has_luma:
                skip = self.cu_skip_flag(cu, node)
            if skip:
                cu.skip = True
                cu.merge_flag = True
                if cu.pred_mode != MODE_IBC:
                    cu.pred_mode = MODE_INTER
                cs.add_cu(cu)
                self.prediction_unit(cu)
                self._add_empty_tus(cu, node)
                self._enc_ibc_update(cu)
                self._update_hmvp(cu)
                return
            self.pred_mode_syntax(cu, node)
        else:
            cu.pred_mode = MODE_INTRA

        cs.add_cu(cu)

        if cu.pred_mode == MODE_INTRA:
            self.adaptive_color_transform(cu)

        if cu.pred_mode == MODE_INTRA:
            if cu.ch_type == 0 and cu.has_luma:
                self.bdpcm_mode(cu, 0)
                self.intra_luma_pred_mode(cu)
            if cu.has_chroma and cs.num_comp > 1:
                self.bdpcm_mode(cu, 1)
                self.intra_chroma_pred_mode(cu)
        else:
            self.prediction_unit(cu)
            if not cu.merge_flag:
                if cu.affine_flag:
                    self.affine_amvr_mode(cu)
                else:
                    self.amvr_mode(cu)
                self.cu_bcw_flag(cu)

        self.cu_residual(cu, node)
        self._enc_ibc_update(cu)
        if cu.pred_mode == MODE_INTER:
            self._update_hmvp(cu)

    def _ibc_ctx(self, cu: CodingUnit) -> int:
        """DeriveCtx::CtxIBCFlag (ContextModelling.cpp:280)."""
        cs = self.cs
        left = cs.cu_at_restricted(cu.x - 1, cu.y, cu, 0)
        above = cs.cu_at_restricted(cu.x, cu.y - 1, cu, 0)
        return int(bool(left and left.pred_mode == MODE_IBC)) + \
            int(bool(above and above.pred_mode == MODE_IBC))

    def cu_skip_flag(self, cu: CodingUnit, node: PartNode) -> bool:
        """Parity: CABACReader::cu_skip_flag (CABACReader.cpp:908)."""
        ibc_ok = self.sps.ibc_enabled and cu.w <= 64 and cu.h <= 64
        cons_intra = node.mode_type == MODE_TYPE_INTRA
        cons_inter = node.mode_type == MODE_TYPE_INTER
        if (self.is_intra_slice or cons_intra) and ibc_ok:
            want = None
            if self.enc is not None:
                want = int(self.decisions.ibc_skip(cu, self))
            skip = bool(self._bin(ctx("SkipFlag", self._skip_ctx(cu)),
                                  want=want))
            if skip:
                cu.pred_mode = MODE_IBC
            return skip
        if not ibc_ok and ((cu.w == 4 and cu.h == 4) or cons_intra):
            return False
        want = None
        if self.enc is not None:
            want = int(self.decisions.cu_skip(cu))
        skip = bool(self._bin(ctx("SkipFlag", self._skip_ctx(cu)),
                              want=want))
        if skip and ibc_ok and not cons_inter:
            if cu.w == 4 and cu.h == 4:
                cu.pred_mode = MODE_IBC
                return True
            want = None
            if self.enc is not None:
                want = int(self.decisions.ibc_skip(cu, self))
            if self._bin(ctx("IBCFlag", self._ibc_ctx(cu)), want=want):
                cu.pred_mode = MODE_IBC
        return skip

    def pred_mode_syntax(self, cu: CodingUnit, node: PartNode) -> None:
        """Parity: CABACReader::pred_mode (CABACReader.cpp:1055)."""
        if node.mode_type == MODE_TYPE_INTER:
            cu.pred_mode = MODE_INTER
            return
        ibc_allowed = False
        if self.is_intra_slice or (cu.w == 4 and cu.h == 4) \
                or node.mode_type == MODE_TYPE_INTRA:
            ibc_allowed = True
            cu.pred_mode = MODE_INTRA
        else:
            cu_left, cu_above = self._neighbors(node)
            ctx_pm = 1 if ((cu_above and cu_above.pred_mode == MODE_INTRA)
                           or (cu_left and cu_left.pred_mode == MODE_INTRA)) \
                else 0
            want = None
            if self.enc is not None:
                want = int(self.decisions.pred_mode(cu) == MODE_INTRA)
            if self._bin(ctx("PredMode", ctx_pm), want=want):
                cu.pred_mode = MODE_INTRA
            else:
                cu.pred_mode = MODE_INTER
                ibc_allowed = True
        ibc_allowed = ibc_allowed and cu.ch_type == 0 \
            and self.sps.ibc_enabled and cu.w <= 64 and cu.h <= 64
        if ibc_allowed:
            want = None
            if self.enc is not None:
                want = int(self.decisions.ibc(cu, self))
            if self._bin(ctx("IBCFlag", self._ibc_ctx(cu)), want=want):
                cu.pred_mode = MODE_IBC

    def predict_qp(self, cu: CodingUnit, prev_qp: int) -> int:
        cs = self.cs
        ch = cu.ch_type
        if ch == 1:
            x, y = cu.cx, cu.cy
            mask_w = (self.sps.ctu_size // cs.sub_w) - 1
            mask_h = (self.sps.ctu_size // cs.sub_h) - 1
        else:
            x, y = cu.x, cu.y
            mask_w = mask_h = self.sps.ctu_size - 1
        cu_above = cs.cu_at(x, y - 1, ch)
        cu_left = cs.cu_at(x - 1, y, ch)
        lx = x * (cs.sub_w if ch else 1)
        ctu_x = lx // self.sps.ctu_size
        if not self.pps.no_pic_partition:
            tile_col = self.pps.ctu_to_tile_col[ctu_x]
            tile_x0 = self.pps.tile_col_bd[tile_col]
        else:
            tile_x0 = 0
        at_tile_col_start = ctu_x == tile_x0
        if (at_tile_col_start and not (x & mask_w) and not (y & mask_h)
                and cu_above is not None
                and cu_above.slice_idx == cu.slice_idx
                and cu_above.tile_idx == cu.tile_idx):
            return cu_above.qp
        a = cu_above.qp if (y & mask_h) and cu_above else prev_qp
        b = cu_left.qp if (x & mask_w) and cu_left else prev_qp
        return (a + b + 1) >> 1

    def bdpcm_mode(self, cu: CodingUnit, comp_ch: int) -> None:
        if not self.sps.bdpcm_enabled:
            return
        max_ts = 1 << self.sps.log2_max_ts_size
        if comp_ch == 0:
            allowed = cu.w <= max_ts and cu.h <= max_ts and cu.has_luma
        else:
            # chroma BDPCM is disallowed under ACT (CU::bdpcmAllowed,
            # UnitTools.cpp:3554)
            allowed = cu.cw <= max_ts and cu.ch <= max_ts \
                and cu.has_chroma and not cu.color_transform
        if not allowed:
            return
        ctx_id = 0 if comp_ch == 0 else 2
        want = None
        if self.enc is not None:
            want = self.decisions.bdpcm_mode(cu, comp_ch)
        mode = self._bin(ctx("BDPCMMode", ctx_id),
                         want=None if want is None else int(want > 0))
        if mode:
            mode += self._bin(ctx("BDPCMMode", ctx_id + 1),
                              want=None if want is None else int(want == 2))
        if comp_ch == 0:
            cu.bdpcm_mode = mode
        else:
            cu.bdpcm_mode_chroma = mode

    # ---------------- intra modes ----------------
    def get_intra_mpms(self, cu: CodingUnit) -> list[int]:
        cs = self.cs
        left_dir = above_dir = PLANAR_IDX
        cu_left = cs.cu_at_restricted(cu.x - 1, cu.y + cu.h - 1, cu, 0)
        if cu_left and cu_left.pred_mode == MODE_INTRA:
            left_dir = PLANAR_IDX if cu_left.mip_flag else cu_left.intra_dir[0]
        cu_above = cs.cu_at_restricted(cu.x + cu.w - 1, cu.y - 1, cu, 0)
        ctu = self.sps.ctu_size
        # above only used when in the same CTU (line-buffer restriction)
        if cu_above and cu_above.pred_mode == MODE_INTRA and \
                (cu.y - 1) // ctu == cu.y // ctu and \
                cu_above.y // ctu == cu.y // ctu:
            above_dir = PLANAR_IDX if cu_above.mip_flag else cu_above.intra_dir[0]

        offset = NUM_LUMA_MODE - 6
        mod = offset + 3
        mpm = [PLANAR_IDX, DC_IDX, VER_IDX, HOR_IDX, VER_IDX - 4, VER_IDX + 4]
        if left_dir == above_dir:
            if left_dir > DC_IDX:
                mpm = [PLANAR_IDX, left_dir,
                       ((left_dir + offset) % mod) + 2,
                       ((left_dir - 1) % mod) + 2,
                       ((left_dir + offset - 1) % mod) + 2,
                       (left_dir % mod) + 2]
        else:
            if left_dir > DC_IDX and above_dir > DC_IDX:
                mpm[0] = PLANAR_IDX
                mpm[1] = left_dir
                mpm[2] = above_dir
                mx, mn = (1, 2) if mpm[1] > mpm[2] else (2, 1)
                d = mpm[mx] - mpm[mn]
                if d == 1:
                    mpm[3] = ((mpm[mn] + offset) % mod) + 2
                    mpm[4] = ((mpm[mx] - 1) % mod) + 2
                    mpm[5] = ((mpm[mn] + offset - 1) % mod) + 2
                elif d >= 62:
                    mpm[3] = ((mpm[mn] - 1) % mod) + 2
                    mpm[4] = ((mpm[mx] + offset) % mod) + 2
                    mpm[5] = (mpm[mn] % mod) + 2
                elif d == 2:
                    mpm[3] = ((mpm[mn] - 1) % mod) + 2
                    mpm[4] = ((mpm[mn] + offset) % mod) + 2
                    mpm[5] = ((mpm[mx] - 1) % mod) + 2
                else:
                    mpm[3] = ((mpm[mn] + offset) % mod) + 2
                    mpm[4] = ((mpm[mn] - 1) % mod) + 2
                    mpm[5] = ((mpm[mx] + offset) % mod) + 2
            elif left_dir + above_dir >= 2:
                mpm[0] = PLANAR_IDX
                mpm[1] = max(left_dir, above_dir)
                mpm[2] = ((mpm[1] + offset) % mod) + 2
                mpm[3] = ((mpm[1] - 1) % mod) + 2
                mpm[4] = ((mpm[1] + offset - 1) % mod) + 2
                mpm[5] = (mpm[1] % mod) + 2
        return mpm

    def trunc_bin(self, max_symbol: int, want: int | None = None) -> int:
        thresh = int(rom.TB_MAX[max_symbol]) if max_symbol <= 256 else \
            max_symbol.bit_length() - 1
        val = 1 << thresh
        b = max_symbol - val
        if self.enc is None:
            symbol = self._eps(thresh)
            if symbol >= val - b:
                symbol = (symbol << 1) + self._ep()
                symbol -= val - b
            return symbol
        # encode
        if want < val - b:
            self._eps(thresh, want=want)
        else:
            w2 = want + val - b
            self._eps(thresh, want=w2 >> 1)
            self._ep(want=w2 & 1)
        return want

    def intra_luma_pred_mode(self, cu: CodingUnit) -> None:
        if cu.bdpcm_mode:
            cu.intra_dir[0] = VER_IDX if cu.bdpcm_mode == 2 else HOR_IDX
            return
        self.mip_flag(cu)
        if cu.mip_flag:
            self.mip_pred_mode(cu)
            return
        self.extend_ref_line(cu)
        self.isp_mode(cu)

        mpm = self.get_intra_mpms(cu)
        target = None
        if self.enc is not None:
            target = self.decisions.intra_luma_mode(cu, mpm)
            if cu.multi_ref_idx:
                assert target in mpm[1:], (target, mpm)
        if cu.multi_ref_idx:
            mpm_flag = True
        else:
            mpm_flag = bool(self._bin(ctx("IPredMode[0]"),
                                      want=None if target is None
                                      else int(target in mpm)))
        if mpm_flag:
            t_idx = mpm.index(target) if target is not None else None
            ctx_pl = 1 if cu.isp_mode == 0 else 0
            if cu.multi_ref_idx == 0:
                idx = self._bin(ctx("IntraLumaPlanarFlag", ctx_pl),
                                want=None if t_idx is None else int(t_idx > 0))
            else:
                idx = 1
            if idx:
                while idx < 5 and self._ep(want=None if t_idx is None
                                           else int(t_idx > idx)):
                    idx += 1
            cu.intra_dir[0] = mpm[idx]
        else:
            if self.enc is not None:
                srt = sorted(mpm)
                mode = target
                for m in reversed(srt):
                    if mode > m:
                        mode -= 1
                mode_sym = mode
            else:
                mode_sym = None
            mode = self.trunc_bin(NUM_LUMA_MODE - NUM_MPM, want=mode_sym)
            for m in sorted(mpm):
                if mode >= m:
                    mode += 1
            cu.intra_dir[0] = mode
            if target is not None:
                assert cu.intra_dir[0] == target, (cu.intra_dir[0], target, mpm)

    def intra_chroma_pred_mode(self, cu: CodingUnit) -> None:
        if cu.bdpcm_mode_chroma:
            cu.intra_dir[1] = VER_IDX if cu.bdpcm_mode_chroma == 2 else HOR_IDX
            return
        if cu.color_transform:
            cu.intra_dir[1] = DM_CHROMA_IDX
            return
        cclm_on = self.sps.cclm_enabled and self.check_cclm_allowed(cu)
        target = None
        if self.enc is not None:
            target = self.decisions.intra_chroma_mode(
                cu, self.get_intra_chroma_cand_modes(cu), cclm_on)
        if cclm_on:
            is_lm = bool(self._bin(ctx("CclmModeFlag"),
                                   want=None if target is None else
                                   int(target in (LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX))))
            if is_lm:
                t_sym = None if target is None else \
                    (LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX).index(target)
                symbol = self._bin(ctx("CclmModeIdx"),
                                   want=None if t_sym is None else int(t_sym > 0))
                if symbol:
                    symbol += self._ep(want=None if t_sym is None else t_sym - 1)
                cu.intra_dir[1] = (LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX)[symbol]
                return
        is_dm = self._bin(ctx("IPredMode[1]"),
                          want=None if target is None
                          else int(target != DM_CHROMA_IDX)) == 0
        if is_dm:
            cu.intra_dir[1] = DM_CHROMA_IDX
            return
        modes = self.get_intra_chroma_cand_modes(cu)
        t_cand = None
        if target is not None:
            assert target in modes[:4], (target, modes)
            t_cand = modes.index(target)
        cand_id = self._eps(2, want=t_cand)
        cu.intra_dir[1] = modes[cand_id]

    def get_intra_chroma_cand_modes(self, cu: CodingUnit) -> list[int]:
        modes = [PLANAR_IDX, VER_IDX, HOR_IDX, DC_IDX,
                 LM_CHROMA_IDX, MDLM_L_IDX, MDLM_T_IDX, DM_CHROMA_IDX]
        luma_mode = self.co_located_luma_mode(cu)
        for i in range(4):
            if luma_mode == modes[i]:
                modes[i] = VDIA_IDX
                break
        return modes

    def co_located_luma_mode(self, cu: CodingUnit) -> int:
        if cu.tree_type == TREE_C or not cu.has_luma:
            lx = (cu.cx + (cu.cw >> 1)) * self.cs.sub_w
            ly = (cu.cy + (cu.ch >> 1)) * self.cs.sub_h
            luma_cu = self.cs.cu_at(lx, ly, 0)
            if luma_cu is None:
                return PLANAR_IDX
            return PLANAR_IDX if luma_cu.mip_flag else luma_cu.intra_dir[0]
        return PLANAR_IDX if cu.mip_flag else cu.intra_dir[0]

    def check_cclm_allowed(self, cu: CodingUnit) -> bool:
        """Parity: CU::checkCCLMAllowed (UnitTools.cpp:3439)."""
        if not self.dual_tree:
            return True
        if self.sps.ctu_size <= 32:
            return True
        d64 = 1 if self.sps.ctu_size == 128 else 0
        hist = cu.split_hist
        s1 = hist[d64] if len(hist) > d64 else CU_DONT_SPLIT
        s2 = hist[d64 + 1] if len(hist) > d64 + 1 else CU_DONT_SPLIT
        allow = (s1 == CU_QUAD_SPLIT
                 or (s1 == CU_HORZ_SPLIT and s2 == CU_VERT_SPLIT)
                 or s1 == CU_DONT_SPLIT
                 or (s1 == CU_HORZ_SPLIT and s2 == CU_DONT_SPLIT))
        if allow:
            luma_cu = self.cs.cu_at(cu.cx * self.cs.sub_w,
                                    cu.cy * self.cs.sub_h, 0)
            if luma_cu is not None:
                if luma_cu.depth > d64 and luma_cu.qt_depth == d64:
                    allow = False
                elif luma_cu.depth == d64 and luma_cu.isp_mode:
                    allow = False
        return allow

    def mip_flag(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::mip_flag (CABACReader.cpp:3123) +
        DeriveCtx::CtxMipFlag (ContextModelling.cpp:495)."""
        if not self.sps.mip_enabled:
            cu.mip_flag = False
            return
        cu_left = self.cs.cu_at_restricted(cu.x - 1, cu.y, cu, 0)
        cu_above = self.cs.cu_at_restricted(cu.x, cu.y - 1, cu, 0)
        ctx_id = (1 if (cu_left and cu_left.mip_flag) else 0) +             (1 if (cu_above and cu_above.mip_flag) else 0)
        if cu.w > 2 * cu.h or cu.h > 2 * cu.w:
            ctx_id = 3
        want = None
        if self.enc is not None:
            want = int(bool(self.decisions.mip(cu)))
        cu.mip_flag = bool(self._bin(ctx("MipFlag", ctx_id), want=want))

    def mip_pred_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::mip_pred_mode (CABACReader.cpp:3136)."""
        from refdec.frame.recon_np import num_mip_modes
        n = num_mip_modes(cu.w, cu.h)
        want_mode = want_tr = None
        if self.enc is not None:
            want_mode, want_tr = self.decisions.mip_mode(cu, n)
        cu.mip_transpose = bool(self._ep(want=want_tr))
        mode = self.trunc_bin(n, want=want_mode)
        cu.intra_dir[0] = mode

    def extend_ref_line(self, cu: CodingUnit) -> None:
        if cu.bdpcm_mode or not self.sps.mrl_enabled:
            return
        if (cu.y & (self.sps.ctu_size - 1)) == 0:
            return
        want = None
        if self.enc is not None:
            want = self.decisions.multi_ref_line(cu)
        idx = 0
        if self._bin(ctx("MultiRefLineIdx", 0),
                     want=None if want is None else int(want > 0)):
            idx = 1
            if self._bin(ctx("MultiRefLineIdx", 1),
                         want=None if want is None else int(want > 1)):
                idx = 2
        cu.multi_ref_idx = idx

    def isp_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::isp_mode (CABACReader.cpp:2541) +
        CU::canUseISPSplit (UnitTools.cpp:343)."""
        if cu.multi_ref_idx or not self.sps.isp_enabled or cu.bdpcm_mode \
                or cu.color_transform:
            return
        allowed = can_use_isp_split(cu.w, cu.h, 1 << self.sps.log2_max_tb_size)
        if allowed == 0:
            return
        want = None
        if self.enc is not None:
            want = self.decisions.isp_mode(cu, allowed)
            if want and not (allowed & want if allowed != 3 else True):
                want = allowed  # clamp to the only permitted split
        symbol = self._bin(ctx("ISPMode", 0),
                           want=None if want is None else int(want > 0))
        if symbol:
            if allowed == HOR_INTRA_SUBPARTITIONS:
                cu.isp_mode = HOR_INTRA_SUBPARTITIONS
            elif allowed == VER_INTRA_SUBPARTITIONS:
                cu.isp_mode = VER_INTRA_SUBPARTITIONS
            else:
                cu.isp_mode = 1 + self._bin(
                    ctx("ISPMode", 1),
                    want=None if want is None else int(want == 2))

    # ==================================================================
    # residual
    # ==================================================================
    def cu_residual(self, cu: CodingUnit, node: PartNode) -> None:
        if cu.pred_mode != MODE_INTRA:
            if not cu.merge_flag:
                cu.root_cbf = self.rqt_root_cbf(cu)
            else:
                cu.root_cbf = True
            if cu.root_cbf:
                self.sbt_mode(cu)
            if not cu.root_cbf:
                self._add_empty_tus(cu, node)
                return
        cu.root_cbf = True
        if cu.pred_mode != MODE_INTRA:  # inter / IBC (CABACReader.cpp:1432)
            self.adaptive_color_transform(cu)
        self.violates_lfnst = [False, False]
        self.lfnst_last_scan_pos = False
        self.violates_mts = False
        self.mts_last_scan_pos = False

        self.transform_tree(cu, node)

        self.residual_lfnst_mode(cu)
        self.mts_idx(cu)

        cu.root_cbf = any(cu.plane_cbf)

    def transform_tree(self, cu: CodingUnit, node: PartNode) -> None:
        max_tr = 1 << self.sps.log2_max_tb_size
        a = node.area
        split = a.w > max_tr or a.h > max_tr
        if cu.sbt_info:
            # SBT: two TUs, one carries all residual
            # (PartitionerImpl::getSbtTuTiling, UnitPartitioner.cpp)
            sbt_idx = cu.sbt_info & 0xF
            pos = (cu.sbt_info >> 4) & 3
            hor = sbt_idx in (2, 4)
            quad = sbt_idx in (3, 4)
            if hor:
                h0 = a.h // 4 if quad else a.h // 2
                sizes = [h0, a.h - h0] if pos == 0 else [a.h - h0, h0]
                subs = [Area(a.x, a.y, a.w, sizes[0]),
                        Area(a.x, a.y + sizes[0], a.w, sizes[1])]
            else:
                w0 = a.w // 4 if quad else a.w // 2
                sizes = [w0, a.w - w0] if pos == 0 else [a.w - w0, w0]
                subs = [Area(a.x, a.y, sizes[0], a.h),
                        Area(a.x + sizes[0], a.y, sizes[1], a.h)]
            for i, sub in enumerate(subs):
                tu = TransformUnit()
                tu.cu_idx = cu.idx
                tu.part_idx = i
                tu.blocks[0] = (sub.x, sub.y, sub.w, sub.h)
                if cu.has_chroma and self.cs.num_comp > 1:
                    cx, cy, cw, chh = sub.chroma(self.cs.sub_w, self.cs.sub_h)
                    tu.blocks[1] = (cx, cy, cw, chh)
                    tu.blocks[2] = (cx, cy, cw, chh)
                cu.tus.append(tu)
                self.cs.add_tu(tu)
                no_resi = (pos == 0 and i == 1) or (pos == 1 and i == 0)
                self.transform_unit(tu, cu, node, sbt_no_resi=no_resi)
            return
        if cu.isp_mode:
            # ISP 1-D TU split (PartitionerImpl::getTUIntraSubPartitions,
            # UnitPartitioner.cpp:628): luma split into nTus strips; chroma
            # rides only the LAST partition, at the full CU area.
            horiz = cu.isp_mode == HOR_INTRA_SUBPARTITIONS
            dim = isp_split_dim(a.w, a.h, horiz)
            n = (a.h if horiz else a.w) // dim
            for i in range(n):
                tu = TransformUnit()
                tu.cu_idx = cu.idx
                tu.part_idx = i
                if horiz:
                    tu.blocks[0] = (a.x, a.y + i * dim, a.w, dim)
                else:
                    tu.blocks[0] = (a.x + i * dim, a.y, dim, a.h)
                if i == n - 1 and cu.has_chroma and self.cs.num_comp > 1:
                    cx, cy, cw, chh = a.chroma(self.cs.sub_w, self.cs.sub_h)
                    tu.blocks[1] = (cx, cy, cw, chh)
                    tu.blocks[2] = (cx, cy, cw, chh)
                cu.tus.append(tu)
                self.cs.add_tu(tu)
                self.transform_unit(tu, cu, node, isp_idx=i, isp_n=n)
            return
        if split:
            for i, sub in enumerate(split_areas(a, TU_MAX_TR_SPLIT, max_tr)):
                child = node.child(sub, TU_MAX_TR_SPLIT, i, 0)
                child.part_idx = i
                self.transform_tree(cu, child)
            return
        tu = TransformUnit()
        tu.cu_idx = cu.idx
        tu.part_idx = node.part_idx
        if cu.has_luma:
            tu.blocks[0] = (a.x, a.y, a.w, a.h)
        if cu.has_chroma and self.cs.num_comp > 1:
            cx, cy, cw, chh = a.chroma(self.cs.sub_w, self.cs.sub_h)
            tu.blocks[1] = (cx, cy, cw, chh)
            tu.blocks[2] = (cx, cy, cw, chh)
        cu.tus.append(tu)
        self.cs.add_tu(tu)
        self.transform_unit(tu, cu, node)

    def _tu_coeffs(self, tu, cu, comp):
        if self.enc is None:
            return None
        return self.decisions.coeffs(tu, cu, comp)

    def transform_unit(self, tu: TransformUnit, cu: CodingUnit,
                       node: PartNode, isp_idx: int = 0,
                       isp_n: int = 1, sbt_no_resi: bool = False) -> None:
        cbf_cb = cbf_cr = False
        sep_tree = cu.tree_type != TREE_D
        enc_coeffs = {}
        if self.enc is not None:
            for comp in range(3):
                if tu.blocks[comp] is not None:
                    enc_coeffs[comp] = self._tu_coeffs(tu, cu, comp)

        if tu.blocks[1] is not None and (not sep_tree or node.ch_type == 1) \
                and not (cu.sbt_info and sbt_no_resi):
            want_cb = want_cr = None
            if self.enc is not None:
                want_cb = int(enc_coeffs.get(1) is not None
                              and np.any(enc_coeffs[1]))
                want_cr = int(enc_coeffs.get(2) is not None
                              and np.any(enc_coeffs[2]))
            cbf_cb = self.cbf_comp(cu, 1, prev_cbf=False, want=want_cb)
            cbf_cr = self.cbf_comp(cu, 2, prev_cbf=cbf_cb, want=want_cr)
        tu.cbf[1], tu.cbf[2] = cbf_cb, cbf_cr

        if node.ch_type == 0 and tu.blocks[0] is not None:
            want_y = None
            if self.enc is not None:
                want_y = int(enc_coeffs.get(0) is not None
                             and np.any(enc_coeffs[0]))
            if cu.sbt_info and sbt_no_resi:
                tu.cbf[0] = False
            elif cu.sbt_info and not (cbf_cb or cbf_cr):
                tu.cbf[0] = True
                if self.enc is not None and not want_y:
                    _, _, w_, h_ = tu.blocks[0]
                    blk = np.zeros((h_, w_), dtype=np.int32)
                    blk[0, 0] = 1
                    enc_coeffs[0] = blk
            elif cu.pred_mode != MODE_INTRA and node.tr_depth == 0 \
                    and not cu.sbt_info and not (cbf_cb or cbf_cr):
                # inter root TU with no chroma cbf: luma cbf inferred 1
                tu.cbf[0] = True
                if self.enc is not None and not want_y:
                    _, _, w_, h_ = tu.blocks[0]
                    blk = np.zeros((h_, w_), dtype=np.int32)
                    blk[0, 0] = 1
                    enc_coeffs[0] = blk
            elif cu.isp_mode:
                # last ISP partition's luma cbf is inferred to 1 when no
                # earlier partition had one (CABACReader.cpp transform_unit)
                prev = cu.tus[-2].cbf[0] if isp_idx > 0 else False
                root_so_far = any(t.cbf[0] for t in cu.tus[:-1])
                if isp_idx == isp_n - 1 and not root_so_far:
                    tu.cbf[0] = True
                    if self.enc is not None and not want_y:
                        # generator must honor the inference: force a level
                        _, _, w_, h_ = tu.blocks[0]
                        blk = np.zeros((h_, w_), dtype=np.int32)
                        blk[0, 0] = 1
                        enc_coeffs[0] = blk
                else:
                    tu.cbf[0] = self.cbf_comp(cu, 0, prev_cbf=bool(prev),
                                              use_isp=True, want=want_y)
            else:
                tu.cbf[0] = self.cbf_comp(cu, 0, prev_cbf=False, want=want_y)

        cu.plane_cbf[0] = cu.plane_cbf[0] or tu.cbf[0]
        cu.plane_cbf[1] = cu.plane_cbf[1] or tu.cbf[1]
        cu.plane_cbf[2] = cu.plane_cbf[2] or tu.cbf[2]

        luma_only = tu.blocks[1] is None
        cbf_luma = tu.cbf[0]
        cbf_chroma = (not luma_only) and (cbf_cb or cbf_cr)

        if cu.w > 64 or cu.h > 64 or cbf_luma or cbf_chroma:
            if self.pps.cu_qp_delta_enabled and not self.is_dqp_coded:
                if not sep_tree or node.ch_type == 0:
                    self.cu_qp_delta(cu)
                    self.qps[0] = cu.qp
                    self.is_dqp_coded = True
                    self.cs.qp_map[cu.y >> 2:(cu.y + cu.h) >> 2,
                                   cu.x >> 2:(cu.x + cu.w) >> 2] = cu.qp
            if (not sep_tree or node.ch_type == 1) and self.sh.cu_chroma_qp_offset_enabled:
                if (cu.w > 64 or cu.h > 64 or cbf_chroma) and not self.is_chroma_qp_adj_coded:
                    self.cu_chroma_qp_offset(cu)
                    self.is_chroma_qp_adj_coded = True
            if not luma_only:
                self.joint_cb_cr(tu, cu, (2 if tu.cbf[1] else 0) + (1 if tu.cbf[2] else 0))
                if tu.joint_cbcr:
                    cu.plane_cbf[1] = cu.plane_cbf[2] = True

            tu.qp = cu.qp
            self._set_chroma_qp(tu, cu)
            if cbf_luma:
                self.residual_coding(tu, cu, 0, enc_coeffs.get(0))
            if not luma_only:
                for comp in (1, 2):
                    if tu.cbf[comp]:
                        self.residual_coding(tu, cu, comp, enc_coeffs.get(comp))
        else:
            tu.qp = cu.qp
            self._set_chroma_qp(tu, cu)

    def _set_chroma_qp(self, tu: TransformUnit, cu: CodingUnit) -> None:
        if self.cs.num_comp == 1 or tu.blocks[1] is None:
            return
        sps, pps, sh = self.sps, self.pps, self.sh
        qp_bd = sps.qp_bd_offset
        base = max(-qp_bd, min(MAX_QP, cu.qp))
        for i in range(2):
            if tu.joint_cbcr:
                off = pps.joint_cbcr_qp_offset + sh.joint_cbcr_qp_offset
                comp_idx = 2
            else:
                off = (pps.cb_qp_offset, pps.cr_qp_offset)[i] + \
                      (sh.cb_qp_offset, sh.cr_qp_offset)[i]
                comp_idx = i
            mapped = sps.chroma_qp_table.map_qp(comp_idx, base)
            qp = max(-qp_bd, min(MAX_QP, mapped + off)) + qp_bd
            tu.chroma_qp[i] = qp

    def cbf_comp(self, cu: CodingUnit, comp: int, prev_cbf: bool,
                 use_isp: bool = False, want: int | None = None) -> bool:
        name = f"QtCbf[{comp}]"
        if (comp == 0 and cu.bdpcm_mode) or (comp != 0 and cu.bdpcm_mode_chroma):
            inc = 2 if comp == 2 else 1
        elif use_isp and comp == 0:
            inc = 2 + int(prev_cbf)
        elif comp == 2:
            inc = 1 if prev_cbf else 0
        else:
            inc = 0
        return bool(self._bin(ctx(name, inc), want=want))

    def cu_qp_delta(self, cu: CodingUnit) -> None:
        pred_qp = cu.qp
        want = self.decisions.qp_delta(cu) if self.enc is not None else None
        if self.enc is None:
            dqp = self.unary_max_symbol(ctx("DeltaQP", 0), ctx("DeltaQP", 1),
                                        CU_DQP_TU_CMAX)
            if dqp >= CU_DQP_TU_CMAX:
                dqp += self.exp_golomb_eqprob(CU_DQP_EG_K)
            if dqp > 0:
                if self._ep():
                    dqp = -dqp
        else:
            mag = abs(want)
            self.unary_max_symbol(ctx("DeltaQP", 0), ctx("DeltaQP", 1),
                                  CU_DQP_TU_CMAX, want=min(mag, CU_DQP_TU_CMAX))
            if mag >= CU_DQP_TU_CMAX:
                self.exp_golomb_eqprob(CU_DQP_EG_K, want=mag - CU_DQP_TU_CMAX)
            if mag > 0:
                self._ep(want=int(want < 0))
            dqp = want
        if dqp != 0:
            qp_bd = self.sps.qp_bd_offset
            cu.qp = ((pred_qp + dqp + (MAX_QP + 1) + 2 * qp_bd)
                     % ((MAX_QP + 1) + qp_bd)) - qp_bd
        else:
            cu.qp = pred_qp

    def cu_chroma_qp_offset(self, cu: CodingUnit) -> None:
        length = len(self.pps.chroma_qp_offset_list)
        adj = self._bin(ctx("ChromaQpAdjFlag"), want=0)
        if adj and length > 1:
            adj += self.unary_max_symbol(ctx("ChromaQpAdjIdc"),
                                         ctx("ChromaQpAdjIdc"), length - 1)
        cu.chroma_qp_adj = self.cs.chroma_qp_adj = adj

    def joint_cb_cr(self, tu: TransformUnit, cu: CodingUnit, cbf_mask: int) -> None:
        if not self.sps.joint_cbcr_enabled:
            return
        if (cu.pred_mode == MODE_INTRA and cbf_mask) or cbf_mask == 3:
            want = None
            if self.enc is not None:
                want = int(bool(self.decisions.joint_cbcr(tu, cu, cbf_mask)))
            if self._bin(ctx("JointCbCrFlag", cbf_mask - 1), want=want):
                tu.joint_cbcr = cbf_mask

    def ts_flag(self, tu: TransformUnit, cu: CodingUnit, comp: int) -> None:
        ts = 1 if ((cu.bdpcm_mode and comp == 0)
                   or (cu.bdpcm_mode_chroma and comp != 0)) else 0
        ctx_idx = 4 if comp == 0 else 5
        if self._ts_allowed(tu, cu, comp):
            want = None
            if self.enc is not None:
                want = int(self.decisions.use_ts(tu, cu, comp))
            ts = self._bin(ctx("MTSIndex", ctx_idx), want=want)
        tu.mts_idx[comp] = MTS_SKIP if ts else MTS_DCT2_DCT2

    def _ts_allowed(self, tu: TransformUnit, cu: CodingUnit, comp: int) -> bool:
        if not self.sps.transform_skip_enabled:
            return False
        if comp == 0 and cu.bdpcm_mode:
            return False
        if comp != 0 and cu.bdpcm_mode_chroma:
            return False
        if (cu.isp_mode and comp == 0) or cu.sbt_info:
            return False
        max_ts = 1 << self.sps.log2_max_ts_size
        _, _, w, h = tu.blocks[comp]
        return w <= max_ts and h <= max_ts

    def mts_idx(self, cu: CodingUnit) -> None:
        if not cu.tus:
            return
        tu = cu.tus[0]
        mts = tu.mts_idx[0]
        if self._mts_allowed(cu) and not self.violates_mts and \
                self.mts_last_scan_pos and cu.lfnst_idx == 0 and mts != MTS_SKIP:
            target = None
            if self.enc is not None:
                target = self.decisions.mts_idx(cu)
            symbol = self._bin(ctx("MTSIndex", 0),
                               want=None if target is None else int(target >= 2))
            if symbol:
                mts = MTS_DST7_DST7
                for i in range(3):
                    symbol = self._bin(ctx("MTSIndex", 1 + i),
                                       want=None if target is None
                                       else int(target > mts))
                    mts += symbol
                    if not symbol:
                        break
            tu.mts_idx[0] = mts

    def _mts_allowed(self, cu: CodingUnit) -> bool:
        sps = self.sps
        if not sps.mts_enabled:
            return False
        use = sps.explicit_mts_intra if cu.pred_mode == MODE_INTRA \
            else sps.explicit_mts_inter
        return (use and cu.w <= 32 and cu.h <= 32 and not cu.sbt_info
                and not cu.isp_mode and cu.has_luma)

    def residual_lfnst_mode(self, cu: CodingUnit) -> None:
        """Parity: CABACReader::residual_lfnst_mode (CABACReader.cpp:2578)."""
        if not self.sps.lfnst_enabled or cu.pred_mode != MODE_INTRA:
            return
        sep_tree = cu.tree_type != TREE_D
        ch_idx = 1 if (sep_tree and cu.ch_type == 1) else 0
        if cu.isp_mode and not can_use_lfnst_with_isp(cu.w, cu.h, cu.isp_mode):
            return
        if cu.mip_flag and not (cu.w >= 16 and cu.h >= 16):
            return
        if cu.ch_type == 1 and min(cu.cw, cu.ch) < 4:
            return
        # luma-scaled size of the reference block
        if ch_idx == 1:
            lw, lh = cu.cw * self.cs.sub_w, cu.ch * self.cs.sub_h
        else:
            lw, lh = cu.w, cu.h
        max_tb = 1 << self.sps.log2_max_tb_size
        if lw > max_tb or lh > max_tb:
            return
        luma_flag = (cu.ch_type == 0) if sep_tree else True
        chroma_flag = (cu.ch_type == 1) if sep_tree else True
        nonzero_corner = (luma_flag and self.violates_lfnst[0]) or \
            (chroma_flag and self.violates_lfnst[1])
        is_tr_skip = False
        for tu in cu.tus:
            for comp in range(3):
                if tu.blocks[comp] is not None and tu.cbf[comp] \
                        and tu.mts_idx[comp] == MTS_SKIP:
                    is_tr_skip = True
        if nonzero_corner or (not self.lfnst_last_scan_pos and not cu.isp_mode) \
                or is_tr_skip:
            return
        cctx = 1 if sep_tree else 0
        want = None
        if self.enc is not None:
            want = self.decisions.lfnst_idx(cu)
        idx = self._bin(ctx("LFNSTIdx", cctx),
                        want=None if want is None else int(want > 0))
        if idx:
            idx += self._bin(ctx("LFNSTIdx", 2),
                             want=None if want is None else int(want > 1))
        cu.lfnst_idx = idx

    # ---------------- residual coding (regular path) ----------------
    def residual_coding(self, tu: TransformUnit, cu: CodingUnit, comp: int,
                        enc_block: np.ndarray | None = None) -> None:
        if comp == 2 and tu.joint_cbcr == 3:
            return
        self.ts_flag(tu, cu, comp)
        if tu.mts_idx[comp] == MTS_SKIP and not self.sh.ts_residual_coding_disabled:
            self.residual_coding_ts(tu, cu, comp, enc_block)
            return
        if enc_block is None and hasattr(self.dec, "_d"):
            self._residual_native(tu, cu, comp)
            return

        ch = 0 if comp == 0 else 1
        x0, y0, w, h = tu.blocks[comp]
        log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
        lg_cw, lg_ch = rom.log2_sbb_size(log2_w, log2_h)
        log2_cg = lg_cw + lg_ch
        w_groups = min(rom.ZERO_OUT_TH, w) >> lg_cw
        h_groups = min(rom.ZERO_OUT_TH, h) >> lg_ch
        scan = rom.scan_grouped(w, h)
        scan_cg = rom.scan_cg(w_groups, h_groups)
        max_num_coeff = w * h

        # In encode mode enc_block holds the *parsed* levels (pre dep-quant
        # correction); with dep-quant/SDH on, the reconstructed coefficients
        # legitimately differ from them (state-machine correction / inferred
        # sign), which is fine for oracle streams.
        enc_flat = None
        if enc_block is not None:
            assert enc_block.shape == (h, w)
            enc_flat = enc_block.reshape(-1).astype(np.int64)

        # ---- last significant position ----
        max_last_x = int(rom.GROUP_IDX[min(rom.ZERO_OUT_TH, w) - 1])
        max_last_y = int(rom.GROUP_IDX[min(rom.ZERO_OUT_TH, h) - 1])
        if ch == 0:
            last_off_x = rom.LAST_PREFIX_CTX[log2_w]
            last_off_y = rom.LAST_PREFIX_CTX[log2_h]
            last_shift_x = (log2_w + 1) >> 2
            last_shift_y = (log2_h + 1) >> 2
        else:
            last_off_x = last_off_y = 0
            last_shift_x = max(0, min(2, w >> 3))
            last_shift_y = max(0, min(2, h >> 3))
        ctx_last_x = _OFF[f"LastX[{ch}]"][0]
        ctx_last_y = _OFF[f"LastY[{ch}]"][0]

        want_gx = want_gy = want_px = want_py = None
        if enc_flat is not None:
            nz = np.nonzero(enc_flat[scan[: len(scan)]])[0]
            assert len(nz), "cbf set but no coefficients"
            scan_pos_last_enc = int(nz[-1])
            blk = int(scan[scan_pos_last_enc])
            want_px = blk & (w - 1)
            want_py = blk >> log2_w
            want_gx = int(rom.GROUP_IDX[want_px])
            want_gy = int(rom.GROUP_IDX[want_py])

        pos_x = self._last_prefix(ctx_last_x + last_off_x, last_shift_x,
                                  max_last_x, want_gx)
        pos_y = self._last_prefix(ctx_last_y + last_off_y, last_shift_y,
                                  max_last_y, want_gy)
        if pos_x > 3:
            n = (pos_x - 2) >> 1
            t = 0
            wsuf = None if want_px is None else want_px - int(rom.MIN_IN_GROUP[pos_x])
            for i in range(n - 1, -1, -1):
                t += self._ep(want=None if wsuf is None else (wsuf >> i) & 1) << i
            pos_x = int(rom.MIN_IN_GROUP[pos_x]) + t
        if pos_y > 3:
            n = (pos_y - 2) >> 1
            t = 0
            wsuf = None if want_py is None else want_py - int(rom.MIN_IN_GROUP[pos_y])
            for i in range(n - 1, -1, -1):
                t += self._ep(want=None if wsuf is None else (wsuf >> i) & 1) << i
            pos_y = int(rom.MIN_IN_GROUP[pos_y]) + t

        blk_last = pos_x + pos_y * w
        idxs = np.nonzero(scan == blk_last)[0]
        scan_pos_last = int(idxs[0]) if len(idxs) else max_num_coeff - 1

        if tu.mts_idx[comp] != MTS_SKIP and w >= 4 and h >= 4:
            max_lfnst_pos = 7 if ((w == 4 and h == 4) or (w == 8 and h == 8)) else 15
            self.violates_lfnst[ch] |= scan_pos_last > max_lfnst_pos
            self.lfnst_last_scan_pos |= scan_pos_last >= 1
        if ch == 0 and tu.mts_idx[comp] != MTS_SKIP:
            self.mts_last_scan_pos |= scan_pos_last >= 1

        state_trans = DQ_STATE_TRANS_TABLE if self.sh.dep_quant_used else 0
        state = 0
        coeff = np.zeros(max_num_coeff, dtype=np.int64)
        tpl = self._tpl
        tpl[:max_num_coeff] = 0

        sign_hiding = self.sh.sign_data_hiding_used
        reg_bin_limit = (min(32, w) * min(32, h) * 28) >> 4
        bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma

        sig_ctx_base = (_OFF[f"SigFlag[{ch}]"][0], _OFF[f"SigFlag[{ch + 2}]"][0],
                        _OFF[f"SigFlag[{ch + 4}]"][0])
        par_ctx_base = _OFF[f"ParFlag[{ch}]"][0]
        gt1_ctx_base = _OFF[f"GtxFlag[{ch + 2}]"][0]
        gt2_ctx_base = _OFF[f"GtxFlag[{ch}]"][0]
        sig_group_ctx_base = _OFF[f"SigCoeffGroup[{ch}]"][0]

        sig_cg_flags = np.zeros(w_groups * h_groups + w_groups + 1, dtype=bool)
        subset_results = []
        tmpl_cp_diag = -1
        tmpl_cp_sum1 = -1
        max_cg_x = max_cg_y = 0

        # SBT + MTS zero-out: sub-blocks in the zeroed region are skipped
        # entirely (CABACReader.cpp:2414-2425 skipBlkPreCond)
        skip_pre = (ch == 0 and self.sps.mts_enabled and cu.sbt_info != 0
                    and w <= 32 and h <= 32)

        for subset_id in range((scan_pos_last >> log2_cg), -1, -1):
            cg_pos = int(scan_cg[subset_id])
            cg_y = cg_pos // w_groups
            cg_x = cg_pos - cg_y * w_groups
            if skip_pre and ((h == 32 and cg_y >= (16 >> lg_ch))
                             or (w == 32 and cg_x >= (16 >> lg_cw))):
                if enc_flat is not None:
                    assert not any(
                        enc_flat[int(scan[p])] != 0
                        for p in range(subset_id << log2_cg,
                                       (subset_id << log2_cg)
                                       + (1 << log2_cg))), \
                        "encoder produced coefficients in the SBT+MTS " \
                        "zero-out region"
                continue
            min_sub_pos = subset_id << log2_cg
            max_sub_pos = min_sub_pos + (1 << log2_cg) - 1
            is_last_cg = (scan_pos_last >> log2_cg) == subset_id

            sig_group = is_last_cg or min_sub_pos == 0
            if not sig_group:
                sig_right = bool(cg_x + 1 < w_groups and sig_cg_flags[cg_pos + 1])
                sig_lower = bool(cg_y + 1 < h_groups and sig_cg_flags[cg_pos + w_groups])
                inc = int(sig_right or sig_lower)
                want_sg = None
                if enc_flat is not None:
                    want_sg = int(any(enc_flat[int(scan[p])] != 0
                                      for p in range(min_sub_pos, max_sub_pos + 1)))
                sig_group = bool(self._bin(sig_group_ctx_base + inc, want=want_sg))
            if not sig_group:
                continue
            sig_cg_flags[cg_pos] = True
            max_cg_x = max(max_cg_x, cg_x)
            max_cg_y = max(max_cg_y, cg_y)
            if ch == 0 and (cg_x > 3 or cg_y > 3):
                self.violates_mts = True

            first_sig_pos = scan_pos_last if is_last_cg else max_sub_pos
            next_sig_pos = first_sig_pos
            infer_sig_pos = next_sig_pos if next_sig_pos == scan_pos_last else (
                min_sub_pos if subset_id != 0 else -1)
            num_nonzero = 0
            positions: list[int] = []
            sub1_pattern = 0
            gt1_positions: list[int] = []
            gt2_mask = 0
            num_gt1 = 0
            first_nz = next_sig_pos
            last_nz = -1

            while next_sig_pos >= min_sub_pos and reg_bin_limit >= 4:
                blk_pos = int(scan[next_sig_pos])
                want_abs = None if enc_flat is None else abs(int(enc_flat[blk_pos]))
                sig_flag = (num_nonzero == 0 and next_sig_pos == infer_sig_pos)
                if not sig_flag:
                    py = blk_pos >> log2_w
                    px = blk_pos & (w - 1)
                    diag = px + py
                    tpl_val = int(tpl[blk_pos])
                    num_pos = tpl_val >> 5
                    sum_abs = tpl_val & 31
                    ctx_ofs = min((sum_abs + 1) >> 1, 3) + (4 if diag < 2 else 0)
                    if ch == 0:
                        ctx_ofs += 4 if diag < 5 else 0
                    tmpl_cp_diag = diag
                    tmpl_cp_sum1 = sum_abs - num_pos
                    sig_flag = bool(self._bin(
                        sig_ctx_base[max(0, state - 1)] + ctx_ofs,
                        want=None if want_abs is None else int(want_abs > 0)))
                    reg_bin_limit -= 1
                if sig_flag:
                    if tmpl_cp_diag != -1:
                        off = min(tmpl_cp_sum1, 4) + 1
                        if tmpl_cp_diag == 0:
                            off += 15 if ch == 0 else 5
                        elif ch == 0:
                            off += 10 if tmpl_cp_diag < 3 else (5 if tmpl_cp_diag < 10 else 0)
                    else:
                        off = 0
                    sub1_pattern = ((state >> 1) & 1) | (sub1_pattern << 1)
                    positions.append(blk_pos)
                    num_nonzero += 1
                    first_nz = next_sig_pos
                    last_nz = max(last_nz, next_sig_pos)
                    gt1 = self._bin(gt1_ctx_base + off,
                                    want=None if want_abs is None else int(want_abs > 1))
                    reg_bin_limit -= 1
                    if gt1:
                        par = self._bin(par_ctx_base + off,
                                        want=None if want_abs is None else want_abs & 1)
                        num_gt1 += 1
                        reg_bin_limit -= 1
                        gt2 = self._bin(gt2_ctx_base + off,
                                        want=None if want_abs is None else int(want_abs > 3))
                        gt2_mask |= gt2 << (num_gt1 - 1)
                        reg_bin_limit -= 1
                        gt1_positions.append(blk_pos)
                        abs_val = 2 + par + (gt2 << 1)
                        state = (state_trans >> ((state << 2) + (par << 1))) & 3
                    else:
                        abs_val = 1
                        state = (state_trans >> ((state << 2) + 2)) & 3
                    coeff[blk_pos] = abs_val
                    py = blk_pos >> log2_w
                    px = blk_pos & (w - 1)
                    upd = 32 + abs_val
                    if py > 1:
                        tpl[blk_pos - 2 * w] += upd
                    if py > 0 and px > 0:
                        tpl[blk_pos - w - 1] += upd
                    if py > 0:
                        tpl[blk_pos - w] += upd
                    if px > 1:
                        tpl[blk_pos - 2] += upd
                    if px > 0:
                        tpl[blk_pos - 1] += upd
                else:
                    state = (state_trans >> (state << 2)) & 3
                next_sig_pos -= 1

            # 3rd pass: go-rice remainders for gt2 coefficients
            gmask = gt2_mask
            for k in range(num_gt1):
                if gmask & 1:
                    bp = gt1_positions[k]
                    sum_all = self._template_abs_sum(bp, coeff, w, h, log2_w, 4)
                    rice = int(rom.GO_RICE_PARS[sum_all])
                    want_rem = None
                    if enc_flat is not None:
                        want_rem = (abs(int(enc_flat[bp])) - int(coeff[bp])) >> 1
                    rem = self._rem(rice, COEF_REMAIN_BIN_REDUCTION,
                                    self.max_log2_tr_range, want=want_rem)
                    coeff[bp] += rem << 1
                gmask >>= 1

            # bypass coefficients
            while next_sig_pos >= min_sub_pos:
                sub1 = (state >> 1) & 1
                blk_pos = int(scan[next_sig_pos])
                sum_all = self._template_abs_sum(blk_pos, coeff, w, h, log2_w, 0)
                rice = int(rom.GO_RICE_PARS[sum_all])
                pos0 = rom.go_rice_pos_coeff0(state, rice)
                want_rem = None
                if enc_flat is not None:
                    v = abs(int(enc_flat[blk_pos]))
                    want_rem = pos0 if v == 0 else (v - 1 if v <= pos0 else v)
                rem = self._rem(rice, COEF_REMAIN_BIN_REDUCTION,
                                self.max_log2_tr_range, want=want_rem)
                tcoeff = 0 if rem == pos0 else (rem + 1 if rem < pos0 else rem)
                state = (state_trans >> ((state << 2) + ((tcoeff & 1) << 1))) & 3
                if tcoeff:
                    coeff[blk_pos] = tcoeff
                    sub1_pattern = sub1 | (sub1_pattern << 1)
                    positions.append(blk_pos)
                    num_nonzero += 1
                    first_nz = next_sig_pos
                    last_nz = max(last_nz, next_sig_pos)
                next_sig_pos -= 1

            # signs
            hide = sign_hiding and (last_nz - first_nz >= SBH_THRESHOLD) and not bdpcm
            num_signs = num_nonzero - 1 if (hide and num_nonzero > 0) else num_nonzero
            want_signs = None
            if enc_flat is not None:
                want_signs = 0
                for p in positions[:num_signs]:
                    want_signs = (want_signs << 1) | int(enc_flat[p] < 0)
            sign_pattern = self._eps(num_signs, want=want_signs)
            if num_nonzero > num_signs:
                sum_abs_cg = sum(int(coeff[p]) for p in positions)
                sign_pattern = (sign_pattern << 1) + (sum_abs_cg & 1)

            if num_nonzero > 0:
                subset_results.append((num_nonzero, sign_pattern, sub1_pattern,
                                       positions))

        if bdpcm:
            max_x_px, max_y_px = w, h
        else:
            max_x_px = (max_cg_x + 1) << lg_cw
            max_y_px = (max_cg_y + 1) << lg_ch

        dep_quant = self.sh.dep_quant_used and tu.mts_idx[comp] != MTS_SKIP
        plane = self.cs.coef[comp]
        plane[y0:y0 + max_y_px, x0:x0 + max_x_px] = 0
        for num_nonzero, sign_pattern, sub1_pattern, positions in reversed(subset_results):
            for k in range(num_nonzero - 1, -1, -1):
                bp = positions[k]
                px = bp & (w - 1)
                py = bp >> log2_w
                abs_c = int(coeff[bp])
                if dep_quant:
                    abs_c = 2 * abs_c - (sub1_pattern & 1)
                plane[y0 + py, x0 + px] = -abs_c if (sign_pattern & 1) else abs_c
                sign_pattern >>= 1
                sub1_pattern >>= 1

        if scan_pos_last == 0:
            tu.max_scan_x[comp] = 0
            tu.max_scan_y[comp] = 0
        else:
            tu.max_scan_x[comp] = max_x_px - 1
            tu.max_scan_y[comp] = max_y_px - 1

        if enc_flat is not None and not dep_quant and not sign_hiding:
            got = plane[y0:y0 + h, x0:x0 + w]
            assert np.array_equal(got, enc_block.astype(plane.dtype)), \
                "encoder produced coefficients that do not round-trip"

    def residual_coding_ts(self, tu: TransformUnit, cu: CodingUnit, comp: int,
                           enc_block: np.ndarray | None = None) -> None:
        """Transform-skip residual coding (parity: CABACReader::
        residual_codingTS :2863, residual_coding_subblockTS :2900)."""
        ch = 0 if comp == 0 else 1
        x0, y0, w, h = tu.blocks[comp]
        log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
        lg_cw, lg_ch = rom.log2_sbb_size(log2_w, log2_h)
        log2_cg = lg_cw + lg_ch
        w_groups = w >> lg_cw
        h_groups = h >> lg_ch
        scan = rom.scan_grouped(w, h)
        scan_cg = rom.scan_cg(w_groups, h_groups)
        max_num_coeff = w * h
        bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma

        coeff = np.zeros(max_num_coeff, dtype=np.int64)
        num_ctx_bins = (max_num_coeff * 7) >> 2
        max_x = max_y = 0
        sig_cg_flags = np.zeros(w_groups * h_groups + w_groups + 1, dtype=bool)
        any_sig_group = False
        last_subset = (max_num_coeff - 1) >> log2_cg

        coded = None
        if enc_block is not None:
            # precompute coded (level-mapped) values from the true levels
            flat = enc_block.reshape(-1).astype(np.int64)
            coded = np.zeros(max_num_coeff, dtype=np.int64)
            for p in range(max_num_coeff):
                py, px = p >> log2_w, p & (w - 1)
                v = abs(int(flat[p]))
                if bdpcm or v == 0:
                    coded[p] = v
                    continue
                right = abs(int(flat[p - 1])) if px > 0 else 0
                below = abs(int(flat[p - w])) if py > 0 else 0
                pred1 = max(right, below)
                if v == pred1:
                    coded[p] = 1
                elif v < pred1:
                    coded[p] = v + 1
                else:
                    coded[p] = v

        tsig = _OFF["TsSigFlag"][0]
        tsign = _OFF["TsResidualSign"][0]
        tlrg1 = _OFF["TsLrg1Flag"][0]
        tpar = _OFF["TsParFlag"][0]
        tgtx = _OFF["TsGtxFlag"][0]
        tsg = _OFF["TsSigCoeffGroup"][0]

        plane = self.cs.coef[comp]
        plane[y0:y0 + h, x0:x0 + w] = 0

        for subset_id in range(last_subset + 1):
            cg_pos = int(scan_cg[subset_id])
            cg_y = cg_pos // w_groups
            cg_x = cg_pos - cg_y * w_groups
            min_pos = subset_id << log2_cg
            max_pos = min_pos + (1 << log2_cg) - 1

            sig_group = (subset_id == last_subset) and not any_sig_group
            if not sig_group:
                sig_left = bool(cg_x > 0 and sig_cg_flags[cg_pos - 1])
                sig_above = bool(cg_y > 0 and sig_cg_flags[cg_pos - w_groups])
                want_sg = None
                if coded is not None:
                    want_sg = int(any(coded[int(scan[p])] != 0
                                      for p in range(min_pos, max_pos + 1)))
                sig_group = bool(self._bin(tsg + sig_left + sig_above, want=want_sg))
            if not sig_group:
                continue
            sig_cg_flags[cg_pos] = True
            any_sig_group = True

            infer_sig_pos = max_pos
            num_nonzero = 0
            sig_blk_pos: list[int] = []
            sign_pattern = 0
            last_pass1 = -1
            last_pass2 = -1

            next_pos = min_pos
            while next_pos <= max_pos and num_ctx_bins >= 4:
                blk = int(scan[next_pos])
                py, px = blk >> log2_w, blk & (w - 1)
                want_c = None if coded is None else int(coded[blk])
                sig = (num_nonzero == 0 and next_pos == infer_sig_pos)
                if not sig:
                    npos = int(px > 0 and coeff[blk - 1] != 0) + \
                        int(py > 0 and coeff[blk - w] != 0)
                    sig = bool(self._bin(tsig + npos,
                                         want=None if want_c is None
                                         else int(want_c != 0)))
                    num_ctx_bins -= 1
                if sig:
                    right = int(coeff[blk - 1]) if px > 0 else 0
                    below = int(coeff[blk - w]) if py > 0 else 0
                    if (right == 0 and below == 0) or right * below < 0:
                        sctx = 0
                    elif right >= 0 and below >= 0:
                        sctx = 1
                    else:
                        sctx = 2
                    if bdpcm:
                        sctx += 3
                    want_sign = None
                    if coded is not None:
                        want_sign = int(enc_block.reshape(-1)[blk] < 0)
                    sign = self._bin(tsign + sctx, want=want_sign)
                    num_ctx_bins -= 1
                    sign_pattern += sign << num_nonzero
                    sig_blk_pos.append(blk)
                    num_nonzero += 1
                    if bdpcm:
                        nlrg = 3
                    else:
                        nlrg = int(px > 0 and coeff[blk - 1] != 0) + \
                            int(py > 0 and coeff[blk - w] != 0)
                    gt1 = self._bin(tlrg1 + nlrg,
                                    want=None if want_c is None
                                    else int(want_c > 1))
                    num_ctx_bins -= 1
                    par = 0
                    if gt1:
                        # after pass 1 the working value is 1+gt1+par; the
                        # final coded value keeps that parity (pass 2/3 add
                        # multiples of 2), so par = coded & 1
                        par = self._bin(tpar, want=None if want_c is None
                                        else int(want_c & 1))
                        num_ctx_bins -= 1
                    coeff[blk] = (-1 if sign else 1) * (1 + par + gt1)
                last_pass1 = next_pos
                next_pos += 1

            # pass 2: greater-x bins
            pos = min_pos
            while pos <= max_pos and num_ctx_bins >= 4:
                blk = int(scan[pos])
                cutoff = 2
                if coeff[blk] < 0:
                    coeff[blk] = -coeff[blk]
                for i in range(4):
                    if coeff[blk] >= cutoff:
                        want_g = None
                        if coded is not None:
                            want_g = int(coded[blk] > coeff[blk] + 1)
                        g = self._bin(tgtx + (cutoff >> 1), want=want_g)
                        coeff[blk] += g << 1
                        num_ctx_bins -= 1
                    cutoff += 2
                last_pass2 = pos
                pos += 1

            # pass 3: remainders
            for pos in range(min_pos, max_pos + 1):
                blk = int(scan[pos])
                cutoff = 10 if pos <= last_pass2 else (2 if pos <= last_pass1 else 0)
                if coeff[blk] < 0:
                    coeff[blk] = -coeff[blk]
                if coeff[blk] >= cutoff:
                    rice = 1  # templateAbsSumTS
                    want_rem = None
                    if coded is not None:
                        if pos <= last_pass1:
                            want_rem = (int(coded[blk]) - int(coeff[blk])) >> 1
                        else:
                            # bypass-coded positions carry the RAW absolute
                            # level (no level mapping applies there)
                            want_rem = abs(int(enc_block.reshape(-1)[blk]))
                    rem = self._rem(rice, COEF_REMAIN_BIN_REDUCTION,
                                    self.max_log2_tr_range, want=want_rem)
                    coeff[blk] += (rem << 1) if pos <= last_pass1 else rem
                    if coeff[blk] and pos > last_pass1:
                        want_sign = None
                        if coded is not None:
                            want_sign = int(enc_block.reshape(-1)[blk] < 0)
                        sign = self._ep(want=want_sign)
                        sign_pattern += sign << num_nonzero
                        sig_blk_pos.append(blk)
                        num_nonzero += 1
                if not bdpcm and cutoff:
                    if coeff[blk] > 0:
                        py, px = blk >> log2_w, blk & (w - 1)
                        right = abs(int(coeff[blk - 1])) if px > 0 else 0
                        below = abs(int(coeff[blk - w])) if py > 0 else 0
                        pred1 = max(right, below)
                        v = int(coeff[blk])
                        if v == 1 and pred1 > 0:
                            coeff[blk] = pred1
                        else:
                            coeff[blk] = v - (v <= pred1)

            # final signs
            for k, blk in enumerate(sig_blk_pos):
                val = int(coeff[blk])
                if (sign_pattern >> k) & 1:
                    val = -val
                coeff[blk] = val
                py, px = blk >> log2_w, blk & (w - 1)
                max_x = max(max_x, px)
                max_y = max(max_y, py)
                plane[y0 + py, x0 + px] = val

        if bdpcm:
            tu.max_scan_x[comp] = w
            tu.max_scan_y[comp] = h
        else:
            tu.max_scan_x[comp] = max_x
            tu.max_scan_y[comp] = max_y

        if enc_block is not None and not bdpcm:
            got = plane[y0:y0 + h, x0:x0 + w]
            assert np.array_equal(got, enc_block.astype(plane.dtype)), \
                "TS encoder round-trip failed"

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _residual_args(w: int, h: int, ch: int, max_log2_tr_range: int):
        """Constant decode_residual arguments for one TU shape class
        (context offsets, scan tables as bytes)."""
        log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
        lg_cw, lg_ch = rom.log2_sbb_size(log2_w, log2_h)
        scan = rom.scan_grouped(w, h)
        w_groups = min(rom.ZERO_OUT_TH, w) >> lg_cw
        h_groups = min(rom.ZERO_OUT_TH, h) >> lg_ch
        scan_cg = rom.scan_cg(w_groups, h_groups)
        max_last_x = int(rom.GROUP_IDX[min(rom.ZERO_OUT_TH, w) - 1])
        max_last_y = int(rom.GROUP_IDX[min(rom.ZERO_OUT_TH, h) - 1])
        if ch == 0:
            last_off_x = rom.LAST_PREFIX_CTX[log2_w]
            last_off_y = rom.LAST_PREFIX_CTX[log2_h]
            last_shift_x = (log2_w + 1) >> 2
            last_shift_y = (log2_h + 1) >> 2
        else:
            last_off_x = last_off_y = 0
            last_shift_x = max(0, min(2, w >> 3))
            last_shift_y = max(0, min(2, h >> 3))
        head = (w, h, ch, lg_cw, lg_ch,
                _OFF[f"LastX[{ch}]"][0] + last_off_x,
                _OFF[f"LastY[{ch}]"][0] + last_off_y,
                last_shift_x, last_shift_y, max_last_x, max_last_y,
                _OFF[f"SigFlag[{ch}]"][0], _OFF[f"SigFlag[{ch + 2}]"][0],
                _OFF[f"SigFlag[{ch + 4}]"][0], _OFF[f"ParFlag[{ch}]"][0],
                _OFF[f"GtxFlag[{ch + 2}]"][0], _OFF[f"GtxFlag[{ch}]"][0],
                _OFF[f"SigCoeffGroup[{ch}]"][0])
        return head, scan.tobytes(), scan_cg.tobytes(), lg_cw, lg_ch

    def _residual_native(self, tu: TransformUnit, cu: CodingUnit,
                         comp: int) -> None:
        """Regular residual coding via the native engine
        (Decoder.decode_residual in refdec/native/cabac.c)."""
        ch = 0 if comp == 0 else 1
        x0, y0, w, h = tu.blocks[comp]
        head, scan_b, scan_cg_b, lg_cw, lg_ch = self._residual_args(
            w, h, ch, self.max_log2_tr_range)
        bdpcm = cu.bdpcm_mode if comp == 0 else cu.bdpcm_mode_chroma
        state_trans = DQ_STATE_TRANS_TABLE if self.sh.dep_quant_used else 0
        # dep-quant writeback is gated on mts != MTS_SKIP
        # (CABACReader.cpp:2460); the state machine still runs
        dep_quant_out = int(self.sh.dep_quant_used
                            and tu.mts_idx[comp] != MTS_SKIP)
        # SBT + MTS zero-out precondition (CABACReader.cpp:2414-2425)
        skip_pre = int(ch == 0 and self.sps.mts_enabled and cu.sbt_info != 0
                       and w <= 32 and h <= 32)

        out = np.zeros(w * h, dtype=np.int32)
        scan_pos_last, max_cg_x, max_cg_y = self.dec._d.decode_residual(
            *head,
            state_trans, int(self.sh.sign_data_hiding_used), int(bool(bdpcm)),
            self.max_log2_tr_range, dep_quant_out, skip_pre,
            scan_b, scan_cg_b, out)

        if tu.mts_idx[comp] != MTS_SKIP and w >= 4 and h >= 4:
            max_lfnst_pos = 7 if ((w == 4 and h == 4)
                                  or (w == 8 and h == 8)) else 15
            self.violates_lfnst[ch] |= scan_pos_last > max_lfnst_pos
            self.lfnst_last_scan_pos |= scan_pos_last >= 1
        if ch == 0 and tu.mts_idx[comp] != MTS_SKIP:
            self.mts_last_scan_pos |= scan_pos_last >= 1
        if ch == 0 and (max_cg_x > 3 or max_cg_y > 3):
            self.violates_mts = True

        if bdpcm:
            max_x_px, max_y_px = w, h
        else:
            max_x_px = (max_cg_x + 1) << lg_cw
            max_y_px = (max_cg_y + 1) << lg_ch
        plane = self.cs.coef[comp]
        blk = out.reshape(h, w)
        plane[y0:y0 + max_y_px, x0:x0 + max_x_px] = \
            blk[:max_y_px, :max_x_px]
        if scan_pos_last == 0:
            tu.max_scan_x[comp] = 0
            tu.max_scan_y[comp] = 0
        else:
            tu.max_scan_x[comp] = max_x_px - 1
            tu.max_scan_y[comp] = max_y_px - 1

    def _last_prefix(self, ctx_base: int, shift: int, max_val: int,
                     want: int | None) -> int:
        pos = 0
        if self.enc is None:
            while pos < max_val and self.dec.decode_bin(ctx_base + (pos >> shift)):
                pos += 1
            return pos
        for pos in range(want):
            self.enc.encode_bin(1, ctx_base + (pos >> shift))
        if want < max_val:
            self.enc.encode_bin(0, ctx_base + (want >> shift))
        return want

    @staticmethod
    def _template_abs_sum(blk_pos: int, coeff: np.ndarray, w: int, h: int,
                          log2_w: int, base_level: int) -> int:
        py = blk_pos >> log2_w
        px = blk_pos & (w - 1)
        s = 0
        if px + 2 < w:
            s += int(coeff[blk_pos + 1]) + int(coeff[blk_pos + 2])
            if py + 1 < h:
                s += int(coeff[blk_pos + w + 1])
        elif px + 1 < w:
            s += int(coeff[blk_pos + 1])
            if py + 1 < h:
                s += int(coeff[blk_pos + w + 1])
        if py + 2 < h:
            s += int(coeff[blk_pos + w]) + int(coeff[blk_pos + 2 * w])
        elif py + 1 < h:
            s += int(coeff[blk_pos + w])
        return max(min(s - 5 * base_level, 31), 0)

    # ---------------- helpers ----------------
    def unary_max_symbol(self, ctx_id0: int, ctx_idn: int, max_symbol: int,
                         want: int | None = None) -> int:
        if self.enc is None:
            ones = 0
            while ones < max_symbol and self.dec.decode_bin(
                    ctx_id0 if ones == 0 else ctx_idn):
                ones += 1
            return ones
        for i in range(want):
            self.enc.encode_bin(1, ctx_id0 if i == 0 else ctx_idn)
        if want < max_symbol:
            self.enc.encode_bin(0, ctx_id0 if want == 0 else ctx_idn)
        return want

    def exp_golomb_eqprob(self, count: int, want: int | None = None) -> int:
        if self.enc is None:
            symbol = 0
            bit = 1
            while bit:
                bit = self.dec.decode_bin_ep()
                symbol += bit << count
                count += 1
            count -= 1
            if count:
                symbol += self.dec.decode_bins_ep(count)
            return symbol
        # encode: unary prefix of k ones then 0; suffix of (count + k) bits?
        # dual of the decode loop: symbol accumulates bit<<count with count
        # incrementing per 1-bit, then a (count-1)-bit suffix.
        k = count
        base = 0
        while want >= base + (1 << k):
            base += 1 << k
            k += 1
        # emit (k - count) ones then a zero
        for _ in range(k - count):
            self.enc.encode_bin_ep(1)
        self.enc.encode_bin_ep(0)
        if k:
            self.enc.encode_bins_ep(want - base, k)
        return want

    # SAO / ALF CTU syntax (later rounds)
    def unary_max_eqprob(self, max_symbol: int, want: int | None = None) -> int:
        """EP-coded truncated unary (CABACReader::unary_max_eqprob :3078)."""
        if self.enc is not None:
            v = min(want, max_symbol)
            for k in range(v):
                self._ep(want=1)
            if v < max_symbol:
                self._ep(want=0)
            return v
        for k in range(max_symbol):
            if not self._ep():
                return k
        return max_symbol

    def sao_ctu(self, cx: int, cy: int) -> None:
        """SAO CTU parameters (parity: CABACReader::sao, CABACReader.cpp:855).
        Params are merge-resolved immediately (raster parse order)."""
        cs = self.cs
        w_ctu = self.pps.pic_width_in_ctu
        rx, ry = cx // self.sps.ctu_size, cy // self.sps.ctu_size
        addr = ry * w_ctu + rx
        params = [{"mode": 0, "type": 0, "offsets": None, "band": 0}
                  for _ in range(3)]
        cs.sao_params[addr] = params
        luma_on = self.sh.sao_enabled_luma
        chroma_on = self.sh.sao_enabled_chroma and cs.num_comp > 1
        if not luma_on and not chroma_on:
            return

        want = None
        if self.enc is not None:
            want = self.decisions.sao(cx, cy, luma_on, chroma_on, self)

        left_ok = rx > 0 and self._sao_nb_avail(cx - 1, cy, cx, cy)
        above_ok = ry > 0 and self._sao_nb_avail(cx, cy - 1, cx, cy)
        merge = -1
        if left_ok:
            w = None if want is None else int(want.get("merge") == 0)
            merge += self._bin(ctx("SaoMergeFlag"), want=w)
        if merge < 0 and above_ok:
            w = None if want is None else int(want.get("merge") == 1)
            merge += self._bin(ctx("SaoMergeFlag"), want=w) << 1
        if merge >= 0:
            src_addr = addr - 1 if merge == 0 else addr - w_ctu
            src = cs.sao_params[src_addr]
            for c in range(3):
                if (c == 0 and luma_on) or (c > 0 and chroma_on):
                    params[c] = dict(src[c])
            return

        max_q = (1 << (min(self.sps.bit_depth, 10) - 5)) - 1
        for comp in (list(range(0, 1)) if not chroma_on else
                     (list(range(0, 3)) if luma_on else [1, 2])):
            p = params[comp]
            if comp != 2:
                w = None if want is None else int(want["mode"][comp] != 0)
                if self._bin(ctx("SaoTypeIdx"), want=w):
                    p["mode"] = 1
                    we = None if want is None else int(want["mode"][comp] == 1)
                    p["type"] = 0 if self._ep(want=we) else 4
            else:
                p["mode"] = params[1]["mode"]
                p["type"] = params[1]["type"]
            if p["mode"] == 0:
                continue
            offs = []
            for k in range(4):
                wo = None if want is None else abs(int(want["offsets"][comp][k]))
                offs.append(self.unary_max_eqprob(max_q, want=wo))
            if p["type"] == 4:  # band offset
                for k in range(4):
                    if offs[k]:
                        ws = None if want is None else \
                            int(want["offsets"][comp][k] < 0)
                        if self._ep(want=ws):
                            offs[k] = -offs[k]
                wb = None if want is None else int(want["band"][comp])
                p["band"] = self._eps(5, want=wb)
                table = np.zeros(32, dtype=np.int32)
                for k in range(4):
                    table[(p["band"] + k) % 32] = offs[k]
                p["offsets"] = table
            else:  # edge offset
                if comp != 2:
                    wc = None if want is None else int(want["eo_class"][comp])
                    p["type"] = self._eps(2, want=wc)
                else:
                    p["type"] = params[1]["type"]
                p["offsets"] = np.array(
                    [offs[0], offs[1], 0, -offs[2], -offs[3]], dtype=np.int32)

    def _sao_nb_avail(self, nx: int, ny: int, cx: int, cy: int) -> bool:
        """Neighbor CTU usable as SAO merge source (getCURestricted on the
        CTU position: parsed, same slice, same tile)."""
        cs = self.cs
        if nx < 0 or ny < 0:
            return False
        cu = cs.cu_at(nx, ny, 0)
        if cu is None:
            return False
        return (cu.slice_idx == self.slice_idx
                and self._tile_at(nx, ny) == self._tile_at(cx, cy))

    def alf_ctu(self, cx: int, cy: int) -> None:
        """ALF/CC-ALF CTU parameters (parity: CABACReader::readAlf,
        CABACReader.cpp:391; readAlfCtuFilterIndex :217)."""
        cs = self.cs
        sh = self.sh
        w_ctu = self.pps.pic_width_in_ctu
        rx, ry = cx // self.sps.ctu_size, cy // self.sps.ctu_size
        addr = ry * w_ctu + rx
        cur = {"enable": [0, 0, 0], "filt_idx": 0, "alt": [0, 0],
               "cc": [0, 0]}
        cs.alf_params[addr] = cur
        zero = {"enable": [0, 0, 0], "cc": [0, 0]}
        left = cs.alf_params[addr - 1] \
            if (rx > 0 and self._sao_nb_avail(cx - 1, cy, cx, cy)) else zero
        above = cs.alf_params[addr - w_ctu] \
            if (ry > 0 and self._sao_nb_avail(cx, cy - 1, cx, cy)) else zero

        want = None
        if self.enc is not None:
            want = self.decisions.alf(cx, cy, self)

        if sh.alf_enabled[0]:
            for comp in range(3 if cs.num_comp > 1 else 1):
                if not sh.alf_enabled[comp]:
                    continue
                ctx_inc = (left["enable"][comp] & 1) \
                    + (above["enable"][comp] & 1)
                w = None if want is None else int(want["enable"][comp])
                cur["enable"][comp] = self._bin(
                    ctx("ctbAlfFlag", comp * 3 + ctx_inc), want=w)
                if comp == 0 and cur["enable"][0]:
                    cur["filt_idx"] = self._alf_filter_idx(want)
                if comp > 0 and cur["enable"][comp]:
                    aps = cs.alf_apss[sh.alf_aps_id_chroma]
                    n_alts = aps.alf.num_alternatives_chroma
                    decoded = 0
                    wa = None if want is None else \
                        min(want["alt"][comp - 1], n_alts - 1)
                    while decoded < n_alts - 1 and self._bin(
                            ctx("ctbAlfAlternative", comp - 1),
                            want=None if wa is None else int(wa > decoded)):
                        decoded += 1
                    cur["alt"][comp - 1] = decoded
        for comp in range(1, cs.num_comp):
            cc_on = sh.ccalf_cb_enabled if comp == 1 else sh.ccalf_cr_enabled
            if not cc_on:
                continue
            ctx_inc = (1 if left["cc"][comp - 1] else 0) \
                + (1 if above["cc"][comp - 1] else 0) \
                + (3 if comp == 2 else 0)
            aps_id = sh.ccalf_cb_aps_id if comp == 1 else sh.ccalf_cr_aps_id
            count = cs.alf_apss[aps_id].cc_alf.filter_count[comp - 1]
            wc = None if want is None else min(want["cc"][comp - 1], count)
            idc = self._bin(ctx("CcAlfFilterControlFlag", ctx_inc),
                            want=None if wc is None else int(wc > 0))
            if idc:
                while idc != count and self._ep(
                        want=None if wc is None else int(wc > idc)):
                    idc += 1
            cur["cc"][comp - 1] = idc

    def _alf_filter_idx(self, want) -> int:
        """readAlfCtuFilterIndex (CABACReader.cpp:217)."""
        sh = self.sh
        num_aps = sh.num_alf_aps_ids_luma
        w_idx = None if want is None else want["filt_idx"]
        use_prev = False
        if num_aps > 0:
            wp = None if w_idx is None else int(w_idx >= 16)
            use_prev = bool(self._bin(ctx("AlfUseTemporalFilt"), want=wp))
        if use_prev:
            idx = 0
            if num_aps > 1:
                idx = self.trunc_bin(num_aps,
                                     want=None if w_idx is None
                                     else min(w_idx - 16, num_aps - 1))
            return idx + 16
        return self.trunc_bin(16, want=None if w_idx is None
                              else min(w_idx, 15))
