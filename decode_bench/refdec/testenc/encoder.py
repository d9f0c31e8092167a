"""Test bitstream generator: produces legal constrained VVC Main10 streams.

Builds SPS/PPS/slice-header via hls_writer and slice data via the dual-mode
CtuDecoder running in encode mode with randomized decisions (partitioning,
intra modes, coefficient levels).  Streams are decodable by the reference
vvdec binary, which pins our writer to the standard; our decoder must then
match vvdec's output bit-exactly.
"""

from __future__ import annotations

import random

import numpy as np

from refdec.bitstream.nal import NalUnitType
from refdec.cabac.ctu_decoder import CtuDecoder, Decisions, ctx
from refdec.cabac.engine import CabacEncoder
from refdec.cabac.partitioner import (
    CU_DONT_SPLIT,
    CU_HORZ_SPLIT,
    CU_QUAD_SPLIT,
    CU_TRIH_SPLIT,
    CU_TRIV_SPLIT,
    CU_VERT_SPLIT,
)
from refdec.frame.structure import (
    CodingStructure,
    DC_IDX,
    DM_CHROMA_IDX,
    HOR_IDX,
    PLANAR_IDX,
    VER_IDX,
)
from refdec.hls.params import (
    SPS, PPS, ChromaQpTable, B_SLICE, I_SLICE, P_SLICE, PicHeader,
    RefPicEntry, RefPicList, SliceHeader,
)
from refdec.testenc.bitwriter import BitWriter
from refdec.testenc.hls_writer import (
    make_nal,
    write_pps,
    write_slice_header,
    write_sps,
)


def make_sps(width: int, height: int, ctu: int = 32, bit_depth: int = 10,
             chroma_format: int = 1, **kw) -> SPS:
    sps = SPS()
    sps.pic_width_max = width
    sps.pic_height_max = height
    sps.ctu_size = ctu
    sps.chroma_format_idc = chroma_format
    # 4:2:2 / 4:4:4 need the Main 10 4:4:4 profile (TypeDef.h:441)
    sps.ptl.profile_idc = 33 if chroma_format >= 2 else 1
    sps.ptl.level_idc = 35
    sps.bit_depth = bit_depth
    sps.max_dec_pic_buffering = [8]
    sps.num_reorder_pics = [0]
    sps.max_latency_increase_plus1 = [0]
    sps.log2_min_cb_size = 2
    # default: allow QT down to 8, BT/TT depth 2 (chroma entries [2] stay 0
    # unless dual-tree — mirrors the parser's inference)
    sps.min_qt_size = [8, 8, 0]
    sps.max_mtt_depth = [2, 2, 0]
    sps.max_bt_size = [min(32, ctu), min(32, ctu), 0]
    sps.max_tt_size = [min(32, ctu), min(32, ctu), 0]
    sps.log2_max_tb_size = 5 if ctu <= 32 else 6
    for k, v in kw.items():
        setattr(sps, k, v)
    if sps.num_subpics > 1:
        sps.subpic_info_present = True
        if not sps.subpic_ids:
            sps.subpic_ids = list(range(sps.num_subpics))
        if sps.subpic_id_len <= 0:
            sps.subpic_id_len = max(1, (sps.num_subpics - 1).bit_length())
        if not sps.subpic_treated_as_pic:
            sps.subpic_treated_as_pic = [True] * sps.num_subpics
        if not sps.loop_filter_across_subpic:
            sps.loop_filter_across_subpic = [False] * sps.num_subpics
    sps.chroma_qp_table = ChromaQpTable.default(sps.qp_bd_offset)
    return sps


def make_pps(sps: SPS, **kw) -> PPS:
    pps = PPS()
    pps.pic_width = sps.pic_width_max
    pps.pic_height = sps.pic_height_max
    for k, v in kw.items():
        setattr(pps, k, v)
    pps.finalize(sps)
    return pps


class RandomDecisions(Decisions):
    """Seeded random encode decisions for stream generation."""

    def __init__(self, seed: int = 0, split_prob: float = 0.4,
                 cbf_prob: float = 0.7, max_level: int = 40,
                 modes: list[int] | None = None,
                 density: float = 0.25, qp_delta_range: int = 0,
                 mrl_prob: float = 0.0, isp_prob: float = 0.0,
                 mip_prob: float = 0.0, jccr_prob: float = 0.0,
                 sao_prob: float = 0.0, inter_prob: float = 0.0,
                 skip_prob: float = 0.0, bi_prob: float = 0.0,
                 mv_range: int = 32, smvd_prob: float = 0.0,
                 mmvd_prob: float = 0.0, amvr_prob: float = 0.0,
                 bcw_prob: float = 0.0, ciip_prob: float = 0.0,
                 sbt_prob: float = 0.0, geo_prob: float = 0.0,
                 max_gpm_cand: int = 2, affine_prob: float = 0.0,
                 affine_merge_prob: float = 0.0, affine_6p_prob: float = 0.5,
                 affine_imv_prob: float = 0.0, aff_mv_range: int = 16,
                 ibc_prob: float = 0.0, act_prob: float = 0.0):
        self.rnd = random.Random(seed)
        self.split_prob = split_prob
        self.cbf_prob = cbf_prob
        self.max_level = max_level
        self.density = density
        self.modes = modes  # None -> any of 0..66
        self.qp_delta_range = qp_delta_range
        self.mrl_prob = mrl_prob
        self.isp_prob = isp_prob
        self.mip_prob = mip_prob
        self.jccr_prob = jccr_prob
        self.sao_prob = sao_prob
        self.inter_prob = inter_prob
        self.skip_prob = skip_prob
        self.bi_prob = bi_prob
        self.mv_range = mv_range
        self.smvd_prob = smvd_prob
        self.mmvd_prob = mmvd_prob
        self.amvr_prob = amvr_prob
        self.bcw_prob = bcw_prob
        self.ciip_prob = ciip_prob
        self.sbt_prob = sbt_prob
        self.geo_prob = geo_prob
        self.max_gpm_cand = max_gpm_cand
        self.affine_prob = affine_prob
        self.affine_merge_prob = affine_merge_prob
        self.affine_6p_prob = affine_6p_prob
        self.affine_imv_prob = affine_imv_prob
        self.aff_mv_range = aff_mv_range
        self.ibc_prob = ibc_prob
        self.act_prob = act_prob
        self._ibc_plans = {}

    def split(self, node, allowed):
        choices = [s for s in (CU_QUAD_SPLIT, CU_HORZ_SPLIT, CU_VERT_SPLIT,
                               CU_TRIH_SPLIT, CU_TRIV_SPLIT) if allowed.get(s)]
        if allowed.get(CU_DONT_SPLIT) and (not choices
                                           or self.rnd.random() > self.split_prob):
            return CU_DONT_SPLIT
        if not choices:
            return CU_DONT_SPLIT
        return self.rnd.choice(choices)

    def intra_luma_mode(self, cu, mpm):
        if cu.multi_ref_idx:
            return self.rnd.choice(mpm[1:])
        if self.modes is not None:
            return self.rnd.choice(self.modes)
        return self.rnd.randrange(0, 67)

    def cu_skip(self, cu):
        return self.rnd.random() < getattr(self, "skip_prob", 0)

    def pred_mode(self, cu):
        from refdec.frame.structure import MODE_INTER, MODE_INTRA
        if self.rnd.random() < getattr(self, "inter_prob", 0):
            return MODE_INTER
        return MODE_INTRA

    def merge_flag(self, cu):
        from refdec.frame.structure import MODE_IBC
        if cu.pred_mode == MODE_IBC:
            plan = self._ibc_plans.get((cu.x, cu.y, cu.w, cu.h))
            return plan is not None and plan["mode"] == "merge"
        return self.rnd.random() < 0.4

    # ---- IBC planning: pick modes/BVs that reference coded samples ----
    def _plan_ibc(self, cu, coder):
        if not hasattr(self, "_ibc_plans"):
            self._ibc_plans = {}
        key = (cu.x, cu.y, cu.w, cu.h)
        if key in self._ibc_plans:
            return self._ibc_plans[key]
        plan = None
        r = self.rnd
        if r.random() < getattr(self, "ibc_prob", 0):
            merge_ok = coder.ibc_valid_merge_indices(cu)
            bvs = []
            cand = [(-cu.w, 0), (0, -cu.h), (-cu.w, -cu.h),
                    (-2 * cu.w, 0), (0, -2 * cu.h), (-cu.w * 3, 0)]
            for _ in range(4):
                cand.append((-r.randrange(0, 65), -r.randrange(0, 65)))
            for bv in cand:
                if coder.ibc_bv_valid(cu, bv[0], bv[1]):
                    bvs.append(bv)
            if merge_ok and (not bvs or r.random() < 0.5):
                plan = {"mode": "merge", "merge_idx": r.choice(merge_ok),
                        "skip": r.random() < 0.5}
            elif bvs:
                bv = r.choice(bvs)
                pred = coder.ibc_mvp(cu)[0]
                plan = {"mode": "amvp", "skip": False,
                        "mvd": [((bv[0] << 4) - pred[0]) >> 4,
                                ((bv[1] << 4) - pred[1]) >> 4]}
        self._ibc_plans[key] = plan
        return plan

    def ibc(self, cu, coder):
        return self._plan_ibc(cu, coder) is not None

    def ibc_skip(self, cu, coder):
        if not coder.is_intra_slice:
            return False
        plan = self._plan_ibc(cu, coder)
        return plan is not None and plan["mode"] == "merge" and plan["skip"]

    def ibc_merge_idx(self, cu, coder):
        plan = self._ibc_plans.get((cu.x, cu.y, cu.w, cu.h))
        return plan["merge_idx"] if plan else 0

    def merge_idx(self, cu, n_cands):
        return self.rnd.randrange(n_cands)

    def inter_dir(self, cu):
        if getattr(self, "bi_prob", 0) and self.rnd.random() < self.bi_prob:
            return 3
        return self.rnd.choice([1, 2]) if getattr(self, "bi_prob", 0) else 1

    def ref_idx(self, cu, lst, num_ref):
        return self.rnd.randrange(max(1, num_ref))

    def mvd(self, cu, lst):
        from refdec.frame.structure import MODE_IBC
        if cu.pred_mode == MODE_IBC:
            return list(self._ibc_plans[(cu.x, cu.y, cu.w, cu.h)]["mvd"])
        r = getattr(self, "mv_range", 32)
        return [self.rnd.randint(-r, r), self.rnd.randint(-r, r)]

    def mvp_idx(self, cu, lst):
        from refdec.frame.structure import MODE_IBC
        if cu.pred_mode == MODE_IBC:
            return 0  # IBC AMVP plans its BV against predictor 0
        return self.rnd.randrange(2)

    def root_cbf(self, cu):
        return self.rnd.random() < self.cbf_prob

    def act_flag(self, cu):
        return self.rnd.random() < self.act_prob

    def smvd(self, cu):
        return self.rnd.random() < getattr(self, "smvd_prob", 0)

    def affine(self, cu):
        return self.rnd.random() < getattr(self, "affine_prob", 0)

    def affine_type(self, cu):
        return int(self.rnd.random() < getattr(self, "affine_6p_prob", 0.5))

    def subblock_merge(self, cu):
        return self.rnd.random() < getattr(self, "affine_merge_prob", 0)

    def affine_imv(self, cu):
        if not getattr(self, "affine_imv_prob", 0) or \
                self.rnd.random() >= self.affine_imv_prob:
            return 0
        return self.rnd.choice([1, 2])

    def merge_kind(self, cu, ciip_ok, geo_ok):
        r = self.rnd.random()
        gp = getattr(self, "geo_prob", 0) if geo_ok else 0
        cp = getattr(self, "ciip_prob", 0) if ciip_ok else 0
        if r < gp:
            return "geo"
        if r < gp + cp:
            return "ciip"
        return "regular"

    def geo(self, cu):
        n = 2  # candidates constrained by caller clamping
        c0 = self.rnd.randrange(self.max_gpm_cand)
        c1 = self.rnd.randrange(self.max_gpm_cand)
        if c1 == c0:
            c1 = (c0 + 1) % self.max_gpm_cand
        return self.rnd.randrange(64), c0, c1

    def sbt(self, cu):
        if not getattr(self, "sbt_prob", 0) or \
                self.rnd.random() >= self.sbt_prob:
            return 0, 0
        return self.rnd.randint(1, 4), self.rnd.randrange(2)

    def mmvd(self, cu):
        return self.rnd.random() < getattr(self, "mmvd_prob", 0)

    def mmvd_idx(self, cu):
        return (self.rnd.randrange(2), self.rnd.randrange(8),
                self.rnd.randrange(4))

    def imv(self, cu):
        from refdec.frame.structure import MODE_IBC
        if cu.pred_mode == MODE_IBC:
            return 1  # integer-pel BVs
        if not getattr(self, "amvr_prob", 0) or \
                self.rnd.random() >= self.amvr_prob:
            return 0
        return self.rnd.choice([1, 2, 3])

    def bcw_idx(self, cu):
        if not getattr(self, "bcw_prob", 0) or \
                self.rnd.random() >= self.bcw_prob:
            return 0
        return self.rnd.randrange(3)

    def sao(self, cx, cy, luma_on, chroma_on, coder):
        prob = getattr(self, "sao_prob", 0)
        r = self.rnd
        out = {"merge": -1, "mode": [0, 0, 0],
               "offsets": [[0] * 4 for _ in range(3)],
               "band": [0] * 3, "eo_class": [0] * 3}
        if not prob:
            return out
        if (cx or cy) and r.random() < 0.3:
            out["merge"] = r.choice([0, 1])
            return out
        for c in range(3):
            if r.random() < prob:
                out["mode"][c] = r.choice([1, 1, 2])
                out["offsets"][c] = [r.randint(-31, 31) if out["mode"][c] == 2
                                     else r.randint(0, 31) for _ in range(4)]
                out["band"][c] = r.randrange(32)
                out["eo_class"][c] = r.randrange(4)
        out["mode"][2] = out["mode"][1]
        out["eo_class"][2] = out["eo_class"][1]
        return out

    def alf(self, cx, cy, coder):
        r = self.rnd
        prob = getattr(self, "alf_prob", 0.6)
        sh = coder.sh
        cs = coder.cs
        out = {"enable": [0, 0, 0], "filt_idx": 0, "alt": [0, 0],
               "cc": [0, 0]}
        for c in range(3):
            if sh.alf_enabled[c] and r.random() < prob:
                out["enable"][c] = 1
        n_aps = sh.num_alf_aps_ids_luma
        out["filt_idx"] = r.randrange(16 + n_aps)
        if sh.alf_enabled[1] or sh.alf_enabled[2]:
            n_alts = cs.alf_apss[sh.alf_aps_id_chroma] \
                .alf.num_alternatives_chroma
            out["alt"] = [r.randrange(n_alts), r.randrange(n_alts)]
        for k, (on, aid) in enumerate((
                (sh.ccalf_cb_enabled, sh.ccalf_cb_aps_id),
                (sh.ccalf_cr_enabled, sh.ccalf_cr_aps_id))):
            if on and r.random() < prob:
                cnt = cs.alf_apss[aid].cc_alf.filter_count[k]
                out["cc"][k] = r.randint(1, cnt)
        return out

    def joint_cbcr(self, tu, cu, cbf_mask):
        if not getattr(self, "jccr_prob", 0):
            return False
        return self.rnd.random() < self.jccr_prob

    def mip(self, cu):
        if not getattr(self, "mip_prob", 0):
            return False
        return self.rnd.random() < self.mip_prob

    def mip_mode(self, cu, n_modes):
        return self.rnd.randrange(n_modes), self.rnd.random() < 0.5

    def isp_mode(self, cu, allowed):
        if not self.isp_prob or self.rnd.random() >= self.isp_prob:
            return 0
        if allowed == 3:
            return self.rnd.choice([1, 2])
        return allowed

    def multi_ref_line(self, cu):
        if not getattr(self, "mrl_prob", 0):
            return 0
        if self.rnd.random() < self.mrl_prob:
            return self.rnd.choice([1, 2])
        return 0

    def intra_chroma_mode(self, cu, cand_modes, cclm_allowed=False):
        if cclm_allowed and self.rnd.random() < 0.5:
            return self.rnd.choice([67, 68, 69])  # LM / MDLM_L / MDLM_T
        if self.rnd.random() < 0.5:
            return DM_CHROMA_IDX
        return self.rnd.choice(cand_modes[:4])

    def qp_delta(self, cu):
        if self.qp_delta_range == 0:
            return 0
        return self.rnd.randint(-self.qp_delta_range, self.qp_delta_range)

    def mts_idx(self, cu):
        # only consulted when MTS signalling conditions hold
        return self.rnd.choice([0, 0, 2, 3, 4, 5])

    def coeffs(self, tu, cu, comp):
        if self.rnd.random() > self.cbf_prob:
            return None
        x, y, w, h = tu.blocks[comp]
        blk = np.zeros((h, w), dtype=np.int32)
        n = max(1, int(w * h * self.density * self.rnd.random()))
        # keep energy in low frequencies and inside the zero-out region
        wmax, hmax = min(w, 32), min(h, 32)
        if cu.sbt_info and comp == 0:
            # implicit DST7/DCT8-32 zero-out: stay within 16 samples
            wmax, hmax = min(wmax, 16), min(hmax, 16)
        for _ in range(n):
            cx = min(int(self.rnd.expovariate(0.25)), wmax - 1)
            cy = min(int(self.rnd.expovariate(0.25)), hmax - 1)
            blk[cy, cx] = self.rnd.randint(1, self.max_level) * \
                (1 if self.rnd.random() < 0.5 else -1)
        if not np.any(blk):
            blk[0, 0] = 1
        return blk


def make_alf_aps(seed: int, aps_id: int = 0, luma: bool = True,
                 chroma: bool = True, cc: bool = True,
                 non_linear: bool = True):
    """Random legal ALF/CC-ALF APS; returns (APS object, NAL bytes)."""
    from refdec.hls.alf_aps import AlfParam, CcAlfParam, write_alf_aps
    from refdec.hls.params import ALF_APS, APS

    rnd = random.Random(seed ^ 0xA1F)
    p = AlfParam()
    ccp = CcAlfParam()
    p.new_filter_luma = luma
    p.new_filter_chroma = chroma
    if luma:
        p.non_linear_luma = non_linear and rnd.random() < 0.5
        p.num_luma_filters = rnd.randint(1, 8)
        if p.num_luma_filters > 1:
            p.filter_coeff_delta_idx = [
                rnd.randrange(p.num_luma_filters) for _ in range(25)]
        for _ in range(p.num_luma_filters):
            p.luma_coeff.append([rnd.randint(-24, 24) for _ in range(12)])
            p.luma_clip_idx.append([rnd.randrange(4) for _ in range(12)])
    if chroma:
        p.non_linear_chroma = non_linear and rnd.random() < 0.5
        p.num_alternatives_chroma = rnd.randint(1, 3)
        for _ in range(p.num_alternatives_chroma):
            p.chroma_coeff.append([rnd.randint(-24, 24) for _ in range(6)])
            p.chroma_clip_idx.append([rnd.randrange(4) for _ in range(6)])
    if cc:
        for cc_idx in range(2):
            ccp.new_filter[cc_idx] = rnd.random() < 0.8
            if ccp.new_filter[cc_idx]:
                ccp.filter_count[cc_idx] = rnd.randint(1, 4)
                for _ in range(ccp.filter_count[cc_idx]):
                    ccp.coeff[cc_idx].append(
                        [rnd.choice([0, 1, 2, 4, 8, -1, -2, -4, -8])
                         for _ in range(7)])
    if not (luma or chroma or any(ccp.new_filter)):
        p.new_filter_luma = True
        p.luma_coeff.append([0] * 12)
        p.luma_clip_idx.append([0] * 12)
    aps = APS(aps_type=ALF_APS, aps_id=aps_id, chroma_present=chroma or cc,
              alf=p, cc_alf=ccp)
    w = BitWriter()
    write_alf_aps(w, aps)
    return aps, make_nal(NalUnitType.PREFIX_APS, w.bytes())


def make_weight_table(seed: int, n0: int, n1: int, chroma: bool = True,
                      prob: float = 0.7):
    """Random legal pred_weight_table for the slice header."""
    from refdec.hls.weight_table import PredWeightTable, WeightEntry

    rnd = random.Random(seed ^ 0x3E1)
    wt = PredWeightTable()
    wt.luma_log2_denom = rnd.randint(0, 7)
    wt.chroma_log2_denom = max(0, min(7, wt.luma_log2_denom
                                      + rnd.randint(-1, 1))) if chroma else 0
    for lst, n in ((0, n0), (1, n1)):
        for _ in range(n):
            e = WeightEntry()
            if rnd.random() < prob:
                e.luma_weight_flag = True
                e.luma_weight = rnd.randint(-16, 16)
                e.luma_offset = rnd.randint(-32, 32)
            if chroma and rnd.random() < prob:
                e.chroma_weight_flag = True
                e.chroma_weight = [rnd.randint(-16, 16) for _ in range(2)]
                e.chroma_offset = [rnd.randint(-64, 64) for _ in range(2)]
            wt.entries[lst].append(e)
        wt.num_weights[lst] = n
    return wt


def make_lmcs_aps(seed: int, aps_id: int = 0, chroma: bool = True):
    """Random legal LMCS model (constraints: Reshape.cpp:330-369) wrapped
    in an APS; returns (APS object, NAL bytes)."""
    from refdec.hls.params import APS, LMCS_APS, LmcsInfo
    from refdec.testenc.hls_writer import write_lmcs_aps

    rnd = random.Random(seed)
    info = LmcsInfo()
    info.min_bin_idx = rnd.randrange(0, 4)
    info.max_bin_idx = 15 - rnd.randrange(0, 4)
    # keep each in-range codeword in [32, 76] (satisfies the [OrgCW>>3,
    # (OrgCW<<3)-1] range and the pivot 1<<(bd-5) crossing rule), then
    # trim until sum(cw) <= (1<<bd)-1
    cws = {i: 64 + rnd.randint(-32, 12)
           for i in range(info.min_bin_idx, info.max_bin_idx + 1)}
    while sum(cws.values()) > 1023:
        i = rnd.choice([k for k, v in cws.items() if v > 32])
        cws[i] -= 1
    for i, cw in cws.items():
        info.cw_delta[i] = cw - 64
    info.delta_cw_prec = 6
    if chroma:
        info.crs_offset = rnd.randint(-7, 7)
    aps = APS(aps_type=LMCS_APS, aps_id=aps_id, chroma_present=chroma,
              lmcs=info)
    w = BitWriter()
    write_lmcs_aps(w, aps)
    return aps, make_nal(NalUnitType.PREFIX_APS, w.bytes())


def make_scaling_aps(seed: int, aps_id: int = 0, chroma: bool = True):
    """Random legal scaling-list APS; returns (APS object, NAL bytes).
    Matrix values stay in [4, 64] (>0 required, parseScalingList)."""
    import numpy as np

    from refdec.bitstream.reader import BitReader
    from refdec.hls.params import APS, SCALING_LIST_APS
    from refdec.hls.scaling_list import (
        ScalingListData,
        is_luma_list,
        matrix_size,
        parse_scaling_list,
    )
    from refdec.testenc.hls_writer import write_scaling_aps

    rnd = random.Random(seed ^ 0x5CA1)
    sl = ScalingListData()
    for i in range(28):
        if not (chroma or is_luma_list(i)):
            continue
        s = matrix_size(i)
        sl.mats[i] = np.array(
            [[rnd.randint(4, 64) for _ in range(s)] for _ in range(s)],
            dtype=np.int32)
        if i >= 14:
            sl.dc[i] = rnd.randint(4, 64)
    aps = APS(aps_type=SCALING_LIST_APS, aps_id=aps_id,
              chroma_present=chroma, scaling_list=sl)
    w = BitWriter()
    write_scaling_aps(w, aps)
    # canonicalize by re-parsing: 64x64 lists have un-coded bottom-right
    # quadrants whose reconstructed values differ from the drawn ones
    r = BitReader(w.bytes())
    r.u(3), r.u(5), r.flag()
    aps.scaling_list = parse_scaling_list(r, chroma)
    return aps, make_nal(NalUnitType.PREFIX_APS, w.bytes())


def encode_frame(sps: SPS, pps: PPS, decisions: Decisions, qp: int = 32,
                 poc: int = 0, idr: bool = True, sh_kw: dict | None = None,
                 ph_kw: dict | None = None, slice_type: int = I_SLICE,
                 ref_deltas: tuple = ((), ()),
                 alf_apss: dict | None = None,
                 scaling_list=None,
                 ) -> tuple[bytes, CodingStructure]:
    """Encode one frame; returns (slice NAL unit bytes, the CS built
    during encoding — i.e. the expected parse result).  For P/B slices,
    ref_deltas[lst] lists positive POC deltas to past pictures (or negative
    for future)."""
    ph = PicHeader()
    ph.gdr_or_irap_pic = idr
    ph.inter_slice_allowed = slice_type != I_SLICE
    ph.intra_slice_allowed = True
    ph.pps_id = pps.pps_id
    ph.poc_lsb = poc & (sps.max_poc_lsb - 1)
    # inherit partition constraints exactly as parse_picture_header does
    ph.min_qt_size = list(sps.min_qt_size)
    ph.max_mtt_depth = list(sps.max_mtt_depth)
    ph.max_bt_size = list(sps.max_bt_size)
    ph.max_tt_size = list(sps.max_tt_size)
    # inferred PH fields (mirror parse_picture_header derivations)
    ph.temporal_mvp_enabled = bool(sps.temporal_mvp_enabled
                                   and slice_type != I_SLICE)
    if sps.affine_enabled:
        ph.max_num_affine_merge_cand = sps.max_num_affine_merge_cand
    else:
        ph.max_num_affine_merge_cand = int(sps.sbtmvp_enabled
                                           and ph.temporal_mvp_enabled)
    for k, v in (ph_kw or {}).items():
        setattr(ph, k, v)

    sh = SliceHeader()
    sh.picture_header_in_slice_header = True
    sh.slice_type = slice_type
    sh.qp_y = qp
    sh.poc = poc
    if slice_type != I_SLICE:
        sh.rpl_idx = [-1, -1]
        for lst in (0, 1):
            rpl = RefPicList()
            for d in ref_deltas[lst]:
                # positive d = d pictures in the past (RefPicPocList =
                # poc + DeltaPocValSt, so past refs carry negative deltas)
                rpl.entries.append(RefPicEntry(value=-d))
            sh.rpl[lst] = rpl
        sh.num_ref_idx_active = [max(1, len(ref_deltas[0])),
                                 len(ref_deltas[1]) if slice_type == B_SLICE
                                 else 0]
    for k, v in (sh_kw or {}).items():
        setattr(sh, k, v)
    # PH-in-SH inheritance (parse_slice_header does the same)
    sh.explicit_scaling_list_used = ph.explicit_scaling_list_enabled
    nal_type = NalUnitType.IDR_N_LP if idr else NalUnitType.TRAIL
    sh.nal_type = nal_type
    if pps.slice_maps:
        sh.ctu_addrs = list(pps.slice_maps[0])  # tile-ordered
    else:
        sh.ctu_addrs = list(range(pps.pic_width_in_ctu
                                  * pps.pic_height_in_ctu))

    # slice data first (CABAC substreams), so entry points are known
    # before the header is written
    cs = CodingStructure(sps, pps, ph, sh)
    if alf_apss:
        cs.alf_apss = alf_apss
    if scaling_list is not None:
        cs.scaling_list = scaling_list
    enc = CabacEncoder()
    init_id = sh.slice_type  # I_SLICE == 2
    enc.reset(qp, init_id)
    coder = CtuDecoder(cs, enc=enc, decisions=decisions)
    coder.code_slice()
    substreams = coder.enc_substreams
    if len(substreams) > 1:
        # signalled entry point offsets count emulation prevention bytes
        # (HLSyntaxReader.cpp:4052-4062 subtracts them); iterate since the
        # offsets themselves live in the slice header ahead of the data
        sh.entry_point_offsets = [len(ss) for ss in substreams[:-1]]
        for _ in range(5):
            w = BitWriter()
            write_slice_header(w, sh, ph, sps, pps)
            new = _ebsp_substream_sizes(w.bytes(), substreams)[:-1]
            if new == sh.entry_point_offsets:
                break
            sh.entry_point_offsets = new

    # slice header bits (ends byte-aligned, so cabac starts aligned)
    w = BitWriter()
    write_slice_header(w, sh, ph, sps, pps)
    rbsp = bytearray(w.bytes())
    for ss in substreams:
        rbsp += ss

    return make_nal(nal_type, bytes(rbsp)), cs


def encode_picture(sps: SPS, pps: PPS, qp: int = 32, poc: int = 0,
                   idr: bool = True, ph_kw: dict | None = None,
                   slices: list[dict] | None = None,
                   alf_apss: dict | None = None, scaling_list=None,
                   ) -> tuple[bytes, CodingStructure]:
    """Encode one picture as a standalone PH NAL plus one NAL per slice
    (multi-slice pictures; encode_frame covers the PH-in-SH single-slice
    case).  Each entry of `slices` is a dict with keys:
      decisions (required), slice_type, qp, ref_deltas, sh_kw.
    Rect-slice mode: slice i covers pps.slice_maps[i].  Raster mode: pass
    'address' (first tile) and 'num_tiles' per slice."""
    from refdec.testenc.hls_writer import write_picture_header

    slices = slices or []
    slice_types = [s.get("slice_type", I_SLICE) for s in slices]

    ph = PicHeader()
    ph.gdr_or_irap_pic = idr
    ph.inter_slice_allowed = any(t != I_SLICE for t in slice_types)
    ph.intra_slice_allowed = any(t == I_SLICE for t in slice_types) or idr
    ph.pps_id = pps.pps_id
    ph.poc_lsb = poc & (sps.max_poc_lsb - 1)
    ph.min_qt_size = list(sps.min_qt_size)
    ph.max_mtt_depth = list(sps.max_mtt_depth)
    ph.max_bt_size = list(sps.max_bt_size)
    ph.max_tt_size = list(sps.max_tt_size)
    ph.temporal_mvp_enabled = bool(sps.temporal_mvp_enabled
                                   and ph.inter_slice_allowed)
    if sps.affine_enabled:
        ph.max_num_affine_merge_cand = sps.max_num_affine_merge_cand
    else:
        ph.max_num_affine_merge_cand = int(sps.sbtmvp_enabled
                                           and ph.temporal_mvp_enabled)
    for k, v in (ph_kw or {}).items():
        setattr(ph, k, v)

    nal_type = NalUnitType.IDR_N_LP if idr else NalUnitType.TRAIL
    w = BitWriter()
    write_picture_header(w, ph, sps, pps)
    w.u(1, 1)  # rbsp_stop_one_bit
    w.byte_align(0)
    out = make_nal(NalUnitType.PH, w.bytes())

    cs = None
    for i, spec in enumerate(slices):
        st = spec.get("slice_type", I_SLICE)
        sqp = spec.get("qp", qp)
        ref_deltas = spec.get("ref_deltas", ((), ()))
        sh = SliceHeader()
        sh.picture_header_in_slice_header = False
        sh.slice_type = st
        sh.qp_y = sqp
        sh.poc = poc
        if st != I_SLICE or not idr:
            # non-IDR slices always carry RPLs (even I slices); keep the
            # same entries across slices so DPB marking stays consistent
            sh.rpl_idx = [-1, -1]
            for lst in (0, 1):
                rpl = RefPicList()
                for d in ref_deltas[lst]:
                    rpl.entries.append(RefPicEntry(value=-d))
                sh.rpl[lst] = rpl
        if st != I_SLICE:
            sh.num_ref_idx_active = [max(1, len(ref_deltas[0])),
                                     len(ref_deltas[1]) if st == B_SLICE
                                     else 0]
        for k, v in spec.get("sh_kw", {}).items():
            setattr(sh, k, v)
        sh.lmcs_enabled = bool(ph.lmcs_enabled
                               and spec.get("lmcs", ph.lmcs_enabled))
        sh.explicit_scaling_list_used = ph.explicit_scaling_list_enabled
        sh.nal_type = nal_type
        if sps.num_subpics > 1:
            # slice i is the j-th slice of subpic k (pps.slices_of_subpic;
            # single_slice_per_subpic reduces to k == i, j == 0)
            k = next(kk for kk, lst in enumerate(pps.slices_of_subpic)
                     if i in lst)
            sh.subpic_id = sps.subpic_ids[k]
            sh.subpic_idx = k
            sh.slice_address = pps.slices_of_subpic[k].index(i)
            sh.ctu_addrs = list(pps.slice_maps[i])
        elif pps.rect_slice or pps.no_pic_partition:
            sh.slice_address = i
            sh.ctu_addrs = list(pps.slice_maps[i])
        else:
            sh.slice_address = spec.get("address", 0)
            sh.num_tiles_in_slice = spec.get("num_tiles", 1)
            sh.ctu_addrs = []
            for t in range(sh.slice_address,
                           sh.slice_address + sh.num_tiles_in_slice):
                tx, ty = t % pps.num_tile_cols, t // pps.num_tile_cols
                sh.ctu_addrs.extend(pps.tile_ctus(
                    pps.tile_col_bd[tx], pps.tile_col_bd[tx + 1],
                    pps.tile_row_bd[ty], pps.tile_row_bd[ty + 1]))

        if cs is None:
            cs = CodingStructure(sps, pps, ph, sh)
            if alf_apss:
                cs.alf_apss = alf_apss
            if scaling_list is not None:
                cs.scaling_list = scaling_list
        else:
            cs.shs.append(sh)
            cs.sh = sh
        enc = CabacEncoder()
        enc.reset(sqp, st)
        coder = CtuDecoder(cs, enc=enc, decisions=spec["decisions"],
                           slice_idx=i)
        coder.code_slice()
        substreams = coder.enc_substreams
        if len(substreams) > 1:
            if not sps.entry_point_offsets_present:
                raise ValueError("multi-substream slice requires "
                                 "sps_entry_point_offsets_present")
            sh.entry_point_offsets = [len(ss) for ss in substreams[:-1]]
            for _ in range(5):
                w = BitWriter()
                write_slice_header(w, sh, ph, sps, pps)
                new = _ebsp_substream_sizes(w.bytes(), substreams)[:-1]
                if new == sh.entry_point_offsets:
                    break
                sh.entry_point_offsets = new
        w = BitWriter()
        write_slice_header(w, sh, ph, sps, pps)
        rbsp = bytearray(w.bytes())
        for ss in substreams:
            rbsp += ss
        out += make_nal(nal_type, bytes(rbsp))
    cs.sh = cs.shs[0]
    return out, cs


def _ebsp_substream_sizes(sh_bytes: bytes, substreams: list[bytes]
                          ) -> list[int]:
    """Per-substream sizes including the emulation prevention bytes the
    escaper will insert (mirrors rbsp_to_ebsp over the full slice RBSP)."""
    bounds = [len(sh_bytes)]
    for s in substreams:
        bounds.append(bounds[-1] + len(s))
    extra = [0] * len(substreams)
    zeros = 0
    full = sh_bytes + b"".join(substreams)
    for i, b in enumerate(full):
        if zeros >= 2 and b <= 3:
            for k in range(len(substreams)):
                if bounds[k] <= i < bounds[k + 1]:
                    extra[k] += 1
                    break
            zeros = 0
        zeros = zeros + 1 if b == 0 else 0
    return [len(s) + e for s, e in zip(substreams, extra)]


def generate_stream(width: int = 64, height: int = 64, n_frames: int = 1,
                    seed: int = 0, qp: int = 32, ctu: int = 32,
                    sps_kw: dict | None = None, pps_kw: dict | None = None,
                    dec_kw: dict | None = None, sh_kw: dict | None = None,
                    ph_kw: dict | None = None, with_vps_dci: bool = False,
                    ) -> tuple[bytes, list[CodingStructure]]:
    """Generate a full Annex-B stream of all-intra frames."""
    sps = make_sps(width, height, ctu=ctu, **(sps_kw or {}))
    pps = make_pps(sps, **(pps_kw or {}))

    out = b""
    if with_vps_dci:
        from refdec.testenc.hls_writer import write_dci, write_vps
        w = BitWriter()
        write_dci(w, sps)
        out += make_nal(NalUnitType.DCI, w.bytes())
        w = BitWriter()
        write_vps(w, sps)
        out += make_nal(NalUnitType.VPS, w.bytes())
    w = BitWriter()
    write_sps(w, sps)
    out += make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    out += make_nal(NalUnitType.PPS, w.bytes())

    css = []
    for f in range(n_frames):
        decisions = RandomDecisions(seed=seed * 1000 + f, **(dec_kw or {}))
        nal, cs = encode_frame(sps, pps, decisions, qp=qp, poc=f, idr=True,
                               sh_kw=sh_kw, ph_kw=ph_kw)
        out += nal
        css.append(cs)
    return out, css
