"""ALF / CC-ALF APS payload: parameter objects + parse + write.

Behavioral parity: HLSyntaxReader::parseAlfAps (HLSyntaxReader.cpp:905),
alfFilterCoeffs (:4659); AlfSliceParam / CcAlfFilterParam (Slice.h).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

MAX_NUM_ALF_CLASSES = 25
MAX_NUM_ALF_LUMA_COEFF = 13
MAX_NUM_ALF_CHROMA_COEFF = 7
MAX_NUM_ALF_ALTERNATIVES_CHROMA = 8
MAX_NUM_CC_ALF_FILTERS = 4
CC_ALF_NUM_COEFF = 8  # g_alfNumCoeff[CC_ALF]; 7 signalled


@dataclass
class AlfParam:
    """AlfSliceParam: one APS's luma/chroma ALF filters."""
    new_filter_luma: bool = False
    new_filter_chroma: bool = False
    non_linear_luma: bool = False
    non_linear_chroma: bool = False
    num_luma_filters: int = 1
    # class -> signalled filter index
    filter_coeff_delta_idx: list[int] = field(
        default_factory=lambda: [0] * MAX_NUM_ALF_CLASSES)
    # [filter][12] signalled luma coefficients (DC implicit 128)
    luma_coeff: list[list[int]] = field(default_factory=list)
    luma_clip_idx: list[list[int]] = field(default_factory=list)
    num_alternatives_chroma: int = 1
    # [alt][6] chroma coefficients
    chroma_coeff: list[list[int]] = field(default_factory=list)
    chroma_clip_idx: list[list[int]] = field(default_factory=list)


@dataclass
class CcAlfParam:
    new_filter: list[bool] = field(default_factory=lambda: [False, False])
    filter_count: list[int] = field(default_factory=lambda: [0, 0])
    # [cc_idx][filter][7]
    coeff: list[list[list[int]]] = field(default_factory=lambda: [[], []])


def _filter_coeffs(r, n_coeff: int, n_filters: int, clip_flag: bool):
    coeffs = []
    clips = []
    for _ in range(n_filters):
        row = []
        for _ in range(n_coeff - 1):
            v = r.ue()
            assert v <= 128, "alf coeff abs out of range"
            if v and r.flag():
                v = -v
            row.append(v)
        coeffs.append(row)
    for _ in range(n_filters):
        row = [0] * (n_coeff - 1)
        if clip_flag:
            row = [r.u(2) for _ in range(n_coeff - 1)]
        clips.append(row)
    return coeffs, clips


def parse_alf_aps(r, aps) -> None:
    p = AlfParam()
    cc = CcAlfParam()
    p.new_filter_luma = bool(r.flag())
    if aps.chroma_present:
        p.new_filter_chroma = bool(r.flag())
        cc.new_filter[0] = bool(r.flag())
        cc.new_filter[1] = bool(r.flag())
    if p.new_filter_luma:
        p.non_linear_luma = bool(r.flag())
        p.num_luma_filters = r.ue() + 1
        assert p.num_luma_filters <= MAX_NUM_ALF_CLASSES
        if p.num_luma_filters > 1:
            length = int(math.ceil(math.log2(p.num_luma_filters)))
            p.filter_coeff_delta_idx = [r.u(length)
                                        for _ in range(MAX_NUM_ALF_CLASSES)]
        p.luma_coeff, p.luma_clip_idx = _filter_coeffs(
            r, MAX_NUM_ALF_LUMA_COEFF, p.num_luma_filters, p.non_linear_luma)
    if p.new_filter_chroma:
        p.non_linear_chroma = bool(r.flag())
        p.num_alternatives_chroma = r.ue() + 1
        assert p.num_alternatives_chroma <= MAX_NUM_ALF_ALTERNATIVES_CHROMA
        for _ in range(p.num_alternatives_chroma):
            c, cl = _filter_coeffs(r, MAX_NUM_ALF_CHROMA_COEFF, 1,
                                   p.non_linear_chroma)
            p.chroma_coeff.append(c[0])
            p.chroma_clip_idx.append(cl[0])
    for cc_idx in range(2):
        if cc.new_filter[cc_idx]:
            cc.filter_count[cc_idx] = r.ue() + 1
            assert cc.filter_count[cc_idx] <= MAX_NUM_CC_ALF_FILTERS
            for _ in range(cc.filter_count[cc_idx]):
                row = []
                for _ in range(CC_ALF_NUM_COEFF - 1):
                    code = r.u(3)
                    v = 0
                    if code:
                        v = 1 << (code - 1)
                        if r.flag():
                            v = -v
                    row.append(v)
                cc.coeff[cc_idx].append(row)
    aps.alf = p
    aps.cc_alf = cc


def write_alf_aps(w, aps) -> None:
    """Mirror of parseAPS + parseAlfAps for the test encoder."""
    p = aps.alf
    cc = aps.cc_alf
    w.u(aps.aps_type, 3)
    w.u(aps.aps_id, 5)
    w.flag(aps.chroma_present)
    w.flag(p.new_filter_luma)
    if aps.chroma_present:
        w.flag(p.new_filter_chroma)
        w.flag(cc.new_filter[0])
        w.flag(cc.new_filter[1])
    if p.new_filter_luma:
        w.flag(p.non_linear_luma)
        w.ue(p.num_luma_filters - 1)
        if p.num_luma_filters > 1:
            length = int(math.ceil(math.log2(p.num_luma_filters)))
            for v in p.filter_coeff_delta_idx:
                w.u(v, length)
        for row in p.luma_coeff:
            for v in row:
                w.ue(abs(v))
                if v:
                    w.flag(v < 0)
        if p.non_linear_luma:
            for row in p.luma_clip_idx:
                for v in row:
                    w.u(v, 2)
    if p.new_filter_chroma:
        w.flag(p.non_linear_chroma)
        w.ue(p.num_alternatives_chroma - 1)
        for alt in range(p.num_alternatives_chroma):
            for v in p.chroma_coeff[alt]:
                w.ue(abs(v))
                if v:
                    w.flag(v < 0)
            if p.non_linear_chroma:
                for v in p.chroma_clip_idx[alt]:
                    w.u(v, 2)
    for cc_idx in range(2):
        if cc.new_filter[cc_idx]:
            w.ue(cc.filter_count[cc_idx] - 1)
            for row in cc.coeff[cc_idx]:
                for v in row:
                    if v == 0:
                        w.u(0, 3)
                    else:
                        w.u(abs(v).bit_length(), 3)
                        w.flag(v < 0)
    w.flag(False)  # aps_extension_flag
    w.u(1, 1)      # rbsp_stop_one_bit
    w.byte_align(0)
