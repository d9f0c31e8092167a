"""Explicit weighted-prediction table parsing (pred_weight_table()).

Parity: vvdec HLSyntaxReader::parsePredWeightTable (HLSyntaxReader.cpp:4359).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from refdec.bitstream.reader import BitReader
from refdec.hls.params import CHROMA_400


@dataclass
class WeightEntry:
    luma_weight_flag: bool = False
    chroma_weight_flag: bool = False
    luma_weight: int = 0  # delta from (1 << luma_log2_denom)
    luma_offset: int = 0
    chroma_weight: list[int] = field(default_factory=lambda: [0, 0])
    chroma_offset: list[int] = field(default_factory=lambda: [0, 0])


@dataclass
class PredWeightTable:
    luma_log2_denom: int = 0
    chroma_log2_denom: int = 0
    num_weights: list[int] = field(default_factory=lambda: [0, 0])
    entries: list[list[WeightEntry]] = field(default_factory=lambda: [[], []])


def parse_pred_weight_table(r: BitReader, sps, pps, num_ref_idx_active, ph) -> PredWeightTable:
    """Parse pred_weight_table().  When called from a picture header
    (num_ref_idx_active is None), the weight counts are explicit syntax
    elements; from a slice header they equal the active ref counts."""
    wt = PredWeightTable()
    chroma = sps.chroma_format_idc != CHROMA_400
    wt.luma_log2_denom = r.ue()
    if chroma:
        wt.chroma_log2_denom = wt.luma_log2_denom + r.se()

    if num_ref_idx_active is None:
        n0 = r.ue()  # num_l0_weights
    else:
        n0 = num_ref_idx_active[0]
    wt.num_weights[0] = n0
    _parse_list(r, wt, 0, n0, chroma)

    if pps.weighted_bipred:
        if num_ref_idx_active is None:
            n1 = r.ue()
        else:
            n1 = num_ref_idx_active[1] if num_ref_idx_active[1] else 0
        wt.num_weights[1] = n1
        _parse_list(r, wt, 1, n1, chroma)
    return wt


def resolve_wp(wt: PredWeightTable | None, lst: int, ref_idx: int,
               bit_depth: int, num_comp: int) -> list[dict]:
    """Per-component WP params (Slice::getWpScaling value semantics,
    HLSyntaxReader.cpp:4459-4487): returns [{present, w, o, denom}]."""
    out = []
    entry = None
    if wt is not None and ref_idx < len(wt.entries[lst]):
        entry = wt.entries[lst][ref_idx]
    for comp in range(num_comp):
        denom = wt.luma_log2_denom if (wt and comp == 0) else \
            (wt.chroma_log2_denom if wt else 0)
        present = False
        w = 1 << denom
        o = 0
        if entry is not None:
            if comp == 0 and entry.luma_weight_flag:
                present = True
                w = (1 << denom) + entry.luma_weight
                o = entry.luma_offset
            elif comp > 0 and entry.chroma_weight_flag:
                present = True
                w = (1 << denom) + entry.chroma_weight[comp - 1]
                o = max(-128, min(127, 128 + entry.chroma_offset[comp - 1]
                                  - ((128 * w) >> denom)))
        out.append({"present": present, "w": w,
                    "o": o * (1 << (bit_depth - 8)), "denom": denom})
    return out


def wp_present_any(wt: PredWeightTable | None, lst: int, ref_idx: int) -> bool:
    """Any component weight present for this reference."""
    if wt is None or ref_idx < 0 or ref_idx >= len(wt.entries[lst]):
        return False
    e = wt.entries[lst][ref_idx]
    return e.luma_weight_flag or e.chroma_weight_flag


def write_pred_weight_table(w, wt: PredWeightTable, sps, pps,
                            num_ref_idx_active) -> None:
    """Mirror of parse_pred_weight_table for the slice-header path."""
    chroma = sps.chroma_format_idc != CHROMA_400
    w.ue(wt.luma_log2_denom)
    if chroma:
        w.se(wt.chroma_log2_denom - wt.luma_log2_denom)
    n0 = num_ref_idx_active[0]
    _write_list(w, wt, 0, n0, chroma)
    if pps.weighted_bipred:
        _write_list(w, wt, 1, num_ref_idx_active[1], chroma)


def _write_list(w, wt: PredWeightTable, lst: int, n: int, chroma: bool) -> None:
    entries = wt.entries[lst][:n]
    assert len(entries) == n, "weight table shorter than active refs"
    for e in entries:
        w.flag(e.luma_weight_flag)
    if chroma:
        for e in entries:
            w.flag(e.chroma_weight_flag)
    for e in entries:
        if e.luma_weight_flag:
            w.se(e.luma_weight)
            w.se(e.luma_offset)
        if e.chroma_weight_flag:
            for c in range(2):
                w.se(e.chroma_weight[c])
                w.se(e.chroma_offset[c])


def _parse_list(r: BitReader, wt: PredWeightTable, lst: int, n: int, chroma: bool) -> None:
    entries = [WeightEntry() for _ in range(n)]
    for e in entries:
        e.luma_weight_flag = r.flag()
    if chroma:
        for e in entries:
            e.chroma_weight_flag = r.flag()
    for e in entries:
        if e.luma_weight_flag:
            e.luma_weight = r.se()
            e.luma_offset = r.se()
        if e.chroma_weight_flag:
            for c in range(2):
                e.chroma_weight[c] = r.se()
                e.chroma_offset[c] = r.se()
    wt.entries[lst] = entries
