"""Host-only decode driver of the reference: Annex-B stream -> pictures.

A copy of the original package's decoder.py with only its host path
kept: the NAL parser (FrameParser), reference picture lists, the host
reconstruction (frame/recon_np.IntraReconstructor), the host in-loop
filters (deblock_np, sao_np, alf_np) and DPB output bumping (dpb.py).
The device pipeline, the parse threads, concealment and the
decoded-picture-hash check are left out: the benchmark's streams need
none of them, and a broken stream raises.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from refdec.bitstream.nal import NalUnitType, read_nal_units
from refdec.bitstream.reader import BitReader
from refdec.cabac.ctu_decoder import CtuDecoder
from refdec.frame.structure import CodingStructure
from refdec.hls.reader import (
    ParameterSetManager,
    parse_picture_header,
    parse_pps,
    parse_slice_header,
    parse_sps,
)


def u16_view(p: np.ndarray) -> np.ndarray:
    """uint16 view of a clipped int32 plane (a copy when it cannot be a
    view)."""
    if p.dtype == np.uint16:
        return p
    if p.dtype == np.int32 and p.flags.c_contiguous \
            and sys.byteorder == "little":
        return p.view(np.uint16)[:, ::2]
    return p.astype(np.uint16)


@dataclass
class ParsedFrame:
    cs: CodingStructure
    poc: int = 0
    is_idr: bool = False
    nal_type: int = 0
    sei: list = field(default_factory=list)


class FrameParser:
    """Stateful NAL-stream parser producing per-picture CodingStructures."""

    def __init__(self) -> None:
        self.psman = ParameterSetManager()
        self.prev_tid0_poc = 0
        self.cur_ph = None
        self.pending_sei: list = []
        # in-progress multi-slice picture: (ParsedFrame, covered-CTU set,
        # total CTUs)
        self._pending: tuple | None = None

    def feed_nal(self, nal, last_frame: ParsedFrame | None = None
                 ) -> list[ParsedFrame]:
        """Process one NAL unit; returns completed pictures (0 or more)."""
        frames: list[ParsedFrame] = []
        full_rbsp = bytes([0, (int(nal.nal_type) << 3)
                           | (nal.temporal_id + 1)]) + nal.rbsp
        t = nal.nal_type
        if t == NalUnitType.SPS:
            self.psman.store_sps(parse_sps(full_rbsp))
        elif t == NalUnitType.VPS:
            from refdec.hls.reader import parse_vps
            self.psman.store_vps(parse_vps(full_rbsp))
        elif t == NalUnitType.DCI:
            from refdec.hls.reader import parse_dci
            self.psman.store_dci(parse_dci(full_rbsp))
        elif t == NalUnitType.PPS:
            self.psman.store_pps(parse_pps(full_rbsp, self.psman.get_sps))
        elif t == NalUnitType.PH:
            self._flush_pending(frames)
            r = BitReader(full_rbsp, pos=16)
            self.cur_ph = parse_picture_header(r, self.psman)
        elif t in (NalUnitType.PREFIX_APS, NalUnitType.SUFFIX_APS):
            from refdec.hls.reader import parse_aps
            self.psman.store_aps(parse_aps(full_rbsp))
        elif t in (NalUnitType.PREFIX_SEI, NalUnitType.SUFFIX_SEI):
            from refdec.hls.sei import parse_sei_nal
            msgs = parse_sei_nal(full_rbsp, nal.temporal_id)
            if t == NalUnitType.PREFIX_SEI or last_frame is None:
                self.pending_sei.extend(msgs)
            else:
                last_frame.sei.extend(msgs)
        elif nal.is_vcl:
            done = self._parse_slice(full_rbsp, nal)
            if done is not None:
                frames.append(done)
                done.sei.extend(self.pending_sei)
                self.pending_sei = []
        return frames

    def _flush_pending(self, frames: list) -> None:
        if self._pending is not None:
            pf, covered, total = self._pending
            self._pending = None
            if len(covered) < total:
                raise ValueError(
                    f"picture POC {pf.poc} incomplete: {len(covered)}/{total}"
                    " CTUs covered by its slices")
            frames.append(pf)
            pf.sei.extend(self.pending_sei)
            self.pending_sei = []

    def _parse_slice(self, full_rbsp: bytes, nal) -> ParsedFrame | None:
        """Parse one slice; returns the ParsedFrame when its picture is
        complete (all CTUs covered), else None."""
        r = BitReader(full_rbsp, pos=16)
        sh, ph = parse_slice_header(r, self.psman, int(nal.nal_type),
                                    nal.temporal_id, self.prev_tid0_poc,
                                    self.cur_ph)
        if nal.temporal_id == 0:
            self.prev_tid0_poc = sh.poc
        if sh.picture_header_in_slice_header and self._pending is not None:
            raise ValueError("PH-in-SH slice while a picture is open")
        if self._pending is None:
            pps = self.psman.get_pps(ph.pps_id)
            sps = self.psman.get_sps(pps.sps_id)
            cs = CodingStructure(sps, pps, ph, sh)
            cs.scaling_list = None
            if sh.explicit_scaling_list_used:
                from refdec.hls.params import SCALING_LIST_APS
                aps = self.psman.get_aps(SCALING_LIST_APS,
                                         ph.scaling_list_aps_id)
                if aps is None:
                    raise ValueError(
                        f"missing scaling-list APS {ph.scaling_list_aps_id}")
                cs.scaling_list = aps.scaling_list
            cs.lmcs_info = None
            if ph.lmcs_enabled:
                from refdec.hls.params import LMCS_APS
                aps = self.psman.get_aps(LMCS_APS, ph.lmcs_aps_id)
                if aps is None:
                    raise ValueError(f"missing LMCS APS {ph.lmcs_aps_id}")
                cs.lmcs_info = aps.lmcs
            pf = ParsedFrame(cs=cs, poc=sh.poc, is_idr=nal.is_idr,
                             nal_type=int(nal.nal_type))
            total = pps.pic_width_in_ctu * pps.pic_height_in_ctu
            self._pending = (pf, set(), total)
            slice_idx = 0
        else:
            pf, _covered, total = self._pending
            cs = pf.cs
            if sh.poc != pf.poc:
                raise ValueError("slice POC changed mid-picture "
                                 f"({sh.poc} vs {pf.poc})")
            slice_idx = len(cs.shs)
            cs.shs.append(sh)
            cs.sh = sh  # CtuDecoder snapshots the current slice header
        # per-slice ALF APS references
        if any(sh.alf_enabled) or sh.ccalf_cb_enabled or sh.ccalf_cr_enabled:
            from refdec.hls.params import ALF_APS
            ids = set(sh.alf_aps_ids_luma if sh.alf_enabled[0] else [])
            if sh.alf_enabled[1] or sh.alf_enabled[2]:
                ids.add(sh.alf_aps_id_chroma)
            if sh.ccalf_cb_enabled:
                ids.add(sh.ccalf_cb_aps_id)
            if sh.ccalf_cr_enabled:
                ids.add(sh.ccalf_cr_aps_id)
            for i in ids:
                aps = self.psman.get_aps(ALF_APS, i)
                if aps is None:
                    raise ValueError(f"missing ALF APS {i}")
                cs.alf_apss[i] = aps
        from refdec.cabac.engine import make_cabac_decoder
        dec = make_cabac_decoder(full_rbsp, sh.data_offset_bits // 8)
        dec.reset(sh.qp_y, sh.slice_type)
        CtuDecoder(cs, dec=dec, slice_idx=slice_idx).decode_slice()
        pf, covered, total = self._pending
        covered.update(sh.ctu_addrs)
        if len(covered) >= total:
            cs.sh = cs.shs[0]
            self._pending = None
            return pf
        return None


class StreamDecoder:
    """Push Annex-B bytes in, pull pictures out in output (bumping)
    order; each picture is reconstructed when the next one begins."""

    def __init__(self) -> None:
        from refdec.dpb import PicListManager
        self.parser = FrameParser()
        self.plm = PicListManager()
        self._refs: dict[int, list] = {}       # poc -> int32 planes
        self._ref_cols: dict[int, object] = {}  # poc -> ColMotion
        self._ref_pps: dict[int, object] = {}   # poc -> PPS (RPR scaling)
        self._pending: ParsedFrame | None = None
        self._num_reorder = 0
        # per-picture hook: called with (poc, cs) once a picture is
        # reconstructed and filtered
        self.on_picture = None

    def push(self, data: bytes) -> list:
        out = []
        for nal in read_nal_units(data):
            for f in self.parser.feed_nal(nal, last_frame=self._pending):
                if self._pending is not None:
                    self._reconstruct(self._pending)
                self._pending = f
            out.extend(self._bump())
        return out

    def flush(self) -> list:
        tail: list[ParsedFrame] = []
        self.parser._flush_pending(tail)
        for f in tail:
            if self._pending is not None:
                self._reconstruct(self._pending)
            self._pending = f
        if self._pending is not None:
            self._reconstruct(self._pending)
            self._pending = None
        out = self.plm.drain(self._num_reorder)
        self.plm.reset()
        self.parser = FrameParser()
        return out

    def _bump(self) -> list:
        out = []
        while True:
            p = self.plm.get_next_output(self._num_reorder)
            if p is None:
                return out
            out.append(p)

    def _build_ref_set(self, f, cs, sh_ref):
        """Resolve one slice's RPLs (Slice::constructRefPicLists +
        scaleRefPicList)."""
        from refdec.frame import rpr_np
        ref_pocs, ref_planes, ref_cols, ref_scaled = ([], []), ([], []), \
            ([], []), ([], [])
        for lst in range(2):
            rpl = sh_ref.rpl[lst]
            if rpl is None:
                continue
            for e in rpl.entries:
                if e.is_long_term:
                    max_lsb = cs.sps.max_poc_lsb
                    if e.delta_poc_msb_present:
                        ref_poc = (e.value + f.poc
                                   - e.delta_poc_msb_cycle * max_lsb
                                   - (f.poc & (max_lsb - 1)))
                    else:
                        ref_poc = next(
                            (p for p in sorted(self._refs, reverse=True)
                             if (p & (max_lsb - 1)) == e.value), e.value)
                else:
                    ref_poc = f.poc + e.value
                if ref_poc not in self._refs:
                    raise ValueError(f"missing reference POC {ref_poc}")
                ref_pocs[lst].append(ref_poc)
                ref_planes[lst].append(self._refs[ref_poc])
                ref_cols[lst].append(self._ref_cols[ref_poc])
                ref_pps = self._ref_pps.get(ref_poc, cs.pps)
                ref_scaled[lst].append(
                    (rpr_np.get_rpr_scaling(cs.sps, cs.pps, ref_pps), ref_pps)
                    if rpr_np.is_ref_scaled(cs.pps, ref_pps) else None)
        check_ldc = all(
            p <= f.poc for lst in range(2)
            for p in ref_pocs[lst][: sh_ref.num_ref_idx_active[lst]])
        return ([list(x) for x in ref_pocs], [list(x) for x in ref_planes],
                [list(x) for x in ref_cols], [list(x) for x in ref_scaled],
                check_ldc)

    def _reconstruct(self, f: ParsedFrame) -> None:
        from refdec.dpb import DecodedPicture
        from refdec.frame.alf_np import alf_frame_vec
        from refdec.frame.deblock_np import deblock_frame
        from refdec.frame.inter_np import ColMotion
        from refdec.frame.recon_np import IntraReconstructor
        from refdec.frame.sao_np import sao_frame

        cs = f.cs
        if f.is_idr:
            self.plm.unmark_all_references()
            self._refs.clear()
            self._ref_cols.clear()
            self._ref_pps.clear()
        self._num_reorder = cs.sps.num_reorder_pics[-1]
        sh_ref = next((s for s in cs.shs if not s.is_intra), cs.sh)
        cs.ref_pocs = [[], []]
        cs.ref_planes = [[], []]
        cs.ref_cols = [[], []]
        cs.ref_scaled = [[], []]
        cs.per_slice_rpl = False
        cs.slice_ref_sets = [None] * len(cs.shs)
        if not sh_ref.is_intra:
            sets_by_key: dict = {}
            first_key = None
            for si, s in enumerate(cs.shs):
                if s.is_intra:
                    continue
                key = self._rpl_key(s)
                if key not in sets_by_key:
                    sets_by_key[key] = self._build_ref_set(f, cs, s)
                cs.slice_ref_sets[si] = sets_by_key[key]
                if first_key is None:
                    first_key = key
            cs.per_slice_rpl = len(sets_by_key) > 1
            (cs.ref_pocs, cs.ref_planes, cs.ref_cols, cs.ref_scaled,
             cs.check_ldc) = sets_by_key[first_key]
        planes = IntraReconstructor(cs).run()
        deblock_frame(cs, planes)
        sao_frame(cs, planes)
        planes = alf_frame_vec(cs, planes)
        # DMVR-refined MVs enter the motion field only after deblocking
        # strength derivation (TaskFinishMotionInfo, DecCu.cpp:161-213)
        for x2, y2, mv0, mv1 in getattr(cs, "dmvr_fixups", ()):
            cs.mi_mv[y2 >> 2, x2 >> 2, 0] = mv0
            cs.mi_mv[y2 >> 2, x2 >> 2, 1] = mv1
        self._refs[f.poc] = planes
        self._ref_pps[f.poc] = cs.pps
        self._ref_cols[f.poc] = ColMotion(cs, f.poc)
        if self.on_picture is not None:
            self.on_picture(f.poc, cs)
        self.plm.add(DecodedPicture(
            poc=f.poc, planes=[u16_view(p) for p in planes],
            bit_depth=cs.sps.bit_depth, is_idr=f.is_idr, sei=f.sei,
            width=cs.w, height=cs.h,
            chroma_format_idc=cs.sps.chroma_format_idc))

    @staticmethod
    def _rpl_key(sh):
        """Hashable identity of a slice's RPLs + active counts."""
        out = [tuple(sh.num_ref_idx_active)]
        for lst in range(2):
            rpl = sh.rpl[lst]
            out.append(None if rpl is None else tuple(
                (e.is_long_term, e.value,
                 getattr(e, "delta_poc_msb_present", False),
                 getattr(e, "delta_poc_msb_cycle", 0))
                for e in rpl.entries))
        return tuple(out)


def decode_annexb(data: bytes, on_picture=None) -> list:
    """Annex-B stream -> its pictures in output order, each a DPB picture
    whose `planes` are uint16 (Y, Cb, Cr) and whose `poc` is set.
    `on_picture(poc, cs)` sees each picture's coding structure once it is
    reconstructed."""
    dec = StreamDecoder()
    dec.on_picture = on_picture
    pics = dec.push(data)
    pics.extend(dec.flush())
    return pics
