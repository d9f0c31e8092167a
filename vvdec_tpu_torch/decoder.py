"""Top-level decode driver: Annex-B stream -> parsed frames -> device recon.

Host-plane orchestration, parity with vvdec DecLib/DecLibParser
(source/Lib/DecoderLib/DecLib.cpp:182 decode, DecLibParser.cpp:125 parse) —
re-designed: the parse stage emits whole-frame tensors that the PyTorch
device pipeline reconstructs per frame.

A copy of vvdec_tpu/decoder.py with these changes: `use_jax` becomes
`device` (resolved by device.resolve_device: CUDA unless the caller asks
for the CPU), and the device pipeline (ops/frame_device.py) is the only
way a picture is decoded unless `plan_frame_device` rejects it.  The
device pipeline takes every intra tool but ISP, MRL and BDPCM, and
inter pictures with translational MC, BCW, WP, SbTMVP, GPM, affine +
PROF, CIIP, DMVR and BDOF (the CUs these two refine take the device
refinement stage).  A picture it rejects is reconstructed on the host
(frame/recon_np.IntraReconstructor) and filtered by the device filter
chain, or by the host filters when `device_filter_reject_reason`
rejects the picture too, as the reference does with use_jax=True; each
such picture counts its reason in `fallback_census`.  Nothing else
sends a picture to the host: no option or environment variable forces
either path, and a CUDA error, a failed kernel build or a missing card
raises.  Inter pictures resolve their reference sets per slice and read
their references from the device DPB (`_refs_dev`: each decoded
picture's filtered planes, kept on the device until no reference
picture list of a later picture names it, VVC's "unused for reference"
marking); a host-reconstructed picture reads them back once per POC
(`_refs_host`) and enters the device DPB itself.  A missing reference raises
ValueError, as the reference's strict mode does; with
err_policy="conceal" a lost reference is substituted and a broken
picture grey-filled, both entering the device DPB, as the reference
conceals them (never a device fault: `is_device_fault`).  threads >= 2
runs the parse on its own thread and the CABAC walks on a pool (the
reference's recon-while-parse); the device stays on the caller's
thread.  The public surface over this class is api.Decoder, the
command-line app (app.py, and `main` here) and the GOP worker pool
(parallel/gop.py).
"""

from __future__ import annotations

import itertools
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from vvdec_tpu_torch.bitstream.nal import NalUnitType, read_nal_units
from vvdec_tpu_torch.bitstream.reader import BitReader
from vvdec_tpu_torch.cabac.ctu_decoder import CtuDecoder
from vvdec_tpu_torch.frame.structure import CodingStructure
from vvdec_tpu_torch.hls.reader import (
    ParameterSetManager,
    parse_picture_header,
    parse_pps,
    parse_slice_header,
    parse_sps,
)
from vvdec_tpu_torch.utils.trace import profiler

# each StreamDecoder's serial: with the POC it names a picture in the
# stage profiler's spans
_serials = itertools.count(1)


def u16_view(p: np.ndarray) -> np.ndarray:
    """Zero-copy uint16 view of a clipped int32 plane: the 10-bit output
    path hands out (strided) views of the internal reconstruction planes
    instead of repacking (reference parity: vvdecimpl.cpp:953-1056 exposes
    internal 16-bit reco pointers directly)."""
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
    broken: bool = False     # parse error: conceal with grey fill
    sei: list = field(default_factory=list)
    walk_future: object = None  # in-flight CABAC walk (parse-ahead pool)


class FrameParser:
    """Stateful NAL-stream parser producing per-frame CodingStructures."""

    _GCI_NAL_RULES = (  # (gci flag, rejected NAL type) — DecLib.cpp:669-695
        ("no_trail", NalUnitType.TRAIL), ("no_stsa", NalUnitType.STSA),
        ("no_rasl", NalUnitType.RASL), ("no_radl", NalUnitType.RADL),
        ("no_idr", NalUnitType.IDR_W_RADL), ("no_idr", NalUnitType.IDR_N_LP),
        ("no_cra", NalUnitType.CRA), ("no_gdr", NalUnitType.GDR),
        ("no_aps", NalUnitType.PREFIX_APS),
        ("no_aps", NalUnitType.SUFFIX_APS),
    )

    def __init__(self) -> None:
        self.psman = ParameterSetManager()
        # optional executor for deferred picture walks: the CABAC decode
        # of whole (single-slice) pictures runs as parse-ahead tasks (the
        # reference's per-slice parse tasks, DecLibParser.cpp:948-1012);
        # the C walk releases the GIL, so tasks parallelize across
        # pictures.  Set by StreamDecoder(threads >= 3).
        self.walk_pool = None
        self.prev_tid0_poc = 0
        self.cur_ph = None
        self.active_sps = None
        self.last_bp = None  # last buffering period (HRD SEI context)
        self.pending_sei: list = []
        # in-progress multi-slice picture: (ParsedFrame, covered-CTU set,
        # total CTUs).  Pictures with the PH in the slice header always
        # consist of a single slice (the VVC constraint), so a picture is
        # open only between a PH NAL and full CTU coverage.
        self._pending: tuple | None = None

    def parse_stream(self, data: bytes) -> list[ParsedFrame]:
        frames: list[ParsedFrame] = []
        for nal in read_nal_units(data):
            frames.extend(self.feed_nal(nal, last_frame=frames[-1]
                                        if frames else None))
        self._flush_pending(frames)
        return frames

    def feed_nal(self, nal, last_frame: ParsedFrame | None = None
                 ) -> list[ParsedFrame]:
        """Process one NAL unit; returns completed pictures (0 or more)."""
        frames: list[ParsedFrame] = []
        full_rbsp = bytes([0, (int(nal.nal_type) << 3) | (nal.temporal_id + 1)]) \
            + nal.rbsp
        t = nal.nal_type
        self._check_nal_constraints(t)
        if t == NalUnitType.SPS:
            self.psman.store_sps(parse_sps(full_rbsp))
        elif t == NalUnitType.VPS:
            from vvdec_tpu_torch.hls.reader import parse_vps
            self.psman.store_vps(parse_vps(full_rbsp))
        elif t == NalUnitType.DCI:
            from vvdec_tpu_torch.hls.reader import parse_dci
            if nal.temporal_id != 0:
                raise ValueError("TemporalId of a DCI NAL unit must be 0")
            self.psman.store_dci(parse_dci(full_rbsp))
        elif t == NalUnitType.PPS:
            self.psman.store_pps(parse_pps(full_rbsp, self.psman.get_sps))
        elif t == NalUnitType.PH:
            self._flush_pending(frames)
            r = BitReader(full_rbsp, pos=16)
            self.cur_ph = parse_picture_header(r, self.psman)
        elif t in (NalUnitType.PREFIX_APS, NalUnitType.SUFFIX_APS):
            from vvdec_tpu_torch.hls.reader import parse_aps
            self.psman.store_aps(parse_aps(full_rbsp))
        elif t in (NalUnitType.PREFIX_SEI, NalUnitType.SUFFIX_SEI):
            from vvdec_tpu_torch.hls.sei import (SEI_BUFFERING_PERIOD,
                                           parse_buffering_period,
                                           parse_sei_nal)
            msgs = parse_sei_nal(full_rbsp, nal.temporal_id)
            # remember the active buffering period: picture-timing and
            # decoding-unit-info field lengths depend on it
            # (SEIread.cpp:226-248)
            for m in msgs:
                if m.payload_type == SEI_BUFFERING_PERIOD:
                    try:
                        self.last_bp = parse_buffering_period(m)
                    except (IndexError, ValueError):
                        pass
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
        # AUD / EOS / EOB / FD: ignored at this stage
        return frames

    def _flush_pending(self, frames: list) -> None:
        if self._pending is not None:
            pf, covered, total, _tasks = self._pending
            self._pending = None
            if len(covered) < total:
                raise ValueError(
                    f"picture POC {pf.poc} incomplete: {len(covered)}/{total}"
                    " CTUs covered by its slices")
            frames.append(pf)
            pf.sei.extend(self.pending_sei)
            self.pending_sei = []

    def _check_nal_constraints(self, t) -> None:
        """General-constraint-info NAL gating vs the active SPS
        (DecLib::xCheckNalUnitConstraintFlags, DecLib.cpp:669-695)."""
        sps = self.active_sps
        if sps is None or sps.ptl is None:
            return
        ci = sps.ptl.constraint_info
        if ci is None or not ci.gci_present_flag:
            return
        for flag, rejected in self._GCI_NAL_RULES:
            if t == rejected and ci.get(flag):
                raise ValueError(
                    f"non-conforming bitstream: {flag}_constraint_flag set "
                    f"but stream contains a {rejected.name} NAL unit")

    def _parse_slice(self, full_rbsp: bytes, nal) -> ParsedFrame | None:
        """Parse one slice; returns the ParsedFrame when its picture is
        complete (all CTUs covered), else None.

        Parity: DecLibParser::xDecodeSliceHead/xDecodeSliceMain
        (DecLibParser.cpp:401, :948) — slices accumulate into one
        CodingStructure until the picture is fully covered."""
        r = BitReader(full_rbsp, pos=16)
        sh, ph = parse_slice_header(r, self.psman, int(nal.nal_type),
                                    nal.temporal_id, self.prev_tid0_poc,
                                    self.cur_ph)
        if nal.temporal_id == 0 and t_is_ref(nal.nal_type):
            self.prev_tid0_poc = sh.poc
        if sh.picture_header_in_slice_header and self._pending is not None:
            raise ValueError("PH-in-SH slice while a picture is open")
        if self._pending is None:
            pps = self.psman.get_pps(ph.pps_id)
            sps = self.psman.get_sps(pps.sps_id)
            # VPS activation checks (DecLibParser.cpp:453-476): a non-zero
            # sps_video_parameter_set_id must resolve, and dependent layers
            # are not decodable
            if sps.vps_id > 0:
                vps = self.psman.get_vps(sps.vps_id)
                if vps is None:
                    raise ValueError(f"no VPS with id {sps.vps_id} "
                                     "for the active SPS")
                layer_idx = (vps.layer_id.index(nal.layer_id)
                             if nal.layer_id in vps.layer_id else 0)
                if not vps.independent_layer[layer_idx]:
                    raise ValueError(
                        "decoding of dependent layers not supported")
            self.active_sps = sps
            cs = CodingStructure(sps, pps, ph, sh)
            cs.scaling_list = None
            if sh.explicit_scaling_list_used:
                from vvdec_tpu_torch.hls.params import SCALING_LIST_APS
                aps = self.psman.get_aps(SCALING_LIST_APS,
                                         ph.scaling_list_aps_id)
                if aps is None:
                    raise ValueError(
                        f"missing scaling-list APS {ph.scaling_list_aps_id}")
                cs.scaling_list = aps.scaling_list
            cs.lmcs_info = None
            if ph.lmcs_enabled:
                from vvdec_tpu_torch.hls.params import LMCS_APS
                aps = self.psman.get_aps(LMCS_APS, ph.lmcs_aps_id)
                if aps is None:
                    raise ValueError(f"missing LMCS APS {ph.lmcs_aps_id}")
                cs.lmcs_info = aps.lmcs
            pf = ParsedFrame(cs=cs, poc=sh.poc, is_idr=nal.is_idr,
                             nal_type=int(nal.nal_type))
            total = pps.pic_width_in_ctu * pps.pic_height_in_ctu
            self._pending = (pf, set(), total, [])
            slice_idx = 0
        else:
            pf, covered0, total, _tasks = self._pending
            cs = pf.cs
            if sh.poc != pf.poc:
                raise ValueError("slice POC changed mid-picture "
                                 f"({sh.poc} vs {pf.poc})")
            slice_idx = len(cs.shs)
            cs.shs.append(sh)
            cs.sh = sh  # CtuDecoder snapshots the current slice header
        # per-slice ALF APS references
        if any(sh.alf_enabled) or sh.ccalf_cb_enabled or sh.ccalf_cr_enabled:
            from vvdec_tpu_torch.hls.params import ALF_APS
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
        start_byte = sh.data_offset_bits // 8
        from vvdec_tpu_torch.cabac.engine import make_cabac_decoder
        dec = make_cabac_decoder(full_rbsp, start_byte)
        dec.reset(sh.qp_y, sh.slice_type)
        if self.walk_pool is not None and slice_idx == 0 \
                and len(sh.ctu_addrs) >= total:
            # single-slice picture: defer the whole CABAC walk to the
            # parse-ahead pool; the picture is "parsed" when the future
            # resolves (checked before reconstruction)
            coder = CtuDecoder(cs, dec=dec, slice_idx=slice_idx)
            pf.walk_future = self.walk_pool.submit(coder.decode_slice)
            self._pending = None
            return pf
        if self.walk_pool is not None and self._parallel_slice_ok(cs, dec):
            # multi-slice picture: ONE walk task per slice over a proxy
            # cs with private record buffers and maps; slices of the
            # same picture parse concurrently (DecLibParser.cpp:948) and
            # merge at join (ParsedFrame.walk_future)
            task = self._submit_slice_walk(cs, sh, dec, slice_idx)
            pf, covered, total, tasks = self._pending
            tasks.append(task)
            covered.update(sh.ctu_addrs)
            self._pending = (pf, covered, total, tasks)
            if len(covered) >= total:
                pf.walk_future = _MultiSliceWalk(cs, tasks)
                self._pending = None
                return pf
            return None
        coder = CtuDecoder(cs, dec=dec, slice_idx=slice_idx)
        coder.decode_slice()
        pf, covered, total, tasks = self._pending
        covered.update(sh.ctu_addrs)
        self._pending = (pf, covered, total, tasks)
        if len(covered) >= total:
            cs.sh = cs.shs[0]
            self._pending = None
            return pf
        return None

    @staticmethod
    def _parallel_slice_ok(cs, dec) -> bool:
        """Per-slice walk tasks need the native walk (the merge operates
        on its flat records); mirror native_walk_ok's gates."""
        import os
        if os.environ.get("VVDEC_TPU_TORCH_PY_WALK") == "1":
            return False
        if cs.sps.act_enabled:
            return False
        return hasattr(dec, "_d") and hasattr(dec._d, "walk_begin")

    def _submit_slice_walk(self, cs, sh, dec, slice_idx):
        """Submit one slice's CABAC walk on a private proxy cs (fresh
        walk buffers + CU/QP/slice maps; coefficient planes and per-CTU
        parameter lists stay shared — slices write disjoint regions)."""
        import copy
        proxy = copy.copy(cs)
        proxy.__dict__.pop("_nw", None)
        proxy.__dict__.pop("_mctx", None)
        proxy.__dict__.pop("_mctx_side", None)
        proxy.cu_map = np.full_like(cs.cu_map, -1)
        proxy.cu_map_c = None if cs.cu_map_c is None \
            else np.full_like(cs.cu_map_c, -1)
        proxy.qp_map = np.zeros_like(cs.qp_map)
        proxy.slice_map = np.full_like(cs.slice_map, -1)
        proxy.sh = sh
        proxy.cus = []
        proxy.tus = []

        def run():
            coder = CtuDecoder(proxy, dec=dec, slice_idx=slice_idx)
            coder.decode_slice()
            return proxy

        return self.walk_pool.submit(run), proxy


class _MultiSliceWalk:
    """Joins the per-slice CABAC walk tasks of one picture and merges
    their private walk records/maps into the real CodingStructure (the
    reference's per-slice parse tasks, DecLibParser.cpp:948-1012, with
    context isolation per slice as DecSlice.cpp:133-167).  Each task
    parsed its slice into a proxy cs with private record buffers and
    CU/QP/slice maps; cross-slice neighbor lookups during the walk see
    -1 (unavailable), which matches the slice availability rule."""

    def __init__(self, cs, tasks) -> None:
        self.cs = cs
        self.tasks = tasks  # [(future, proxy)] in slice order
        self._done = False

    def result(self) -> None:
        if self._done:
            return
        self._done = True
        from vvdec_tpu_torch.cabac.native_walk import (
            CU_F, LazyRecList, _materialize_cu, _materialize_tu)
        cs = self.cs
        proxies = []
        for fut, proxy in self.tasks:
            fut.result()  # re-raises slice parse errors
            proxies.append(proxy)
        first_tu_col = CU_F["first_tu"]
        cu_parts, tu_parts = [], []
        cu_base = tu_base = 0
        for p in proxies:
            nw = p._nw
            ncu, ntu = int(nw["counts"][0]), int(nw["counts"][1])
            cu_rec = nw["cu_rec"][:ncu].copy()
            tu_rec = nw["tu_rec"][:ntu].copy()
            cu_rec[:, first_tu_col] += tu_base
            tu_rec[:, 0] += cu_base
            cu_parts.append(cu_rec)
            tu_parts.append(tu_rec)
            m = p.cu_map >= 0
            cs.cu_map[m] = p.cu_map[m] + cu_base
            if cs.cu_map_c is not None:
                mc = p.cu_map_c >= 0
                cs.cu_map_c[mc] = p.cu_map_c[mc] + cu_base
            ms = p.slice_map >= 0
            cs.slice_map[ms] = p.slice_map[ms]
            cs.qp_map[ms] = p.qp_map[ms]
            cu_base += ncu
            tu_base += ntu
        nw = {
            "cu_rec": np.concatenate(cu_parts),
            "tu_rec": np.concatenate(tu_parts),
            "counts": np.asarray([cu_base, tu_base], dtype=np.int32),
        }
        cs._nw = nw
        cs.chroma_qp_adj = proxies[-1].chroma_qp_adj
        cs.cus = LazyRecList(lambda i: _materialize_cu(cs, nw, i))
        cs.tus = LazyRecList(lambda i: _materialize_tu(cs, nw, i))
        cs.cus.extend([None] * cu_base)
        cs.tus.extend([None] * tu_base)
        cs.sh = cs.shs[0]


class _DeferredFrame:
    """In-flight device-filtered frame: resolves to pixel planes on first
    use (as a host picture's reference or for output), running the
    deferred DPH check.  `pic` is its picture id in the stage profiler's
    spans, which its readback carries."""

    def __init__(self, dec, pending, sei, poc, bit_depth, pic) -> None:
        self._dec = dec
        self._pending = pending
        self._sei = sei
        self._poc = poc
        self._bd = bit_depth
        self._pic = pic
        self._planes32 = None
        self._u16 = None

    def resolve_int32(self) -> list:
        if self._planes32 is None:
            with profiler.picture(self._pic):
                self._planes32 = self._pending.resolve()
            self._pending = None
            self._u16 = [u16_view(p) for p in self._planes32]
            self._dec._check_dph(self._sei, self._u16, self._bd,
                                 self._poc)
        return self._planes32

    def resolve_u16(self) -> list:
        self.resolve_int32()
        return self._u16


def picture_type(f: ParsedFrame) -> str:
    """"IDR", "I", "B" or "P": the picture's type in the per-picture log
    line and in the stage profiler's picture ids."""
    if f.is_idr:
        return "IDR"
    sh = f.cs.sh
    return "I" if sh.is_intra else ("B" if sh.is_b else "P")


def t_is_ref(nal_type) -> bool:
    """Whether a TemporalId-0 picture of this NAL type updates prevTid0Pic:
    every type does, as in vvdec_tpu (RASL, RADL and sub-layer
    non-reference pictures are not singled out)."""
    return True


def parse_annexb(data: bytes) -> list[ParsedFrame]:
    return FrameParser().parse_stream(data)


class StreamDecoder:
    """Streaming decoder: push Annex-B bytes in, pull pictures out in
    output (bumping) order.

    The vvdec_decode/vvdec_flush analog (vvdecimpl.cpp:271,:511): NAL
    dispatch to the parser, one-picture parse-ahead (a picture is
    reconstructed when the next one begins, so its suffix SEIs — notably
    the decoded-picture-hash — are attached first), reference management
    with a device-resident DPB, and DPB output bumping.  Pictures the
    device pipeline rejects are reconstructed on the host and counted in
    `fallback_census` (a Counter with the reference's keys:
    device_recon:<reason>, device_filter:<reason>, intra_c:, inter_c:,
    tu_python, tu_native).  Concealment and the recon-while-parse
    threads are the reference's (see __init__)."""

    def __init__(self, device=None, strict_hash: bool = True,
                 err_policy: str = "strict", threads: int = 0,
                 parse_delay: int | None = None):
        """device: where the reconstruction runs (default CUDA; raises when
        CUDA is missing unless "cpu" is passed).

        err_policy: "strict" raises on broken streams; "conceal" follows
        the reference's fault tolerance — lost references are synthesized
        (closest picture or grey, DecLibParser::prepareUnavailablePicture,
        PicListManager::findClosestPic) and broken pictures are grey-filled
        and kept referenceable (DecLib::sanitizeBrokenPicture).  Only
        faults of the stream are concealed: a kernel's build, load or
        launch error, CUDA out of memory and any other CUDA error raise
        under either policy (`is_device_fault`).

        threads >= 2 enables the recon-while-parse overlap (the reference's
        RECO_WHILE_PARSE, TypeDef.h:69 + parse-ahead, DecLib.cpp:128-133):
        a dedicated parse thread runs the CABAC walk (which releases the
        GIL inside the C loops) up to `parse_delay` pictures ahead while
        the calling thread reconstructs; threads >= 3 adds threads - 2
        walk threads.  Those threads never touch the device: the plan,
        the uploads, the launches and the readbacks all run on the thread
        that calls push or flush.  parse_delay defaults to
        min(1.5 * threads, 48), the reference's default."""
        from vvdec_tpu_torch.device import resolve_device
        from vvdec_tpu_torch.dpb import PicListManager
        self.serial = next(_serials)
        self.parser = FrameParser()
        self.plm = PicListManager()
        self.device = resolve_device(device)
        self.strict_hash = strict_hash
        self.err_policy = err_policy
        self._parse_exec = None
        self._last_parsed: ParsedFrame | None = None
        if parse_delay is None:
            parse_delay = min(int(threads * 1.5), 48) if threads else 1
        self._parse_delay = max(1, parse_delay)
        if threads >= 2:
            from concurrent.futures import ThreadPoolExecutor
            self._parse_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="vvdec-parse")
            if threads >= 3:
                # picture-walk tasks run threads-2 wide (the reference
                # spawns one parse task per slice, DecLibParser.cpp:990)
                self.parser.walk_pool = ThreadPoolExecutor(
                    max_workers=threads - 2,
                    thread_name_prefix="vvdec-walk")
        self.hash_errors = 0
        # concealed pictures: one per substituted reference, one per
        # grey-filled broken picture
        self.error_pictures = 0
        # per-picture fallback census: every picture the device pipeline
        # rejects is counted here with its reason, as are the host
        # reconstruction's own fallbacks from its C paths
        from collections import Counter
        self.fallback_census = Counter()
        # the device DPB: poc -> the filtered planes on the device (the
        # PendingFrame's planes_dev, kept past its readback), plus what
        # later pictures' motion derivation and RPR check read
        self._refs_dev: dict[int, tuple] = {}
        # poc -> the in-flight frame or its int32 host planes: what a
        # host-reconstructed picture reads its references from
        self._refs_host: dict[int, object] = {}
        self._ref_cols: dict[int, object] = {}  # poc -> ColMotion
        self._ref_pps: dict[int, object] = {}   # poc -> PPS (RPR scaling)
        # under err_policy="conceal": poc -> (host planes or in-flight
        # frame, ColMotion) of each picture that reference marking dropped
        # since the last IDR.  Only concealment reads them, so that a lost
        # reference takes the closest decoded picture that vvdec_tpu picks
        # (it keeps every picture until the next IDR); uploaded on use
        self._unused_refs: dict[int, tuple] = {}
        self._pending: ParsedFrame | None = None
        self._num_reorder = 0
        # random-access tune-in state
        self._first_rap_poc: int | None = None   # first decoded RAP
        self._first_rap_cra = False
        self._last_irap_poc: int | None = None
        self._gdr_recovery_poc: int | None = None

    def push(self, data: bytes) -> list:
        """Feed a chunk of Annex-B bytes (one AU or more); returns the
        pictures that became ready for output, in output order."""
        if self._parse_exec is not None:
            return self._push_threaded(data)
        out = []
        for nal in read_nal_units(data):
            try:
                done = self._feed(nal, self._pending)
            except Exception as e:
                done = self._parse_failed(e)
            for f in done:
                if self._pending is not None:
                    self._reconstruct(self._pending)
                self._pending = f
            out.extend(self._bump())
        return out

    def _feed(self, nal, last_frame) -> list:
        """parser.feed_nal in the stage "parse", whose span carries the
        picture of a slice once its header is read."""
        with profiler.stage("parse"):
            done = self.parser.feed_nal(nal, last_frame=last_frame)
            if profiler.enabled and nal.is_vcl:
                open_ = self.parser._pending
                f = done[-1] if done else open_[0] if open_ else None
                if f is not None:
                    profiler.tag(self._picture_id(f))
        return done

    def _picture_id(self, f: ParsedFrame) -> tuple:
        """(decoder serial, POC, type): the picture in the spans."""
        return (self.serial, f.poc, picture_type(f))

    def _parse_failed(self, exc: Exception) -> list:
        """Called while `exc`, raised by the parser, is being handled:
        re-raises it unless the decoder conceals a fault of the stream.
        A parse error mid-picture breaks the open picture, which is then
        grey-filled, and the parser resynchronizes (reference: parse-task
        exception transport, DecLibParser.cpp:969-980).  Returns the
        broken picture, if any."""
        if self.err_policy != "conceal" or is_device_fault(exc):
            raise
        if self.parser._pending is None:
            return []
        pf = self.parser._pending[0]
        pf.broken = True
        self.parser._pending = None
        return [pf]

    def _parse_one(self, nal) -> list:
        """Runs on the parse thread; serial, owns all parser state."""
        try:
            done = self._feed(nal, self._last_parsed)
        except Exception as e:
            done = self._parse_failed(e)
        if done:
            self._last_parsed = done[-1]
        return done

    def _push_threaded(self, data: bytes) -> list:
        """Recon-while-parse: the parse thread runs ahead up to the
        parse-delay while this thread reconstructs completed pictures.
        The CABAC walk and the C recon kernels both release the GIL, so
        the two stages genuinely overlap."""
        from collections import deque
        out = []
        futs: deque = deque()
        # NAL count bound approximating the picture-count parse delay
        bound = 4 + 2 * self._parse_delay

        def drain_one():
            done = futs.popleft().result()
            for f in done:
                if self._pending is not None:
                    self._reconstruct(self._pending)
                self._pending = f
            out.extend(self._bump())

        for nal in read_nal_units(data):
            futs.append(self._parse_exec.submit(self._parse_one, nal))
            while len(futs) > bound:
                drain_one()
        while futs:
            drain_one()
        return out

    def flush(self) -> list:
        """Drain all remaining pictures (vvdec_flush)."""
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
        pool = self.parser.walk_pool
        self.parser = FrameParser()
        self.parser.walk_pool = pool
        return out

    def _bump(self) -> list:
        out = []
        while True:
            p = self.plm.get_next_output(self._num_reorder)
            if p is None:
                return out
            out.append(p)

    def _grey_planes(self, cs) -> list:
        """Mid-grey planes for concealment (Picture::fillGrey)."""
        grey = 1 << (cs.sps.bit_depth - 1)
        return [np.full((h, w), grey, dtype=np.int32)
                for (w, h) in cs.comp_size]

    def _store_grey(self, poc: int, cs) -> list:
        """A grey picture enters the DPB under `poc`: torch.full planes on
        the device, its numpy planes for the host path.  Returns those."""
        planes = self._grey_planes(cs)
        grey = 1 << (cs.sps.bit_depth - 1)
        self._refs_dev[poc] = tuple(
            torch.full(p.shape, grey, dtype=torch.int32, device=self.device)
            for p in planes)
        self._refs_host[poc] = planes
        return planes

    def _ref_planes_of(self, poc: int) -> list:
        """A DPB picture's int32 host planes: a device picture resolves
        its output readback once, and the planes stay cached by POC while
        the picture is a reference."""
        v = self._refs_host[poc]
        if isinstance(v, _DeferredFrame):
            v = v.resolve_int32()
            self._refs_host[poc] = v
        return v

    def _host_ref_sets(self, cs) -> None:
        """Swap the device planes of cs's reference sets for host planes,
        for the host reconstruction."""
        def host(pocs):
            return [[self._ref_planes_of(p) for p in lst] for lst in pocs]

        cs.slice_ref_sets = [
            None if st is None else (st[0], host(st[0])) + tuple(st[2:])
            for st in cs.slice_ref_sets]
        cs.ref_planes = host(cs.ref_pocs)

    def _random_access_skip(self, f: ParsedFrame) -> bool:
        """RASL pictures associated with the RAP we tuned in at are not
        decodable (DecLibParser::isRandomAccessSkipPicture)."""
        t = NalUnitType(f.nal_type)
        if t in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                 NalUnitType.CRA, NalUnitType.GDR):
            self._last_irap_poc = f.poc
            if self._first_rap_poc is None:
                self._first_rap_poc = f.poc
                self._first_rap_cra = t == NalUnitType.CRA
                if t == NalUnitType.GDR:
                    self._gdr_recovery_poc = \
                        f.poc + f.cs.ph.recovery_poc_cnt
            return False
        if t == NalUnitType.RASL and self._first_rap_cra \
                and self._last_irap_poc == self._first_rap_poc:
            return True
        return False

    @staticmethod
    def _rpl_key(sh):
        """Hashable identity of a slice's RPLs + active counts (two
        slices with equal keys share one resolved reference set)."""
        out = [tuple(sh.num_ref_idx_active)]
        for lst in range(2):
            rpl = sh.rpl[lst]
            out.append(None if rpl is None else tuple(
                (e.is_long_term, e.value,
                 getattr(e, "delta_poc_msb_present", False),
                 getattr(e, "delta_poc_msb_cycle", 0))
                for e in rpl.entries))
        return tuple(out)

    def _entry_poc(self, f, cs, e) -> int:
        """The POC an RPL entry names: a short-term delta, or a long-term
        reference matched by POC LSB against the DPB, or by full POC
        when the MSB cycle is signalled (Slice::constructRefPicLists +
        xGetLongTermRefPic)."""
        if not e.is_long_term:
            return f.poc + e.value
        max_lsb = cs.sps.max_poc_lsb
        if e.delta_poc_msb_present:
            return (e.value + f.poc - e.delta_poc_msb_cycle * max_lsb
                    - (f.poc & (max_lsb - 1)))
        return next((p for p in sorted(self._refs_dev, reverse=True)
                     if (p & (max_lsb - 1)) == e.value), e.value)

    def _mark_unused(self, f, cs) -> None:
        """Reference picture marking (VVC 8.3.3): a DPB picture that no
        entry of this picture's RPLs names, active or not, in any slice,
        is unused for reference from now on, and leaves the device DPB
        with its host planes, its motion and its PPS.  Called after the
        picture's reference sets are resolved, so a lost reference is
        concealed from the DPB the previous picture left."""
        named = {self._entry_poc(f, cs, e)
                 for s in cs.shs for rpl in s.rpl if rpl is not None
                 for e in rpl.entries}
        for poc in [p for p in self._refs_dev if p not in named]:
            del self._refs_dev[poc]
            host = self._refs_host.pop(poc, None)
            cols = self._ref_cols.pop(poc, None)
            self._ref_pps.pop(poc, None)
            if self.err_policy == "conceal":
                self._unused_refs[poc] = (host, cols)

    def _build_ref_set(self, f, cs, sh_ref):
        """Resolve one slice's RPLs: (ref_pocs, ref_planes, ref_cols,
        ref_scaled, check_ldc), plus a missing-reference error flag
        (Slice::constructRefPicLists + scaleRefPicList).  ref_planes holds
        the device DPB's planes."""
        from vvdec_tpu_torch.frame import rpr_np
        ref_pocs = [[], []]
        ref_planes = [[], []]
        ref_cols = [[], []]
        ref_scaled = [[], []]
        pic_error = False
        for lst in range(2):
            rpl = sh_ref.rpl[lst]
            if rpl is None:
                continue
            for e in rpl.entries:
                ref_poc = self._entry_poc(f, cs, e)
                ref_pocs[lst].append(ref_poc)
                if ref_poc not in self._refs_dev:
                    if self.err_policy != "conceal":
                        raise ValueError(
                            f"missing reference POC {ref_poc}")
                    self._substitute_ref(ref_poc, cs)
                    pic_error = True
                ref_planes[lst].append(self._refs_dev[ref_poc])
                ref_cols[lst].append(self._ref_cols[ref_poc])
                # RPR: record per-ref scaling when the reference uses a
                # different size/scaling window (Slice::scaleRefPicList)
                ref_pps = self._ref_pps.get(ref_poc, cs.pps)
                if rpr_np.is_ref_scaled(cs.pps, ref_pps):
                    ref_scaled[lst].append(
                        (rpr_np.get_rpr_scaling(cs.sps, cs.pps,
                                                ref_pps), ref_pps))
                else:
                    ref_scaled[lst].append(None)
        # low-delay check: every active reference precedes this picture
        check_ldc = all(
            p <= f.poc
            for lst in range(2)
            for p in ref_pocs[lst][: sh_ref.num_ref_idx_active[lst]])
        return (ref_pocs, ref_planes, ref_cols, ref_scaled,
                check_ldc), pic_error

    def _substitute_ref(self, poc: int, cs) -> int | None:
        """Lost reference: the closest picture decoded since the last IDR
        (DecLibParser::prepareUnavailablePicture + findClosestPic), still
        a reference or already marked unused, or a grey frame, stored
        under `poc` in the device DPB, its host planes and its motion.
        Returns the POC picked, None for grey."""
        self.error_pictures += 1
        candidates = set(self._refs_dev) | set(self._unused_refs)
        if candidates:
            best = min(candidates, key=lambda p: (abs(p - poc), p))
            if best in self._refs_dev:
                self._refs_dev[poc] = self._refs_dev[best]
                self._refs_host[poc] = self._refs_host[best]
                self._ref_cols[poc] = self._ref_cols[best]
                return best
            from vvdec_tpu_torch.ops.device_pipeline import upload
            host, cols = self._unused_refs[best]
            if isinstance(host, _DeferredFrame):
                host = host.resolve_int32()
            self._refs_dev[poc] = tuple(
                upload(p, self.device, "wait: upload concealed reference")
                for p in host)
            self._refs_host[poc] = host
            self._ref_cols[poc] = cols
            return best
        from vvdec_tpu_torch.frame.inter_np import ColMotion
        self._store_grey(poc, cs)
        self._ref_cols[poc] = ColMotion(cs, poc)
        return None

    def _resolve_ref_sets(self, f, cs) -> bool:
        """Per-slice reference sets (the reference constructs RPLs per
        slice, Slice::constructRefPicLists); the shared cs.ref_* come from
        the first inter slice, and when slices disagree cs.per_slice_rpl
        is set (plan_frame_device rejects such pictures).  Returns whether
        a reference was missing and substituted."""
        sh_ref = next((s for s in cs.shs if not s.is_intra), cs.sh)
        cs.ref_pocs = [[], []]
        cs.ref_planes = [[], []]
        cs.ref_cols = [[], []]
        cs.ref_scaled = [[], []]  # (scaling, ref_pps) or None per ref (RPR)
        cs.per_slice_rpl = False
        cs.slice_ref_sets = [None] * len(cs.shs)
        pic_error = False
        if sh_ref.is_intra:
            return pic_error
        sets_by_key: dict = {}
        first_key = None
        for si, s in enumerate(cs.shs):
            if s.is_intra:
                continue
            key = self._rpl_key(s)
            if key not in sets_by_key:
                st, err = self._build_ref_set(f, cs, s)
                sets_by_key[key] = st
                pic_error = pic_error or err
            cs.slice_ref_sets[si] = sets_by_key[key]
            if first_key is None:
                first_key = key
        cs.per_slice_rpl = len(sets_by_key) > 1
        (cs.ref_pocs, cs.ref_planes, cs.ref_cols, cs.ref_scaled,
         cs.check_ldc) = sets_by_key[first_key]
        return pic_error

    def _reconstruct(self, f: ParsedFrame) -> None:
        if self._random_access_skip(f):
            return
        try:
            if f.broken:
                raise RuntimeError("picture broken during parse")
            with profiler.picture(self._picture_id(f)):
                self._reconstruct_inner(f)
        except Exception as e:
            if self.err_policy != "conceal" or is_device_fault(e):
                raise
            # broken picture: grey-fill, keep referenceable, mark error
            # (DecLib::sanitizeBrokenPicture, Picture::ensureUsableAsRef).
            # The grey planes replace whatever the failed picture left
            # under its POC; its refined MVs never reach the motion field
            from vvdec_tpu_torch.dpb import DecodedPicture
            from vvdec_tpu_torch.frame.inter_np import ColMotion
            cs = f.cs
            cs.dmvr_fixups = ()
            self.error_pictures += 1
            planes = self._store_grey(f.poc, cs)
            self._ref_cols[f.poc] = ColMotion(cs, f.poc)
            self._ref_pps[f.poc] = cs.pps
            self.plm.add(DecodedPicture(
                poc=f.poc, planes=[u16_view(p) for p in planes],
                bit_depth=cs.sps.bit_depth, is_idr=f.is_idr, sei=f.sei,
                width=cs.w, height=cs.h,
                chroma_format_idc=cs.sps.chroma_format_idc, error=True,
                vui=cs.sps.vui, hrd=cs.sps.hrd_params))

    def _reconstruct_inner(self, f: ParsedFrame) -> None:
        if f.walk_future is not None:
            fut, f.walk_future = f.walk_future, None
            fut.result()  # join the picture's CABAC walk (re-raises)
        from vvdec_tpu_torch.dpb import DecodedPicture
        from vvdec_tpu_torch.frame.inter_np import ColMotion

        cs = f.cs
        if f.is_idr:
            # previous pictures can no longer be referenced (NoOutputOfPrior
            # handling is trivial here: they remain output-marked)
            self.plm.unmark_all_references()
            self._refs_dev.clear()
            self._refs_host.clear()
            self._ref_cols.clear()
            self._ref_pps.clear()
            self._unused_refs.clear()
        self._num_reorder = cs.sps.num_reorder_pics[-1]
        pic_error = self._resolve_ref_sets(f, cs)
        self._mark_unused(f, cs)
        from vvdec_tpu_torch.utils.trace import msg, trace, INFO
        t_pic = time.monotonic()
        # full device pipeline: ITX + MC + intra chain + filters + packing
        # in one device-resident flow (ops/frame_device.py); it times its
        # host stages itself ("plan (host)", "motion (host)").  A picture
        # it rejects is reconstructed on the host, then filtered on the
        # device, or on the host when the device chain rejects it too
        from vvdec_tpu_torch.ops.device_pipeline import (
            device_filter_reject_reason, filter_frame_device, upload)
        from vvdec_tpu_torch.ops.frame_device import (
            plan_frame_device, reconstruct_frame_device)
        desc, dev_reason = plan_frame_device(cs)
        planes = None
        if desc is not None:
            def get_ref(lst, ref_idx, comp):
                return cs.ref_planes[lst][ref_idx][comp]

            pending = reconstruct_frame_device(cs, desc, get_ref,
                                               device=self.device)
        else:
            self.fallback_census[f"device_recon:{dev_reason}"] += 1
            reason = device_filter_reject_reason(cs)
            if reason is not None:
                self.fallback_census[f"device_filter:{reason}"] += 1
            self._host_ref_sets(cs)
            from vvdec_tpu_torch.frame.recon_np import IntraReconstructor
            with profiler.stage("recon"):
                planes = IntraReconstructor(
                    cs, census=self.fallback_census).run()
            pending = None
            if reason is None:
                # the device filter chain; its deblocking strengths are
                # derived before the DMVR MV fixups below, as on the host
                with profiler.stage("filter(submit)"):
                    pending = filter_frame_device(cs, [
                        upload(p, self.device, "wait: upload host picture")
                        for p in planes])
            else:
                from vvdec_tpu_torch.frame.alf_np import alf_frame_vec
                from vvdec_tpu_torch.frame.deblock_np import deblock_frame
                from vvdec_tpu_torch.frame.sao_np import sao_frame
                with profiler.stage("deblock"):
                    deblock_frame(cs, planes)
                with profiler.stage("sao"):
                    sao_frame(cs, planes)
                with profiler.stage("alf"):
                    planes = alf_frame_vec(cs, planes)
        if pending is not None:
            # device-resident DPB entry, stored before the readback drops
            # the PendingFrame's device planes: later pictures gather
            # their MC references from it without a host round trip
            self._refs_dev[f.poc] = tuple(pending.planes_dev)
            deferred = _DeferredFrame(self, pending, f.sei, f.poc,
                                      cs.sps.bit_depth, self._picture_id(f))
            self._refs_host[f.poc] = deferred
        else:
            # host-filtered planes enter the device DPB, uploaded once
            self._refs_dev[f.poc] = tuple(
                upload(p, self.device, "wait: upload host picture")
                for p in planes)
            deferred = None
            self._refs_host[f.poc] = planes
        # DMVR-refined MVs enter the motion field only after the
        # deblocking strengths are derived (TaskFinishMotionInfo,
        # DecCu.cpp:161-213): the device refinement stage leaves a
        # LazyDmvrFixups in cs.dmvr_fixups (iterating it waits for the
        # refined MVs' own readback only), the host reconstruction a list
        fixups = getattr(cs, "dmvr_fixups", ())
        if fixups:
            with profiler.stage("dmvr fixups"):
                for x2, y2, mv0, mv1 in fixups:
                    cs.mi_mv[y2 >> 2, x2 >> 2, 0] = mv0
                    cs.mi_mv[y2 >> 2, x2 >> 2, 1] = mv1
        self._ref_pps[f.poc] = cs.pps
        with profiler.stage("motion (host)"):
            self._ref_cols[f.poc] = ColMotion(cs, f.poc)
        if deferred is None:
            out_planes = [u16_view(p) for p in planes]
            self._check_dph(f.sei, out_planes, cs.sps.bit_depth, f.poc,
                            cs=cs)
        # per-POC decode log + trace (reference per-picture log line,
        # DecLib.cpp:395-438; D_PIC trace channel)
        st = picture_type(f)
        msg(INFO, f"POC {f.poc:4d} [{st}] QP {cs.sh.qp_y} "
                  f"[DT {time.monotonic() - t_pic:.3f}]")
        trace("D_PIC", f"poc={f.poc} type={st}\n", poc=f.poc)
        # GDR tune-in: suppress output until the recovery point
        # (DecLibParser GDR tracking, :658-684)
        needed = True
        if self._gdr_recovery_poc is not None:
            if f.poc >= self._gdr_recovery_poc:
                self._gdr_recovery_poc = None
            else:
                needed = False
        self.plm.add(DecodedPicture(
            poc=f.poc,
            planes=None if deferred is not None else out_planes,
            pending=deferred,
            bit_depth=cs.sps.bit_depth,
            is_idr=f.is_idr, sei=f.sei, width=cs.w, height=cs.h,
            chroma_format_idc=cs.sps.chroma_format_idc, error=pic_error,
            needed_for_output=needed, vui=cs.sps.vui,
            hrd=cs.sps.hrd_params))

    def _check_dph(self, sei, out_planes, bit_depth, poc,
                   cs=None) -> None:
        # decoded-picture-hash verification (DecLib::checkPictureHashSEI,
        # DecLib.cpp:480); per-subpicture hashes arrive nested in
        # subpic-flagged scalable-nesting SEIs (DecLib.cpp:518-569)
        from vvdec_tpu_torch.hls.sei import (
            SEI_DECODED_PICTURE_HASH, SEI_SCALABLE_NESTING,
            calc_picture_hash, parse_dph, parse_scalable_nesting,
        )
        for m in sei:
            if m.payload_type == SEI_DECODED_PICTURE_HASH:
                dph = parse_dph(m)
                got = calc_picture_hash(out_planes, bit_depth, dph.method)
                if got != dph.digest:
                    self.hash_errors += 1
                    if self.strict_hash:
                        raise ValueError(
                            f"decoded picture hash mismatch at POC {poc}: "
                            f"{got.hex()} != {dph.digest.hex()}")
                return
        if cs is None or not cs.subpics:
            return
        ids = cs.pps.subpic_ids if cs.pps.subpic_ids else cs.sps.subpic_ids
        sx, sy = cs.sub_w - 1, cs.sub_h - 1
        for m in sei:
            if m.payload_type != SEI_SCALABLE_NESTING:
                continue
            try:
                nest = parse_scalable_nesting(m)
            except (IndexError, ValueError):
                continue
            if not nest.subpic_flag:
                continue
            dphs = [n for n in nest.messages
                    if n.payload_type == SEI_DECODED_PICTURE_HASH]
            if not dphs:
                continue
            dph = parse_dph(dphs[0])
            for sid in nest.subpic_ids:
                if sid not in ids:
                    continue
                idx = ids.index(sid)
                x0, y0, x1, y1 = cs.subpics[idx][:4]
                views = [out_planes[0][y0:y1, x0:x1]]
                for c in range(1, len(out_planes)):
                    views.append(out_planes[c][y0 >> sy: y1 >> sy,
                                               x0 >> sx: x1 >> sx])
                got = calc_picture_hash(views, bit_depth, dph.method)
                if got != dph.digest:
                    self.hash_errors += 1
                    if self.strict_hash:
                        raise ValueError(
                            f"subpicture {sid} hash mismatch at POC "
                            f"{poc}: {got.hex()} != {dph.digest.hex()}")


def is_device_fault(exc: BaseException) -> bool:
    """Whether an exception comes from the device rather than from the
    stream: a kernel's build, load or launch (KernelError), CUDA out of
    memory, or any other error the CUDA runtime raised (torch's
    AcceleratorError where the installed torch has it, else a
    RuntimeError whose message names CUDA).  Concealment never hides
    these: they raise under err_policy="conceal" too."""
    from vvdec_tpu_torch.ops.cuda._build import KernelError
    if isinstance(exc, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "cuda" in str(exc).lower()


def decode_annexb(data: bytes, device=None,
                  threads: int = 0) -> list[list[np.ndarray]]:
    """Full decode: Annex-B stream -> list of frames in output order, each a
    list of uint16 planes (Y, Cb, Cr), reconstructed on `device` (default
    CUDA; pass "cpu" to run on the CPU)."""
    dec = StreamDecoder(device=device, threads=threads)
    pics = dec.push(data)
    pics.extend(dec.flush())
    return [p.planes for p in pics]


def decode_to_yuv(data: bytes, device=None, threads: int = 0) -> bytes:
    """Decode to the vvdecapp YUV output format: planar LE, one byte per
    sample for 8-bit streams, two bytes otherwise (vvdecHelper.h
    writeYUVToFile sample packing)."""
    # sniff the stream bit depth from the first SPS
    bd = 10
    from vvdec_tpu_torch.bitstream.nal import NalUnitType, read_nal_units
    from vvdec_tpu_torch.hls.reader import parse_sps
    for nal in read_nal_units(data):
        if nal.nal_type == NalUnitType.SPS:
            full = bytes([0, (int(nal.nal_type) << 3) | 1]) + nal.rbsp
            bd = parse_sps(full).bit_depth
            break
    parts = []
    for planes in decode_annexb(data, device=device, threads=threads):
        for p in planes:
            parts.append(p.astype("u1" if bd == 8 else "<u2",
                                  copy=False).tobytes())
    return b"".join(parts)


def main(argv: list[str] | None = None) -> int:
    """CLI decoder: the vvdecapp equivalent (vvdecapp.cpp:main).

    Usage: python -m vvdec_tpu_torch.decoder BITSTREAM [OUT.yuv]
    [--device {cuda,cpu}]
    Prints per-stream summary; OUT.yuv is 16-bit LE planar (vvdecapp format).
    """
    import argparse

    ap = argparse.ArgumentParser(prog="vvdec_tpu_torch",
                                 description="PyTorch/CUDA VVC decoder")
    ap.add_argument("bitstream", help="Annex-B .266 input")
    ap.add_argument("output", nargs="?", help="YUV output (16-bit LE planar)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the reconstruction runs (default cuda)")
    args = ap.parse_args(argv)

    data = open(args.bitstream, "rb").read()
    t0 = time.monotonic()
    yuv = decode_to_yuv(data, device=args.device)
    dt = time.monotonic() - t0
    if args.output:
        with open(args.output, "wb") as f:
            f.write(yuv)
    n = sum(1 for _ in parse_annexb(data))
    print(f"vvdec_tpu_torch: {n} frames decoded in {dt:.3f}s "
          f"({n / dt:.2f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
