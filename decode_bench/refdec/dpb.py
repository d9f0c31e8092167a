"""Decoded picture buffer: output reordering ("bumping"), frame locking.

Behavioral parity with the reference DPB (PicListManager::getNextOutputPic,
source/Lib/CommonLib/PicListManager.cpp:285-409): output range up to the
first unfinished picture or next IDR, tune-in delay, auto-flush before an
IDR, lowest-POC bumping gated on the number of not-yet-displayed pictures
vs. the stream's num_reorder_pics, MAX_OUT_OF_ORDER_PICS slack before the
first output, and application-side frame locking (vvdec_frame_unref).
"""

from __future__ import annotations

MAX_OUT_OF_ORDER_PICS = 3  # TypeDef.h:72


class DecodedPicture:
    """A reconstructed picture held in the DPB.

    `planes` may be deferred: with the device filter pipeline the pixel
    data is an in-flight device readback (`pending`), resolved lazily on
    first access — the decoder keeps parsing/reconstructing later frames
    while filtered frames stream back from the TPU."""

    def __init__(self, poc: int, planes: list | None = None,
                 bit_depth: int = 10, is_idr: bool = False,
                 sei: list | None = None, needed_for_output: bool = True,
                 reference_mark: bool = True, finished: bool = True,
                 locked_by_application: bool = False, width: int = 0,
                 height: int = 0, chroma_format_idc: int = 1,
                 error: bool = False, vui: dict | None = None,
                 hrd: dict | None = None, pending=None) -> None:
        self._planes = planes
        self.pending = pending         # object with resolve_u16()
        self.poc = poc
        self.bit_depth = bit_depth
        self.is_idr = is_idr
        self.sei = sei if sei is not None else []
        self.needed_for_output = needed_for_output
        self.reference_mark = reference_mark
        self.finished = finished
        self.locked_by_application = locked_by_application
        self.width = width
        self.height = height
        self.chroma_format_idc = chroma_format_idc
        self.error = error
        self.vui = vui
        self.hrd = hrd

    @property
    def planes(self) -> list:
        if self._planes is None and self.pending is not None:
            self._planes = self.pending.resolve_u16()
            self.pending = None
        return self._planes

    @planes.setter
    def planes(self, v) -> None:
        self._planes = v
        self.pending = None


class PicListManager:
    """Decode-order picture list with vvdec-parity output bumping."""

    def __init__(self, parallel_instances: int = 0) -> None:
        self._pics: list[DecodedPicture] = []
        self._tune_in_delay = 0
        self._first_output = True
        self._parallel = parallel_instances

    def reset(self) -> None:
        self._pics.clear()
        self._tune_in_delay = 0
        self._first_output = True

    def add(self, pic: DecodedPicture) -> None:
        self._pics.append(pic)

    def pictures(self) -> list[DecodedPicture]:
        return list(self._pics)

    def unmark_all_references(self) -> None:
        """IDR: previous pictures can no longer be referenced."""
        for p in self._pics:
            p.reference_mark = False
        self._prune()

    def release(self, pic: DecodedPicture) -> None:
        """vvdec_frame_unref analog: the app is done with this picture."""
        pic.locked_by_application = False
        self._prune()

    def _prune(self) -> None:
        self._pics = [
            p for p in self._pics
            if p.needed_for_output or p.reference_mark
            or p.locked_by_application
        ]

    def get_next_output(self, num_reorder: int,
                        flush: bool = False) -> DecodedPicture | None:
        """Port of PicListManager::getNextOutputPic (see module docstring)."""
        pics = self._pics
        if not pics:
            return None

        # find the picture range up to the first unfinished pic / next IDR
        seq_start, seq_end = 0, len(pics)
        found_output_pic = False
        for i, p in enumerate(pics):
            if not p.needed_for_output and p.finished:
                continue
            if not p.finished:
                seq_end = i
                break
            if p.is_idr:
                if not found_output_pic:
                    seq_start = i
                else:
                    seq_end = i
                    break
            found_output_pic |= p.needed_for_output
            if not found_output_pic and not p.reference_mark:
                seq_start = i
        if not found_output_pic:
            return None

        rng = pics[seq_start:seq_end]

        if self._tune_in_delay <= num_reorder + self._parallel + 1 \
                and not flush:
            self._tune_in_delay += 1
            return None

        # an IDR coming up flushes everything before it
        if seq_end < len(pics) and pics[seq_end].is_idr:
            flush = True

        if not flush:
            not_displayed = sum(1 for p in rng
                                if p.needed_for_output and p.finished)
            slack = MAX_OUT_OF_ORDER_PICS if self._first_output else 0
            if not_displayed <= num_reorder + slack:
                return None

        lowest: DecodedPicture | None = None
        for p in rng:
            if p.needed_for_output and p.finished \
                    and (lowest is None or p.poc < lowest.poc):
                lowest = p
        if lowest is not None:
            self._first_output = False
            lowest.locked_by_application = True
            lowest.needed_for_output = False
        return lowest

    def drain(self, num_reorder: int) -> list[DecodedPicture]:
        """Flush every remaining output picture in bumping order."""
        out = []
        while True:
            p = self.get_next_output(num_reorder, flush=True)
            if p is None:
                return out
            out.append(p)
