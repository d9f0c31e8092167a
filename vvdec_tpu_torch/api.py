"""Public decoder API.

Mirrors the reference's C API surface (include/vvdec/vvdec.h.in:558-712:
vvdec_decoder_open / vvdec_decode / vvdec_flush / vvdec_frame_unref /
vvdec_find_frame_sei / vvdec_get_hash_error_count) as an idiomatic Python
class over the streaming core.  Frames expose zero-copy views of the
internal 16-bit planes (vvdecimpl.cpp:953 xAddPicture hands out plane
pointers the same way).

A copy of vvdec_tpu/api.py whose DecoderParams takes `device` (default
None: CUDA, raising without a card; "cpu" runs on the CPU) in place of
`use_device_pipeline`: the port reconstructs every picture through its
device pipeline, so it has no other path to choose.  Film grain is
synthesized on the host, on the read-back planes, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from vvdec_tpu_torch.utils.trace import profiler


@dataclass
class DecoderParams:
    """vvdecParams analog (vvdec.h.in:487-502)."""

    threads: int = 0
    parse_delay: int = -1
    verify_picture_hash: bool = False   # strict: raise on mismatch
    film_grain_synthesis: bool = True
    log_level: int = 2
    device: object = None   # torch device of the reconstruction (CUDA)
    # VVDEC_ERR_HANDLING_TRY_CONTINUE analog (vvdec.h.in:180-184):
    # "strict" raises, "conceal" grey-fills broken pictures and synthesizes
    # lost references, continuing the stream
    err_handling: str = "strict"
    # external frame-buffer allocator (vvdec_decoder_open_with_allocator,
    # vvdec.h.in:514-523): called per output frame with
    # (width, height, bit_depth, chroma_format_idc) and must return a list
    # of writable numpy arrays the decoded planes are placed into;
    # buffer_unref is invoked from frame_unref with the same list
    buffer_allocator: object = None
    buffer_unref: object = None


@dataclass
class Frame:
    """vvdecFrame analog: decoded picture handed to the application."""

    planes: list = field(default_factory=list)  # numpy uint16 views (Y,Cb,Cr)
    width: int = 0
    height: int = 0
    bit_depth: int = 10
    poc: int = 0
    cts: int = 0
    sei: list = field(default_factory=list)
    chroma_format_idc: int = 1
    picture: object = None               # internal DPB handle
    # picAttributes analogs (vvdecPicAttributes: vui/hrd from the SPS)
    vui: dict | None = None
    hrd: dict | None = None


class Decoder:
    """vvdec_decoder_open analog: a stateful streaming decoder."""

    def __init__(self, params: DecoderParams | None = None):
        from vvdec_tpu_torch.decoder import StreamDecoder
        self.params = params or DecoderParams()
        with profiler.stage("api: open"):
            self._core = StreamDecoder(
                device=self.params.device,
                strict_hash=self.params.verify_picture_hash,
                err_policy=self.params.err_handling,
                threads=self.params.threads,
                parse_delay=None if self.params.parse_delay < 0
                else self.params.parse_delay)
        self._fg = None  # film-grain synthesizer (lazy, FGC-SEI driven)
        self._fg_state = "none"

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        with profiler.stage("api: close"):
            self._core = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- decoding ----------------------------------------------------------
    def decode(self, au: bytes) -> list[Frame]:
        """Push one access unit (or any Annex-B chunk); returns the frames
        that became ready for output, in output order (vvdec_decode)."""
        with profiler.stage("api: decode"):
            return [self._to_frame(p) for p in self._core.push(au)]

    def flush(self) -> list[Frame]:
        """Drain all remaining frames (vvdec_flush)."""
        with profiler.stage("api: flush"):
            return [self._to_frame(p) for p in self._core.flush()]

    def frame_unref(self, frame: Frame) -> None:
        """Release the frame's DPB slot (vvdec_frame_unref)."""
        with profiler.stage("api: frame_unref"):
            if self.params.buffer_unref is not None and frame.planes:
                self.params.buffer_unref(frame.planes)
            if frame.picture is not None:
                self._core.plm.release(frame.picture)
                frame.picture = None
                frame.planes = []

    # -- queries -----------------------------------------------------------
    def find_frame_sei(self, frame: Frame, payload_type: int):
        """First SEI of the given payload type attached to this frame
        (vvdec_find_frame_sei)."""
        for m in frame.sei:
            if m.payload_type == payload_type:
                return m
        return None

    def get_hash_error_count(self) -> int:
        return self._core.hash_errors

    def get_decoder_info(self) -> str:
        """Capability string (DecLib::create banner, DecLib.cpp:145-160),
        plus the fallback census: every frame where a device or native-C
        stage silently fell back to the host/Python path, with reason."""
        from vvdec_tpu_torch.native import native_cabac, native_recon
        native = "C" if (native_cabac() and native_recon()) else "python"
        dev = self._core.device.type
        info = (f"vvdec_tpu_torch {version()} [KERNELS={native}; "
                f"RECON={dev}; "
                f"FGS={int(self.params.film_grain_synthesis)}]")
        census = getattr(self._core, "fallback_census", None)
        if census:
            info += " FALLBACKS[" + "; ".join(
                f"{k}={v}" for k, v in sorted(census.items())) + "]"
        return info

    def get_fallback_census(self) -> dict:
        """Per-reason counts of device-/C-stage host fallbacks."""
        return dict(getattr(self._core, "fallback_census", {}) or {})

    # -- helpers -----------------------------------------------------------
    def _to_frame(self, pic) -> Frame:
        planes = pic.planes
        if self.params.film_grain_synthesis:
            planes = self._apply_film_grain(pic, planes)
        if self.params.buffer_allocator is not None:
            bufs = self.params.buffer_allocator(
                pic.width, pic.height, pic.bit_depth,
                pic.chroma_format_idc)
            for dst, src in zip(bufs, planes):
                dst[...] = src
            planes = bufs
        return Frame(planes=planes, width=pic.width, height=pic.height,
                     bit_depth=pic.bit_depth, poc=pic.poc, sei=pic.sei,
                     chroma_format_idc=pic.chroma_format_idc, picture=pic,
                     vui=getattr(pic, "vui", None),
                     hrd=getattr(pic, "hrd", None))

    def _apply_film_grain(self, pic, planes):
        """FGC-SEI-driven film grain synthesis on output (VVDecImpl::
        xAddGrain, vvdecimpl.cpp:894; exact VFGS model).  The synthesizer
        is persistent — grain seeds evolve across output frames — and the
        FGC state follows the persistence flag (xUpdateFGC)."""
        from vvdec_tpu_torch.hls.sei import (
            SEI_FILM_GRAIN_CHARACTERISTICS, parse_fgc)
        if pic.is_idr:
            # FGC persistence ends at a CLVS start (vvdecimpl.cpp:985)
            self._fg_state = "none"
        msg = next((m for m in pic.sei
                    if m.payload_type == SEI_FILM_GRAIN_CHARACTERISTICS),
                   None)
        if msg is not None:
            fgc = parse_fgc(msg)
            if fgc.cancel:
                self._fg_state = "none"
            else:
                if self._fg is None:
                    from vvdec_tpu_torch.frame.film_grain import \
                        FilmGrainSynthesizer
                    self._fg = FilmGrainSynthesizer()
                self._fg.update_fgc(fgc)
                self._fg_state = "persist" if fgc.persistence else "once"
        if self._fg is None or self._fg_state == "none":
            return planes
        out = self._fg.apply(planes, pic.bit_depth, pic.chroma_format_idc)
        if self._fg_state != "persist":
            self._fg_state = "none"
        return out


def version() -> str:
    """Library version string (vvdec_get_version analog)."""
    return "0.1.0"
