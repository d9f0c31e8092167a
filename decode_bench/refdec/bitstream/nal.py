"""Annex-B byte stream handling and NAL unit parsing for H.266/VVC.

Behavioral parity targets (re-implemented from the H.266 spec, not ported):
  - vvdec VVDecImpl::xRetrieveNalStartCode  (vvdecimpl.cpp:1389)
  - vvdec VVDecImpl::xConvertPayloadToRBSP  (vvdecimpl.cpp:1409)
  - vvdec VVDecImpl::xReadNalUnitHeader     (vvdecimpl.cpp:1481)
  - vvdec AnnexBread byteStreamNALUnit      (AnnexBread.h:201)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class NalUnitType(enum.IntEnum):
    """H.266 Table 5 nal_unit_type values."""

    TRAIL = 0
    STSA = 1
    RADL = 2
    RASL = 3
    RSV_VCL_4 = 4
    RSV_VCL_5 = 5
    RSV_VCL_6 = 6
    IDR_W_RADL = 7
    IDR_N_LP = 8
    CRA = 9
    GDR = 10
    RSV_IRAP_11 = 11
    OPI = 12
    DCI = 13
    VPS = 14
    SPS = 15
    PPS = 16
    PREFIX_APS = 17
    SUFFIX_APS = 18
    PH = 19
    AUD = 20
    EOS = 21
    EOB = 22
    PREFIX_SEI = 23
    SUFFIX_SEI = 24
    FD = 25
    RSV_NVCL_26 = 26
    RSV_NVCL_27 = 27
    UNSPEC_28 = 28
    UNSPEC_29 = 29
    UNSPEC_30 = 30
    UNSPEC_31 = 31


def is_vcl(t: NalUnitType | int) -> bool:
    return int(t) <= NalUnitType.RSV_IRAP_11


def is_irap(t: NalUnitType | int) -> bool:
    return NalUnitType.IDR_W_RADL <= int(t) <= NalUnitType.CRA


def is_idr(t: NalUnitType | int) -> bool:
    return int(t) in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)


@dataclass
class NalUnit:
    nal_type: NalUnitType
    layer_id: int
    temporal_id: int  # nuh_temporal_id_plus1 - 1
    rbsp: bytes  # payload with emulation-prevention bytes removed, header stripped
    ebsp_size: int = 0  # size including header before de-emulation (diagnostics)

    @property
    def is_vcl(self) -> bool:
        return is_vcl(self.nal_type)

    @property
    def is_irap(self) -> bool:
        return is_irap(self.nal_type)

    @property
    def is_idr(self) -> bool:
        return is_idr(self.nal_type)


def split_annexb(buf: bytes) -> list[tuple[int, int]]:
    """Split an Annex-B byte stream into (offset, size) spans of NAL units
    (spans exclude the start code, include header + EBSP payload)."""
    spans: list[tuple[int, int]] = []
    n = len(buf)
    i = 0
    starts: list[int] = []
    # Scan for 0x000001 start codes.
    while True:
        j = buf.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # A 4-byte start code appears as a 0x00 before the next 3-byte code;
        # trailing zeros before the next start code belong to the start code.
        while e > s and buf[e - 1] == 0:
            e -= 1
        if e > s:
            spans.append((s, e - s))
    return spans


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation_prevention_three_byte (0x03 following 0x00 0x00)."""
    if b"\x00\x00\x03" not in ebsp:
        return ebsp
    out = bytearray()
    i = 0
    n = len(ebsp)
    while True:
        j = ebsp.find(b"\x00\x00\x03", i)
        if j < 0:
            out += ebsp[i:]
            break
        out += ebsp[i : j + 2]  # keep the two zero bytes, drop the 0x03
        i = j + 3
    return bytes(out)


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation prevention bytes (used by the test bitstream writer)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def parse_nal_header(data: bytes) -> tuple[NalUnitType, int, int]:
    """Parse the 2-byte NAL unit header -> (type, layer_id, temporal_id)."""
    if len(data) < 2:
        raise ValueError("NAL unit shorter than header")
    b0, b1 = data[0], data[1]
    if b0 & 0x80:
        raise ValueError("forbidden_zero_bit set in NAL header")
    layer_id = b0 & 0x3F
    nal_type = NalUnitType((b1 >> 3) & 0x1F)
    tid_plus1 = b1 & 0x07
    if tid_plus1 == 0:
        raise ValueError("nuh_temporal_id_plus1 == 0")
    return nal_type, layer_id, tid_plus1 - 1


def read_nal_units(buf: bytes) -> list[NalUnit]:
    """Annex-B byte stream -> list of NAL units with RBSP payloads."""
    out: list[NalUnit] = []
    for off, size in split_annexb(buf):
        ebsp = buf[off : off + size]
        nal_type, layer_id, tid = parse_nal_header(ebsp)
        rbsp = ebsp_to_rbsp(ebsp[2:])
        out.append(NalUnit(nal_type, layer_id, tid, rbsp, ebsp_size=size))
    return out
