"""SEI message parsing + decoded-picture-hash computation.

Behavioral parity (re-designed, not ported):
  - SEI framing:  SEIReader::parseSEImessage / xReadSEImessage
                  (SEIread.cpp:133-182)
  - DPH payload:  xParseSEIDecodedPictureHash (SEIread.cpp:443)
  - hashes:       calcMD5 / compCRC / compChecksum (PicYuvMD5.cpp:76-210)
  - verification: DecLib::checkPictureHashSEI (DecLib.cpp:480)
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

# payload types (include/vvdec/sei.h:51-77)
SEI_BUFFERING_PERIOD = 0
SEI_PICTURE_TIMING = 1
SEI_FILLER_PAYLOAD = 3
SEI_USER_DATA_REGISTERED_ITU_T_T35 = 4
SEI_USER_DATA_UNREGISTERED = 5
SEI_FILM_GRAIN_CHARACTERISTICS = 19
SEI_FRAME_PACKING = 45
SEI_PARAMETER_SETS_INCLUSION_INDICATION = 129
SEI_DECODING_UNIT_INFO = 130
SEI_DECODED_PICTURE_HASH = 132
SEI_SCALABLE_NESTING = 133
SEI_MASTERING_DISPLAY_COLOUR_VOLUME = 137
SEI_CONTENT_LIGHT_LEVEL_INFO = 144
SEI_DEPENDENT_RAP_INDICATION = 145
SEI_ALTERNATIVE_TRANSFER_CHARACTERISTICS = 147
SEI_EQUIRECTANGULAR_PROJECTION = 150
SEI_GENERALIZED_CUBEMAP_PROJECTION = 153
SEI_SPHERE_ROTATION = 154
SEI_REGION_WISE_PACKING = 155
SEI_OMNI_VIEWPORT = 156
SEI_FRAME_FIELD_INFO = 168
SEI_SUBPICTURE_LEVEL_INFO = 203
SEI_SAMPLE_ASPECT_RATIO_INFO = 204

HASH_MD5, HASH_CRC, HASH_CHECKSUM = 0, 1, 2


@dataclass
class SeiMessage:
    payload_type: int = 0
    payload: bytes = b""
    temporal_id: int = 0


@dataclass
class DecodedPictureHash:
    method: int = HASH_MD5
    single_comp: bool = False
    digest: bytes = b""


def parse_sei_nal(rbsp: bytes, temporal_id: int = 0) -> list[SeiMessage]:
    """Parse all SEI messages of one SEI NAL (payload stored raw;
    typed decoding per payload as needed)."""
    data = rbsp[2:]  # skip NAL header
    out = []
    pos = 0
    while pos < len(data) - 1:  # leave the rbsp trailing byte
        ptype = 0
        while True:
            v = data[pos]
            pos += 1
            ptype += v
            if v != 0xFF:
                break
        psize = 0
        while True:
            v = data[pos]
            pos += 1
            psize += v
            if v != 0xFF:
                break
        out.append(SeiMessage(ptype, data[pos:pos + psize], temporal_id))
        pos += psize
    return out


def parse_dph(msg: SeiMessage) -> DecodedPictureHash:
    d = DecodedPictureHash()
    d.method = msg.payload[0]
    d.single_comp = bool(msg.payload[1] >> 7)
    d.digest = msg.payload[2:]
    return d


def write_sei_nal(messages: list[SeiMessage]) -> bytes:
    """SEI NAL RBSP body (caller wraps with make_nal)."""
    out = bytearray()
    for m in messages:
        t = m.payload_type
        while t >= 0xFF:
            out.append(0xFF)
            t -= 0xFF
        out.append(t)
        s = len(m.payload)
        while s >= 0xFF:
            out.append(0xFF)
            s -= 0xFF
        out.append(s)
        out += m.payload
    out.append(0x80)  # rbsp trailing bits
    return bytes(out)


def make_dph_sei(planes: list[np.ndarray], bit_depth: int,
                 method: int = HASH_MD5) -> SeiMessage:
    digest = calc_picture_hash(planes, bit_depth, method)
    payload = bytes([method, 0x00]) + digest
    return SeiMessage(SEI_DECODED_PICTURE_HASH, payload)


# ---------------------------------------------------------------------------
# hash computation (PicYuvMD5.cpp)
# ---------------------------------------------------------------------------

def calc_picture_hash(planes: list[np.ndarray], bit_depth: int,
                      method: int) -> bytes:
    if method == HASH_MD5:
        return b"".join(_md5_plane(p, bit_depth) for p in planes)
    if method == HASH_CRC:
        return b"".join(_crc_plane(p, bit_depth) for p in planes)
    if method == HASH_CHECKSUM:
        return b"".join(_checksum_plane(p, bit_depth) for p in planes)
    raise ValueError(f"unknown hash method {method}")


def _md5_plane(plane: np.ndarray, bit_depth: int) -> bytes:
    if bit_depth > 8:
        data = plane.astype("<u2").tobytes()
    else:
        data = plane.astype(np.uint8).tobytes()
    return hashlib.md5(data).digest()


def _crc_table() -> list[int]:
    def step8(crc):
        for _ in range(8):
            msb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) ^ (msb * 0x1021)
        return crc
    return [step8(h << 8) for h in range(256)]


_CRC_T = _crc_table()


def _crc_plane(plane: np.ndarray, bit_depth: int) -> bytes:
    """16-bit CRC with data bits entering at the register bottom
    (compCRC, PicYuvMD5.cpp:99): per sample the low byte is processed
    MSB-first, then the high byte.  Byte-wise via the table identity
    step8(c, B) = T[c>>8] ^ ((c & 0xff) << 8) ^ B."""
    if bit_depth > 8:
        data = plane.astype("<u2").tobytes()
    else:
        data = plane.astype(np.uint8).tobytes()
    crc = 0xFFFF
    t = _CRC_T
    for byte in data:
        crc = t[crc >> 8] ^ ((crc & 0xFF) << 8) ^ byte
    crc = t[crc >> 8] ^ ((crc & 0xFF) << 8)
    crc = t[crc >> 8] ^ ((crc & 0xFF) << 8)
    return bytes([(crc >> 8) & 0xFF, crc & 0xFF])


def _checksum_plane(plane: np.ndarray, bit_depth: int) -> bytes:
    h, w = plane.shape
    xs = np.arange(w, dtype=np.uint32)
    ys = np.arange(h, dtype=np.uint32)[:, None]
    xor_mask = ((xs & 0xFF) ^ (ys & 0xFF) ^ (xs >> 8) ^ (ys >> 8)) \
        .astype(np.uint32)
    p = plane.astype(np.uint32)
    total = int((((p & 0xFF) ^ xor_mask).sum()))
    if bit_depth > 8:
        total += int(((p >> 8) ^ xor_mask).sum())
    total &= 0xFFFFFFFF
    return total.to_bytes(4, "big")


# ---------------------------------------------------------------------------
# film grain characteristics (payload type 19)
# ---------------------------------------------------------------------------
@dataclass
class CompModel:
    present: bool = False
    num_model_values: int = 0
    # per interval: (lower_bound, upper_bound, [model values])
    intervals: list = field(default_factory=list)


@dataclass
class FilmGrainCharacteristics:
    """Parsed FGC SEI (xParseSEIFilmGrainCharacteristics, SEIread.cpp)."""

    cancel: bool = False
    model_id: int = 0
    separate_colour_description: bool = False
    bit_depth_luma: int = 0
    bit_depth_chroma: int = 0
    full_range: bool = False
    colour_primaries: int = 0
    transfer_characteristics: int = 0
    matrix_coeffs: int = 0
    blending_mode_id: int = 0
    log2_scale_factor: int = 0
    comp_model: list = field(default_factory=lambda: [CompModel(),
                                                      CompModel(),
                                                      CompModel()])
    persistence: bool = False


def parse_fgc(msg: SeiMessage) -> FilmGrainCharacteristics:
    """Film grain characteristics SEI payload
    (xParseSEIFilmGrainCharacteristics, SEIread.cpp)."""
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    f = FilmGrainCharacteristics()
    f.cancel = bool(r.u(1))
    if f.cancel:
        return f
    f.model_id = r.u(2)
    f.separate_colour_description = bool(r.u(1))
    if f.separate_colour_description:
        f.bit_depth_luma = r.u(3) + 8
        f.bit_depth_chroma = r.u(3) + 8
        f.full_range = bool(r.u(1))
        f.colour_primaries = r.u(8)
        f.transfer_characteristics = r.u(8)
        f.matrix_coeffs = r.u(8)
    f.blending_mode_id = r.u(2)
    f.log2_scale_factor = r.u(4)
    for c in range(3):
        f.comp_model[c].present = bool(r.u(1))
    for c in range(3):
        cm = f.comp_model[c]
        if not cm.present:
            continue
        n_int = r.u(8) + 1
        cm.num_model_values = r.u(3) + 1
        if cm.num_model_values > 6:
            raise ValueError("num_model_values out of range")
        for _ in range(n_int):
            lo = r.u(8)
            hi = r.u(8)
            vals = [r.se() for _ in range(cm.num_model_values)]
            cm.intervals.append((lo, hi, vals))
    f.persistence = bool(r.u(1))
    return f


# ---------------------------------------------------------------------------
# structured payloads for the remaining common SEIs
# (SEIread.cpp xParseSEI*; payload numbering include/vvdec/sei.h:51-77)
# ---------------------------------------------------------------------------
SEI_AMBIENT_VIEWING_ENVIRONMENT = 148
SEI_CONTENT_COLOUR_VOLUME = 149


@dataclass
class FrameFieldInfo:
    """Frame-field info SEI (xParseSEIFrameFieldInfo)."""

    field_pic_flag: bool = False
    bottom_field_flag: bool = False
    pairing_indicated_flag: bool = False
    paired_with_next_field: bool = False
    display_fields_from_frame: bool = False
    top_field_first: bool = False
    display_elemental_periods: int = 1
    source_scan_type: int = 0
    duplicate_flag: bool = False


def parse_frame_field_info(msg: SeiMessage) -> FrameFieldInfo:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    f = FrameFieldInfo()
    f.field_pic_flag = bool(r.u(1))
    if f.field_pic_flag:
        f.bottom_field_flag = bool(r.u(1))
        f.pairing_indicated_flag = bool(r.u(1))
        if f.pairing_indicated_flag:
            f.paired_with_next_field = bool(r.u(1))
    else:
        f.display_fields_from_frame = bool(r.u(1))
        if f.display_fields_from_frame:
            f.top_field_first = bool(r.u(1))
        f.display_elemental_periods = r.u(8) + 1
    f.source_scan_type = r.u(2)
    f.duplicate_flag = bool(r.u(1))
    return f


@dataclass
class MasteringDisplayColourVolume:
    primaries: tuple = ()       # 3 x (x, y)
    white_point: tuple = (0, 0)
    max_luminance: int = 0
    min_luminance: int = 0


def parse_mastering_display(msg: SeiMessage) -> MasteringDisplayColourVolume:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    m = MasteringDisplayColourVolume()
    m.primaries = tuple((r.u(16), r.u(16)) for _ in range(3))
    m.white_point = (r.u(16), r.u(16))
    m.max_luminance = r.u(32)
    m.min_luminance = r.u(32)
    return m


@dataclass
class ContentLightLevel:
    max_content_light_level: int = 0
    max_pic_average_light_level: int = 0


def parse_content_light_level(msg: SeiMessage) -> ContentLightLevel:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    return ContentLightLevel(r.u(16), r.u(16))


@dataclass
class UserDataUnregistered:
    uuid: bytes = b""
    data: bytes = b""


def parse_user_data_unregistered(msg: SeiMessage) -> UserDataUnregistered:
    return UserDataUnregistered(msg.payload[:16], msg.payload[16:])


@dataclass
class ScalableNesting:
    """Scalable nesting SEI header + the nested SEI messages
    (xParseSEIScalableNesting)."""

    ols_flag: bool = False
    subpic_flag: bool = False
    ols_idx: list = field(default_factory=list)
    layer_id: list = field(default_factory=list)
    subpic_ids: list = field(default_factory=list)
    messages: list = field(default_factory=list)  # nested SeiMessage list


def parse_scalable_nesting(msg: SeiMessage,
                           subpic_id_len: int = 16) -> ScalableNesting:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    n = ScalableNesting()
    n.ols_flag = bool(r.u(1))
    n.subpic_flag = bool(r.u(1))
    if n.ols_flag:
        num_olss = r.ue() + 1
        for _ in range(num_olss):
            n.ols_idx.append(r.ue())
    else:
        all_layers = bool(r.u(1))
        if not all_layers:
            num_layers = r.ue() + 1
            for _ in range(num_layers):
                n.layer_id.append(r.u(6))
    if n.subpic_flag:
        num_subpics = r.ue() + 1
        id_len = r.ue() + 1
        for _ in range(num_subpics):
            n.subpic_ids.append(r.u(id_len))
    num_seis = r.ue() + 1
    # byte-align before the nested SEI messages
    while r.pos % 8:
        r.u(1)
    data = msg.payload[r.pos // 8:]
    # nested messages use the standard SEI framing
    pos = 0
    for _ in range(num_seis):
        if pos >= len(data):
            break
        ptype = 0
        while data[pos] == 0xFF:
            ptype += 255
            pos += 1
        ptype += data[pos]
        pos += 1
        size = 0
        while data[pos] == 0xFF:
            size += 255
            pos += 1
        size += data[pos]
        pos += 1
        n.messages.append(SeiMessage(ptype, data[pos:pos + size]))
        pos += size
    return n


# ---------------------------------------------------------------------------
# HRD-coupled payloads: buffering period, picture timing, decoding-unit info
# (xParseSEIBufferingPeriod SEIread.cpp:708, xParseSEIPictureTiming :832,
#  xParseSEIDecodingUnitInfo :650)
# ---------------------------------------------------------------------------
@dataclass
class BufferingPeriod:
    nal_cpb_params: bool = False
    vcl_cpb_params: bool = False
    initial_cpb_removal_delay_length: int = 24
    cpb_removal_delay_length: int = 24
    dpb_output_delay_length: int = 24
    du_hrd_params_present: bool = False
    du_cpb_removal_delay_increment_length: int = 24
    dpb_output_delay_du_length: int = 24
    du_cpb_params_in_pic_timing: bool = False
    du_dpb_params_in_pic_timing: bool = False
    concatenation: bool = False
    additional_concatenation_info: bool = False
    max_initial_removal_delay_for_concatenation: int = 0
    au_cpb_removal_delay_delta: int = 1
    max_sublayers: int = 1
    cpb_removal_delay_deltas: list = field(default_factory=list)
    cpb_cnt: int = 1
    sublayer_initial_cpb_removal_delay_present: bool = False
    # [sublayer][cpb][nal=0 / vcl=1] -> (delay, offset)
    initial_cpb_removal: dict = field(default_factory=dict)
    sublayer_dpb_output_offsets_present: bool = False
    dpb_output_tid_offset: list = field(default_factory=list)
    alt_cpb_params_present: bool = False
    use_alt_cpb_params: bool = False


def parse_buffering_period(msg: SeiMessage) -> BufferingPeriod:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    bp = BufferingPeriod()
    bp.nal_cpb_params = r.flag()
    bp.vcl_cpb_params = r.flag()
    bp.initial_cpb_removal_delay_length = r.u(5) + 1
    bp.cpb_removal_delay_length = r.u(5) + 1
    bp.dpb_output_delay_length = r.u(5) + 1
    bp.du_hrd_params_present = r.flag()
    if bp.du_hrd_params_present:
        bp.du_cpb_removal_delay_increment_length = r.u(5) + 1
        bp.dpb_output_delay_du_length = r.u(5) + 1
        bp.du_cpb_params_in_pic_timing = r.flag()
        bp.du_dpb_params_in_pic_timing = r.flag()
    bp.concatenation = r.flag()
    bp.additional_concatenation_info = r.flag()
    if bp.additional_concatenation_info:
        bp.max_initial_removal_delay_for_concatenation = \
            r.u(bp.initial_cpb_removal_delay_length)
    bp.au_cpb_removal_delay_delta = r.u(bp.cpb_removal_delay_length) + 1
    bp.max_sublayers = r.u(3) + 1
    if bp.max_sublayers > 7:
        raise ValueError("bp_max_sub_layers_minus1 > 6")
    deltas_present = r.flag() if bp.max_sublayers > 1 else False
    if deltas_present:
        n = r.ue() + 1
        if n > 15:
            raise ValueError("num_cpb_removal_delay_deltas_minus1 > 14")
        bp.cpb_removal_delay_deltas = [
            r.u(bp.cpb_removal_delay_length) for _ in range(n)]
    bp.cpb_cnt = r.ue() + 1
    if bp.cpb_cnt > 32:
        raise ValueError("bp_cpb_cnt_minus1 > 31")
    if bp.max_sublayers > 1:
        bp.sublayer_initial_cpb_removal_delay_present = r.flag()
    lo = 0 if bp.sublayer_initial_cpb_removal_delay_present \
        else bp.max_sublayers - 1
    for i in range(lo, bp.max_sublayers):
        for nal_or_vcl in range(2):
            present = bp.nal_cpb_params if nal_or_vcl == 0 \
                else bp.vcl_cpb_params
            if not present:
                continue
            for j in range(bp.cpb_cnt):
                d = r.u(bp.initial_cpb_removal_delay_length)
                o = r.u(bp.initial_cpb_removal_delay_length)
                bp.initial_cpb_removal[(i, j, nal_or_vcl)] = (d, o)
    if bp.max_sublayers > 1:
        bp.sublayer_dpb_output_offsets_present = r.flag()
    if bp.sublayer_dpb_output_offsets_present:
        bp.dpb_output_tid_offset = [r.ue()
                                    for _ in range(bp.max_sublayers - 1)]
        bp.dpb_output_tid_offset.append(0)
    bp.alt_cpb_params_present = r.flag()
    if bp.alt_cpb_params_present:
        bp.use_alt_cpb_params = r.flag()
    return bp


@dataclass
class PictureTiming:
    au_cpb_removal_delay: dict = field(default_factory=dict)  # sublayer -> n
    sublayer_delays_present: dict = field(default_factory=dict)
    cpb_removal_delay_delta_idx: dict = field(default_factory=dict)
    dpb_output_delay: int = 0
    cpb_alt_timing_info_present: bool = False
    dpb_output_du_delay: int = 0
    num_decoding_units: int = 0
    du_common_cpb_removal_delay: dict = field(default_factory=dict)
    num_nalus_in_du: list = field(default_factory=list)
    du_cpb_removal_delay: dict = field(default_factory=dict)
    display_elemental_periods: int = 1


def parse_picture_timing(msg: SeiMessage, bp: BufferingPeriod
                         ) -> PictureTiming:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    tid = msg.temporal_id
    pt = PictureTiming()
    pt.au_cpb_removal_delay[bp.max_sublayers - 1] = \
        r.u(bp.cpb_removal_delay_length) + 1
    for i in range(tid, bp.max_sublayers - 1):
        pt.sublayer_delays_present[i] = r.flag()
        if not pt.sublayer_delays_present[i]:
            continue
        delta_enabled = r.flag() if bp.cpb_removal_delay_deltas else False
        if delta_enabled:
            n = len(bp.cpb_removal_delay_deltas)
            idx = r.u((n - 1).bit_length()) if n > 1 else 0
            pt.cpb_removal_delay_delta_idx[i] = idx
        else:
            pt.au_cpb_removal_delay[i] = \
                r.u(bp.cpb_removal_delay_length) + 1
    pt.dpb_output_delay = r.u(bp.dpb_output_delay_length)
    if bp.alt_cpb_params_present:
        pt.cpb_alt_timing_info_present = r.flag()
        if pt.cpb_alt_timing_info_present:
            lo = 0 if bp.sublayer_initial_cpb_removal_delay_present \
                else bp.max_sublayers - 1
            for params_present in (bp.nal_cpb_params, bp.vcl_cpb_params):
                if not params_present:
                    continue
                for _i in range(lo, bp.max_sublayers):
                    for _j in range(bp.cpb_cnt):
                        r.u(bp.initial_cpb_removal_delay_length)
                        r.u(bp.initial_cpb_removal_delay_length)
                    r.u(bp.initial_cpb_removal_delay_length)
                    r.u(bp.initial_cpb_removal_delay_length)
    if bp.du_hrd_params_present and bp.du_dpb_params_in_pic_timing:
        pt.dpb_output_du_delay = r.u(bp.dpb_output_delay_du_length)
    if bp.du_hrd_params_present and bp.du_cpb_params_in_pic_timing:
        pt.num_decoding_units = r.ue() + 1
        if pt.num_decoding_units > 32:
            raise ValueError("num_decoding_units_minus1 > 31")
        if pt.num_decoding_units > 1:
            common = r.flag()
            if common:
                for i in range(tid, bp.max_sublayers - 1):
                    if pt.sublayer_delays_present.get(i):
                        pt.du_common_cpb_removal_delay[i] = r.u(
                            bp.du_cpb_removal_delay_increment_length) + 1
            for i in range(pt.num_decoding_units):
                pt.num_nalus_in_du.append(r.ue() + 1)
                if not common and i < pt.num_decoding_units - 1:
                    for j in range(tid, bp.max_sublayers - 1):
                        if pt.sublayer_delays_present.get(j):
                            pt.du_cpb_removal_delay[(i, j)] = r.u(
                                bp.du_cpb_removal_delay_increment_length
                            ) + 1
    pt.display_elemental_periods = r.u(8) + 1
    return pt


@dataclass
class DecodingUnitInfo:
    decoding_unit_idx: int = 0
    du_spt_cpb_removal_delay_increment: dict = field(default_factory=dict)
    dpb_output_du_delay_present: bool = False
    pic_spt_dpb_output_du_delay: int = 0


def parse_decoding_unit_info(msg: SeiMessage, bp: BufferingPeriod
                             ) -> DecodingUnitInfo:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    tid = msg.temporal_id
    d = DecodingUnitInfo()
    d.decoding_unit_idx = r.ue()
    if not bp.du_cpb_params_in_pic_timing:
        for i in range(tid, bp.max_sublayers):
            present = r.flag() if i < bp.max_sublayers - 1 else True
            if present:
                d.du_spt_cpb_removal_delay_increment[i] = r.u(
                    bp.du_cpb_removal_delay_increment_length)
    if bp.du_dpb_params_in_pic_timing:
        d.dpb_output_du_delay_present = r.flag()
    if d.dpb_output_du_delay_present:
        d.pic_spt_dpb_output_du_delay = r.u(bp.dpb_output_delay_du_length)
    return d


# ---------------------------------------------------------------------------
# remaining structured payloads (xParseSEI*, SEIread.cpp)
# ---------------------------------------------------------------------------
@dataclass
class UserDataRegistered:
    country_code: int = 0
    country_code_extension: int = -1
    data: bytes = b""


def parse_user_data_registered(msg: SeiMessage) -> UserDataRegistered:
    u = UserDataRegistered()
    u.country_code = msg.payload[0]
    if u.country_code == 255:
        u.country_code_extension = msg.payload[1]
        u.data = msg.payload[2:]
    else:
        u.data = msg.payload[1:]
    return u


@dataclass
class FramePacking:
    arrangement_id: int = 0
    cancel: bool = False
    arrangement_type: int = 0
    quincunx_sampling: bool = False
    content_interpretation_type: int = 0
    spatial_flipping: bool = False
    frame0_flipped: bool = False
    field_views: bool = False
    current_frame_is_frame0: bool = False
    frame0_self_contained: bool = False
    frame1_self_contained: bool = False
    frame0_grid_position: tuple = (0, 0)
    frame1_grid_position: tuple = (0, 0)
    persistence: bool = False
    upsampled_aspect_ratio: bool = False


def parse_frame_packing(msg: SeiMessage) -> FramePacking:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    f = FramePacking()
    f.arrangement_id = r.ue()
    f.cancel = r.flag()
    if not f.cancel:
        f.arrangement_type = r.u(7)
        f.quincunx_sampling = r.flag()
        f.content_interpretation_type = r.u(6)
        f.spatial_flipping = r.flag()
        f.frame0_flipped = r.flag()
        f.field_views = r.flag()
        f.current_frame_is_frame0 = r.flag()
        f.frame0_self_contained = r.flag()
        f.frame1_self_contained = r.flag()
        if not f.quincunx_sampling and f.arrangement_type != 5:
            f.frame0_grid_position = (r.u(4), r.u(4))
            f.frame1_grid_position = (r.u(4), r.u(4))
        r.u(8)  # frame_packing_arrangement_reserved_byte
        f.persistence = r.flag()
    f.upsampled_aspect_ratio = r.flag()
    return f


@dataclass
class ParameterSetsInclusionIndication:
    self_contained_clvs: bool = False


def parse_parameter_sets_inclusion(msg: SeiMessage
                                   ) -> ParameterSetsInclusionIndication:
    from refdec.bitstream.reader import BitReader
    return ParameterSetsInclusionIndication(BitReader(msg.payload).flag())


@dataclass
class DependentRapIndication:
    """dependent_rap_indication() carries no syntax elements."""


@dataclass
class EquirectangularProjection:
    cancel: bool = False
    persistence: bool = False
    guard_band: bool = False
    guard_band_type: int = 0
    left_guard_band_width: int = 0
    right_guard_band_width: int = 0


def parse_equirectangular_projection(msg: SeiMessage
                                     ) -> EquirectangularProjection:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    e = EquirectangularProjection()
    e.cancel = r.flag()
    if not e.cancel:
        e.persistence = r.flag()
        e.guard_band = r.flag()
        r.u(2)  # erp_reserved_zero_2bits
        if e.guard_band:
            e.guard_band_type = r.u(3)
            e.left_guard_band_width = r.u(8)
            e.right_guard_band_width = r.u(8)
    return e


@dataclass
class SphereRotation:
    cancel: bool = False
    persistence: bool = False
    yaw: int = 0
    pitch: int = 0
    roll: int = 0


def _s32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


def parse_sphere_rotation(msg: SeiMessage) -> SphereRotation:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    s = SphereRotation()
    s.cancel = r.flag()
    if not s.cancel:
        s.persistence = r.flag()
        r.u(6)  # reserved
        s.yaw = _s32(r.u(32))
        s.pitch = _s32(r.u(32))
        s.roll = _s32(r.u(32))
    return s


@dataclass
class PackedRegion:
    transform_type: int = 0
    guard_band: bool = False
    proj_region: tuple = (0, 0, 0, 0)     # w, h, top, left
    packed_region: tuple = (0, 0, 0, 0)
    guard_band_widths: tuple = ()          # l, r, t, b
    guard_band_not_used_for_pred: bool = False
    guard_band_types: tuple = ()


@dataclass
class RegionWisePacking:
    cancel: bool = False
    persistence: bool = False
    constituent_picture_matching: bool = False
    proj_picture: tuple = (0, 0)
    packed_picture: tuple = (0, 0)
    regions: list = field(default_factory=list)


def parse_region_wise_packing(msg: SeiMessage) -> RegionWisePacking:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    p = RegionWisePacking()
    p.cancel = r.flag()
    if p.cancel:
        return p
    p.persistence = r.flag()
    p.constituent_picture_matching = r.flag()
    r.u(5)  # reserved
    num_regions = r.u(8)
    p.proj_picture = (r.u(32), r.u(32))
    p.packed_picture = (r.u(16), r.u(16))
    for _ in range(num_regions):
        reg = PackedRegion()
        r.u(4)  # reserved
        reg.transform_type = r.u(3)
        reg.guard_band = r.flag()
        reg.proj_region = (r.u(32), r.u(32), r.u(32), r.u(32))
        reg.packed_region = (r.u(16), r.u(16), r.u(16), r.u(16))
        if reg.guard_band:
            reg.guard_band_widths = (r.u(8), r.u(8), r.u(8), r.u(8))
            reg.guard_band_not_used_for_pred = r.flag()
            reg.guard_band_types = tuple(r.u(3) for _ in range(4))
            r.u(3)  # reserved
        p.regions.append(reg)
    return p


@dataclass
class OmniViewport:
    viewport_id: int = 0
    cancel: bool = False
    persistence: bool = False
    # per viewport: (azimuth, elevation, tilt, hor_range, ver_range)
    viewports: list = field(default_factory=list)


def parse_omni_viewport(msg: SeiMessage) -> OmniViewport:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    o = OmniViewport()
    o.viewport_id = r.u(10)
    o.cancel = r.flag()
    if not o.cancel:
        o.persistence = r.flag()
        cnt = r.u(4) + 1
        for _ in range(cnt):
            o.viewports.append((_s32(r.u(32)), _s32(r.u(32)),
                                _s32(r.u(32)), r.u(32), r.u(32)))
    return o


@dataclass
class GeneralizedCubemapProjection:
    cancel: bool = False
    persistence: bool = False
    packing_type: int = 0
    mapping_function_type: int = 0
    face_index: list = field(default_factory=list)
    face_rotation: list = field(default_factory=list)
    function_coeff_u: list = field(default_factory=list)
    function_u_affected_by_v: list = field(default_factory=list)
    function_coeff_v: list = field(default_factory=list)
    function_v_affected_by_u: list = field(default_factory=list)
    guard_band: bool = False
    guard_band_type: int = 0
    guard_band_boundary_exterior: bool = False
    guard_band_samples: int = 0


def parse_generalized_cubemap_projection(
        msg: SeiMessage) -> GeneralizedCubemapProjection:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    g = GeneralizedCubemapProjection()
    g.cancel = r.flag()
    if not g.cancel:
        g.persistence = r.flag()
        g.packing_type = r.u(3)
        g.mapping_function_type = r.u(2)
        num_face = 5 if g.packing_type in (4, 5) else 6
        for _ in range(num_face):
            g.face_index.append(r.u(3))
            g.face_rotation.append(r.u(2))
            if g.mapping_function_type == 2:
                g.function_coeff_u.append(r.u(7))
                g.function_u_affected_by_v.append(r.flag())
                g.function_coeff_v.append(r.u(7))
                g.function_v_affected_by_u.append(r.flag())
        g.guard_band = r.flag()
        if g.guard_band:
            g.guard_band_type = r.u(3)
            g.guard_band_boundary_exterior = r.flag()
            g.guard_band_samples = r.u(4) + 1
    return g


@dataclass
class SubpictureLevelInfo:
    num_ref_levels: int = 1
    cbr_constraint: bool = False
    explicit_fraction_present: bool = False
    num_subpics: int = 0
    max_sublayers: int = 1
    sublayer_info_present: bool = False
    # [ref_level][sublayer] -> (non_subpic_layers_fraction, ref_level_idc)
    ref_levels: dict = field(default_factory=dict)
    # [ref_level][subpic][sublayer] -> ref_level_fraction_minus1
    ref_level_fraction: dict = field(default_factory=dict)


def parse_subpicture_level_info(msg: SeiMessage) -> SubpictureLevelInfo:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    s = SubpictureLevelInfo()
    s.num_ref_levels = r.u(3) + 1
    s.cbr_constraint = r.flag()
    s.explicit_fraction_present = r.flag()
    if s.explicit_fraction_present:
        s.num_subpics = r.ue() + 1
    s.max_sublayers = r.u(3) + 1
    s.sublayer_info_present = r.flag()
    while not r.byte_aligned():
        if r.u(1):
            raise ValueError("sli_alignment_zero_bit != 0")
    lo = 0 if s.sublayer_info_present else s.max_sublayers - 1
    for k in range(lo, s.max_sublayers):
        for i in range(s.num_ref_levels):
            frac = r.u(8)
            idc = r.u(8)
            s.ref_levels[(i, k)] = (frac, idc)
            if s.explicit_fraction_present:
                for j in range(s.num_subpics):
                    s.ref_level_fraction[(i, j, k)] = r.u(8)
    if not s.sublayer_info_present:
        # infer lower sublayers from the highest (SEIread.cpp SLI tail)
        top = s.max_sublayers - 1
        for k in range(top - 1, -1, -1):
            for i in range(s.num_ref_levels):
                s.ref_levels[(i, k)] = s.ref_levels[(i, top)]
                if s.explicit_fraction_present:
                    for j in range(s.num_subpics):
                        s.ref_level_fraction[(i, j, k)] = \
                            s.ref_level_fraction[(i, j, top)]
    return s


@dataclass
class SampleAspectRatioInfo:
    cancel: bool = False
    persistence: bool = False
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0


def parse_sample_aspect_ratio_info(msg: SeiMessage) -> SampleAspectRatioInfo:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    s = SampleAspectRatioInfo()
    s.cancel = r.flag()
    if not s.cancel:
        s.persistence = r.flag()
        s.aspect_ratio_idc = r.u(8)
        if s.aspect_ratio_idc == 255:
            s.sar_width = r.u(16)
            s.sar_height = r.u(16)
    return s


@dataclass
class AlternativeTransferCharacteristics:
    preferred_transfer_characteristics: int = 0


def parse_alternative_transfer_characteristics(
        msg: SeiMessage) -> AlternativeTransferCharacteristics:
    return AlternativeTransferCharacteristics(msg.payload[0])


@dataclass
class AmbientViewingEnvironment:
    ambient_illuminance: int = 0
    ambient_light_x: int = 0
    ambient_light_y: int = 0


def parse_ambient_viewing_environment(msg: SeiMessage
                                      ) -> AmbientViewingEnvironment:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    return AmbientViewingEnvironment(r.u(32), r.u(16), r.u(16))


@dataclass
class ContentColourVolume:
    cancel: bool = False
    persistence: bool = False
    primaries: list = field(default_factory=list)  # 3 x (x, y) signed
    min_luminance: int | None = None
    max_luminance: int | None = None
    avg_luminance: int | None = None


def parse_content_colour_volume(msg: SeiMessage) -> ContentColourVolume:
    from refdec.bitstream.reader import BitReader
    r = BitReader(msg.payload)
    c = ContentColourVolume()
    c.cancel = r.flag()
    if c.cancel:
        return c
    c.persistence = r.flag()
    primaries_present = r.flag()
    min_present = r.flag()
    max_present = r.flag()
    avg_present = r.flag()
    if primaries_present:
        c.primaries = [(_s32(r.u(32)), _s32(r.u(32))) for _ in range(3)]
    if min_present:
        c.min_luminance = r.u(32)
    if max_present:
        c.max_luminance = r.u(32)
    if avg_present:
        c.avg_luminance = r.u(32)
    return c


_SEI_PARSERS = {
    SEI_DECODED_PICTURE_HASH: parse_dph,
    SEI_FILM_GRAIN_CHARACTERISTICS: parse_fgc,
    SEI_FRAME_FIELD_INFO: parse_frame_field_info,
    SEI_MASTERING_DISPLAY_COLOUR_VOLUME: parse_mastering_display,
    SEI_CONTENT_LIGHT_LEVEL_INFO: parse_content_light_level,
    SEI_USER_DATA_UNREGISTERED: parse_user_data_unregistered,
    SEI_SCALABLE_NESTING: parse_scalable_nesting,
    SEI_BUFFERING_PERIOD: parse_buffering_period,
    SEI_USER_DATA_REGISTERED_ITU_T_T35: parse_user_data_registered,
    SEI_FRAME_PACKING: parse_frame_packing,
    SEI_PARAMETER_SETS_INCLUSION_INDICATION: parse_parameter_sets_inclusion,
    SEI_DEPENDENT_RAP_INDICATION: lambda _m: DependentRapIndication(),
    SEI_EQUIRECTANGULAR_PROJECTION: parse_equirectangular_projection,
    SEI_SPHERE_ROTATION: parse_sphere_rotation,
    SEI_REGION_WISE_PACKING: parse_region_wise_packing,
    SEI_OMNI_VIEWPORT: parse_omni_viewport,
    SEI_GENERALIZED_CUBEMAP_PROJECTION:
        parse_generalized_cubemap_projection,
    SEI_SUBPICTURE_LEVEL_INFO: parse_subpicture_level_info,
    SEI_SAMPLE_ASPECT_RATIO_INFO: parse_sample_aspect_ratio_info,
    SEI_ALTERNATIVE_TRANSFER_CHARACTERISTICS:
        parse_alternative_transfer_characteristics,
    SEI_AMBIENT_VIEWING_ENVIRONMENT: parse_ambient_viewing_environment,
    SEI_CONTENT_COLOUR_VOLUME: parse_content_colour_volume,
    SEI_FILLER_PAYLOAD: lambda m: m,
}


def parse_sei_payload(msg: SeiMessage, bp: BufferingPeriod | None = None):
    """Structured view of a parsed SEI message (dispatch by payload type);
    returns the raw message when no structured parser exists.  Picture
    timing and decoding-unit info need the last buffering period for their
    HRD field lengths (SEIread.cpp:226-248) — pass it as `bp`."""
    try:
        if msg.payload_type == SEI_PICTURE_TIMING:
            return parse_picture_timing(msg, bp) if bp is not None else msg
        if msg.payload_type == SEI_DECODING_UNIT_INFO:
            return parse_decoding_unit_info(msg, bp) if bp is not None \
                else msg
        fn = _SEI_PARSERS.get(msg.payload_type)
        if fn is not None:
            return fn(msg)
    except (IndexError, ValueError):
        return msg
    return msg
