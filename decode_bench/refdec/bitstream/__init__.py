from refdec.bitstream.reader import BitReader
from refdec.bitstream.nal import (
    NalUnit,
    NalUnitType,
    split_annexb,
    ebsp_to_rbsp,
    parse_nal_header,
    read_nal_units,
    is_vcl,
    is_irap,
)

__all__ = [
    "BitReader",
    "NalUnit",
    "NalUnitType",
    "split_annexb",
    "ebsp_to_rbsp",
    "parse_nal_header",
    "read_nal_units",
    "is_vcl",
    "is_irap",
]
