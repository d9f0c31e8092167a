from refdec.hls.params import (  # noqa: F401
    SPS,
    PPS,
    PicHeader,
    SliceHeader,
    RefPicList,
    RefPicEntry,
    ChromaQpTable,
    CHROMA_400,
    CHROMA_420,
    CHROMA_422,
    CHROMA_444,
    B_SLICE,
    P_SLICE,
    I_SLICE,
)
from refdec.hls.reader import (  # noqa: F401
    HlsError,
    ParameterSetManager,
    parse_picture_header,
    parse_pps,
    parse_slice_header,
    parse_sps,
)
