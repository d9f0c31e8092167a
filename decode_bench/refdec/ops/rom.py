"""ROM constant tables (H.266 standard constants), generated programmatically.

Parity targets: vvdec Rom.{h,cpp} (scan orders :80, group indices :463-464,
Rice tables :465, sub-block sizes :188) — all values defined by ITU-T H.266.
"""

from __future__ import annotations

import functools

import numpy as np

# zero-out threshold for high-frequency coefficients (JVET-C0024)
ZERO_OUT_TH = 32
MAX_TU_SIZE = 64

# last-significant-coefficient group index: g_uiGroupIdx[pos]
# defining sequence: {0,1,2,3,4,4,5,5,6x4,7x4,8x8,9x8,10x16,11x16}
GROUP_IDX = np.array(
    [0, 1, 2, 3] + [4] * 2 + [5] * 2 + [6] * 4 + [7] * 4 + [8] * 8 + [9] * 8
    + [10] * 16 + [11] * 16, dtype=np.int32)

# minimum position within a group: g_uiMinInGroup
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96], dtype=np.int32)

# Golomb-Rice parameter from template sum: g_auiGoRiceParsCoeff
GO_RICE_PARS = np.array(
    [0] * 7 + [1] * 7 + [2] * 14 + [3] * 4, dtype=np.int32)

# last-coeff prefix context offsets for luma (ContextModelling.cpp:55)
LAST_PREFIX_CTX = (0, 0, 0, 3, 6, 10, 15, 21)


def go_rice_pos_coeff0(state: int, rice_par: int) -> int:
    return (1 if state < 2 else 2) << rice_par


@functools.lru_cache(maxsize=None)
def log2_sbb_size(log2_w: int, log2_h: int) -> tuple[int, int]:
    """Coefficient sub-block (CG) log2 dimensions for a TU of the given log2
    size (H.266 clause 6.5.2 table; parity Rom.cpp:188)."""
    table = [
        [(0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 4), (0, 4)],
        [(1, 0), (1, 1), (1, 1), (1, 3), (1, 3), (1, 3), (1, 3)],
        [(2, 0), (1, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(3, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
        [(4, 0), (3, 1), (2, 2), (2, 2), (2, 2), (2, 2), (2, 2)],
    ]
    return table[log2_w][log2_h]


def _diag_scan(w: int, h: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan positions (x, y) for a w x h block."""
    out = []
    for d in range(w + h - 1):
        y = min(d, h - 1)
        while y >= 0 and d - y < w:
            out.append((d - y, y))
            y -= 1
    return out


@functools.lru_cache(maxsize=None)
def scan_ungrouped(w: int, h: int) -> np.ndarray:
    """Raster positions in diagonal scan order (no grouping)."""
    return np.array([y * w + x for x, y in _diag_scan(w, h)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def scan_grouped(w: int, h: int) -> np.ndarray:
    """Raster positions in grouped (CG) diagonal scan order.

    scan[scanPos] = raster position within the w x h block.  For blocks larger
    than the 32-wide/high zero-out threshold, positions beyond the zeroed
    region never occur; only in-group positions are generated (the reference
    fills them with a sentinel; our decoder never indexes them either).
    """
    lg_cw, lg_ch = log2_sbb_size(w.bit_length() - 1, h.bit_length() - 1)
    gw, gh = 1 << lg_cw, 1 << lg_ch
    w_groups = min(ZERO_OUT_TH, w) >> lg_cw
    h_groups = min(ZERO_OUT_TH, h) >> lg_ch
    out = []
    for gx, gy in _diag_scan(w_groups, h_groups):
        ox, oy = gx * gw, gy * gh
        for x, y in _diag_scan(gw, gh):
            out.append((oy + y) * w + ox + x)
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def scan_cg(w_groups: int, h_groups: int) -> np.ndarray:
    """Scan order of coefficient groups (ungrouped scan over the CG grid)."""
    return scan_ungrouped(w_groups, h_groups)


# truncated-binary code thresholds: g_tbMax[n] = floor(log2(n)) for n in [1,256]
TB_MAX = np.zeros(257, dtype=np.int32)
for _n in range(1, 257):
    TB_MAX[_n] = _n.bit_length() - 1

# NOTE on TU max-split tiling order: for the sizes reachable in VVC
# (CTU<=128, maxTb>=32 => at most 4x4 tiles) z-scan over the tile grid is used;
# for the common 2x2 case z-scan == raster.  General z-order helper:
def z_scan_order(tiles_w: int, tiles_h: int) -> list[tuple[int, int]]:
    """(x, y) tile coordinates in z-scan order."""
    def interleave(v: int) -> int:
        r = 0
        for b in range(8):
            r |= ((v >> b) & 1) << (2 * b)
        return r
    coords = [(x, y) for y in range(tiles_h) for x in range(tiles_w)]
    coords.sort(key=lambda p: interleave(p[1]) << 1 | interleave(p[0]))
    return coords


# dequant scale tables (H.266 clause 8.7.3): levelScale[rectNonNorm][qp%6]
INV_QUANT_SCALES = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102],  # used when (log2W+log2H) is odd
], dtype=np.int32)
