"""Standard constant tables for the compute pipeline (ITU-T H.266).

Transform matrices are loaded from tables_tr.npz (extracted numerically from
the standard's tables; see docstrings in ops/rom.py).  Filter tables below are
the spec's interpolation/smoothing filters (Tables 25-28 of H.266).
"""

from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = np.load(os.path.join(os.path.dirname(__file__), "tables_tr.npz"))

DCT2 = {n: _NPZ[f"DCT2_{n}"].astype(np.int32) for n in (2, 4, 8, 16, 32, 64)}
DST7 = {n: _NPZ[f"DST7_{n}"].astype(np.int32) for n in (4, 8, 16, 32)}
DCT8 = {n: _NPZ[f"DCT8_{n}"].astype(np.int32) for n in (4, 8, 16, 32)}
LFNST_8x8 = _NPZ["LFNST8x8"].astype(np.int32)  # [4][2][48][16]
LFNST_4x4 = _NPZ["LFNST4x4"].astype(np.int32)  # [4][2][16][16]
LFNST_LUT = _NPZ["LFNST_LUT"].astype(np.int32)  # intra mode -> transform set

_MIP_NPZ = np.load(os.path.join(os.path.dirname(__file__), "tables_mip.npz"))
MIP_4x4 = _MIP_NPZ["MIP4x4"].astype(np.int32)      # [16][16][4]
MIP_8x8 = _MIP_NPZ["MIP8x8"].astype(np.int32)      # [8][16][8]
MIP_16x16 = _MIP_NPZ["MIP16x16"].astype(np.int32)  # [6][64][7]


def tr_matrix(kind: str, n: int) -> np.ndarray:
    """Transform matrix rows=frequency, cols=spatial, int32 [n, n]."""
    if kind == "DCT2":
        return DCT2[n]
    if kind == "DST7":
        return DST7[n]
    if kind == "DCT8":
        return DCT8[n]
    raise ValueError(kind)


# intra angular parameters (H.266 Table 30/31)
ANG_TABLE = np.array(
    [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35, 39, 45,
     51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512, 1024], dtype=np.int32)
INV_ANG_TABLE = np.array(
    [0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365, 1170, 1024, 910, 819,
     712, 630, 565, 512, 468, 420, 364, 321, 287, 256, 224, 191, 161, 128, 96,
     64, 48, 32, 16], dtype=np.int32)  # (512 * 32) / angle

# reference smoothing threshold per channel / log2 size (minimum mode distance
# from HOR/VER for the 4-tap interpolation filter switch)
INTRA_FILTER_THRESH = (
    (24, 24, 24, 14, 2, 0, 0, 0),  # luma, index = (log2w+log2h)>>1
    (40, 40, 40, 28, 4, 0, 0, 0),  # chroma
)

# 4-tap intra interpolation filters, 32 phases (fC = chroma MC DCT-IF, fG = Gauss)
CHROMA_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int32)

GAUSS_FILTER = np.array([
    [16, 32, 16, 0], [16, 32, 16, 0], [15, 31, 17, 1], [15, 31, 17, 1],
    [14, 30, 18, 2], [14, 30, 18, 2], [13, 29, 19, 3], [13, 29, 19, 3],
    [12, 28, 20, 4], [12, 28, 20, 4], [11, 27, 21, 5], [11, 27, 21, 5],
    [10, 26, 22, 6], [10, 26, 22, 6], [9, 25, 23, 7], [9, 25, 23, 7],
    [8, 24, 24, 8], [8, 24, 24, 8], [7, 23, 25, 9], [7, 23, 25, 9],
    [6, 22, 26, 10], [6, 22, 26, 10], [5, 21, 27, 11], [5, 21, 27, 11],
    [4, 20, 28, 12], [4, 20, 28, 12], [3, 19, 29, 13], [3, 19, 29, 13],
    [2, 18, 30, 14], [2, 18, 30, 14], [1, 17, 31, 15], [1, 17, 31, 15],
], dtype=np.int32)
