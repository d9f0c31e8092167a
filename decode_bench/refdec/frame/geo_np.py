"""Geometric partitioning (GPM) tables and helpers (H.266 clause 8.5.7).

The split-mode table, blending weight masks, and per-size offsets are the
standard's procedural derivations (initGeoTemplate parity, Rom.cpp:519) —
generated here rather than stored.
"""

from __future__ import annotations

import numpy as np

GEO_NUM_ANGLES = 32
GEO_NUM_DISTANCES = 4
GEO_NUM_MODES = 64
GEO_MAX_CU_LOG2 = 6
GEO_WEIGHT_MASK_SIZE = 3 * ((1 << GEO_MAX_CU_LOG2) >> 3) * 2 + \
    (1 << GEO_MAX_CU_LOG2)  # 112

ANGLE2MASK = (0, -1, 1, 2, 3, 4, -1, -1, 5, -1, -1, 4, 3, 2, 1, -1,
              0, -1, 1, 2, 3, 4, -1, -1, 5, -1, -1, 4, 3, 2, 1, -1)
DIS = (8, 8, 8, 8, 4, 4, 2, 1, 0, -1, -2, -4, -4, -8, -8, -8,
       -8, -8, -8, -8, -4, -4, -2, -1, 0, 1, 2, 4, 4, 8, 8, 8)
ANGLE2MIRROR = (0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 2)


def _build():
    params = []
    for angle in range(GEO_NUM_ANGLES):
        for dist in range(GEO_NUM_DISTANCES):
            if (dist == 0 and angle >= 16) or \
                    ((dist in (0, 2)) and ANGLE2MASK[angle] in (0, 5)) or \
                    ANGLE2MASK[angle] == -1:
                continue
            params.append((angle, dist))
    weights = np.zeros((6, GEO_WEIGHT_MASK_SIZE, GEO_WEIGHT_MASK_SIZE),
                       dtype=np.int16)
    mask_off = (2 * (1 << GEO_MAX_CU_LOG2) - GEO_WEIGHT_MASK_SIZE) >> 1
    for angle in range((GEO_NUM_ANGLES >> 2) + 1):
        if ANGLE2MASK[angle] == -1:
            continue
        dx = angle
        dy = (dx + (GEO_NUM_ANGLES >> 2)) % GEO_NUM_ANGLES
        rho = (DIS[dx] << (GEO_MAX_CU_LOG2 + 1)) + \
            (DIS[dy] << (GEO_MAX_CU_LOG2 + 1))
        ys = (((np.arange(GEO_WEIGHT_MASK_SIZE) + mask_off) << 1) + 1) * DIS[dy]
        xs = (((np.arange(GEO_WEIGHT_MASK_SIZE) + mask_off) << 1) + 1) * DIS[dx]
        widx = 32 + (xs[None, :] + ys[:, None] - rho)
        weights[ANGLE2MASK[angle]] = np.clip((widx + 4) >> 3, 0, 8)
    return tuple(params), weights


GEO_PARAMS, GEO_WEIGHTS = _build()


def weight_offset(split_dir: int, w: int, h: int) -> tuple[int, int]:
    angle, dist = GEO_PARAMS[split_dir]
    off_x = (GEO_WEIGHT_MASK_SIZE - w) >> 1
    off_y = (GEO_WEIGHT_MASK_SIZE - h) >> 1
    if dist > 0:
        if angle % 16 == 8 or (angle % 16 != 0 and h >= w):
            off_y += (dist * h) >> 3 if angle < 16 else -((dist * h) >> 3)
        else:
            off_x += (dist * w) >> 3 if angle < 16 else -((dist * w) >> 3)
    return off_x, off_y


def geo_weight_block(split_dir: int, w: int, h: int, scale_x: int,
                     scale_y: int) -> np.ndarray:
    """Per-sample weights for candidate 0 (xWeightedGeoBlk,
    InterpolationFilter.cpp)."""
    angle, _ = GEO_PARAMS[split_dir]
    mask = GEO_WEIGHTS[ANGLE2MASK[angle]]
    ox, oy = weight_offset(split_dir, w << scale_x, h << scale_y)
    mirror = ANGLE2MIRROR[angle]
    ys = oy + (np.arange(h) << scale_y)
    xs = ox + (np.arange(w) << scale_x)
    if mirror == 2:
        ys = (GEO_WEIGHT_MASK_SIZE - 1 - oy) - (np.arange(h) << scale_y)
    elif mirror == 1:
        xs = (GEO_WEIGHT_MASK_SIZE - 1 - ox) - (np.arange(w) << scale_x)
    return mask[np.ix_(ys, xs)].astype(np.int64)
