"""The kernels' work, counted by hand on small pictures."""

from types import SimpleNamespace

import numpy as np
import pytest

import work
from refdec.frame.structure import (MODE_INTER, MODE_INTRA, MTS_SKIP,
                                    CodingUnit, TransformUnit)


def test_least_seconds_is_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 1.979e15) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 2 * 1.979e15) == pytest.approx(2.0)


@pytest.mark.parametrize("h,w,rows,cols,nbytes,ops", [
    # 4x4, all levels: 16 levels in, 16 residuals out; 4 columns of
    # 4x4 multiply-adds, then 4 rows of 4x4
    (4, 4, 4, 4, (16 + 16) * 2, 2 * (4 * 4 * 4 + 4 * 4 * 4)),
    # 8 high, 16 wide, levels in the top-left 2x3: 3 columns of 8 outputs
    # from 2 inputs, then 8 rows of 16 outputs from 3 inputs
    (8, 16, 2, 3, (6 + 128) * 2, 2 * (3 * 8 * 2 + 8 * 16 * 3)),
    # a 32x32 block whose only level is its DC
    (32, 32, 1, 1, (1 + 1024) * 2, 2 * (32 + 1024)),
    # no level: no transform
    (16, 16, 0, 0, 0, 0),
])
def test_itx_block_work(h, w, rows, cols, nbytes, ops):
    assert work.itx_block_work(h, w, rows, cols) == (nbytes, ops)


def _picture():
    """A 16x8 4:2:0 picture: an intra CU on the left 8x8 (one TU, luma
    levels in its top-left 2x1, Cb with a DC level, Cr not coded) and
    an inter CU on the right (one TU, luma transform skip, Cb coded
    with a level at row 3, column 0)."""
    coef = [np.zeros((8, 16), np.int32), np.zeros((4, 8), np.int32),
            np.zeros((4, 8), np.int32)]
    coef[0][0, 0] = 5
    coef[0][1, 0] = -2
    coef[1][0, 0] = 1
    coef[0][0, 9] = 7          # transform skip: not counted
    coef[1][3, 4] = 3
    intra = CodingUnit(x=0, y=0, w=8, h=8, cx=0, cy=0, cw=4, ch=4,
                       pred_mode=MODE_INTRA)
    inter = CodingUnit(x=8, y=0, w=8, h=8, cx=4, cy=0, cw=4, ch=4,
                       pred_mode=MODE_INTER)
    t0 = TransformUnit(blocks=[(0, 0, 8, 8), (0, 0, 4, 4), (0, 0, 4, 4)],
                       cbf=[True, True, False])
    t1 = TransformUnit(blocks=[(8, 0, 8, 8), (4, 0, 4, 4), (4, 0, 4, 4)],
                       cbf=[True, True, False],
                       mts_idx=[MTS_SKIP, 0, 0])
    return SimpleNamespace(num_comp=3, coef=coef, tus=[t0, t1],
                           cus=[intra, inter],
                           shs=[SimpleNamespace(deblocking_disabled=False)],
                           comp_size=[(16, 8), (8, 4), (8, 4)])


def test_picture_work_by_hand():
    cs = _picture()
    got = work.picture_work(cs)
    luma = work.itx_block_work(8, 8, 2, 1)      # rows 0-1, column 0
    cb0 = work.itx_block_work(4, 4, 1, 1)       # the DC
    cb1 = work.itx_block_work(4, 4, 4, 1)       # row 3, column 0
    assert got["itx"] == [luma[0] + cb0[0] + cb1[0],
                          luma[1] + cb0[1] + cb1[1]]
    # the intra CU: 64 luma and 2 x 16 chroma samples, read and written
    assert got["intra"] == [(64 + 32) * 2 * 2, 0]
    # every sample of the picture, read and written
    assert got["deblock"] == [(128 + 32 + 32) * 2 * 2, 0]


def test_picture_work_without_deblocking():
    cs = _picture()
    cs.shs = [SimpleNamespace(deblocking_disabled=True)]
    assert work.picture_work(cs)["deblock"] == [0, 0]


def test_least_of_sums_launches():
    pic = {"itx": [3.35e12, 0], "intra": [0, 1.979e15], "deblock": [0, 0]}
    got = work.least_of([pic, pic])
    assert got == pytest.approx({"itx": 2.0, "intra": 2.0, "deblock": 0.0})
