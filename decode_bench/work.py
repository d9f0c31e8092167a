"""The yardstick of the kernels: the card's peaks and the work of a picture.

The work of each hand-written kernel of the decode path is counted from
the decoded picture and its syntax (the reference decoder's coding
structure), never from the kernel's own buffers, so a kernel that packs
its data tighter does not lower its own bound.  Every input the
algorithm needs is read once and every output written once; samples,
coefficient levels and residuals count at 2 bytes (10-bit video in
16-bit words).  The least time of a piece of work is the larger of its
bytes over the card's memory bandwidth and its operations over the int8
tensor rate: the published H100 SXM peaks, which assume the card's full
700 W (a run prints the card's power limit beside them).
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
SAMPLE_BYTES = 2

# the kernels of the decode path: work kind -> the substring of the
# device kernel's name in a profiler trace, and the wrappers' counters
KERNELS = {
    "itx": ("itx_kernel", ("ops.cuda.itx", ("itx_frame_cuda",
                                            "itx_batch_cuda"))),
    "intra": ("intra_wavefront_kernel", ("ops.cuda.intra",
                                         ("intra_wavefront_cuda",))),
    "deblock": ("deblock_kernel", ("ops.cuda.deblock",
                                   ("deblock_dense_cuda",))),
}


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time of work of `nbytes` and `ops` on one card."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S)


def itx_block_work(h: int, w: int, rows: int, cols: int) -> tuple[int, int]:
    """(bytes, operations) of the separable inverse transform of an h x w
    block whose non-zero levels lie in its top-left rows x cols: the
    levels of that region read, the h x w residuals written, and the
    multiply-adds (2 operations each) of a first pass over the `cols`
    columns (rows inputs to h outputs each) and a second over the h rows
    (cols inputs to w outputs each)."""
    if rows == 0 or cols == 0:
        return 0, 0
    macs = cols * h * rows + h * w * cols
    return (rows * cols + h * w) * SAMPLE_BYTES, 2 * macs


def _nonzero_extent(block: np.ndarray) -> tuple[int, int]:
    """(rows, cols) of the smallest top-left region holding every non-zero
    level of `block`."""
    nz = block != 0
    if not nz.any():
        return 0, 0
    rows = int(np.flatnonzero(nz.any(axis=1))[-1]) + 1
    cols = int(np.flatnonzero(nz.any(axis=0))[-1]) + 1
    return rows, cols


def picture_work(cs) -> dict:
    """{kind: [bytes, operations]} of one decoded picture, from its
    coding structure `cs`:

    - itx: every coded transform block but transform skip (which has no
      transform), by `itx_block_work` over its levels; a joint Cb-Cr
      block is one transform whose residual is written to both planes;
    - intra: every sample of every intra-coded block, its residual read
      and its reconstruction written (the prediction's few operations a
      sample are far below the bytes bound at the int8 rate, and the
      neighbouring samples it reads are other blocks' outputs);
    - deblock: every sample of every plane read and written once, in a
      picture whose slices do not all turn the deblocking off.
    """
    from refdec.frame.structure import MODE_INTRA, MTS_SKIP
    itx_b = itx_o = 0
    for tu in cs.tus:
        if tu is None:
            continue
        for comp in range(cs.num_comp):
            blk = tu.blocks[comp]
            if blk is None or not tu.cbf[comp] or tu.mts_idx[comp] == MTS_SKIP:
                continue
            if comp == 2 and tu.joint_cbcr and tu.cbf[1]:
                continue    # the Cb block's transform made it
            x, y, w, h = blk
            rows, cols = _nonzero_extent(cs.coef[comp][y:y + h, x:x + w])
            b, o = itx_block_work(h, w, rows, cols)
            if comp > 0 and tu.joint_cbcr:
                b += h * w * SAMPLE_BYTES   # the second chroma residual
            itx_b += b
            itx_o += o
    intra_samples = 0
    for cu in cs.cus:
        if cu is None or cu.pred_mode != MODE_INTRA:
            continue
        if cu.has_luma:
            intra_samples += cu.w * cu.h
        if cu.has_chroma and cs.num_comp > 1:
            intra_samples += 2 * cu.cw * cu.ch
    deblock_on = not all(getattr(s, "deblocking_disabled", False)
                         for s in cs.shs)
    samples = sum(w * h for w, h in cs.comp_size)
    return {
        "itx": [itx_b, itx_o],
        "intra": [2 * SAMPLE_BYTES * intra_samples, 0],
        "deblock": [2 * SAMPLE_BYTES * samples if deblock_on else 0, 0],
    }


def least_of(works) -> dict:
    """{kind: least seconds} of a list of picture_work results, each
    kind's work of a picture being one launch's (or, for the deblock, the
    two launches' of one picture)."""
    out = {k: 0.0 for k in KERNELS}
    for wk in works:
        for k, (b, o) in wk.items():
            out[k] += least_seconds(b, o)
    return out
