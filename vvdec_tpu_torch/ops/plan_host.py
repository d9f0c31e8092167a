"""The intra descriptor table of a picture, built in C from the syntax
walk's flat records (csrc/plan_host.c).

The native syntax walk (cabac/native_walk.py) leaves every CU and TU of a
picture as a row of int32 records in `cs._nw`; `build_rows` hands those
records, the picture's CU maps and the mode tables to the C builder, which
returns the same [n, D] table, or the same first rejection reason, as the
Python builder ops/intra_device.build_intra_descriptors_py, without making
a CodingUnit or TransformUnit object.  The record columns the builder
reads go to it as index tables: CU columns by their names in the walk's
own CU_F, TU columns by TU_FIELDS, the layout of
cabac/native_walk._materialize_tu (tests/test_torch_plan_native.py holds
the two together).  The library is built with the host compiler into
build/kernels/ on first use (ops/cuda/_build.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from vvdec_tpu_torch.cabac.native_walk import CU_F, CU_FIELDS
from vvdec_tpu_torch.ops.intra_device import D

# the TU record layout, field by field as _materialize_tu unpacks it
TU_FIELDS = (
    "cu_idx", "part_idx",
    "bx0", "by0", "bw0", "bh0", "bx1", "by1", "bw1", "bh1",
    "bx2", "by2", "bw2", "bh2",
    "cbf0", "cbf1", "cbf2", "mts0", "mts1", "mts2", "joint", "qp",
    "cqp0", "cqp1", "msx0", "msx1", "msx2", "msy0", "msy1", "msy2",
)
TU_F = {name: i for i, name in enumerate(TU_FIELDS)}

# the columns the C builder reads, in the order of its C_* / T_* enums
CU_COLS = ("x", "y", "w", "h", "cx", "cy", "cw", "ch", "has_luma",
           "has_chroma", "tree_type", "pred_mode", "intra_dir0",
           "intra_dir1", "bdpcm", "bdpcm_c", "mip_flag", "mip_transpose",
           "multi_ref", "isp", "ciip", "slice_idx", "tile_idx")
TU_COLS = ("cu_idx", "bx0", "by0", "bw0", "bh0", "bx1", "by1", "bw1", "bh1",
           "bx2", "by2", "bw2", "bh2", "cbf0", "cbf1", "cbf2", "joint")
CU_COL_IDX = np.asarray([CU_F[n] for n in CU_COLS], dtype=np.int32)
TU_COL_IDX = np.asarray([TU_F[n] for n in TU_COLS], dtype=np.int32)

# the parameter vector, in the order of the C builder's P_* enum
PARAMS = ("n_cus", "n_tus", "cu_width", "tu_width", "w", "h", "cw", "ch",
          "sub_w", "sub_h", "num_comp", "chroma_format", "ctu_log2",
          "ctu_size", "wpp", "chroma_scale", "map_w", "map_h", "mapc_w",
          "mapc_h", "n_ang", "n_thresh", "n_c422", "max_rows")

# rejection reasons, in the order of the C builder's R_* enum
REASONS = ("ibc", "ciip_size", "isp", "mrl", "bdpcm", "block_size",
           "fill_corner_case", "chroma_mode")
PLAN_REJECT, PLAN_UNMODELLED = -1, -2

_failed: list = []   # the build or load error, kept: Python plans from then


def plan_function():
    """plan_intra_rows of csrc/plan_host.c, built and loaded on first use;
    None where the host compiler is missing or the build failed."""
    if _failed:
        return None
    from vvdec_tpu_torch.ops.cuda._build import KernelError, load_kernel
    try:
        lib = load_kernel("plan_host")
    except KernelError as e:
        _failed.append(e)
        return None
    fn = lib.plan_intra_rows
    if fn.argtypes is None:
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        fn.argtypes = [i32, ctypes.c_int] + [i32] * 12
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tables() -> tuple:
    """ANG_TABLE, INV_ANG_TABLE, the luma filter thresholds and the 4:2:2
    chroma mode map, as int32 arrays."""
    from vvdec_tpu_torch.frame.recon_np import CHROMA422_MAP
    from vvdec_tpu_torch.ops.tables import (ANG_TABLE, INTRA_FILTER_THRESH,
                                            INV_ANG_TABLE)
    tabs = (ANG_TABLE, INV_ANG_TABLE, INTRA_FILTER_THRESH[0], CHROMA422_MAP)
    return tuple(np.ascontiguousarray(t, dtype=np.int32) for t in tabs)


def records_of(cs):
    """(cu_rec, tu_rec) of the picture's syntax walk when they describe
    every CU and TU of cs in the layout named here, else None."""
    nw = getattr(cs, "_nw", None)
    if nw is None:
        return None
    n_cus, n_tus = int(nw["counts"][0]), int(nw["counts"][1])
    if n_cus != len(cs.cus) or n_tus != len(cs.tus):
        return None
    cu_rec, tu_rec = nw["cu_rec"], nw["tu_rec"]
    if cu_rec.ndim != 2 or cu_rec.shape[1] != len(CU_FIELDS) \
            or tu_rec.ndim != 2 or tu_rec.shape[1] != len(TU_FIELDS) \
            or cu_rec.dtype != np.int32 or tu_rec.dtype != np.int32 \
            or cu_rec.shape[0] < n_cus or tu_rec.shape[0] < n_tus:
        return None
    return cu_rec, tu_rec


def build_rows(cs, chroma_scale: bool):
    """(desc [n, D] int32, None, has_inter) or (None, reason, has_inter)
    from the C builder, for a picture that passed the picture-level gates
    of ops/intra_device._picture_gates (chroma_scale: whether LMCS scales
    its chroma residuals); has_inter says whether any CU is not intra.
    None where the picture carries no records, the library is missing, or
    the builder meets an input it does not model: the Python builder
    plans the picture then."""
    recs = records_of(cs)
    if recs is None:
        return None
    fn = plan_function()
    if fn is None:
        return None
    cu_rec, tu_rec = (np.ascontiguousarray(r) for r in recs)
    n_cus, n_tus = len(cs.cus), len(cs.tus)
    ang, inv, thresh, c422 = _tables()
    cw, ch = cs.comp_size[1] if cs.num_comp > 1 else (0, 0)
    map_c = cs.cu_map_c if cs.cu_map_c is not None \
        else np.zeros((0, 0), dtype=np.int32)
    map_c = np.ascontiguousarray(map_c, dtype=np.int32)
    cu_map = np.ascontiguousarray(cs.cu_map, dtype=np.int32)
    # at most a row a component of each TU and of each CIIP CU
    max_rows = 3 * (n_tus + n_cus)
    values = dict(
        n_cus=n_cus, n_tus=n_tus, cu_width=cu_rec.shape[1],
        tu_width=tu_rec.shape[1], w=cs.w, h=cs.h, cw=cw, ch=ch,
        sub_w=cs.sub_w, sub_h=cs.sub_h, num_comp=cs.num_comp,
        chroma_format=cs.sps.chroma_format_idc, ctu_log2=cs.sps.ctu_log2,
        ctu_size=cs.sps.ctu_size,
        wpp=int(bool(cs.sps.entropy_coding_sync_enabled)),
        chroma_scale=int(chroma_scale), map_w=cu_map.shape[1],
        map_h=cu_map.shape[0], mapc_w=map_c.shape[1], mapc_h=map_c.shape[0],
        n_ang=len(ang), n_thresh=len(thresh), n_c422=len(c422),
        max_rows=max_rows)
    params = np.asarray([values[k] for k in PARAMS], dtype=np.int32)
    out = np.empty((max(max_rows, 1), D), dtype=np.int32)
    status = np.zeros(2, dtype=np.int32)
    r = fn(params, len(params), CU_COL_IDX, TU_COL_IDX, cu_rec, tu_rec,
           cu_map, map_c, ang, inv, thresh, c422, out, status)
    if r == PLAN_UNMODELLED:
        return None
    inter = bool(status[1])
    if r == PLAN_REJECT:
        return None, REASONS[int(status[0])], inter
    return out[:r].copy(), None, inter
