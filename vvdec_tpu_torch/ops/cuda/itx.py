"""Dequant + separable inverse transform: the Hopper kernel
(csrc/itx.cu), its ctypes wrappers and their plain PyTorch versions.

Counterpart of vvdec_tpu/ops/pallas/itx.py (itx_batch_pallas,
dequant_params).  Two entry points run the one kernel:

- `itx_frame_cuda`: every plain TU of a frame in one launch.  It reads
  the int16 coefficient planes and writes the padded int32 residual
  planes in place, driven by a work table that `frame_table` builds on
  the host and by the constant pool of every transform matrix
  (`matrix_pool`).  Plain version: `itx_frame_ref`.
- `itx_batch_cuda`: the TPU kernel's own interface, levels [N, h, w]
  int32 with per-TU scale / rshift / imax from `dequant_params` and
  matrices Mv [h, h], Mh [w, w] int32, run as a one-group table.  Plain
  version: `itx_batch_ref`.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches the kernel (counted in `<wrapper>.launches`) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops import rom
from vvdec_tpu_torch.ops.tables import tr_matrix

MAX_LOG2_TR_RANGE = 15
TR_MIN = -(1 << MAX_LOG2_TR_RANGE)
TR_MAX = (1 << MAX_LOG2_TR_RANGE) - 1
SIDES = (2, 4, 8, 16, 32, 64)
# the work table (csrc/itx.cu): n_tasks + 1 task starts (TU row
# indices), then one row of ROW_INTS int32 per TU with these fields
ROW_FIELDS = ("comp", "y", "x", "log2_h", "log2_w", "mv_off", "mh_off",
              "scale", "rshift", "imax")
ROW_INTS = len(ROW_FIELDS)
# coefficients of one task of small TUs (kSmallCap); a small TU larger
# than that (8x64 and the like) is a task of its own
SMALL_CAP = 256
# every transform matrix the ITX stage uses, by kind and side
POOL_MATRICES = tuple((kind, n) for kind, sides in (
    ("DCT2", SIDES), ("DST7", (4, 8, 16, 32)), ("DCT8", (4, 8, 16, 32)))
    for n in sides)


def _s2(bit_depth: int) -> int:
    return (6 + MAX_LOG2_TR_RANGE - 1) - bit_depth


def _exact_dot(eq: str, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Exact int32 contraction through float64 (CUDA has no int32
    matmul; float64 is exact below 2^53 and these sums stay below 2^28)."""
    return torch.einsum(eq, a.to(torch.float64),
                        m.to(torch.float64)).to(torch.int32)


def _dequant(levels, scale, rshift, imax):
    """The per-TU dequant of _itx_kernel: [N, h, w] int32."""
    imax = imax[:, None, None]
    rs = rshift[:, None, None]
    prod = torch.clamp(levels, -imax - 1, imax) * scale[:, None, None]
    rs_pos = torch.clamp(rs, min=0)
    deq_pos = (prod + (1 << torch.clamp(rs_pos - 1, min=0))) >> rs_pos
    deq_neg = prod << torch.clamp(-rs, min=0)
    deq = torch.where(rs > 0, deq_pos, deq_neg)
    return torch.where(levels != 0, torch.clamp(deq, TR_MIN, TR_MAX),
                       torch.zeros_like(deq))


def itx_batch_ref(levels, scale, rshift, imax, mv, mh, *, h: int, w: int,
                  bit_depth: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same integer arithmetic,
    products in float64.  Runs on any device."""
    s2 = _s2(bit_depth)
    deq = _dequant(levels, scale, rshift, imax)
    tmp = _exact_dot("nkx,ky->nxy", deq, mv)
    tmp = torch.clamp((tmp + (1 << 6)) >> 7, TR_MIN, TR_MAX)
    res = _exact_dot("nky,kx->nyx", tmp, mh)
    return torch.clamp((res + (1 << (s2 - 1))) >> s2, TR_MIN, TR_MAX)


def _check(fn, name, t, shape, device, dtype=torch.int32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, not {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def itx_batch_cuda(levels, scale, rshift, imax, mv, mh, *, h: int, w: int,
                   bit_depth: int) -> torch.Tensor:
    """levels [N,h,w] int32, scale/rshift/imax [N] int32, mv [h,h],
    mh [w,w] int32 -> residual [N,h,w] int32, bit-exact with
    itx_batch_pallas.

    On CUDA tensors this launches the csrc/itx.cu kernel on the current
    stream (counted in `itx_batch_cuda.launches`) with the batch as one
    plane of N TUs stacked in rows, or raises; on CPU tensors it runs
    `itx_batch_ref`.  The matrices must fit int8, as every transform
    matrix does (checked on the device, which waits for the stream)."""
    fn = "itx_batch_cuda"
    if h not in SIDES or w not in SIDES:
        raise ValueError(f"{fn}: unsupported TU shape {h}x{w}")
    if not isinstance(levels, torch.Tensor) or levels.dim() != 3:
        raise ValueError(f"{fn}: levels must be a [N, h, w] tensor")
    n = levels.shape[0]
    dev = levels.device
    for name, t, shape in (("levels", levels, (n, h, w)),
                           ("scale", scale, (n,)), ("rshift", rshift, (n,)),
                           ("imax", imax, (n,)), ("mv", mv, (h, h)),
                           ("mh", mh, (w, w))):
        _check(fn, name, t, shape, dev)
    if dev.type == "cpu":
        return itx_batch_ref(levels, scale, rshift, imax, mv, mh, h=h, w=w,
                             bit_depth=bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    out = torch.empty((n, h, w), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    if bool(((mv < -128) | (mv > 127)).any()
            | ((mh < -128) | (mh > 127)).any()):
        raise ValueError(f"{fn}: transform matrix entries must fit int8")
    mv_entry = _pool_entry(mv.to(torch.int8))
    pool = torch.cat([mv_entry, _pool_entry(mh.to(torch.int8))])
    mh_off = mv_entry.numel()

    def col(v):
        return torch.full((n,), v, dtype=torch.int32, device=dev)

    rows = torch.stack([
        col(0), torch.arange(0, n * h, h, dtype=torch.int32, device=dev),
        col(0), col(h.bit_length() - 1), col(w.bit_length() - 1), col(0),
        col(mh_off), scale, rshift, imax], dim=1)
    per = 1 if min(h, w) >= 16 else max(1, SMALL_CAP // (h * w))
    starts = torch.cat([
        torch.arange(0, n, per, dtype=torch.int32, device=dev),
        torch.full((1,), n, dtype=torch.int32, device=dev)])
    plane = levels.view(n * h, w)
    _launch(fn, [plane, None, None], [out.view(n * h, w), None, None],
            torch.cat([starts, rows.reshape(-1)]), starts.numel() - 1, pool,
            bit_depth)
    itx_batch_cuda.launches += 1
    return out


itx_batch_cuda.launches = 0


def _pool_entry(m):
    """One matrix M [n, n] (row = frequency) of the int8 pool: M^T, for
    the tensor-core path, then M, for the CUDA-core path, each padded to
    16 bytes (csrc/itx.cu plain_offset).  numpy or torch in, same out."""
    n = m.shape[0]
    size = -(-n * n // 16) * 16
    if isinstance(m, torch.Tensor):
        out = torch.zeros(2 * size, dtype=torch.int8, device=m.device)
    else:
        out = np.zeros(2 * size, np.int8)
    out[:n * n] = m.T.reshape(-1)
    out[size:size + n * n] = m.reshape(-1)
    return out


@functools.lru_cache(maxsize=None)
def _pool_layout() -> tuple[np.ndarray, dict]:
    """(int8 pool, {(kind, n): offset}): a `_pool_entry` for each matrix
    of POOL_MATRICES, at 16-byte aligned offsets."""
    chunks, offsets, off = [], {}, 0
    for kind, n in POOL_MATRICES:
        m = np.asarray(tr_matrix(kind, n))
        assert np.abs(m).max() <= 127, (kind, n)
        chunks.append(_pool_entry(m))
        offsets[(kind, n)] = off
        off += chunks[-1].size
    return np.concatenate(chunks), offsets


@functools.lru_cache(maxsize=None)
def matrix_pool(device) -> torch.Tensor:
    """The int8 pool of every transform matrix on `device`, uploaded once
    per device; offsets in `pool_offset`."""
    return torch.as_tensor(_pool_layout()[0], device=device)


def pool_offset(kind: str, n: int) -> int:
    return _pool_layout()[1][(kind, n)]


def frame_table(groups, bit_depth: int) -> tuple[np.ndarray, int]:
    """The work table of one frame's kernel TUs and its task count.

    `groups` holds ((comp, w, h, hor, ver, dep_quant), [(x, y, qp),
    ...]) pairs.  Scale, rshift and imax come from `dequant_params` on
    numpy QPs, as the TPU kernel has them computed on the host.  Rows are
    ordered large TUs first (both sides >= 16, largest first, one task
    each), then small TUs grouped by shape, packed up to SMALL_CAP
    coefficients a task (one TU where it alone has more)."""
    parts = []
    for (comp, w, h, hor, ver, dep_quant), items in groups:
        xyq = np.asarray(items, dtype=np.int32).reshape(-1, 3)
        scale, rshift, imax = dequant_params(xyq[:, 2], w, h, bit_depth,
                                             dep_quant)
        consts = np.array([comp, h.bit_length() - 1, w.bit_length() - 1,
                           pool_offset(ver, h), pool_offset(hor, w)],
                          dtype=np.int32)
        part = np.empty((len(xyq), ROW_INTS), dtype=np.int32)
        part[:, 0] = consts[0]
        part[:, 1] = xyq[:, 1]
        part[:, 2] = xyq[:, 0]
        part[:, 3:7] = consts[1:]
        part[:, 7], part[:, 8], part[:, 9] = scale, rshift, imax
        parts.append(part)
    rows = np.concatenate(parts) if parts \
        else np.zeros((0, ROW_INTS), np.int32)
    lh, lw = rows[:, 3], rows[:, 4]
    small = (lh < 4) | (lw < 4)
    rows = rows[np.lexsort((lw, lh, -(lh + lw), small))]
    lh, lw = rows[:, 3], rows[:, 4]
    small = (lh < 4) | (lw < 4)
    idx = np.arange(len(rows))
    shape = lh * 8 + lw
    run_head = small & np.r_[True, shape[1:] != shape[:-1]]
    run_start = np.maximum.accumulate(np.where(run_head, idx, 0))
    per = np.maximum(SMALL_CAP >> (lh + lw), 1)
    head = ~small | ((idx - run_start) % per == 0)
    starts = np.r_[idx[head], len(rows)].astype(np.int32)
    return np.concatenate([starts, rows.reshape(-1)]), len(starts) - 1


def table_rows(table, n_tasks: int) -> np.ndarray:
    """The TU rows [N, ROW_INTS] of a work table (numpy)."""
    t = table.cpu().numpy() if isinstance(table, torch.Tensor) else table
    return np.asarray(t[n_tasks + 1:]).reshape(-1, ROW_INTS)


def itx_frame_ref(coef, resi, table, pool, *, n_tasks: int,
                  bit_depth: int) -> list:
    """Plain PyTorch version of itx_frame_cuda on any device: per group
    of TUs with one shape and one matrix pair, extract the levels from
    the coefficient plane, run itx_batch_ref and scatter the residuals
    into the residual plane, windows clamped as the kernel clamps them."""
    from vvdec_tpu_torch.ops.frame_device import _extract_fn, _scatter_fn

    rows = table_rows(table, n_tasks)
    keys, inv = np.unique(rows[:, [0, 3, 4, 5, 6]], axis=0,
                          return_inverse=True)
    dev = resi[0].device
    for gi, (comp, lh, lw, mv_off, mh_off) in enumerate(keys.tolist()):
        sel = torch.as_tensor(rows[inv.reshape(-1) == gi], device=dev)
        h, w = 1 << lh, 1 << lw
        mv = pool[mv_off:mv_off + h * h].view(h, h).t().to(torch.int32)
        mh = pool[mh_off:mh_off + w * w].view(w, w).t().to(torch.int32)
        ys, xs = sel[:, 1], sel[:, 2]
        levels = _extract_fn(h, w)(coef[comp], ys, xs)
        out = itx_batch_ref(levels, sel[:, 7], sel[:, 8], sel[:, 9], mv, mh,
                            h=h, w=w, bit_depth=bit_depth)
        resi[comp] = _scatter_fn(h, w)(resi[comp], out, ys, xs)
    return resi


def itx_frame_cuda(coef, resi, table, pool, *, n_tasks: int,
                   bit_depth: int) -> list:
    """Every TU of a work table in one launch.

    coef: three 2-D contiguous level planes, int16 (or all int32), None
    for an absent component; resi: three 2-D contiguous int32 residual
    planes, updated in place and returned; table: 1-D int32 work table
    (`frame_table`) of n_tasks tasks; pool: `matrix_pool`.

    On CUDA tensors this launches the csrc/itx.cu kernel on the current
    stream (counted in `itx_frame_cuda.launches`) or raises; on CPU
    tensors it runs `itx_frame_ref`."""
    fn = "itx_frame_cuda"
    if not isinstance(table, torch.Tensor) or table.dim() != 1:
        raise ValueError(f"{fn}: table must be a 1-D tensor")
    dev = table.device
    _check(fn, "table", table, None, dev)
    _check(fn, "pool", pool, None, dev, torch.int8)
    if len(coef) != 3 or len(resi) != 3:
        raise ValueError(f"{fn}: expected three coefficient and three "
                         f"residual planes")
    present = [c for c in coef if c is not None]
    ltype = present[0].dtype if present else torch.int16
    if ltype not in (torch.int16, torch.int32):
        raise TypeError(f"{fn}: levels must be int16 or int32")
    for i in range(3):
        if coef[i] is not None:
            _check(fn, f"coef[{i}]", coef[i], None, dev, ltype)
        _check(fn, f"resi[{i}]", resi[i], None, dev)
        if resi[i].dim() != 2 or (coef[i] is not None
                                  and coef[i].dim() != 2):
            raise ValueError(f"{fn}: planes must be 2-D")
    if table.numel() < n_tasks + 1 \
            or (table.numel() - n_tasks - 1) % ROW_INTS:
        raise ValueError(f"{fn}: table of {table.numel()} ints does not "
                         f"hold {n_tasks} tasks and whole TU rows")
    if dev.type == "cpu":
        return itx_frame_ref(coef, resi, table, pool, n_tasks=n_tasks,
                             bit_depth=bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if n_tasks == 0:
        return resi
    _launch(fn, coef, resi, table, n_tasks, pool, bit_depth)
    itx_frame_cuda.launches += 1
    return resi


itx_frame_cuda.launches = 0


def _launch(fn, coef, resi, table, n_tasks, pool, bit_depth) -> None:
    """One itx_frame_launch of the built library on the current stream
    (planes of absent components None); raises if the launch is
    refused."""
    if pool.data_ptr() % 16:
        raise ValueError(f"{fn}: the matrix pool must be 16-byte aligned")
    desc = (ctypes.c_longlong * 18)()
    ltype = None
    for i in range(3):
        c, r = coef[i], resi[i]
        if c is not None:
            ltype = c.dtype
            desc[6 * i:6 * i + 3] = [c.data_ptr(), c.shape[0], c.shape[1]]
        if r is not None:
            desc[6 * i + 3:6 * i + 6] = [r.data_ptr(), r.shape[0],
                                         r.shape[1]]
    level_bytes = 4 if ltype == torch.int32 else 2
    lib = _library()
    dev = table.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.itx_frame_launch(desc, table.data_ptr(), n_tasks,
                                   pool.data_ptr(), _s2(bit_depth),
                                   level_bytes, stream)
    if err != 0:
        from vvdec_tpu_torch.ops.cuda._build import KernelError
        raise KernelError(f"{fn}: kernel launch failed (cudaError {err}) "
                           f"for {n_tasks} tasks")


def _library():
    from vvdec_tpu_torch.ops.cuda._build import load_kernel

    lib = load_kernel("itx")
    fn = lib.itx_frame_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _scale_table(row: int, device) -> torch.Tensor:
    """rom.INV_QUANT_SCALES[row] on `device`, uploaded once (a copy per
    call would synchronise the stream once per TU group)."""
    return torch.as_tensor(rom.INV_QUANT_SCALES[row], dtype=torch.int32,
                           device=device)


def dequant_params(qp, w: int, h: int, bit_depth: int, dep_quant: bool):
    """Per-TU dequant parameters (scale, right-shift, input max) from QP
    (Quant.cpp:292 scale/shift derivation).  Works on numpy arrays and on
    torch tensors (on the tensor's device)."""
    log2_w, log2_h = w.bit_length() - 1, h.bit_length() - 1
    transform_shift = MAX_LOG2_TR_RANGE - bit_depth - ((log2_w + log2_h) >> 1)
    needs_sqrt2 = ((log2_w + log2_h) & 1) == 1
    i_transform_shift = transform_shift + (-1 if needs_sqrt2 else 0)
    row = 1 if needs_sqrt2 else 0
    if isinstance(qp, torch.Tensor):
        qp = qp.to(torch.int32)
        scales = _scale_table(row, qp.device)
    else:
        qp = np.asarray(qp, dtype=np.int32)
        scales = np.asarray(rom.INV_QUANT_SCALES[row], dtype=np.int32)
    if dep_quant:
        qp_per = (qp + 1) // 6
        qp_rem = qp + 1 - 6 * qp_per
    else:
        qp_per, qp_rem = qp // 6, qp % 6
    rshift = 6 + (1 if dep_quant else 0) - (i_transform_shift + qp_per)
    if isinstance(qp, torch.Tensor):
        scale = scales[qp_rem.long()]
        target_bd = torch.clamp(64 + rshift - 7, max=MAX_LOG2_TR_RANGE + 1)
        imax = (1 << (target_bd.to(torch.int64) - 1)).to(torch.int32) - 1
        return (scale.to(torch.int32), rshift.to(torch.int32),
                imax.to(torch.int32))
    scale = scales[qp_rem]
    target_bd = np.minimum(MAX_LOG2_TR_RANGE + 1, 64 + rshift - 7)
    imax = (1 << (target_bd.astype(np.int64) - 1)).astype(np.int32) - 1
    return (scale.astype(np.int32), rshift.astype(np.int32),
            imax.astype(np.int32))
