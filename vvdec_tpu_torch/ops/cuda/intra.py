"""The intra wavefront of one picture: the Hopper kernel
(csrc/intra_wavefront.cu), its ctypes wrapper and its plain PyTorch
version.

Counterpart of vvdec_tpu/ops/intra_device.py::_intra_wavefront_fn, one
jax.jit program a picture (a lax.scan over the host's [S, K, D] step
batches, a lax.switch on each step's mode class, a fori_loop over the K
masked block writes).

Both versions run the steps as phases (`wavefront_phases`): the
consecutive steps of one dependency level (with the step levels; one
phase a step without), split where two units of one component would
write the same sample, so the later row still wins.  Units of one level
never read each other's output, so a phase may read everything before
it writes anything, and the result is the reference's.

- `intra_wavefront_cuda` runs every phase of a picture in one launch of
  one thread-block cluster on CUDA tensors (counted in
  `intra_wavefront_cuda.launches`), over the host's plan
  (`wavefront_plan`: each phase's units dealt over the cluster's blocks,
  packed in chunk records), and the plain version on CPU tensors.
- `intra_wavefront_ref` is the plain version: one Python loop iteration
  a phase and mode class (gather, predict, residual add), then the
  phase's masked index_put_ writes, on any device.
- `intra_consts(device)` is the one pool of constant tables both read
  (the plain version through views, ops/intra_device._angular_filters,
  _mip_matrices, _cclm_div): the cubic and gauss interpolation filters,
  MIP_4x4 / 8x8 / 16x16 and the CCLM division table, from ops/tables.py
  and ops/intra_device.py.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.tables import (
    CHROMA_FILTER,
    GAUSS_FILTER,
    MIP_4x4,
    MIP_8x8,
    MIP_16x16,
)
from vvdec_tpu_torch.utils.trace import profiler

# the constant pool (csrc/intra_wavefront.cu k* offsets): name, shape
CONST_TABLES = (("cubic", (32, 4)), ("gauss", (32, 4)),
                ("mip4", (16, 16, 4)), ("mip8", (8, 16, 8)),
                ("mip16", (6, 64, 7)), ("cclm_div", (16,)))
CONST_LEN = sum(int(np.prod(s)) for _, s in CONST_TABLES)
N_CLASSES = 6   # planar, DC, angular, MIP, CCLM, CIIP
# the plan's layout (csrc/intra_wavefront.cu kU, kRow, kHead): a chunk
# record holds a phase number, a row count n, 2 pad ints and n <=
# CHUNK_UNITS rows of PLAN_ROW ints (a descriptor row and 3 pad ints, 16
# bytes aligned); PLAN_HEAD ints before the records hold where each
# block's records begin
CHUNK_UNITS = 8
PLAN_ROW = 36
PLAN_HEAD = 20
# the most samples of one unit a record row takes: a larger unit is cut
# into slices of whole rows, each dealt on its own (csrc reads the slice's
# rows from the pad field d[32])
SLICE_SAMPLES = 1024
# cluster sizes the kernel takes (above 8, the non-portable size;
# launch_plan), and the one the wrapper launches, chosen on the card from
# the kernel's time at equal empty-phase floors (PERF.md)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
CLUSTER = 16


@functools.lru_cache(maxsize=None)
def _const_pool() -> np.ndarray:
    from vvdec_tpu_torch.ops.intra_device import _CCLM_DIV
    tables = dict(cubic=CHROMA_FILTER, gauss=GAUSS_FILTER, mip4=MIP_4x4,
                  mip8=MIP_8x8, mip16=MIP_16x16, cclm_div=_CCLM_DIV)
    out = [np.asarray(tables[name], dtype=np.int32).reshape(-1)
           for name, _ in CONST_TABLES]
    return np.concatenate(out)


@functools.lru_cache(maxsize=None)
def intra_consts(device) -> torch.Tensor:
    """The int32 pool of CONST_TABLES on `device`, uploaded once."""
    return torch.as_tensor(_const_pool(), device=device)


def const_tables(consts: torch.Tensor) -> dict:
    """The named views of CONST_TABLES into a pool."""
    out, off = {}, 0
    for name, shape in CONST_TABLES:
        n = int(np.prod(shape))
        out[name] = consts[off:off + n].view(shape)
        off += n
    return out


def _validate(fn, buf, resi, batches, consts, lm, K, bd, has_lmcs, levels):
    """The host checks of both versions: tensors, shapes, devices, every
    valid row's mode class and the step levels (one integer a step, never
    decreasing).  Returns the batches as an [S, K, D] int32 numpy array
    and the levels as a numpy array (or None)."""
    from vvdec_tpu_torch.ops.intra_device import D, LM_LEN, RL
    for name, t in (("buf", buf), ("resi", resi), ("consts", consts)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"{fn}: {name} must be an int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    dev = buf.device
    if buf.dim() != 3 or buf.shape[0] != 3 or buf.shape[1] < RL \
            or buf.shape[2] < RL:
        raise ValueError(f"{fn}: buf must be [3, hh, ww] with hh, ww >= "
                         f"{RL}, not {tuple(buf.shape)}")
    if tuple(resi.shape) != tuple(buf.shape) or resi.device != dev:
        raise ValueError(f"{fn}: resi must be {tuple(buf.shape)} on {dev}")
    if tuple(consts.shape) != (CONST_LEN,) or consts.device != dev:
        raise ValueError(f"{fn}: consts must be intra_consts({dev})")
    if has_lmcs and (not isinstance(lm, torch.Tensor)
                     or lm.dtype != torch.int32
                     or tuple(lm.shape) != (LM_LEN,) or lm.device != dev):
        raise ValueError(f"{fn}: lm must be an int32 [{LM_LEN}] tensor "
                         f"on {dev}")
    if not 2 <= bd <= 16:
        raise ValueError(f"{fn}: unsupported bit depth {bd}")
    batches = np.asarray(batches)
    if batches.ndim != 3 or batches.shape[1:] != (K, D):
        raise ValueError(f"{fn}: batches must be [S, {K}, {D}], not "
                         f"{batches.shape}")
    rows = batches.reshape(-1, D)
    mc = rows[rows[:, 28] == 1, 7]
    bad = (mc < 0) | (mc >= N_CLASSES)
    if bad.any():
        raise NotImplementedError(
            f"intra wavefront: mode class {int(mc[bad][0])} is not ported")
    if levels is not None:
        levels = np.asarray(levels)
        if levels.shape != batches.shape[:1] \
                or not np.issubdtype(levels.dtype, np.integer):
            raise ValueError(f"{fn}: levels must hold one integer a step "
                             f"({batches.shape[0]}), not {levels.shape} "
                             f"{levels.dtype}")
        if (np.diff(levels) < 0).any():
            raise ValueError(f"{fn}: the step levels must not decrease")
    return np.ascontiguousarray(batches, dtype=np.int32), levels


def unit_blocks(rows, hh: int, ww: int) -> tuple:
    """(comp, y0, x0, h, w) numpy arrays of the samples each descriptor
    row writes in the stacked [3, hh, ww] planes: the h x w corner of its
    64 x 64 window, whose start is clamped as lax.dynamic_update_slice
    clamps it."""
    from vvdec_tpu_torch.ops.intra_device import B

    def start(s, dim):
        return np.clip(np.where(s < 0, s + dim, s), 0, dim - B)

    return (np.clip(rows[:, 0], 0, 2), start(rows[:, 2], hh),
            start(rows[:, 1], ww), np.clip(rows[:, 4], 0, B),
            np.clip(rows[:, 3], 0, B))


def moved_windows(batches, hh: int, ww: int) -> bool:
    """Whether a valid unit's 64 x 64 window starts elsewhere than at the
    unit, the clamp having moved it off the [3, hh, ww] planes' edge (or
    its negative start wrapped): never on the decoder's planes, which are
    padded by PB = 64.  Such a unit writes where another may read."""
    from vvdec_tpu_torch.ops.intra_device import D
    rows = batches.reshape(-1, D)
    rows = rows[rows[:, 28] == 1]
    _, y0, x0, _, _ = unit_blocks(rows, hh, ww)
    return bool(((y0 != rows[:, 2]) | (x0 != rows[:, 1])).any())


def wavefront_phases(batches, levels, hh: int, ww: int) -> np.ndarray:
    """The phases of a picture's [S, K, D] step batches, as the first row
    of each (an index into batches.reshape(-1, D)) and the row count at
    the end: [n_phases + 1] int64.  A phase is the run of consecutive
    steps of one level (`levels`, one a step), or one step where levels
    is None or a window is moved (`moved_windows`: the level property
    need not hold); where two valid units of one component in a phase
    would write the same sample of the [3, hh, ww] planes (never in a
    conformant picture), the later one in row order starts a new phase,
    so it still wins.  Vectorised: every pair of units of a phase is
    tested at once, and phases are cut one unit at a time only where two
    meet."""
    from vvdec_tpu_torch.ops.intra_device import D
    S, K = batches.shape[:2]
    if levels is None or S == 0 or moved_windows(batches, hh, ww):
        starts = np.arange(S)
    else:
        starts = np.flatnonzero(np.r_[True, levels[1:] != levels[:-1]])
    bounds = np.append(starts * K, S * K).astype(np.int64)
    rows = batches.reshape(-1, D)
    valid = np.flatnonzero(rows[:, 28] == 1)
    comp, y0, x0, h, w = unit_blocks(rows[valid], hh, ww)
    ph = np.searchsorted(bounds, valid, side="right") - 1
    # every pair (i, j), i before j, of valid units of one phase and
    # component
    by = np.argsort(ph * 3 + comp, kind="stable")
    seg = (ph * 3 + comp)[by]
    cnt = np.searchsorted(seg, seg, side="right") - np.arange(seg.size) - 1
    a = np.repeat(np.arange(seg.size), cnt)
    i, j = by[a], by[a + 1 + np.arange(a.size)
                      - np.repeat(np.cumsum(cnt) - cnt, cnt)]
    meet = (np.minimum(y0[i] + h[i], y0[j] + h[j]) > np.maximum(y0[i], y0[j])) \
        & (np.minimum(x0[i] + w[i], x0[j] + w[j]) > np.maximum(x0[i], x0[j]))
    if not meet.any():
        return bounds
    earlier: dict = {}
    for a, b in zip(i[meet].tolist(), j[meet].tolist()):
        earlier.setdefault(b, []).append(a)
    cuts, first = [], 0
    for b in sorted(earlier):
        if ph[first] != ph[b]:
            first = int(np.searchsorted(ph, ph[b]))
        if max(earlier[b]) >= first:
            cuts.append(valid[b])
            first = b
    return np.union1d(bounds, np.asarray(cuts, np.int64))


def wavefront_plan(batches, phases, cluster: int, masked: bool = False,
                   slice_samples: int = SLICE_SAMPLES) -> np.ndarray:
    """The kernel's input for a cluster of `cluster` blocks, int32.  Each
    valid unit is cut into slices of whole rows of at most
    `slice_samples` samples (its rows ys to ye in the pad field of its
    copy, d[32] = ys | ye << 8).  Each phase's slices, heaviest first, are
    dealt over the blocks in snake order (round r to blocks 0..C-1, the
    next back), rotated by the phase's index, so that the blocks' sample
    counts differ by at most one slice; each block's share goes in chunk
    records of up to CHUNK_UNITS rows, in phase order.  A record is its
    phase, its row count n, 2 pad ints and n rows of PLAN_ROW ints; a
    block's records follow one another.  The head (PLAN_HEAD ints) holds
    where each block's records begin and, at index cluster, where they
    end (offsets past the head); the plan ends in the room of one more
    record, which the kernel's fixed-size copy of the last may read.
    With `masked` the rows keep their places but are marked invalid
    (d[28] = 0): the same phases, barriers and descriptor loads, and no
    unit (the empty-phase floor)."""
    from vvdec_tpu_torch.ops.intra_device import B, D
    rows = batches.reshape(-1, D)
    n_ph = max(len(phases) - 1, 1)
    valid = np.flatnonzero(rows[:, 28] == 1)
    h = np.clip(rows[valid, 4], 0, B)
    w = np.clip(rows[valid, 3], 0, B)
    per = np.maximum(slice_samples // np.maximum(w, 1), 1)
    n_sl = np.maximum(-(-h // per), 1)
    unit = np.repeat(np.arange(valid.size), n_sl)
    ys = (np.arange(unit.size) - np.repeat(np.cumsum(n_sl) - n_sl, n_sl)) \
        * per[unit]
    ye = np.minimum(ys + per[unit], h[unit])
    ph = np.searchsorted(phases, valid[unit], side="right") - 1
    order = np.lexsort((-(ye - ys) * w[unit], ph))
    unit, ys, ye, ph = unit[order], ys[order], ye[order], ph[order]
    rnd, j = np.divmod(np.arange(unit.size)
                       - np.searchsorted(ph, ph, side="left"), cluster)
    blk = (np.where(rnd % 2 == 0, j, cluster - 1 - j) + ph) % cluster
    chunk, pos = np.divmod(rnd, CHUNK_UNITS)
    n_ch = int(chunk.max()) + 1 if unit.size else 1
    # the records in (block, phase, chunk) order, each slice's record
    key = (blk * n_ph + ph) * n_ch + chunk
    by = np.argsort(key, kind="stable")
    new = np.r_[True, key[by][1:] != key[by][:-1]]
    rec = np.empty(key.size, np.int64)
    rec[by] = np.cumsum(new) - 1
    key = key[by][new]
    count = np.bincount(rec, minlength=key.size)
    size = 4 + PLAN_ROW * count
    start = PLAN_HEAD + np.cumsum(size) - size
    out = np.zeros(PLAN_HEAD + int(size.sum()) + 4
                   + PLAN_ROW * CHUNK_UNITS, np.int32)
    out[start] = key // n_ch % n_ph
    out[start + 1] = count
    body = np.zeros((unit.size, PLAN_ROW), np.int32)
    body[:, :D] = rows[valid[unit]]
    body[:, 32] = ys | ye << 8
    if masked:
        body[:, 28] = 0
    # each row at a multiple of 4 ints: written as PLAN_ROW / 4 quads
    quad = (start[rec] + 4 + PLAN_ROW * pos) // 4
    out.reshape(-1, 4)[quad[:, None] + np.arange(PLAN_ROW // 4)] = \
        body.reshape(unit.size, -1, 4)
    first = np.searchsorted(key // (n_ch * n_ph), np.arange(cluster + 1))
    out[:cluster + 1] = np.append(start, PLAN_HEAD + size.sum())[first] \
        - PLAN_HEAD
    return out


def launch_plan(buf, resi, plan, n_phases: int, consts, lm, *, bd: int,
                cfmt: int, collocated: bool, ctu_log2: int, has_lmcs: bool,
                cluster: int, staged: bool = False) -> int:
    """One launch of csrc/intra_wavefront.cu over a wavefront_plan of
    n_phases phases, on the current stream, uncounted (the wrapper counts
    its own; `cluster` one of CLUSTER_SIZES); returns the launch's
    cudaError_t (0 on success).  `staged`
    (one block, phases of at most CHUNK_UNITS units): each phase's samples
    go to shared memory first and are written after all its reads."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"launch_plan: a cluster of {cluster} blocks; the "
                         f"kernel takes {CLUSTER_SIZES}")
    dev = buf.device
    with profiler.stage("wait: upload intra plan"):
        pt = torch.as_tensor(plan, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return lib.intra_wavefront_launch(
            buf.data_ptr(), resi.data_ptr(), pt.data_ptr(), n_phases,
            cluster, buf.shape[1], buf.shape[2], consts.data_ptr(),
            lm.data_ptr() if has_lmcs else None, bd, cfmt, int(collocated),
            ctu_log2, int(has_lmcs), int(staged), stream)


def intra_wavefront_cuda(buf, resi, batches, consts, lm, *, bd: int,
                         cfmt: int, collocated: bool, ctu_log2: int, K: int,
                         has_lmcs: bool, levels=None) -> torch.Tensor:
    """Every wavefront step of one picture, in place on buf.

    buf: the stacked padded planes [3, hh, ww] int32 (hh, ww >= RL);
    resi: the residual planes, the same shape; batches: the host's
    [S, K, D] numpy step batches (build_wavefront_batches), any K;
    levels: each step's dependency level (intra_device.
    wavefront_step_levels), or None for one phase a step; consts:
    intra_consts(buf.device); lm: the LMCS table (build_lmcs_params) as
    an int32 tensor, read only with has_lmcs.  Returns buf.

    On CUDA tensors this launches csrc/intra_wavefront.cu once, as one
    cluster of CLUSTER blocks, on the current stream (counted in
    `intra_wavefront_cuda.launches`; no launch for S = 0) or raises
    KernelError; on CPU tensors it runs `intra_wavefront_ref`.  Where a
    window is moved (`moved_windows`, never on the decoder's planes) the
    phases are the steps, and one block runs them staged: every read of
    a step before its writes, as the reference's step does."""
    from vvdec_tpu_torch.ops.intra_device import B
    fn = "intra_wavefront_cuda"
    batches, levels = _validate(fn, buf, resi, batches, consts, lm, K, bd,
                                has_lmcs, levels)
    dev = buf.device
    if dev.type == "cpu":
        return intra_wavefront_ref(
            buf, resi, batches, consts, lm, bd=bd, cfmt=cfmt,
            collocated=collocated, ctu_log2=ctu_log2, K=K, has_lmcs=has_lmcs,
            levels=levels)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if batches.shape[0] == 0:
        return buf
    staged = moved_windows(batches, buf.shape[1], buf.shape[2])
    cluster = CLUSTER
    if staged:
        if K > CHUNK_UNITS:
            raise ValueError(f"{fn}: a unit's window is moved by the planes' "
                             f"edge, which the kernel takes only in steps "
                             f"of at most {CHUNK_UNITS} units, not {K}")
        cluster = 1
    phases = wavefront_phases(batches, levels, buf.shape[1], buf.shape[2])
    # staged: a step's units whole, in one chunk
    plan = wavefront_plan(batches, phases, cluster,
                          slice_samples=B * B if staged else SLICE_SAMPLES)
    err = launch_plan(buf, resi, plan, len(phases) - 1, consts, lm, bd=bd,
                      cfmt=cfmt,
                      collocated=collocated, ctu_log2=ctu_log2,
                      has_lmcs=has_lmcs, cluster=cluster, staged=staged)
    if err != 0:
        from vvdec_tpu_torch.ops.cuda._build import KernelError
        raise KernelError(f"{fn}: kernel launch failed (cudaError {err}) "
                          f"for {len(phases) - 1} phases on a cluster of "
                          f"{cluster} blocks")
    intra_wavefront_cuda.launches += 1
    return buf


intra_wavefront_cuda.launches = 0


def _library():
    from vvdec_tpu_torch.ops.cuda._build import load_kernel

    lib = load_kernel("intra_wavefront")
    fn = lib.intra_wavefront_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _predict(P, Rf, hb, db, mc, lm, bd, cfmt, collocated, ctu_log2,
             has_lmcs):
    """The writes of n valid units of mode class mc: gather, predict, add
    the residual, every read against P as it stands.  hb is the units'
    host copy of their descriptor rows, db the device one.  Returns (flat
    indices [n, B, B] into P, one past its end where a window position
    lies outside the unit's h x w corner; samples [n, B, B])."""
    from vvdec_tpu_torch.ops import intra_device as I
    pel_max = (1 << bd) - 1
    top, left = I._gather_refs(P, db, bd)
    if mc == 0:
        blk = I._pred_planar(top, left, db)
    elif mc == 1:
        blk = I._pred_dc(top, left, db)
    elif mc == 2:
        kinds = set(np.clip(hb[:, 26], 0, 3).tolist())
        cf, gf = I._angular_filters(P.device)
        blk = I._pred_angular(top, left, db, pel_max, cf, gf, kinds)
    elif mc == 3:
        sids = sorted(set(np.clip(hb[:, 26], 0, 2).tolist()))
        blk = I._pred_mip(top, left, db, bd, sids)
    elif mc == 4:
        blk = I._pred_cclm(top, left, db, P[0], bd, cfmt, collocated,
                           ctu_log2)
    else:
        blk = I._pred_planar(top, left, db)
    if mc in (0, 1, 5):
        blk = torch.where(I._col(db, 27) == 1,
                          I._pdpc_dc_planar(blk, top, left, db), blk)
    idx = I._block_index(db, P.shape[1], P.shape[2])
    if mc == 5:
        # CIIP (predBlendIntraCiip, IntraPrediction.cpp:884): planar
        # blended with the raw inter prediction in the plane
        cur = P.reshape(-1)[idx]
        blk = (I._col(db, 25) * cur + I._col(db, 24) * blk + 2) >> 2
    r = Rf[idx]
    if has_lmcs and (hb[:, 29] & 1).any():
        scale = I._chroma_scale_dev(P[0], db, lm, bd,
                                    min(64, 1 << ctu_log2))
        r = torch.where((I._col(db, 29) & 1) == 1,
                        I._scale_signal_dev(r, scale[:, None, None], bd), r)
    cbf = I._col(db, 9) == 1
    out = torch.clamp(blk + torch.where(cbf, r, torch.zeros_like(r)), 0,
                      pel_max)
    ys, xs = I._grid(P.device)
    m = (ys < I._col(db, 4)) & (xs < I._col(db, 3))
    return torch.where(m, idx, P.numel()), out


def intra_wavefront_ref(buf, resi, batches, consts, lm, *, bd: int,
                        cfmt: int, collocated: bool, ctu_log2: int, K: int,
                        has_lmcs: bool, levels=None) -> torch.Tensor:
    """Plain PyTorch version of intra_wavefront_cuda, on any device: the
    phases of wavefront_phases in order; in each, every valid unit's
    output computed against the planes as the phase began (one loop
    iteration a mode class, read from the host batches, so no
    device->host sync), then the phase's masked writes.  Each unit goes
    by its own mode class d[7]; padding rows (d[28] != 1) are skipped.
    The tables are those of intra_consts(device), which `consts` must be.
    Updates buf in place and returns it."""
    from vvdec_tpu_torch.ops.intra_device import D
    batches, levels = _validate("intra_wavefront_ref", buf, resi, batches,
                                consts, lm, K, bd, has_lmcs, levels)
    phases = wavefront_phases(batches, levels, buf.shape[1], buf.shape[2])
    dev = buf.device
    # one trailing scratch element takes the writes of window positions
    # outside a unit's corner
    flat = torch.cat([buf.reshape(-1),
                      torch.zeros(1, dtype=torch.int32, device=dev)])
    P = flat[:-1].view(buf.shape)
    Rf = resi.reshape(-1)
    rows = batches.reshape(-1, D)
    valid = np.flatnonzero(rows[:, 28] == 1)
    ph = np.searchsorted(phases, valid, side="right") - 1
    mc = rows[valid, 7]
    # the valid units by phase, then class, then row: one slice a group
    order = np.lexsort((valid, mc, ph))
    ph, mc, units = ph[order], mc[order], rows[valid[order]]
    dt = torch.as_tensor(units, device=dev)
    ends = np.append(np.flatnonzero((np.diff(ph) != 0)
                                    | (np.diff(mc) != 0)) + 1, ph.size)
    writes, a = [], 0
    for e in ends.tolist() if ph.size else ():
        writes.append(_predict(P, Rf, units[a:e], dt[a:e], int(mc[a]), lm,
                               bd, cfmt, collocated, ctu_log2, has_lmcs))
        if e == ph.size or ph[e] != ph[a]:
            for idx, out in writes:
                flat.index_put_((idx,), out)
            writes = []
        a = e
    buf.copy_(P)
    return buf
