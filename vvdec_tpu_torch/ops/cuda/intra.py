"""The intra wavefront of one picture: the Hopper kernel
(csrc/intra_wavefront.cu), its ctypes wrapper and its plain PyTorch
version.

Counterpart of vvdec_tpu/ops/intra_device.py::_intra_wavefront_fn, one
jax.jit program a picture (a lax.scan over the host's [S, K, D] step
batches, a lax.switch on each step's mode class, a fori_loop over the K
masked block writes).

- `intra_wavefront_cuda` runs every step of a picture in one launch on
  CUDA tensors (counted in `intra_wavefront_cuda.launches`), and the
  plain version on CPU tensors.
- `intra_wavefront_ref` is the plain version: one Python loop iteration
  a step (gather, predict, residual add, one masked index_put_), on any
  device.
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

# the constant pool (csrc/intra_wavefront.cu k* offsets): name, shape
CONST_TABLES = (("cubic", (32, 4)), ("gauss", (32, 4)),
                ("mip4", (16, 16, 4)), ("mip8", (8, 16, 8)),
                ("mip16", (6, 64, 7)), ("cclm_div", (16,)))
CONST_LEN = sum(int(np.prod(s)) for _, s in CONST_TABLES)
MAX_K = 8   # units a step the kernel takes (its shared-memory tiles)
N_CLASSES = 6   # planar, DC, angular, MIP, CCLM, CIIP


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


def _validate(fn, buf, resi, batches, consts, lm, K, bd, has_lmcs):
    """The host checks of both versions: tensors, shapes, devices, and
    every step's mode class on the host batches.  Returns the batches as
    an [S, K, D] int32 numpy array."""
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
    mc = batches[:, 0, 7] if batches.shape[0] else np.zeros(0, np.int64)
    bad = (mc < 0) | (mc >= N_CLASSES)
    if bad.any():
        raise NotImplementedError(
            f"intra wavefront: mode class {int(mc[bad][0])} is not ported")
    return np.ascontiguousarray(batches, dtype=np.int32)


def intra_wavefront_cuda(buf, resi, batches, consts, lm, *, bd: int,
                         cfmt: int, collocated: bool, ctu_log2: int, K: int,
                         has_lmcs: bool) -> torch.Tensor:
    """Every wavefront step of one picture, in order, in place on buf.

    buf: the stacked padded planes [3, hh, ww] int32 (hh, ww >= RL);
    resi: the residual planes, the same shape; batches: the host's
    [S, K, D] numpy step batches (build_wavefront_batches), homogeneous
    in mode class; consts: intra_consts(buf.device); lm: the LMCS table
    (build_lmcs_params) as an int32 tensor, read only with has_lmcs.
    Returns buf.

    On CUDA tensors this launches csrc/intra_wavefront.cu once on the
    current stream (counted in `intra_wavefront_cuda.launches`; no
    launch for S = 0) or raises; on CPU tensors it runs
    `intra_wavefront_ref`."""
    fn = "intra_wavefront_cuda"
    batches = _validate(fn, buf, resi, batches, consts, lm, K, bd, has_lmcs)
    dev = buf.device
    if dev.type == "cpu":
        return intra_wavefront_ref(
            buf, resi, batches, consts, lm, bd=bd, cfmt=cfmt,
            collocated=collocated, ctu_log2=ctu_log2, K=K, has_lmcs=has_lmcs)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{fn}: the kernel takes 1 to {MAX_K} units a "
                         f"step, not {K}")
    if batches.shape[0] == 0:
        return buf
    bt = torch.as_tensor(batches, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.intra_wavefront_launch(
            buf.data_ptr(), resi.data_ptr(), bt.data_ptr(),
            batches.shape[0], K, buf.shape[1], buf.shape[2],
            consts.data_ptr(), lm.data_ptr() if has_lmcs else None, bd, cfmt,
            int(collocated), ctu_log2, int(has_lmcs), stream)
    if err != 0:
        from vvdec_tpu_torch.ops.cuda._build import KernelError
        raise KernelError(f"{fn}: kernel launch failed (cudaError {err}) "
                          f"for {batches.shape[0]} steps")
    intra_wavefront_cuda.launches += 1
    return buf


intra_wavefront_cuda.launches = 0


def _library():
    from vvdec_tpu_torch.ops.cuda._build import load_kernel

    lib = load_kernel("intra_wavefront")
    fn = lib.intra_wavefront_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _step(flat, P, Rf, hb, db, mc, lm, bd, cfmt, collocated, ctu_log2,
          has_lmcs):
    """One wavefront step: gather, predict, add the residual, write.
    hb is the step's host copy of the K descriptor rows, db the device
    one; P the stacked planes viewed from flat, whose last element takes
    the masked-out writes."""
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
        valid = hb[hb[:, 28] == 1]
        sids = sorted(set(np.clip(valid[:, 26], 0, 2).tolist()))
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
    m = (ys < I._col(db, 4)) & (xs < I._col(db, 3)) & (I._col(db, 28) == 1)
    flat.index_put_((torch.where(m, idx, flat.numel() - 1),), out)


def intra_wavefront_ref(buf, resi, batches, consts, lm, *, bd: int,
                        cfmt: int, collocated: bool, ctu_log2: int, K: int,
                        has_lmcs: bool) -> torch.Tensor:
    """Plain PyTorch version of intra_wavefront_cuda, on any device: one
    loop iteration a step, each reading everything before its one masked
    write, with the step's mode class read from the host batches (no
    device->host sync a step), and the tables of intra_consts(device),
    which `consts` must be.  Units inside one step never read each
    other's output, so the result is bit-identical to a sequential scan.
    Updates buf in place and returns it."""
    batches = _validate("intra_wavefront_ref", buf, resi, batches, consts,
                        lm, K, bd, has_lmcs)
    dev = buf.device
    # one trailing scratch element takes the writes of masked-out window
    # positions, so the K block writes never collide
    flat = torch.cat([buf.reshape(-1),
                      torch.zeros(1, dtype=torch.int32, device=dev)])
    P = flat[:-1].view(buf.shape)
    Rf = resi.reshape(-1)
    bt = torch.as_tensor(batches, device=dev)
    for s in range(batches.shape[0]):
        _step(flat, P, Rf, batches[s], bt[s], int(batches[s, 0, 7]), lm, bd,
              cfmt, collocated, ctu_log2, has_lmcs)
    buf.copy_(P)
    return buf
