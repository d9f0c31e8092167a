"""The dense deblock of the device filter chain: the Hopper kernel
(csrc/deblock.cu), its ctypes wrapper and its plain PyTorch version.

Counterpart of the deblock of vvdec_tpu/ops/device_pipeline.py::_chain_fn
(inside its jax.jit): every vertical edge of Y, Cb and Cr, then every
horizontal edge, each plane through the dense cores of
vvdec_tpu/ops/deblock_dense.py, the horizontal direction on transposed
planes and grids.

- `deblock_dense_cuda` runs one kernel launch per direction on CUDA
  tensors, all components at once (counted in
  `deblock_dense_cuda.launches`: 2 a call), and the plain version on CPU
  tensors.  It takes a leading frame axis (the batched chain's stacked
  pictures) as the kernel's grid dimension: still 2 launches.
- `deblock_dense_ref` is the plain version: the cores of
  ops/deblock_dense.py composed exactly as the chain composed them before
  the kernel, one picture at a time, on any device.
- `deblock_consts(device)` is the int32 pool of the tables the kernel
  reads (ops/pipeline._DB_TC, _DB_BETA, _DB_DB, _DB_TCC), so that the
  source holds no second copy of them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.pipeline import _DB_BETA, _DB_DB, _DB_TC, _DB_TCC

# the constant pool (csrc/deblock.cu k* offsets): name, shape
CONST_TABLES = (("tc", (66,)), ("beta", (64,)), ("db", (3, 7)),
                ("tcc", (3, 7)))
CONST_LEN = sum(int(np.prod(s)) for _, s in CONST_TABLES)


@functools.lru_cache(maxsize=None)
def _const_pool() -> np.ndarray:
    tables = dict(tc=_DB_TC, beta=_DB_BETA, db=_DB_DB, tcc=_DB_TCC)
    return np.concatenate([np.asarray(tables[name], dtype=np.int32)
                           .reshape(-1) for name, _ in CONST_TABLES])


@functools.lru_cache(maxsize=None)
def deblock_consts(device) -> torch.Tensor:
    """The int32 pool of CONST_TABLES on `device`, uploaded once."""
    return torch.as_tensor(_const_pool(), device=device)


def _validate(fn, planes, grids, si, sltab, *, bd, ctu, sub_w, sub_h, n_sl):
    """The host checks of both versions.  Returns (batched, h, w)."""
    from torch._C._functorch import is_batchedtensor
    planes, grids = list(planes), list(grids)
    tensors = planes + grids + [sltab] + ([] if si is None else [si])
    if any(not isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError(f"{fn}: planes, grids, si and sltab must be tensors")
    if any(is_batchedtensor(t) for t in tensors):
        raise RuntimeError(f"{fn}: called under torch.func.vmap; the batched "
                           f"chain deblocks its stacked planes before the "
                           f"vmapped stages")
    num_comp = len(planes)
    if num_comp not in (1, 3) or len(grids) != num_comp:
        raise ValueError(f"{fn}: 1 or 3 planes and one grid a plane, not "
                         f"{num_comp} and {len(grids)}")
    batched = planes[0].dim() == 3
    lead = tuple(planes[0].shape[:1]) if batched else ()
    dev = planes[0].device
    if planes[0].dim() not in (2, 3):
        raise ValueError(f"{fn}: planes must be [H, W] or [F, H, W]")
    h, w = planes[0].shape[-2:]
    if h % 4 or w % 4 or h < 4 or w < 4:
        raise ValueError(f"{fn}: the luma plane's sides must be multiples of"
                         f" 4, not {h}x{w}")
    if not 8 <= bd <= 16 or ctu < 8 or sub_w not in (1, 2) \
            or sub_h not in (1, 2) or n_sl < 1:
        raise ValueError(f"{fn}: unsupported bd {bd}, ctu {ctu}, sub "
                         f"{sub_w}x{sub_h} or n_sl {n_sl}")
    shapes = [(h, w)] + [(h // sub_h, w // sub_w)] * (num_comp - 1)
    for c, (p, (ph, pw)) in enumerate(zip(planes, shapes)):
        if p.dtype != torch.int32 or p.device != dev \
                or tuple(p.shape) != lead + (ph, pw):
            raise ValueError(f"{fn}: plane {c} must be int32 "
                             f"{lead + (ph, pw)} on {dev}, not {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    if num_comp > 1:
        # the chroma segments: 4 / sub lines along each direction
        hc, wc = shapes[1]
        if hc % (4 // sub_h) or wc % (4 // sub_w):
            raise ValueError(f"{fn}: chroma {hc}x{wc} is not a whole number "
                             f"of deblocking segments")
    # the grids and slice tables as the host packs and uploads them
    cells = (h // 4, w // 4)
    for c, g in enumerate(grids):
        if g.dtype != torch.int16 or g.device != dev \
                or tuple(g.shape) != lead + (2,) + cells:
            raise ValueError(f"{fn}: grid {c} must be int16 "
                             f"{lead + (2,) + cells} on {dev}")
    if tuple(sltab.shape) != lead + (n_sl, 6) or sltab.device != dev \
            or sltab.dtype != torch.int16:
        raise ValueError(f"{fn}: sltab must be int16 {lead + (n_sl, 6)} on "
                         f"{dev}")
    if n_sl > 1 and si is None:
        raise ValueError(f"{fn}: {n_sl} slices need the slice-index grid")
    if si is not None and (tuple(si.shape) != lead + cells
                           or si.device != dev or si.dtype != torch.int16):
        raise ValueError(f"{fn}: si must be int16 {lead + cells} on {dev}")
    return batched, h, w


def deblock_dense_ref(planes, grids, si, sltab, *, bd: int, ctu: int,
                      sub_w: int, sub_h: int, n_sl: int) -> tuple:
    """Plain PyTorch version of deblock_dense_cuda, on any device: per
    picture the vertical edges of each plane, then the horizontal ones on
    the transposed planes and grids, through the dense cores."""
    from vvdec_tpu_torch.ops.deblock_dense import (deblock_chroma_dense_core,
                                                   deblock_luma_dense_core)
    batched, h, w = _validate("deblock_dense_ref", planes, grids, si, sltab,
                              bd=bd, ctu=ctu, sub_w=sub_w, sub_h=sub_h,
                              n_sl=n_sl)
    if batched:
        per = [deblock_dense_ref(
            [p[i] for p in planes], [g[i] for g in grids],
            None if si is None else si[i], sltab[i], bd=bd, ctu=ctu,
            sub_w=sub_w, sub_h=sub_h, n_sl=n_sl)
            for i in range(planes[0].shape[0])]
        return tuple(torch.stack(ps) for ps in zip(*per))
    planes, num_comp = list(planes), len(planes)
    dev = str(planes[0].device)
    # the cores compute on int32 grids and tables
    grids = [g.to(torch.int32) for g in grids]
    sltab = sltab.to(torch.int32)
    si = torch.zeros((h // 4, w // 4), dtype=torch.int32, device=dev) \
        if si is None else si.to(torch.int32)
    db_y = [deblock_luma_dense_core(h, w, bd, ctu, False, n_sl, dev),
            deblock_luma_dense_core(w, h, bd, ctu, True, n_sl, dev)]
    db_c = []
    if num_comp > 1:
        hc, wc = planes[1].shape
        for d in range(2):
            L = 4 // (sub_h if d == 0 else sub_w)
            fy = 4 // (sub_h if d == 0 else sub_w)
            fx = 4 // (sub_w if d == 0 else sub_h)
            dims = (hc, wc) if d == 0 else (wc, hc)
            db_c.append([deblock_chroma_dense_core(
                dims[0], dims[1], bd, ctu // sub_h, L, d == 1, fy, fx, n_sl,
                comp, dev) for comp in (1, 2)])
    planes[0] = db_y[0](planes[0], grids[0][0], si, sltab)
    for k in range(1, num_comp):
        planes[k] = db_c[0][k - 1](planes[k], grids[k][0], si, sltab)
    planes[0] = db_y[1](planes[0].T, grids[0][1].T, si.T, sltab).T
    for k in range(1, num_comp):
        planes[k] = db_c[1][k - 1](planes[k].T, grids[k][1].T, si.T,
                                   sltab).T
    return tuple(p.contiguous() for p in planes)


def deblock_dense_cuda(planes, grids, si, sltab, *, bd: int, ctu: int,
                       sub_w: int, sub_h: int, n_sl: int) -> tuple:
    """The deblock of one picture, or of a stack of pictures.

    planes: the component planes, int32 [H, W] (chroma [H / sub_h,
    W / sub_w]; one plane for 4:0:0, three else), or [F, H, W] with a
    leading frame axis; grids: each component's packed int16 cell grid
    [2, H / 4, W / 4] (vertical, horizontal direction; chroma grids on
    luma cells; ops/deblock_dense.pack_luma_grid / pack_chroma_grid),
    [F, 2, ...] with the frame axis; si: the int16 slice-index grid
    [H / 4, W / 4] (None for one slice); sltab: the int16 [n_sl, 6]
    per-slice tc / beta offsets; ctu: the luma CTU size.  The grids, si
    and sltab are int16 as the host packs and uploads them
    (device_pipeline._flat_pack), and the kernel reads them so.  Returns the filtered planes, new
    tensors of the planes' shapes.

    On CUDA tensors this launches csrc/deblock.cu twice on the current
    stream, the vertical edges of every component, then the horizontal
    ones (counted in `deblock_dense_cuda.launches`), or raises
    KernelError; on CPU tensors it runs `deblock_dense_ref`.  Under
    torch.func.vmap it raises on any device: the batched chain passes its
    stacked planes instead."""
    fn = "deblock_dense_cuda"
    kw = dict(bd=bd, ctu=ctu, sub_w=sub_w, sub_h=sub_h, n_sl=n_sl)
    batched, h, w = _validate(fn, planes, grids, si, sltab, **kw)
    dev = planes[0].device
    if dev.type == "cpu":
        return deblock_dense_ref(planes, grids, si, sltab, **kw)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    lib = _library()
    num_comp = len(planes)

    def prep(t):
        return (t if batched else t.unsqueeze(0)).contiguous()

    src = [prep(p) for p in planes]
    gr = [prep(g) for g in grids]
    si_t = None if si is None or n_sl == 1 else prep(si)
    sl = prep(sltab)
    consts = deblock_consts(dev)
    n_frames = src[0].shape[0]
    for d in range(2):
        dst = [torch.empty_like(p) for p in src]
        desc = (ctypes.c_longlong * 15)()
        for c in range(num_comp):
            desc[5 * c: 5 * c + 5] = [src[c].data_ptr(), dst[c].data_ptr(),
                                      src[c].shape[1], src[c].shape[2],
                                      gr[c].data_ptr()]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.deblock_launch(
                desc, num_comp, n_frames,
                None if si_t is None else si_t.data_ptr(), sl.data_ptr(),
                consts.data_ptr(), h // 4, w // 4, n_sl, bd, ctu, sub_w,
                sub_h, d, stream)
        if err != 0:
            from vvdec_tpu_torch.ops.cuda._build import KernelError
            raise KernelError(f"{fn}: kernel launch failed (cudaError {err})"
                              f" for direction {d} of {n_frames} pictures "
                              f"of {h}x{w}")
        deblock_dense_cuda.launches += 1
        src = dst
    return tuple(p if batched else p[0] for p in src)


deblock_dense_cuda.launches = 0


def _library():
    from vvdec_tpu_torch.ops.cuda._build import load_kernel

    lib = load_kernel("deblock")
    fn = lib.deblock_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), i, i, p, p, p, i, i,
                       i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def random_inputs(seed: int, h: int, w: int, *, cfmt: int = 1, bd: int = 10,
                  n_sl: int = 1, frames: int = 0) -> tuple:
    """Random deblocking inputs for the checks: (planes, grids, si, sltab,
    kw) as numpy arrays (int32 planes; int16 grids, si and sltab, as the
    host packs them), planes of flat 4x4 blocks plus small noise (every
    block edge a candidate for the strong, weak and long filters), grids
    of every bS, QP 0..127, filter lengths {1, 2, 3, 5, 7} on neighbouring
    cells (so that write windows overlap) and the large-chroma flag,
    slice offsets of -12..12 (table indices past both ends).  cfmt is
    the chroma format (0 for 4:0:0 .. 3 for 4:4:4); frames > 0 adds a
    leading frame axis."""
    rng = np.random.default_rng(seed)
    sub_w, sub_h = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}[cfmt]
    lead = (frames,) if frames else ()
    h4, w4 = h // 4, w // 4

    def blocky(ph, pw):
        base = rng.integers(0, 1 << bd, size=lead + (-(-ph // 4),
                                                     -(-pw // 4)))
        step = np.repeat(np.repeat(base, 4, -2), 4, -1)[..., :ph, :pw]
        return np.clip(step + rng.integers(-3, 4, size=lead + (ph, pw)), 0,
                       (1 << bd) - 1).astype(np.int32)

    def grid(luma):
        bs = rng.integers(0, 4, size=lead + (2, h4, w4))
        qp = rng.integers(0, 128, size=bs.shape)
        if luma:
            mfl = rng.choice([1, 2, 3, 5, 7], size=(2,) + bs.shape)
            g = bs | qp << 2 | mfl[0] << 9 | mfl[1] << 12
        else:
            g = bs | qp << 2 | (rng.random(bs.shape) < 0.5) << 9
        return g.astype(np.int16)

    num_comp = 1 if cfmt == 0 else 3
    planes = [blocky(h, w)] + [blocky(h // sub_h, w // sub_w)
                               for _ in range(num_comp - 1)]
    grids = [grid(True)] + [grid(False) for _ in range(num_comp - 1)]
    si = rng.integers(0, n_sl, size=lead + (h4, w4)).astype(np.int16) \
        if n_sl > 1 else None
    sltab = rng.integers(-12, 13, size=lead + (n_sl, 6)).astype(np.int16)
    return planes, grids, si, sltab, dict(sub_w=sub_w, sub_h=sub_h, bd=bd,
                                          n_sl=n_sl)
