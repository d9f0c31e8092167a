"""SAO, ALF and CC-ALF of the device filter chain: the Hopper kernels
(csrc/sao_alf.cu), their ctypes wrapper and their plain PyTorch version.

Counterpart of the SAO and ALF closures of
vvdec_tpu/ops/device_pipeline.py::_chain_fn (:503-634, inside its
jax.jit): SAO of each component, the luma ALF's 4x4 classification and
bank gathers, the 7x7 luma and 5x5 chroma clipped diamonds, CC-ALF.

- `sao_alf_cuda(planes, flat, key)` runs SAO in one launch (every
  component) and ALF / CC-ALF in a second (every component), each only
  where the chain's static key turns it on (counted in
  `sao_alf_cuda.launches`: at most 2 a call), on CUDA tensors, reading
  the parameters from the int16 vector `flat` as the host packed and
  uploaded it (device_pipeline._flat_layout); on CPU tensors it runs
  `sao_alf_ref`.  It takes a leading frame axis (the batched chain's
  stacked pictures) as the kernels' grid dimension: still at most 2
  launches.  Each call counts its pictures in the stage profiler's
  "filter: SAO/ALF kernel pictures" or "filter: SAO/ALF plain pictures".
- `sao_alf_ref` is the plain version: device_pipeline's _sao_plane,
  _classify_dense, _ccalf_dense_core and pipeline._alf_diamond_dense_core
  composed as the chain composed them before the kernels, one picture at
  a time, on any device.
- `random_inputs` makes fuzzed planes and parameter vectors for the
  checks.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vvdec_tpu_torch.utils.trace import profiler

# the fields the kernels read, in csrc/sao_alf.cu's Field order
FIELDS = ("sao_type", "sao_vals", "en_y", "set_ctu", "en_c", "alt_ctu",
          "cc_ctu", "banks_co", "banks_cl", "cbanks_co", "cbanks_cl",
          "cc_banks")


def _unkey(key) -> dict:
    names = ("h", "w", "hc", "wc", "bd", "ctu", "sub_w", "sub_h",
             "num_comp", "w_ctu", "db_on", "n_sl", "sao_on", "alf_luma",
             "alf_chroma", "cc_on", "n_banks", "n_cb", "n_cc", "pack_pad")
    if len(key) != len(names):
        raise ValueError(f"the chain key has {len(names)} fields, not "
                         f"{len(key)}")
    return dict(zip(names, key))


def layout(key) -> tuple[dict, int]:
    """({field: offset}, length) of one picture's packed int16 vector
    (device_pipeline._flat_layout; the length is 1 where it holds no
    field, as _flat_pack makes it)."""
    from vvdec_tpu_torch.ops.device_pipeline import _flat_layout
    off, pos = {}, 0
    for name, shape in _flat_layout(key):
        off[name] = pos
        pos += int(np.prod(shape))
    return off, max(pos, 1)


def _validate(fn, planes, flat, key):
    """The host checks of both versions.  Returns (batched, the key as a
    dict, {field: offset})."""
    from torch._C._functorch import is_batchedtensor
    k = _unkey(key)
    planes = list(planes)
    if any(not isinstance(t, torch.Tensor) for t in planes + [flat]):
        raise TypeError(f"{fn}: planes and flat must be tensors")
    if any(is_batchedtensor(t) for t in planes + [flat]):
        raise RuntimeError(f"{fn}: called under torch.func.vmap; the "
                           f"batched chain passes its stacked planes")
    num_comp = k["num_comp"]
    if num_comp not in (1, 3) or len(planes) != num_comp:
        raise ValueError(f"{fn}: the key has {num_comp} components, the "
                         f"call {len(planes)} planes")
    h, w, ctu = k["h"], k["w"], k["ctu"]
    if h % 4 or w % 4 or h < 4 or w < 4:
        raise ValueError(f"{fn}: the luma plane's sides must be multiples of"
                         f" 4, not {h}x{w}")
    if not 8 <= k["bd"] <= 16 or ctu < 16 or ctu & (ctu - 1) \
            or k["sub_w"] not in (1, 2) or k["sub_h"] not in (1, 2):
        raise ValueError(f"{fn}: unsupported bd {k['bd']}, ctu {ctu} or sub "
                         f"{k['sub_w']}x{k['sub_h']}")
    if k["w_ctu"] != -(-w // ctu):
        raise ValueError(f"{fn}: w_ctu {k['w_ctu']} for width {w} and CTU "
                         f"{ctu}")
    batched = planes[0].dim() == 3
    lead = tuple(planes[0].shape[:1]) if batched else ()
    dev = planes[0].device
    shapes = [(h, w)]
    if num_comp > 1:
        if (k["hc"], k["wc"]) != (h // k["sub_h"], w // k["sub_w"]):
            raise ValueError(f"{fn}: chroma {k['hc']}x{k['wc']} for luma "
                             f"{h}x{w} at sub {k['sub_w']}x{k['sub_h']}")
        shapes += [(k["hc"], k["wc"])] * 2
    for c, (p, shape) in enumerate(zip(planes, shapes)):
        if p.dtype != torch.int32 or p.device != dev \
                or tuple(p.shape) != lead + shape:
            raise ValueError(f"{fn}: plane {c} must be int32 {lead + shape} "
                             f"on {dev}, not {p.dtype} {tuple(p.shape)} on "
                             f"{p.device}")
    off, n = layout(key)
    if flat.dtype != torch.int16 or flat.device != dev \
            or tuple(flat.shape[:-1]) != lead or flat.dim() != len(lead) + 1:
        raise ValueError(f"{fn}: flat must be int16 {lead + (n,)} on {dev}, "
                         f"not {flat.dtype} {tuple(flat.shape)} on "
                         f"{flat.device}")
    if not flat.is_contiguous():
        raise ValueError(f"{fn}: flat must be contiguous, as uploaded")
    if flat.shape[-1] != n:
        from vvdec_tpu_torch.ops.device_pipeline import _flat_layout
        lost = [name for name, shape in _flat_layout(key)
                if off[name] + int(np.prod(shape)) > flat.shape[-1]]
        raise ValueError(f"{fn}: flat holds {flat.shape[-1]} values a "
                         f"picture, the key's layout {n}"
                         + (f": field {lost[0]} is missing" if lost else ""))
    return batched, k, off


def sao_alf_ref(planes, flat, key) -> tuple:
    """Plain PyTorch version of sao_alf_cuda, on any device: per picture
    SAO of each component, then the luma ALF (classification, bank
    gathers, 7x7 diamond), the chroma ALF and CC-ALF, as the chain
    composed them.  Returns the planes, the unfiltered ones as they
    came."""
    batched, _, _ = _validate("sao_alf_ref", planes, flat, key)
    if batched:
        per = [sao_alf_ref([p[i] for p in planes], flat[i], key)
               for i in range(planes[0].shape[0])]
        return tuple(torch.stack(ps) for ps in zip(*per))
    from vvdec_tpu_torch.ops.device_pipeline import (
        _ccalf_dense_core, _classify_dense, _expand_ctu, _flat_unpack, _rep4,
        _sao_plane)
    from vvdec_tpu_torch.ops.intra_device import _jidx
    from vvdec_tpu_torch.ops.pipeline import _alf_diamond_dense_core
    (h, w, hc, wc, bd, ctu, sub_w, sub_h, num_comp, w_ctu, _, _, sao_on,
     alf_luma, alf_chroma, cc_on, n_banks, n_cb, n_cc, _) = key
    P = _flat_unpack(key, flat, FIELDS)
    planes = list(planes)
    dev = str(planes[0].device)
    if sao_on:
        for comp in range(num_comp):
            ph_, pw_ = (hc, wc) if comp else (h, w)
            planes[comp] = _sao_plane(
                planes[comp], P["sao_type"][comp], P["sao_vals"][comp],
                h=ph_, w=pw_, ctu_w=(ctu // sub_w) if comp else ctu,
                ctu_h=(ctu // sub_h) if comp else ctu, w_ctu=w_ctu, bd=bd)
    # ALF and CC-ALF read the post-SAO planes and write fresh ones
    out = list(planes)
    h4, w4 = h // 4, w // 4
    ctu4 = ctu >> 2
    if alf_luma:
        fn = _alf_diamond_dense_core(h, w, bd, 12, ctu, ctu - 4, False, dev)
        cls, tr = _classify_dense(planes[0], h, w, bd, ctu, ctu - 4)
        set4 = _expand_ctu(P["set_ctu"], ctu4, ctu4, h4, w4, w_ctu)
        sel = (_jidx(set4, n_banks), _jidx(tr, 4), _jidx(cls, 25))
        co = _rep4(P["banks_co"][sel][:, :, :12], h, w)
        cl = _rep4(P["banks_cl"][sel][:, :, :12], h, w)
        mask = _rep4(_expand_ctu(P["en_y"], ctu4, ctu4, h4, w4, w_ctu),
                     h, w) != 0
        out[0] = fn(planes[0], co, cl, mask)
    if num_comp > 1 and (alf_chroma or cc_on):
        hc4, wc4 = (hc + 3) >> 2, (wc + 3) >> 2
        lc4w = (ctu // sub_w) >> 2
        lc4h = (ctu // sub_h) >> 2
        vb_c = ctu // sub_h
        for i in range(2):
            comp = 1 + i
            if alf_chroma:
                fn = _alf_diamond_dense_core(hc, wc, bd, 6, vb_c, vb_c - 2,
                                             True, dev)
                en4 = _expand_ctu(P["en_c"][i], lc4h, lc4w, hc4, wc4, w_ctu)
                alt4 = _jidx(_expand_ctu(P["alt_ctu"][i], lc4h, lc4w, hc4,
                                         wc4, w_ctu), n_cb)
                co = _rep4(P["cbanks_co"][alt4][:, :, :6], hc, wc)
                cl = _rep4(P["cbanks_cl"][alt4][:, :, :6], hc, wc)
                out[comp] = fn(planes[comp], co, cl, _rep4(en4, hc, wc) != 0)
            if cc_on:
                fn = _ccalf_dense_core(h, w, hc, wc, bd, sub_w, sub_h, ctu,
                                       w_ctu, n_cc, dev)
                out[comp] = fn(planes[0], out[comp], P["cc_banks"],
                               P["cc_ctu"][i])
    return tuple(out)


def sao_alf_cuda(planes, flat, key) -> tuple:
    """SAO, ALF and CC-ALF of one picture, or of a stack of pictures.

    planes: the deblocked component planes, int32 [h, w] (chroma [hc,
    wc]; one plane for 4:0:0, three else), or [F, ...] with a leading
    frame axis; flat: the picture's packed int16 parameter vector as the
    host uploaded it (device_pipeline._flat_pack), [n] or [F, n]; key:
    the chain's static key (device_pipeline._frame_key_arrays), whose
    sao_on, alf_luma, alf_chroma and cc_on say which stages run.
    Returns the filtered planes, new tensors where a stage wrote them
    (the others as they came).

    On CUDA tensors this launches csrc/sao_alf.cu on the current stream,
    SAO if the key has it on, then ALF and CC-ALF if it has any of them on
    (counted in `sao_alf_cuda.launches`), or raises KernelError; on CPU
    tensors it runs `sao_alf_ref`.  Under torch.func.vmap it raises on
    any device: the batched chain passes its stacked planes instead."""
    fn = "sao_alf_cuda"
    batched, k, off = _validate(fn, planes, flat, key)
    if not (k["sao_on"] or k["alf_luma"] or k["alf_chroma"] or k["cc_on"]):
        return tuple(planes)
    dev = planes[0].device
    n_pics = planes[0].shape[0] if batched else 1
    if dev.type == "cpu":
        profiler.count("filter: SAO/ALF plain pictures", n_pics)
        return sao_alf_ref(planes, flat, key)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    lib = _library()
    num_comp = k["num_comp"]
    src = [(p if batched else p.unsqueeze(0)).contiguous() for p in planes]
    prm = flat if batched else flat.unsqueeze(0)
    offs = (ctypes.c_longlong * len(FIELDS))(*[off.get(name, -1)
                                               for name in FIELDS])
    h_ctu = -(-k["h"] // k["ctu"])
    stages = []
    if k["sao_on"]:
        stages.append((0, range(num_comp)))
    writes = ([0] if k["alf_luma"] else []) + (
        [1, 2] if num_comp > 1 and (k["alf_chroma"] or k["cc_on"]) else [])
    if writes:
        stages.append((1, writes))
    for stage, written in stages:
        dst = [torch.empty_like(p) if c in written else p
               for c, p in enumerate(src)]
        desc = (ctypes.c_longlong * 12)()
        for c in range(num_comp):
            desc[4 * c: 4 * c + 4] = [src[c].data_ptr(), dst[c].data_ptr(),
                                      src[c].shape[1], src[c].shape[2]]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.sao_alf_launch(
                desc, num_comp, n_pics, prm.data_ptr(), prm.shape[-1], offs,
                k["bd"], k["ctu"], k["sub_w"], k["sub_h"], k["w_ctu"],
                k["w_ctu"] * h_ctu, k["n_banks"], k["n_cb"], k["n_cc"],
                int(k["alf_luma"]), int(k["alf_chroma"]), int(k["cc_on"]),
                stage, stream)
        if err != 0:
            from vvdec_tpu_torch.ops.cuda._build import KernelError
            raise KernelError(f"{fn}: kernel launch failed (cudaError {err})"
                              f" for stage {('SAO', 'ALF')[stage]} of "
                              f"{n_pics} pictures of {k['h']}x{k['w']}")
        sao_alf_cuda.launches += 1
        src = dst
    profiler.count("filter: SAO/ALF kernel pictures", n_pics)
    return tuple(p if batched else p[0] for p in src)


sao_alf_cuda.launches = 0


def _library():
    from vvdec_tpu_torch.ops.cuda._build import load_kernel

    lib = load_kernel("sao_alf")
    fn = lib.sao_alf_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ctypes.POINTER(ll), i, i, p, ll,
                       ctypes.POINTER(ll), i, i, i, i, i, i, i, i, i, i, i,
                       i, i, p]
        fn.restype = ctypes.c_int
    return lib


def random_inputs(seed: int, h: int, w: int, *, cfmt: int = 1,
                  bd: int = 10, ctu: int = 64,
                  stages: tuple = (True, True, True, True), frames: int = 0,
                  n_banks: int = 3, n_cb: int = 2, n_cc: int = 3) -> tuple:
    """Random SAO / ALF inputs for the checks: (planes, flat, key) with
    int32 numpy planes, the int16 parameter vector as the host packs it
    and the chain's key (deblock off).  stages = (sao_on, alf_luma,
    alf_chroma, cc_on); 4:0:0 drops the chroma stages.  Planes of flat
    4x4 blocks, ramps and noise; every SAO type and off (255), offsets of
    +-31 and bands up to 31 (four bands wrapping past 31); luma banks the
    first of which is a fixed set with its clip table, the others random
    with the bit depth's clip values and some zero or negative clips;
    CTU bank, alternative and CC-ALF indices one past each end (a
    negative bank index wraps, a large one clamps; CC-ALF's filter none);
    CC-ALF bank 0 zero, as the host makes it.  cfmt is the chroma format
    (0 for 4:0:0 .. 3 for 4:4:4); frames > 0 adds a leading frame axis of
    independent draws."""
    from vvdec_tpu_torch.frame.alf_np import CLIP_VALUES, build_fixed_sets
    from vvdec_tpu_torch.ops.device_pipeline import _flat_pack
    rng = np.random.default_rng(seed)
    sub_w, sub_h = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}[cfmt]
    num_comp = 1 if cfmt == 0 else 3
    sao_on, alf_luma, alf_chroma, cc_on = stages
    if num_comp == 1:
        alf_chroma = cc_on = False
    any_alf = alf_luma or alf_chroma or cc_on
    hc, wc = (h // sub_h, w // sub_w) if num_comp > 1 else (1, 1)
    w_ctu = -(-w // ctu)
    n_ctu = w_ctu * -(-h // ctu)
    shapes = [(h, w)] + [(hc, wc)] * (num_comp - 1)
    total = sum(a * b for a, b in shapes)
    key = (h, w, hc, wc, bd, ctu, sub_w, sub_h, num_comp, w_ctu, False, 1,
           bool(sao_on), bool(alf_luma), bool(alf_chroma), bool(cc_on),
           n_banks if any_alf else 0, n_cb if any_alf else 0,
           n_cc if any_alf else 0, (-total) % 4 if bd > 8 else 0)
    fixed, fixed_clip = build_fixed_sets(bd)
    clips = np.append(np.asarray(CLIP_VALUES[bd - 8]), [0, -3])

    def textured(ph, pw):
        hi = 1 << bd
        base = rng.integers(0, hi, size=(-(-ph // 4), -(-pw // 4)))
        flat4 = np.repeat(np.repeat(base, 4, 0), 4, 1)[:ph, :pw]
        ramp = (np.arange(ph)[:, None] * 7 + np.arange(pw)[None, :] * 3) % hi
        pick = rng.integers(0, 3, size=(ph, pw))
        return np.choose(pick, [flat4, ramp, rng.integers(0, hi, (ph, pw))]
                         ).astype(np.int32)

    def one():
        arrays = {}
        if sao_on:
            arrays["sao_type"] = rng.choice([0, 1, 2, 3, 4, 255],
                                            size=(num_comp, n_ctu))
            vals = rng.integers(-31, 32, size=(num_comp, n_ctu, 6))
            vals[..., 0] = rng.integers(0, 32, size=(num_comp, n_ctu))
            arrays["sao_vals"] = vals
        if any_alf:
            co = rng.integers(-64, 65, size=(n_banks, 4, 25, 13))
            cl = rng.choice(clips, size=co.shape)
            co[0] = fixed[rng.integers(0, len(fixed))]
            cl[0] = fixed_clip
            cc = rng.integers(-64, 65, size=(n_cc, 7))
            cc[0] = 0
            arrays.update(
                en_y=(rng.random(n_ctu) < 0.8).astype(np.int32),
                set_ctu=rng.integers(-1, n_banks + 1, size=n_ctu),
                en_c=(rng.random((2, n_ctu)) < 0.8).astype(np.int32),
                alt_ctu=rng.integers(-1, n_cb + 1, size=(2, n_ctu)),
                cc_ctu=rng.integers(-1, n_cc + 1, size=(2, n_ctu)),
                banks_co=co, banks_cl=cl,
                cbanks_co=rng.integers(-64, 65, size=(n_cb, 7)),
                cbanks_cl=rng.choice(clips, size=(n_cb, 7)), cc_banks=cc)
        planes = [textured(*s) for s in shapes]
        return planes, _flat_pack(key, arrays)

    if not frames:
        planes, flat = one()
        return planes, flat, key
    draws = [one() for _ in range(frames)]
    planes = [np.stack(ps) for ps in zip(*(d[0] for d in draws))]
    return planes, np.stack([d[1] for d in draws]), key
