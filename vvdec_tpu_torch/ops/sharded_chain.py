"""CTU-row-sharded device filter chain over a device mesh.

Port of vvdec_tpu/ops/sharded_chain.py, the multi-device form of
ops/device_pipeline's whole-frame filter chain:

 - planes are cut into CTU-row-aligned bands (the shard height is a
   multiple of the CTU size, so every static mask of the dense stages --
   virtual-boundary rows, the deblock's CTU-boundary rules, the 4/8-pel
   edge phases -- keeps its alignment in shard coordinates);
 - one halo exchange of `ctu_size` rows per neighbour per frame: each
   shard's device receives its neighbours' boundary rows, taken from the
   planes as they were before the chain (parallel/sharding.halo_rows),
   and the whole chain then runs on the haloed shard.  The chain reads at
   most 22 rows past a shard edge (deblock 15 + SAO 1 + ALF 6), well
   inside the halo, so the shards are bit-exact against the unsharded
   chain;
 - per-CTU parameters ride one int16 vector per frame, uploaded to every
   shard's device, with grids padded by one CTU row of inert values on
   each side; each shard slices its rows by its index.  JAX's
   `lax.dynamic_slice` would clamp an out-of-range start; the padded
   grids keep every start in range, and the port asserts that rather
   than clamp.

Picture-edge shards replicate their border rows into the halo, as the
whole-frame stages pad the picture's edge; SAO trims at the picture's
top and bottom rows from the shard's absolute row offset.  Before ALF,
a shard that holds the picture's first or last row replicates that row,
as deblocking and SAO left it, over its rows outside the picture: ALF,
its classification and CC-ALF read there, and the whole-frame stages
clamp those reads to the picture.  (The reference keeps the halo's
unfiltered rows there, so its sharded chain differs from its unsharded
one next to the picture's top and bottom rows when ALF or CC-ALF is
on.)  One process drives every device of the mesh
(parallel/sharding.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda
from vvdec_tpu_torch.ops.device_pipeline import (
    _DB_FIELDS,
    _alf_inputs,
    _ccalf_dense_core,
    _classify_dense,
    _deblock_grid_inputs,
    _expand_ctu,
    _rep4,
    _sao_inputs,
    _sao_plane,
    batch_key,
    device_filter_eligible,
)
from vvdec_tpu_torch.ops.intra_device import _jidx
from vvdec_tpu_torch.ops.pipeline import _alf_diamond_dense_core
from vvdec_tpu_torch.parallel.sharding import halo_rows


def sharded_filter_eligible(cs) -> bool:
    return device_filter_eligible(cs)


def _sharded_layout(skey):
    """(name, shape) list for the replicated parameter vector; grids are
    padded with one halo CTU row of inert values on each side so every
    shard's slice is in range."""
    (h_img, w, hc_img, wc, h_pad, sh, bd, ctu, sub_w, sub_h, num_comp,
     w_ctu, db_on, n_sl, sao_on, alf_luma, alf_chroma, cc_on, n_banks,
     n_cb, n_cc) = skey
    c4 = ctu // 4
    g4 = h_pad // 4 + 2 * c4
    gc = h_pad // ctu + 2
    out = []
    if db_on:
        out.append(("db_y", (2, g4, w // 4)))
        if num_comp > 1:
            out.append(("db_cb", (2, g4, w // 4)))
            out.append(("db_cr", (2, g4, w // 4)))
        if n_sl > 1:
            out.append(("db_si", (g4, w // 4)))
        out.append(("db_sltab", (n_sl, 6)))
    if sao_on:
        out.append(("sao_type", (num_comp, gc, w_ctu)))
        out.append(("sao_vals", (num_comp, gc, w_ctu, 6)))
    if alf_luma or alf_chroma or cc_on:
        out += [("en_y", (gc, w_ctu)), ("set_ctu", (gc, w_ctu)),
                ("en_c", (2, gc, w_ctu)), ("alt_ctu", (2, gc, w_ctu)),
                ("cc_ctu", (2, gc, w_ctu)),
                ("banks_co", (n_banks, 4, 25, 13)),
                ("banks_cl", (n_banks, 4, 25, 13)),
                ("cbanks_co", (n_cb, 7)), ("cbanks_cl", (n_cb, 7)),
                ("cc_banks", (n_cc, 7))]
    return out


def _pack(skey, arrays) -> np.ndarray:
    parts = []
    for name, shape in _sharded_layout(skey):
        a = np.ascontiguousarray(arrays[name], dtype=np.int32)
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        if a.size and (a.min() < -32768 or a.max() >= 32768):
            raise ValueError(f"{name}: values outside the int16 range")
        parts.append(a.reshape(-1).astype(np.int16))
    return np.concatenate(parts) if parts else np.zeros(1, np.int16)


def _pad_rows(a, rows_before, rows_after, fill):
    return np.pad(a, [(rows_before, rows_after)] + [(0, 0)] * (a.ndim - 1),
                  constant_values=fill)


def _clamp_rows(a, lo: int, hi: int):
    """a with its rows above row lo replaced by row lo and those below
    row hi by row hi (each where it lies inside a)."""
    h = a.shape[0]
    lo, hi = max(lo, 0), min(hi, h - 1)
    if lo > hi or (lo == 0 and hi == h - 1):
        return a
    return a.index_select(0, torch.arange(h, device=a.device).clamp(lo, hi))


@functools.lru_cache(maxsize=None)
def _shard_chain_core(skey, n_shards: int, device: str):
    """The chain body of one shard on `device`: run(planes, flat, idx)
    with planes the shard's haloed planes (ctu rows above and below the
    luma band, ctu / sub_h the chroma ones), flat the frame's parameter
    vector on `device` and idx the shard's index on the row axis ->
    the filtered band, halo cropped."""
    (h_img, w, hc_img, wc, h_pad, sh, bd, ctu, sub_w, sub_h, num_comp,
     w_ctu, db_on, n_sl, sao_on, alf_luma, alf_chroma, cc_on, n_banks,
     n_cb, n_cc) = skey
    layout = _sharded_layout(skey)
    c4 = ctu // 4
    sh4 = sh // 4
    hs = sh + 2 * ctu          # haloed luma shard height
    ctu_c = ctu // sub_h
    hcs = hs // sub_h
    shc = sh // sub_h
    wcs = wc
    sh_ctu = sh // ctu
    gcs = sh_ctu + 2
    vb_luma_h, vb_luma_pos = ctu, ctu - 4
    vb_chma_h = ctu // sub_h
    vb_chma_pos = vb_chma_h - 2
    h4s, w4s = hs // 4, w // 4

    alf_luma_fn = _alf_diamond_dense_core(
        hs, w, bd, 12, vb_luma_h, vb_luma_pos, False, device) \
        if alf_luma else None
    alf_chroma_fn = _alf_diamond_dense_core(
        hcs, wcs, bd, 6, vb_chma_h, vb_chma_pos, True, device) \
        if alf_chroma else None
    cc_fn = _ccalf_dense_core(hs, w, hcs, wcs, bd, sub_w, sub_h, ctu,
                              w_ctu, n_cc, device) if cc_on else None

    def unpack(flat):
        out = {}
        pos = 0
        for name, shape in layout:
            n = int(np.prod(shape))
            a = flat[pos:pos + n].reshape(shape)
            # the deblock kernel reads its grids in the packed int16
            out[name] = a if name in _DB_FIELDS else a.to(torch.int32)
            pos += n
        return out

    def rows_of(a, start: int, size: int, lead: int = 0):
        """a's rows [start, start + size) along dim `lead`, which the
        padded grids hold for every shard."""
        assert 0 <= start and start + size <= a.shape[lead], \
            (start, size, a.shape, lead)
        return a.narrow(lead, start, size)

    def shard_fn(planes, flat, idx: int):
        planes = list(planes)
        Prm = unpack(flat)

        def g4slice(a):
            return rows_of(a, idx * sh4, sh4 + 2 * c4)

        def gcslice(a, lead=0):
            return rows_of(a, idx * sh_ctu, gcs, lead)

        # ---- deblocking: the kernel on the haloed band ----
        if db_on:
            names = ("db_y", "db_cb", "db_cr")[:num_comp]
            planes[:num_comp] = deblock_dense_cuda(
                planes[:num_comp],
                [rows_of(Prm[nm], idx * sh4, sh4 + 2 * c4, 1)
                 for nm in names],
                g4slice(Prm["db_si"]) if n_sl > 1 else None,
                Prm["db_sltab"], bd=bd, ctu=ctu, sub_w=sub_w, sub_h=sub_h,
                n_sl=n_sl)
        # ---- SAO ----
        if sao_on:
            row0_y = idx * sh - ctu
            for comp in range(num_comp):
                planes[comp] = _sao_plane(
                    planes[comp],
                    gcslice(Prm["sao_type"], 1)[comp].reshape(-1),
                    gcslice(Prm["sao_vals"], 1)[comp].reshape(-1, 6),
                    h=hcs if comp else hs, w=wcs if comp else w,
                    ctu_w=(ctu // sub_w) if comp else ctu,
                    ctu_h=(ctu // sub_h) if comp else ctu, w_ctu=w_ctu,
                    bd=bd, row0=row0_y // (sub_h if comp else 1),
                    img_h=hc_img if comp else h_img)
        # ---- ALF / CC-ALF ----
        out = list(planes)
        if alf_luma or alf_chroma or cc_on:
            # the picture's first and last rows as SAO left them,
            # replicated over the shard's rows outside the picture: the
            # whole-frame stages clamp these reads to the picture
            row0 = idx * sh - ctu
            for comp in range(num_comp):
                r0 = row0 // (sub_h if comp else 1)
                planes[comp] = _clamp_rows(
                    planes[comp], -r0, (hc_img if comp else h_img) - 1 - r0)
            out = list(planes)
            ctu4 = ctu >> 2
            if alf_luma:
                cls, tr = _classify_dense(planes[0], hs, w, bd,
                                          vb_luma_h, vb_luma_pos)
                set4 = _expand_ctu(gcslice(Prm["set_ctu"]).reshape(-1),
                                   ctu4, ctu4, h4s, w4s, w_ctu)
                sel = (_jidx(set4, n_banks), _jidx(tr, 4), _jidx(cls, 25))
                co = _rep4(Prm["banks_co"][sel][:, :, :12], hs, w)
                cl = _rep4(Prm["banks_cl"][sel][:, :, :12], hs, w)
                mask = _rep4(_expand_ctu(
                    gcslice(Prm["en_y"]).reshape(-1), ctu4, ctu4,
                    h4s, w4s, w_ctu), hs, w) != 0
                out[0] = alf_luma_fn(planes[0], co, cl, mask)
            if num_comp > 1 and (alf_chroma or cc_on):
                hc4, wc4 = (hcs + 3) >> 2, (wcs + 3) >> 2
                lc4w = (ctu // sub_w) >> 2
                lc4h = (ctu // sub_h) >> 2
                for k in range(2):
                    comp = 1 + k
                    if alf_chroma:
                        en4 = _expand_ctu(
                            gcslice(Prm["en_c"], 1)[k].reshape(-1),
                            lc4h, lc4w, hc4, wc4, w_ctu)
                        alt4 = _jidx(_expand_ctu(
                            gcslice(Prm["alt_ctu"], 1)[k].reshape(-1),
                            lc4h, lc4w, hc4, wc4, w_ctu), n_cb)
                        co = _rep4(Prm["cbanks_co"][alt4][:, :, :6], hcs,
                                   wcs)
                        cl = _rep4(Prm["cbanks_cl"][alt4][:, :, :6], hcs,
                                   wcs)
                        maskc = _rep4(en4, hcs, wcs) != 0
                        out[comp] = alf_chroma_fn(planes[comp], co, cl,
                                                  maskc)
                    if cc_on:
                        out[comp] = cc_fn(
                            planes[0], out[comp], Prm["cc_banks"],
                            gcslice(Prm["cc_ctu"], 1)[k].reshape(-1))
        # crop the halo
        res = [out[0][ctu:ctu + sh]]
        if num_comp > 1:
            res += [o[ctu_c:ctu_c + shc] for o in out[1:num_comp]]
        return res

    return shard_fn


_CACHE: dict = {}


def _frame_devices(mesh, axis: str) -> list:
    """devices[f][r]: the device of frame f's row shard r (frame index f
    on the mesh's "frame" axis, when it has one)."""
    if "frame" not in mesh.axis_names:
        return [mesh.axis_devices(axis)]
    return [mesh.axis_devices(axis, frame=f)
            for f in range(mesh.shape["frame"])]


def _get_mapped(skey, mesh, axis: str):
    """run(planes_per_frame, flats) for `skey` over `mesh[axis]` (and
    its frame axis): pads, cuts and halos each frame's planes, runs
    every shard on its device and gathers each frame's planes on its
    first shard's device.  Cached by value: the key, the axis, the mesh's
    torch.device values and its axis names."""
    mkey = (skey, axis, tuple(mesh.devices.flat), mesh.axis_names)
    fn = _CACHE.get(mkey)
    if fn is not None:
        return fn
    (h_img, w, hc_img, wc, h_pad, sh, bd, ctu, sub_w, sub_h, num_comp,
     *_rest) = skey
    devs = _frame_devices(mesh, axis)
    n = len(devs[0])
    cores = [[_shard_chain_core(skey, n, str(d)) for d in row]
             for row in devs]

    def run(planes_per_frame, flats):
        result = []
        for f, planes in enumerate(planes_per_frame):
            shards = []
            for comp in range(num_comp):
                hp = h_pad if comp == 0 else h_pad // sub_h
                p = planes[comp]
                # edge-pad the picture's bottom to the padded height
                p = torch.cat([p, p[-1:].expand(hp - p.shape[0], -1)])
                shp = hp // n
                shards.append([p[k * shp:(k + 1) * shp].to(devs[f][k])
                               for k in range(n)])
            outs = []
            for k in range(n):
                hrows = [ctu] + [ctu // sub_h] * (num_comp - 1)
                haloed = [halo_rows(shards[c], k, hrows[c])
                          for c in range(num_comp)]
                flat = torch.as_tensor(flats[f], device=devs[f][k])
                outs.append(cores[f][k](haloed, flat, k))
            home = devs[f][0]
            res = [torch.cat([o[0].to(home) for o in outs])[:h_img]]
            res += [torch.cat([o[c].to(home) for o in outs])[:hc_img]
                    for c in range(1, num_comp)]
            result.append(res)
        return result

    _CACHE[mkey] = run
    return run


def sharded_inputs(cs):
    """Host-side parameter assembly for the sharded chain (the padded
    grids are built from device_pipeline's packers)."""
    bd = cs.sps.bit_depth
    db = _deblock_grid_inputs(cs)
    sao = _sao_inputs(cs)
    alf = _alf_inputs(cs, bd)
    return db, sao, alf


def _frame_arrays(cs, n: int):
    """(skey, arrays) for one picture cut into n row shards: the padded
    grids, by name of _sharded_layout."""
    bd = cs.sps.bit_depth
    ctu = cs.sps.ctu_size
    w_ctu = cs.pps.pic_width_in_ctu
    num_comp = cs.num_comp
    w, h_img = cs.comp_size[0]
    wc, hc_img = cs.comp_size[1] if num_comp > 1 else (1, 1)
    sh = -(-h_img // (n * ctu)) * ctu
    h_pad = n * sh
    c4 = ctu // 4

    db, sao, alf = sharded_inputs(cs)
    skey = (h_img, w, hc_img, wc, h_pad, sh, bd, ctu, cs.sub_w, cs.sub_h,
            num_comp, w_ctu, db is not None, len(cs.shs), sao is not None,
            bool(alf and alf["any"][0]), bool(alf and alf["any"][1]),
            bool(alf and alf["any"][2]),
            0 if not alf else alf["arrays"][5].shape[0],
            0 if not alf else alf["arrays"][7].shape[0],
            0 if not alf else alf["arrays"][9].shape[0])

    arrays = {}
    g4_img = h_img // 4
    g4_pad = h_pad // 4
    h_ctu = -(-h_img // ctu)
    gc_pad = h_pad // ctu
    if db is not None:
        for nm in ("db_y", "db_cb", "db_cr"):
            if nm in db:
                g = db[nm].astype(np.int32)  # [2, g4_img, w4]
                g = _pad_rows(g.transpose(1, 0, 2), c4,
                              g4_pad - g4_img + c4, 0).transpose(1, 0, 2)
                arrays[nm] = g
        if "db_si" in db:
            arrays["db_si"] = _pad_rows(db["db_si"].astype(np.int32),
                                        c4, g4_pad - g4_img + c4, 0)
        arrays["db_sltab"] = db["db_sltab"]
    if sao is not None:
        t = sao[0][:num_comp].reshape(num_comp, h_ctu, w_ctu)
        v = sao[1][:num_comp].reshape(num_comp, h_ctu, w_ctu, 6)
        arrays["sao_type"] = _pad_rows(
            t.transpose(1, 0, 2), 1, gc_pad - h_ctu + 1,
            255).transpose(1, 0, 2)
        arrays["sao_vals"] = _pad_rows(
            v.transpose(1, 0, 2, 3), 1, gc_pad - h_ctu + 1,
            0).transpose(1, 0, 2, 3)
    if alf is not None:
        names = ("en_y", "set_ctu", "en_c", "alt_ctu", "cc_ctu",
                 "banks_co", "banks_cl", "cbanks_co", "cbanks_cl",
                 "cc_banks")
        for nm, a in zip(names, alf["arrays"]):
            if nm in ("en_y", "set_ctu"):
                a = _pad_rows(a.reshape(h_ctu, w_ctu), 1,
                              gc_pad - h_ctu + 1, 0)
            elif nm in ("en_c", "alt_ctu", "cc_ctu"):
                a = _pad_rows(a.reshape(2, h_ctu, w_ctu).transpose(
                    1, 0, 2), 1, gc_pad - h_ctu + 1, 0).transpose(1, 0, 2)
            arrays[nm] = a
    return skey, arrays


def _frame_inputs(cs, mesh, axis: str):
    """(skey, flat) for one picture: padded grids packed into the
    replicated int16 vector."""
    skey, arrays = _frame_arrays(cs, mesh.shape[axis])
    return skey, _pack(skey, arrays)


def filter_frames_sharded(items, mesh, axis: str = "row"):
    """Run the filter chain for `items` -- a list of (cs, planes) of
    pictures with one geometry and filter config, planes int32 tensors
    on any device -- row-sharded over `mesh[axis]` and frame-sharded
    over the mesh's "frame" axis.  The number of frames must equal the
    frame axis's size (1 when absent).  Their ALF bank counts may differ
    (device_pipeline.batch_key).  Returns each frame's filtered planes,
    int32 tensors on the device of its first row shard, bit-exact with
    the unsharded chain."""
    n_f = mesh.shape["frame"] if "frame" in mesh.axis_names else 1
    if len(items) != n_f:
        raise ValueError(f"{len(items)} frames for a frame axis of {n_f}")
    for cs, _ in items:
        if not sharded_filter_eligible(cs):
            raise NotImplementedError("sharded filter chain: the device "
                                      "chain rejects this picture")
    per = [_frame_arrays(cs, mesh.shape[axis]) for cs, _ in items]
    skey = batch_key(per, 18)
    flats = [_pack(skey, arrays) for _, arrays in per]
    return _get_mapped(skey, mesh, axis)(
        [planes for _, planes in items], flats)
