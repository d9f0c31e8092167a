"""Numpy golden SAO filter (H.266 clause 8.8.2).

Behavioral parity: vvdec SampleAdaptiveOffset::offsetBlock_core
(SampleAdaptiveOffset.cpp:64) and offsetCTU (:661) — vectorized per-CTU with
edge-availability trimming instead of the reference's scalar line walkers.
SAO reads the deblocked picture and writes the output picture; all neighbor
samples (including across CTU boundaries) come from the pre-SAO source.
"""

from __future__ import annotations

import numpy as np

from refdec.frame.structure import CodingStructure


def _sgn(a: np.ndarray) -> np.ndarray:
    return np.sign(a).astype(np.int32)


def sao_frame(cs: CodingStructure, planes: list[np.ndarray]) -> None:
    """In-place SAO over reconstructed (deblocked) planes — whole-frame
    vectorized: one padded copy and one edge-class evaluation per plane
    (the per-CTU variant below, kept as the golden reference, re-padded
    the full plane per CTU and dominated host decode time)."""
    if not any(s_.sao_enabled_luma or s_.sao_enabled_chroma
               for s_ in cs.shs):
        return
    bd = cs.sps.bit_depth
    pel_max = (1 << bd) - 1
    from refdec.native import native_cabac
    nc = native_cabac()
    if _native_sao_frame(cs, planes, nc, bd):
        return
    for comp, (type_map, ctu_idx, tables, mask) in enumerate(
            sao_prepare_maps(cs)):
        if not mask.any():
            continue
        if nc is not None and hasattr(nc, "sao_plane") \
                and planes[comp].dtype == np.int32 \
                and planes[comp].flags.c_contiguous:
            h, w = planes[comp].shape
            out = planes[comp].copy()
            nc.sao_plane(planes[comp], out, h, w,
                         np.ascontiguousarray(type_map, dtype=np.uint8),
                         np.ascontiguousarray(ctu_idx, dtype=np.int32),
                         np.ascontiguousarray(tables, dtype=np.int32),
                         np.ascontiguousarray(mask, dtype=np.uint8), bd)
            planes[comp][:] = out
            continue
        c = planes[comp]
        present = np.unique(type_map)
        pad = np.pad(c, 1, mode="edge")
        typ = type_map
        n = (
            (pad[1:-1, :-2], pad[1:-1, 2:]),    # EO 0 deg
            (pad[:-2, 1:-1], pad[2:, 1:-1]),    # EO 90
            (pad[:-2, :-2], pad[2:, 2:]),       # EO 135
            (pad[:-2, 2:], pad[2:, :-2]),       # EO 45
        )
        eo_present = [t for t in range(4) if t in present]
        if eo_present:
            a, b = n[eo_present[0]]
            for t in eo_present[1:]:
                sel = typ == t
                a = np.where(sel, n[t][0], a)
                b = np.where(sel, n[t][1], b)
            edge = _sgn(c - a) + _sgn(c - b) + 2
        else:
            edge = np.zeros_like(c)
        if 4 in present:
            idx = np.where(typ == 4, 5 + (c >> (bd - 5)), edge)
        else:
            idx = edge
        off = tables[ctu_idx, idx]
        planes[comp][:] = np.where(mask, np.clip(c + off, 0, pel_max), c)


def _native_sao_frame(cs, planes, nc, bd: int) -> bool:
    """Whole-frame SAO in one C call straight off the syntax walk's flat
    per-CTU records (no parameter materialization, no per-pixel map
    assembly).  Parity: sao_frame_per_ctu."""
    nw = getattr(cs, "_nw", None)
    if (nc is None or not hasattr(nc, "sao_apply_frame") or nw is None
            or len(cs.cus) != int(nw["counts"][0])
            or any(p.dtype != np.int32 or not p.flags["C_CONTIGUOUS"]
                   for p in planes)):
        return False
    vbx, vby = cs.virtual_boundaries()
    subpics = np.asarray(
        [[sp[0], sp[1], sp[2], sp[3], int(sp[4]), int(sp[5])]
         for sp in cs.subpics], dtype=np.int32) \
        if cs.subpics else np.zeros((0, 6), dtype=np.int32)
    y = planes[0]
    cb = planes[1] if cs.num_comp > 1 else y
    cr = planes[2] if cs.num_comp > 1 else y
    nc.sao_apply_frame(
        y, cb, cr, cs.w, cs.h, cs.sub_w, cs.sub_h, cs.num_comp,
        cs.sps.ctu_size, cs.pps.pic_width_in_ctu,
        cs.pps.pic_height_in_ctu, nw["sao"], nw["flags"], cs.slice_map,
        cs.tile_map, subpics.tobytes(), len(cs.subpics),
        int(cs.pps.loop_filter_across_slices),
        int(cs.pps.loop_filter_across_tiles),
        np.asarray(vbx, dtype=np.int32).tobytes(), len(vbx),
        np.asarray(vby, dtype=np.int32).tobytes(), len(vby), bd)
    return True


def sao_frame_per_ctu(cs: CodingStructure,
                      planes: list[np.ndarray]) -> None:
    """Per-CTU golden SAO (scalar-block reference for the vectorized
    paths above and the device stage)."""
    if not any(s_.sao_enabled_luma or s_.sao_enabled_chroma
               for s_ in cs.shs):
        return
    bd = cs.sps.bit_depth
    pel_max = (1 << bd) - 1
    ctu = cs.sps.ctu_size
    w_ctu = cs.pps.pic_width_in_ctu
    h_ctu = cs.pps.pic_height_in_ctu
    srcs = [p.copy() for p in planes]
    vbx, vby = cs.virtual_boundaries()

    def ctu_avail(rx, ry, nx, ny):
        """Neighbor CTU (nx, ny) usable for SAO of CTU (rx, ry)?
        (deriveLoopFilterBoundaryAvailibility: picture bounds + the
        loop-filter-across slice/tile/subpic rules)."""
        if nx < 0 or ny < 0 or nx >= w_ctu or ny >= h_ctu:
            return False
        y4a, x4a = (ry * ctu) >> 2, (rx * ctu) >> 2
        y4b, x4b = (ny * ctu) >> 2, (nx * ctu) >> 2
        pps = cs.pps
        if not pps.loop_filter_across_slices \
                and cs.slice_map[y4a, x4a] != cs.slice_map[y4b, x4b]:
            return False
        if not pps.loop_filter_across_tiles \
                and cs.tile_map[y4a, x4a] != cs.tile_map[y4b, x4b]:
            return False
        if cs.subpics:
            sp_a = cs.subpic_at(rx * ctu, ry * ctu)
            sp_b = cs.subpic_at(nx * ctu, ny * ctu)
            if sp_a is not sp_b and not (
                    (sp_a is None or sp_a[5]) and (sp_b is None or sp_b[5])):
                return False
        return True

    for ry in range(h_ctu):
        for rx in range(w_ctu):
            params = cs.sao_params[ry * w_ctu + rx]
            if params is None or all(p["mode"] == 0 for p in params):
                continue
            # diagonals exist when both orthogonal neighbours are in
            # bounds, then apply their own boundary rule (reference
            # fetches cuAboveLeft only if cuLeft && cuAbove)
            in_l, in_r = rx > 0, rx + 1 < w_ctu
            in_a, in_b = ry > 0, ry + 1 < h_ctu
            av = {
                "L": ctu_avail(rx, ry, rx - 1, ry),
                "R": ctu_avail(rx, ry, rx + 1, ry),
                "A": ctu_avail(rx, ry, rx, ry - 1),
                "B": ctu_avail(rx, ry, rx, ry + 1),
            }
            av["AL"] = in_a and in_l and ctu_avail(rx, ry, rx - 1, ry - 1)
            av["AR"] = in_a and in_r and ctu_avail(rx, ry, rx + 1, ry - 1)
            av["BL"] = in_b and in_l and ctu_avail(rx, ry, rx - 1, ry + 1)
            av["BR"] = in_b and in_r and ctu_avail(rx, ry, rx + 1, ry + 1)
            for comp in range(cs.num_comp):
                p = params[comp]
                if p["mode"] == 0:
                    continue
                sx = cs.sub_w if comp else 1
                sy = cs.sub_h if comp else 1
                cw, chh = cs.comp_size[comp]
                x0 = (rx * ctu) // sx
                y0 = (ry * ctu) // sy
                bw = min(ctu // sx, cw - x0)
                bh = min(ctu // sy, chh - y0)
                vbx_c = [v // sx for v in vbx]
                vby_c = [v // sy for v in vby]
                _apply(srcs[comp], planes[comp], x0, y0, bw, bh,
                       int(p["type"]), p["offsets"], av, bd, pel_max,
                       vbx_c, vby_c)


def sao_prepare_maps(cs: CodingStructure):
    """Host-side SAO parameter tensors for the device (JAX) stage.

    Per component: (type_map uint8 [Hc,Wc] with 255 = off, ctu_idx int32
    [Hc,Wc], tables int32 [n_ctu, 37] (idx 0..4 = EO class offsets,
    5..36 = BO table), mask bool [Hc,Wc]).  The mask encodes the same
    per-class trimming and virtual-boundary rules as _apply."""
    ctu = cs.sps.ctu_size
    w_ctu = cs.pps.pic_width_in_ctu
    h_ctu = cs.pps.pic_height_in_ctu
    n_ctu = w_ctu * h_ctu
    vbx, vby = cs.virtual_boundaries()
    out = []
    # availability closure identical to sao_frame's
    def ctu_avail(rx, ry, nx, ny):
        if nx < 0 or ny < 0 or nx >= w_ctu or ny >= h_ctu:
            return False
        y4a, x4a = (ry * ctu) >> 2, (rx * ctu) >> 2
        y4b, x4b = (ny * ctu) >> 2, (nx * ctu) >> 2
        pps = cs.pps
        if not pps.loop_filter_across_slices \
                and cs.slice_map[y4a, x4a] != cs.slice_map[y4b, x4b]:
            return False
        if not pps.loop_filter_across_tiles \
                and cs.tile_map[y4a, x4a] != cs.tile_map[y4b, x4b]:
            return False
        if cs.subpics:
            sp_a = cs.subpic_at(rx * ctu, ry * ctu)
            sp_b = cs.subpic_at(nx * ctu, ny * ctu)
            if sp_a is not sp_b and not (
                    (sp_a is None or sp_a[5]) and (sp_b is None or sp_b[5])):
                return False
        return True

    for comp in range(cs.num_comp):
        sx = cs.sub_w if comp else 1
        sy = cs.sub_h if comp else 1
        cw, chh = cs.comp_size[comp]
        type_map = np.full((chh, cw), 255, dtype=np.uint8)
        ctu_idx = np.zeros((chh, cw), dtype=np.int32)
        tables = np.zeros((n_ctu, 37), dtype=np.int32)
        mask_all = np.zeros((chh, cw), dtype=bool)
        vbx_c = [v // sx for v in vbx]
        vby_c = [v // sy for v in vby]
        for ry in range(h_ctu):
            for rx in range(w_ctu):
                params = cs.sao_params[ry * w_ctu + rx]
                if params is None:
                    continue
                p = params[comp]
                if p["mode"] == 0:
                    continue
                in_l, in_r = rx > 0, rx + 1 < w_ctu
                in_a, in_b = ry > 0, ry + 1 < h_ctu
                av = {
                    "L": ctu_avail(rx, ry, rx - 1, ry),
                    "R": ctu_avail(rx, ry, rx + 1, ry),
                    "A": ctu_avail(rx, ry, rx, ry - 1),
                    "B": ctu_avail(rx, ry, rx, ry + 1),
                }
                av["AL"] = in_a and in_l and ctu_avail(rx, ry, rx - 1,
                                                       ry - 1)
                av["AR"] = in_a and in_r and ctu_avail(rx, ry, rx + 1,
                                                       ry - 1)
                av["BL"] = in_b and in_l and ctu_avail(rx, ry, rx - 1,
                                                       ry + 1)
                av["BR"] = in_b and in_r and ctu_avail(rx, ry, rx + 1,
                                                       ry + 1)
                x0 = (rx * ctu) // sx
                y0 = (ry * ctu) // sy
                bw = min(ctu // sx, cw - x0)
                bh = min(ctu // sy, chh - y0)
                t = int(p["type"])
                addr = ry * w_ctu + rx
                type_map[y0:y0 + bh, x0:x0 + bw] = t
                ctu_idx[y0:y0 + bh, x0:x0 + bw] = addr
                if t == 4:
                    tables[addr, 5:] = p["offsets"]
                    mask_all[y0:y0 + bh, x0:x0 + bw] = True
                    continue
                tables[addr, :5] = p["offsets"]
                mask = np.zeros((bh, bw), dtype=bool)
                _eo_mask(mask, bw, bh, t, av)
                if t != 1:
                    for v in vbx_c:
                        for lx in (v - x0, v - 1 - x0):
                            if 0 <= lx < bw:
                                mask[:, lx] = False
                if t != 0:
                    for v in vby_c:
                        for ly in (v - y0, v - 1 - y0):
                            if 0 <= ly < bh:
                                mask[ly, :] = False
                mask_all[y0:y0 + bh, x0:x0 + bw] = mask
        out.append((type_map, ctu_idx, tables, mask_all))
    return out


def _eo_mask(mask, w, h, type_idc, av):
    """Per-class trimming mask (shared by _apply and the device stage)."""
    s_x = 0 if av["L"] else 1
    e_x = w if av["R"] else w - 1
    s_y = 0 if av["A"] else 1
    e_y = h if av["B"] else h - 1
    if type_idc == 0:
        mask[:, s_x:e_x] = True
    elif type_idc == 1:
        mask[s_y:e_y, :] = True
    elif type_idc == 2:
        mask[1:h - 1, s_x:e_x] = True
        mask[0, (0 if av["AL"] else 1): (e_x if av["A"] else 1)] = True
        mask[h - 1, (s_x if av["B"] else w - 1):
             (w if av["BR"] else w - 1)] = True
    else:
        mask[1:h - 1, s_x:e_x] = True
        mask[0, (s_x if av["A"] else w - 1): (w if av["AR"] else w - 1)] = True
        mask[h - 1, (0 if av["BL"] else 1): (e_x if av["B"] else 1)] = True


def _apply(src, res, x0, y0, w, h, type_idc, offsets, av, bd, pel_max,
           vbx_c=(), vby_c=()):
    if type_idc == 4:  # band offset
        blk = src[y0:y0 + h, x0:x0 + w].astype(np.int32)
        band = blk >> (bd - 5)
        res[y0:y0 + h, x0:x0 + w] = np.clip(
            blk + offsets[band], 0, pel_max)
        return

    # edge offset: compute edge class on a padded copy, apply where the
    # per-class trimming mask allows
    pad = np.pad(src.astype(np.int32), 1, mode="edge")
    c = pad[1 + y0: 1 + y0 + h, 1 + x0: 1 + x0 + w]
    if type_idc == 0:    # EO 0 deg: left/right
        n1 = pad[1 + y0: 1 + y0 + h, x0: x0 + w]
        n2 = pad[1 + y0: 1 + y0 + h, 2 + x0: 2 + x0 + w]
    elif type_idc == 1:  # EO 90: above/below
        n1 = pad[y0: y0 + h, 1 + x0: 1 + x0 + w]
        n2 = pad[2 + y0: 2 + y0 + h, 1 + x0: 1 + x0 + w]
    elif type_idc == 2:  # EO 135: above-left/below-right
        n1 = pad[y0: y0 + h, x0: x0 + w]
        n2 = pad[2 + y0: 2 + y0 + h, 2 + x0: 2 + x0 + w]
    else:                # EO 45: above-right/below-left
        n1 = pad[y0: y0 + h, 2 + x0: 2 + x0 + w]
        n2 = pad[2 + y0: 2 + y0 + h, x0: x0 + w]
    edge = _sgn(c - n1) + _sgn(c - n2) + 2

    mask = np.zeros((h, w), dtype=bool)
    _eo_mask(mask, w, h, type_idc, av)

    # virtual boundaries: samples at vb and vb-1 in the direction(s) the
    # EO class reads are left unfiltered (SampleAdaptiveOffset::
    # isProcessDisabled — EO_0 checks vertical VBs only, EO_90 horizontal
    # only, the diagonal classes both)
    if type_idc != 1:
        for v in vbx_c:
            for lx in (v - x0, v - 1 - x0):
                if 0 <= lx < w:
                    mask[:, lx] = False
    if type_idc != 0:
        for v in vby_c:
            for ly in (v - y0, v - 1 - y0):
                if 0 <= ly < h:
                    mask[ly, :] = False

    out = np.clip(c + offsets[edge], 0, pel_max)
    region = res[y0:y0 + h, x0:x0 + w]
    region[mask] = out[mask]
