"""Device-resident post-reconstruction filter chain: deblocking (V then
H, luma + chroma), SAO, ALF (with the pixel-dependent 4x4
classification) and CC-ALF, then the 10-bit output pack, with one packed
int16 parameter upload and one packed readback per frame.

Port of vvdec_tpu/ops/device_pipeline.py (the single-frame chain).
The deblock runs as the hand-written kernel csrc/deblock.cu
(ops/cuda/deblock.deblock_dense_cuda: one launch per direction a
picture, or a stack of pictures), SAO, ALF and CC-ALF as csrc/sao_alf.cu
(ops/cuda/sao_alf.sao_alf_cuda: at most two launches a picture, or a
stack of pictures); on CPU tensors each runs its plain version.
Parameters are uploaded as compact per-CTU tensors, which the kernels
read as uploaded and the plain versions expand to per-pixel maps.  The
plain stages compute what the reference's do, not always as it does:
the ALF classification evaluates its
laplacians on the half-sample grid only, CC-ALF filters at the chroma
positions only, and the edge padding is built from clamped indices
(torch's `replicate` pad does not take integer tensors on CUDA).  The
readback replaces JAX's `copy_to_host_async` with a non-blocking copy
into pinned host memory plus a CUDA event that `PendingFrame.resolve`
waits on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda
from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda
from vvdec_tpu_torch.ops.deblock_dense import pack_chroma_grid, pack_luma_grid
from vvdec_tpu_torch.utils.trace import profiler

_ACT_TH = np.array((0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4),
                   dtype=np.int32)
_TRANSPOSE = np.array((0, 1, 0, 2, 2, 3, 1, 3), dtype=np.int32)


def timed_stage(name: str, device):
    """profiler.stage(name) whose span, while the span log is on and
    `device` is CUDA, also holds the device time of the work queued
    inside it (a CUDA event at entry and one at exit, resolved when the
    log turns off), so the stage's time in `profiler.totals` includes
    its device work.  Nothing waits for the device."""
    ctx = profiler.stage(name)
    if profiler.enabled:
        if not isinstance(device, torch.device):
            device = torch.device(device)
        if device.type == "cuda":
            return profiler.device_span(ctx, device)
    return ctx


def upload(a, device, site: str, **kw):
    """torch.as_tensor(a, device=device, **kw) in the span `site`, a
    "wait: upload ..." name: from pageable host memory the copy waits
    for the card's queue to drain."""
    with profiler.stage(site):
        return torch.as_tensor(a, device=device, **kw)


def device_filter_reject_reason(cs) -> str | None:
    """Why this picture's filter config cannot run on the device chain
    (None = eligible); the reference's gates."""
    if cs.sps.bit_depth > 10:
        return "bit_depth>10"
    vbx, vby = cs.virtual_boundaries()
    if vbx or vby:
        return "virtual_boundaries"
    if cs.subpics:
        return "subpics"
    if len(cs.shs) > 1 and not cs.pps.loop_filter_across_slices:
        return "lf_across_slices_off"
    if len(cs.shs) > 16:
        # per-slice offsets become a select chain in the dense deblock
        return ">16_slices"
    if not cs.pps.no_pic_partition \
            and not cs.pps.loop_filter_across_tiles:
        return "lf_across_tiles_off"
    return None


def device_filter_eligible(cs) -> bool:
    """Whether the device chain models this picture's filter config."""
    return device_filter_reject_reason(cs) is None


def _edge_pad(a, top: int, bottom: int, left: int, right: int):
    """`a` [h, w] padded by replicating its edge rows and columns."""
    h, w = a.shape
    ri = torch.clamp(torch.arange(-top, h + bottom, device=a.device), 0, h - 1)
    ci = torch.clamp(torch.arange(-left, w + right, device=a.device), 0,
                     w - 1)
    return a.index_select(0, ri).index_select(1, ci)


def _u32(x):
    """int32 values as the uint32 they reinterpret, held in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


# ======================================================================
# ALF classification (deriveClassificationBlk, whole frame)
# ======================================================================
@functools.lru_cache(maxsize=None)
def _classify_tables(h: int, w: int, vb_h: int, vb_pos: int, device: str):
    """Static index tables of the classification on `device`: for each
    half-sample row y = -2, 0, ..., h the rows (y-1, y, y+1, y+2) it
    reads, with the virtual-boundary substitutions, clamped to the
    picture; for each half-sample column x = -2, 0, ..., w the columns
    (x-1, x, x+1, x+2), clamped; the per-block-row VB flags."""
    y = np.arange(0, h + 4, 2) - 2
    vb_lo = (y > 0) & (y % vb_h == vb_pos - 2)
    vb_hi = (y > 0) & ~vb_lo & (y % vb_h == vb_pos)
    rows = [np.where(vb_hi, y, y - 1), y, y + 1, np.where(vb_lo, y + 1, y + 2)]
    x = np.arange(0, w + 4, 2) - 2
    cols = [x - 1, x, x + 1, x + 2]
    ymod = (4 * np.arange(h // 4)) % vb_h

    def t(a, hi):
        return torch.as_tensor(np.clip(a, 0, hi), dtype=torch.int64,
                               device=device)

    return dict(
        rows=[t(r, h - 1) for r in rows], cols=[t(c, w - 1) for c in cols],
        lo=torch.as_tensor((ymod == vb_pos - 4)[:, None], device=device),
        hi=torch.as_tensor((ymod == vb_pos)[:, None], device=device),
        act_th=torch.as_tensor(_ACT_TH, device=device),
        transpose=torch.as_tensor(_TRANSPOSE, device=device))


def _classify_dense(src, h: int, w: int, bd: int, vb_h: int, vb_pos: int):
    """Whole-frame 4x4 ALF classification -> (class, transpose index),
    int32 [h/4, w/4].  Parity: frame/alf_np.classify (bounds=None) and
    the reference's _classify_dense / _classify_jnp.  The laplacians are
    evaluated on the half-sample grid (every other row and column) and
    summed over each block's 4x4 (3x4 beside a virtual boundary) cells;
    sums wrap in int32 and the direction tests compare products as
    uint32, as the reference's do."""
    t = _classify_tables(h, w, vb_h, vb_pos, str(src.device))
    s = src.to(torch.int32)
    srows = [s.index_select(0, r) for r in t["rows"]]

    def at(r: int, c: int):
        return srows[r].index_select(1, t["cols"][c])

    y0v = at(1, 1) * 2
    yup1 = at(2, 2) * 2
    laps = (
        torch.abs(y0v - at(0, 1) - at(2, 1))
        + torch.abs(yup1 - at(1, 2) - at(3, 2)),            # vertical
        torch.abs(y0v - at(1, 2) - at(1, 0))
        + torch.abs(yup1 - at(2, 3) - at(2, 1)),            # horizontal
        torch.abs(y0v - at(0, 0) - at(2, 2))
        + torch.abs(yup1 - at(1, 1) - at(3, 3)),            # diagonal 0
        torch.abs(y0v - at(2, 0) - at(0, 2))
        + torch.abs(yup1 - at(3, 1) - at(1, 3)))            # diagonal 1
    h4, w4 = h // 4, w // 4
    lo, hi = t["lo"], t["hi"]
    sums = []
    for lap in laps:
        rows = []
        for k in range(4):
            r = lap[k:k + 2 * h4:2]
            rows.append(r[:, 0:2 * w4:2] + r[:, 1:1 + 2 * w4:2]
                        + r[:, 2:2 + 2 * w4:2] + r[:, 3:3 + 2 * w4:2])
        full = rows[0] + rows[1] + rows[2] + rows[3]
        sums.append(torch.where(lo, full - rows[3],
                                torch.where(hi, full - rows[0], full)))
    sum_v, sum_h, sum_d0, sum_d1 = sums

    shift = bd + 4
    temp_act = sum_v + sum_h
    act = torch.where(lo | hi, (temp_act * 96) >> shift,
                      (temp_act * 64) >> shift)
    cls = t["act_th"][torch.clamp(act, 0, 15).long()]
    vgh = sum_v > sum_h
    hv1 = torch.where(vgh, sum_v, sum_h)
    hv0 = torch.where(vgh, sum_h, sum_v)
    dir_hv = 3 - 2 * vgh.to(torch.int32)
    dgd = sum_d0 > sum_d1
    d1 = torch.where(dgd, sum_d0, sum_d1)
    d0 = torch.where(dgd, sum_d1, sum_d0)
    dir_d = 2 - 2 * dgd.to(torch.int32)
    m32 = 0xFFFFFFFF
    dsel = ((_u32(d1) * _u32(hv0)) & m32) > ((_u32(hv1) * _u32(d0)) & m32)
    hvd1 = torch.where(dsel, d1, hv1)
    hvd0 = torch.where(dsel, d0, hv0)
    main_dir = torch.where(dsel, dir_d, dir_hv)
    sec_dir = torch.where(dsel, dir_hv, dir_d)
    strong = ((_u32(hvd1) * 2) & m32) > ((9 * _u32(hvd0)) & m32)
    strength = torch.where(strong, 2, (hvd1 > 2 * hvd0).to(torch.int32))
    cls = torch.where(strength > 0,
                      cls + (((main_dir & 1) << 1) + strength) * 5, cls)
    tr = t["transpose"][(main_dir * 2 + (sec_dir >> 1)).long()]
    return cls, tr


# ======================================================================
# SAO with per-CTU parameter expansion
# ======================================================================
def _expand_ctu(vals, rep_y: int, rep_x: int, out_h: int, out_w: int,
                w_ctu: int):
    """Per-CTU values [n_ctu] (row-major) broadcast onto a dense grid of
    rep_y x rep_x cells per CTU, cropped to [out_h, out_w]."""
    g = vals.reshape(-1, w_ctu)
    return g.repeat_interleave(rep_y, 0).repeat_interleave(rep_x, 1) \
        [:out_h, :out_w]


def _sao_plane(plane, sao_type, vals, *, h, w, ctu_w, ctu_h, w_ctu, bd,
               row0=None, img_h=None):
    """SAO for one plane.  sao_type: [n_ctu] (255 = off); vals:
    [n_ctu, 6] compact offsets -- EO: (_, o0..o4); BO: (band, b0..b3, _).
    Neighbours are available inside the picture (the chain's gates), so
    only the picture border trims the edge classes (sao_np._eo_mask).

    Row-sharded use: `row0` is the picture row of the plane's row 0 and
    `img_h` the picture's height, so the top and bottom trimming applies
    at the picture's edges rather than the shard's."""
    pel_max = (1 << bd) - 1
    band_shift = bd - 5
    c = plane.to(torch.int32)
    typ = _expand_ctu(sao_type, ctu_h, ctu_w, h, w, w_ctu)
    v = [_expand_ctu(vals[:, j], ctu_h, ctu_w, h, w, w_ctu)
         for j in range(6)]
    pad = _edge_pad(c, 1, 1, 1, 1)
    pairs = (
        (pad[1:-1, :-2], pad[1:-1, 2:]),    # EO 0 deg
        (pad[:-2, 1:-1], pad[2:, 1:-1]),    # EO 90
        (pad[:-2, :-2], pad[2:, 2:]),       # EO 135
        (pad[:-2, 2:], pad[2:, :-2]),       # EO 45
    )
    edge = None
    for k, (a, b) in enumerate(pairs):
        e = torch.sign(c - a) + torch.sign(c - b) + 2
        edge = e if edge is None else torch.where(typ == k, e, edge)
    off_eo = v[1]
    for j in range(1, 5):
        off_eo = torch.where(edge == j, v[1 + j], off_eo)
    rel = ((c >> band_shift) - v[0]) & 31
    off_bo = torch.zeros_like(c)
    for j in range(4):
        off_bo = torch.where(rel == j, v[1 + j], off_bo)
    off = torch.where(typ == 4, off_bo, off_eo)
    ys = torch.arange(h, device=c.device)[:, None]
    xs = torch.arange(w, device=c.device)[None, :]
    on_x = (xs > 0) & (xs < w - 1)
    if row0 is not None:
        on_y = (ys + row0 > 0) & (ys + row0 < img_h - 1)
    else:
        on_y = (ys > 0) & (ys < h - 1)
    eo_diag = (typ != 0) & (typ != 1) & (typ != 4)
    mask = (typ == 4) | ((typ == 0) & on_x) | ((typ == 1) & on_y) \
        | (eo_diag & on_x & on_y)
    mask = mask & (typ != 255)
    out = torch.clamp(c + off, 0, pel_max)
    return torch.where(mask, out, c).to(plane.dtype)


# ======================================================================
# CC-ALF at the chroma positions
# ======================================================================
@functools.lru_cache(maxsize=None)
def _ccalf_dense_core(h: int, w: int, hc: int, wc: int, bd: int,
                      sub_w: int, sub_h: int, ctu: int, w_ctu: int,
                      n_cc: int, device: str):
    """CC-ALF correction of a chroma plane from the (pre-ALF) luma
    plane, evaluated at each chroma sample's co-located luma position,
    with the per-row virtual-boundary tap rules as static row tables.
    Parity: filterBlkCcAlf (AdaptiveLoopFilter.cpp:1348) / the
    reference's _ccalf_dense_core."""
    pel_max = (1 << bd) - 1
    half = (1 << bd) >> 1
    sy, sx = sub_h - 1, sub_w - 1
    vb_h, vb_pos = ctu, ctu - 4
    ly = np.arange(hc) << sy
    lx = np.arange(wc) << sx
    pos = ly & (vb_h - 1)
    rz = (pos == vb_pos - 1) | (pos == vb_pos)          # o1 = o2 = o3 = 0
    r31 = (pos == vb_pos - 2) | (pos == vb_pos + 1)     # o3 = o1
    skip = (sy == 0) & ((pos == vb_pos) | (pos == vb_pos + 1))
    row_off = {0: np.zeros_like(ly), -1: np.where(rz, 0, -1),
               1: np.where(rz, 0, 1),
               2: np.where(rz, 0, np.where(r31, 1, 2))}
    # the 7 taps as (row offset, column offset)
    tap_list = ((-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1), (2, 0))

    def t(a, hi):
        return torch.as_tensor(np.clip(a, 0, hi), dtype=torch.int64,
                               device=device)

    rows = {k: t(ly + o, h - 1) for k, o in row_off.items()}
    cols = {dx: t(lx + dx, w - 1) for dx in (-1, 0, 1)}
    skip_t = torch.as_tensor(skip[:, None], device=device)

    def apply(luma, dst, cc_banks, cc_ctu):
        sl = luma.to(torch.int32)
        srows = {k: sl.index_select(0, r) for k, r in rows.items()}
        curr = srows[0].index_select(1, cols[0])
        cidx = _expand_ctu(cc_ctu, ctu >> sy, ctu >> sx, hc, wc, w_ctu)
        bank = cc_banks[torch.clamp(cidx, 0, n_cc - 1).long()]  # [hc,wc,7]
        live = (cidx >= 1) & (cidx < n_cc)
        acc = torch.zeros_like(curr)
        for k, (dy, dx) in enumerate(tap_list):
            tap = srows[dy].index_select(1, cols[dx])
            acc = acc + torch.where(live, bank[:, :, k], 0) * (tap - curr)
        acc = (acc + 64) >> 7
        acc = torch.clamp(acc + half, 0, pel_max) - half
        d = dst.to(torch.int32)
        out = torch.clamp(acc + d, 0, pel_max)
        use = (cidx != 0) & ~skip_t
        return torch.where(use, out, d).to(dst.dtype)

    return apply


# ======================================================================
# chain assembly
# ======================================================================
def _rep4(a, h: int, w: int):
    """4x4-block values broadcast to pixels, cropped to [h, w]."""
    return a.repeat_interleave(4, 0).repeat_interleave(4, 1)[:h, :w]


def _flat_layout(key):
    """Static (name, shape) list describing the packed parameter vector
    (one host->device int16 transfer per frame; every field fits 15
    bits, checked at pack time)."""
    (h, w, hc, wc, bd, ctu, sub_w, sub_h, num_comp, w_ctu,
     db_on, n_sl, sao_on, alf_luma, alf_chroma, cc_on, n_banks, n_cb,
     n_cc, pack_pad) = key
    h_ctu = -(-h // ctu)
    n_ctu = w_ctu * h_ctu
    h4g, w4g = h // 4, w // 4
    out = []
    if db_on:
        out.append(("db_y", (2, h4g, w4g)))
        if num_comp > 1:
            out.append(("db_cb", (2, h4g, w4g)))
            out.append(("db_cr", (2, h4g, w4g)))
        if n_sl > 1:
            out.append(("db_si", (h4g, w4g)))
        out.append(("db_sltab", (n_sl, 6)))
    if sao_on:
        out.append(("sao_type", (num_comp, n_ctu)))
        out.append(("sao_vals", (num_comp, n_ctu, 6)))
    if alf_luma or alf_chroma or cc_on:
        out += [("en_y", (n_ctu,)), ("set_ctu", (n_ctu,)),
                ("en_c", (2, n_ctu)), ("alt_ctu", (2, n_ctu)),
                ("cc_ctu", (2, n_ctu)),
                ("banks_co", (n_banks, 4, 25, 13)),
                ("banks_cl", (n_banks, 4, 25, 13)),
                ("cbanks_co", (n_cb, 7)), ("cbanks_cl", (n_cb, 7)),
                ("cc_banks", (n_cc, 7))]
    return out


def _flat_pack(key, arrays: dict) -> np.ndarray:
    parts = []
    for name, shape in _flat_layout(key):
        a = np.ascontiguousarray(arrays[name], dtype=np.int32)
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        if a.size and (a.min() < -32768 or a.max() >= 32768):
            raise ValueError(f"{name}: values outside the int16 range")
        parts.append(a.reshape(-1).astype(np.int16))
    if not parts:
        return np.zeros(1, dtype=np.int16)
    return np.concatenate(parts)


# the deblock's fields, which the kernel reads in their packed int16
_DB_FIELDS = ("db_y", "db_cb", "db_cr", "db_si", "db_sltab")


def _flat_unpack(key, flat, names=None):
    """The fields of the packed vector (or of only `names`) as tensors,
    int32 but for the deblock's (_DB_FIELDS, views of the int16 upload);
    a leading frame axis of `flat` leads every field."""
    out = {}
    pos = 0
    for name, shape in _flat_layout(key):
        n = int(np.prod(shape))
        if names is None or name in names:
            a = flat[..., pos:pos + n].reshape(flat.shape[:-1] + shape)
            out[name] = a if name in _DB_FIELDS else a.to(torch.int32)
        pos += n
    return out


@functools.lru_cache(maxsize=None)
def _chain_fn(key):
    """The whole-frame filter chain (deblock, SAO, ALF, CC-ALF, pack)
    for one static config: chain(planes, flat) -> (filtered planes,
    packed uint8), on the planes' device."""
    (h, w, hc, wc, bd, ctu, sub_w, sub_h, num_comp, w_ctu,
     db_on, n_sl, sao_on, alf_luma, alf_chroma, cc_on, n_banks, n_cb,
     n_cc, pack_pad) = key

    def deblock(planes, P):
        """In place on the list: V then H edges of every component, one
        kernel launch each (a leading frame axis: still one)."""
        names = ("db_y", "db_cb", "db_cr")[:num_comp]
        planes[:num_comp] = deblock_dense_cuda(
            planes[:num_comp], [P[nm] for nm in names],
            P["db_si"] if n_sl > 1 else None, P["db_sltab"], bd=bd, ctu=ctu,
            sub_w=sub_w, sub_h=sub_h, n_sl=n_sl)

    def pack(planes):
        """The 10-bit (or 8-bit) output bytes; planes may carry a leading
        frame axis."""
        lead = tuple(planes[0].shape[:-2])
        flat = torch.cat([p.reshape(lead + (-1,)) for p in planes], -1)
        if pack_pad:
            flat = torch.cat([flat, flat.new_zeros(lead + (pack_pad,))], -1)
        if bd <= 8:
            return flat.to(torch.uint8)
        g = flat.reshape(lead + (-1, 4))
        b0 = g[..., 0] & 255
        b1 = (g[..., 0] >> 8) | ((g[..., 1] & 63) << 2)
        b2 = (g[..., 1] >> 6) | ((g[..., 2] & 15) << 4)
        b3 = (g[..., 2] >> 4) | ((g[..., 3] & 3) << 6)
        b4 = g[..., 3] >> 2
        return torch.stack([b0, b1, b2, b3, b4], -1).to(torch.uint8) \
            .reshape(lead + (-1,))

    def chain(planes, flat):
        """The deblock, SAO, ALF / CC-ALF and the pack; planes and flat
        may carry a leading frame axis (the batched chain's stacked
        pictures: each kernel still launches once)."""
        planes = list(planes)
        dev = str(planes[0].device)
        if db_on:
            with timed_stage("filter: params", dev):
                P = _flat_unpack(key, flat, _DB_FIELDS)
            with timed_stage("filter: deblock", dev):
                deblock(planes, P)
        if sao_on or alf_luma or alf_chroma or cc_on:
            with timed_stage("filter: sao/alf", dev):
                planes = list(sao_alf_cuda(planes, flat, key))
        with timed_stage("filter: pack", dev):
            out = [p.contiguous() for p in planes]
            packed = pack(out)
        return tuple(out), packed

    return chain


def _deblock_grid_inputs(cs):
    """Packed per-4x4-cell deblock grids (host strength derivation in
    C): {"db_y": [2, h4, w4], "db_cb"/"db_cr": same (chroma formats),
    "db_si": slice-index grid (multi-slice), "db_sltab": [n_sl, 6]
    per-slice tc/beta offsets}."""
    from vvdec_tpu_torch.frame.deblock_np import Deblocker
    if all(s.deblocking_disabled for s in cs.shs):
        return None
    db = Deblocker(cs, None)
    db.derive_strengths()
    out = {
        "db_y": np.stack([pack_luma_grid(db.edges[0]),
                          pack_luma_grid(db.edges[1])]),
        "db_sltab": np.array(
            [[s.tc_offset_div2, s.beta_offset_div2,
              s.cb_tc_offset_div2, s.cb_beta_offset_div2,
              s.cr_tc_offset_div2, s.cr_beta_offset_div2]
             for s in cs.shs], dtype=np.int32),
    }
    if cs.num_comp > 1:
        out["db_cb"] = np.stack([pack_chroma_grid(db.edges[0], 1),
                                 pack_chroma_grid(db.edges[1], 1)])
        out["db_cr"] = np.stack([pack_chroma_grid(db.edges[0], 2),
                                 pack_chroma_grid(db.edges[1], 2)])
    if len(cs.shs) > 1:
        out["db_si"] = np.clip(cs.slice_map, 0, len(cs.shs) - 1) \
            .astype(np.int16)
    return out


def _sao_inputs(cs):
    """Per-CTU SAO tensors: type per comp [n_ctu] (255 off) + compact
    values [n_ctu, 6] -- EO: (_, o0..o4); BO: (band, b0..b3, _)."""
    if not any(s_.sao_enabled_luma or s_.sao_enabled_chroma
               for s_ in cs.shs):
        return None
    w_ctu = cs.pps.pic_width_in_ctu
    h_ctu = cs.pps.pic_height_in_ctu
    n_ctu = w_ctu * h_ctu
    types = np.full((cs.num_comp, n_ctu), 255, dtype=np.int32)
    vals = np.zeros((cs.num_comp, n_ctu, 6), dtype=np.int32)
    for addr in range(n_ctu):
        params = cs.sao_params[addr]
        if params is None:
            continue
        for comp in range(cs.num_comp):
            p = params[comp]
            if p["mode"] == 0:
                continue
            t = int(p["type"])
            types[comp, addr] = t
            if t == 4:
                band = int(p["band"])
                vals[comp, addr, 0] = band
                for k in range(4):
                    vals[comp, addr, 1 + k] = p["offsets"][(band + k)
                                                           % 32]
            else:
                vals[comp, addr, 1:6] = p["offsets"]
    if (types == 255).all():
        return None
    return types, vals


def _alf_inputs(cs, bd: int):
    """Per-CTU ALF tensors + stacked banks (host coefficient build)."""
    from vvdec_tpu_torch.frame.alf_np import (
        NUM_FIXED_FILTER_SETS, build_chroma_coeff, build_fixed_sets,
        build_luma_coeff)
    if not any(any(s_.alf_enabled) or s_.ccalf_cb_enabled
               or s_.ccalf_cr_enabled for s_ in cs.shs):
        return None
    ctu = cs.sps.ctu_size
    w_ctu = cs.pps.pic_width_in_ctu
    h_ctu = cs.pps.pic_height_in_ctu
    n_ctu = w_ctu * h_ctu

    fixed_sets, fixed_clip = build_fixed_sets(bd)
    luma_tables = {}
    for si, s_ in enumerate(cs.shs):
        for i, aps_id in enumerate(s_.alf_aps_ids_luma):
            aps = cs.alf_apss[aps_id]
            luma_tables[(si, i)] = build_luma_coeff(aps.alf, bd)

    bank_key_to_id: dict = {}
    banks_co: list = []
    banks_cl: list = []

    def bank_id(si, idx):
        key = ("fixed", idx) if idx < NUM_FIXED_FILTER_SETS else (si, idx)
        if key not in bank_key_to_id:
            if idx < NUM_FIXED_FILTER_SETS:
                co, cl = fixed_sets[idx], fixed_clip
            else:
                co, cl = luma_tables[(si, idx - NUM_FIXED_FILTER_SETS)]
            bank_key_to_id[key] = len(banks_co)
            banks_co.append(co)
            banks_cl.append(cl)
        return bank_key_to_id[key]

    # chroma banks: per (slice alt) pair; cc banks
    cbank_ids: dict = {}
    cbanks_co: list = []
    cbanks_cl: list = []
    cc_bank_ids: dict = {}
    cc_banks: list = [np.zeros(7, dtype=np.int64)]

    en_y = np.zeros(n_ctu, dtype=np.int32)
    set_ctu = np.zeros(n_ctu, dtype=np.int32)
    en_c = np.zeros((2, n_ctu), dtype=np.int32)
    alt_ctu = np.zeros((2, n_ctu), dtype=np.int32)
    cc_ctu = np.zeros((2, n_ctu), dtype=np.int32)
    any_luma = any_chroma = any_cc = False
    for ry in range(h_ctu):
        for rx in range(w_ctu):
            addr = ry * w_ctu + rx
            p = cs.alf_params[addr]
            if p is None:
                continue
            si = int(cs.slice_map[(ry * ctu) >> 2, (rx * ctu) >> 2])
            sh = cs.shs[si if 0 <= si < len(cs.shs) else 0]
            if sh.alf_enabled[0] and p["enable"][0]:
                any_luma = True
                en_y[addr] = 1
                set_ctu[addr] = bank_id(si, p["filt_idx"])
            if cs.num_comp > 1:
                for k, comp in enumerate((1, 2)):
                    if sh.alf_enabled[comp] and p["enable"][comp]:
                        any_chroma = True
                        en_c[k, addr] = 1
                        ckey = (sh.alf_aps_id_chroma, p["alt"][k])
                        if ckey not in cbank_ids:
                            aps = cs.alf_apss[sh.alf_aps_id_chroma]
                            co, cl = build_chroma_coeff(aps.alf,
                                                        p["alt"][k], bd)
                            cbank_ids[ckey] = len(cbanks_co)
                            cbanks_co.append(co)
                            cbanks_cl.append(cl)
                        alt_ctu[k, addr] = cbank_ids[ckey]
                    cc_i = p["cc"][k]
                    cc_en = sh.ccalf_cb_enabled if comp == 1 \
                        else sh.ccalf_cr_enabled
                    if cc_en and cc_i:
                        any_cc = True
                        aps_id = sh.ccalf_cb_aps_id if comp == 1 \
                            else sh.ccalf_cr_aps_id
                        ckey = (aps_id, comp, cc_i)
                        if ckey not in cc_bank_ids:
                            aps = cs.alf_apss[aps_id]
                            cc_bank_ids[ckey] = len(cc_banks)
                            cc_banks.append(np.asarray(
                                aps.cc_alf.coeff[comp - 1][cc_i - 1],
                                dtype=np.int64))
                        cc_ctu[k, addr] = cc_bank_ids[ckey]
    if not (any_luma or any_chroma or any_cc):
        return None
    if not banks_co:
        # chroma ALF or CC-ALF without a luma ALF CTU: one zero bank that
        # no CTU selects keeps the stacked [B, 4, 25, 13] shape (the
        # reference reshapes the empty list and raises)
        banks_co.append(np.zeros((4, 25, 13), dtype=np.int32))
        banks_cl.append(np.zeros((4, 25, 13), dtype=np.int32))
    return {
        "any": (any_luma, any_chroma and cs.num_comp > 1,
                any_cc and cs.num_comp > 1),
        "arrays": (
            en_y, set_ctu, en_c, alt_ctu, cc_ctu,
            np.asarray(banks_co, dtype=np.int32).reshape(
                max(1, len(banks_co)), 4, 25, 13),
            np.asarray(banks_cl, dtype=np.int32).reshape(
                max(1, len(banks_cl)), 4, 25, 13),
            np.asarray(cbanks_co, dtype=np.int32)
            if cbanks_co else np.zeros((1, 7), dtype=np.int32),
            np.asarray(cbanks_cl, dtype=np.int32)
            if cbanks_cl else np.ones((1, 7), dtype=np.int32),
            np.asarray(cc_banks, dtype=np.int32)),
    }


def _frame_key_arrays(cs, shapes):
    """(key, arrays dict) for one picture: the static chain config and
    its packed parameters.  shapes: the (h, w) of each output plane."""
    bd = cs.sps.bit_depth
    num_comp = cs.num_comp
    h, w = shapes[0]
    hc, wc = shapes[1] if num_comp > 1 else (1, 1)
    with profiler.stage("deblock strengths (host)"):
        db = _deblock_grid_inputs(cs)
    with profiler.stage("sao/alf parameters (host)"):
        sao = _sao_inputs(cs)
        alf = _alf_inputs(cs, bd)
    total = sum(hh * ww for hh, ww in shapes[:num_comp])
    pack_pad = (-total) % 4 if bd > 8 else 0
    key = (h, w, hc, wc, bd, cs.sps.ctu_size, cs.sub_w, cs.sub_h,
           num_comp, cs.pps.pic_width_in_ctu, db is not None,
           len(cs.shs), sao is not None,
           bool(alf and alf["any"][0]), bool(alf and alf["any"][1]),
           bool(alf and alf["any"][2]),
           0 if not alf else alf["arrays"][5].shape[0],
           0 if not alf else alf["arrays"][7].shape[0],
           0 if not alf else alf["arrays"][9].shape[0], pack_pad)
    arrays = {}
    if db is not None:
        arrays.update(db)
    if sao is not None:
        arrays["sao_type"] = sao[0][:num_comp]
        arrays["sao_vals"] = sao[1][:num_comp]
    if alf is not None:
        names = ("en_y", "set_ctu", "en_c", "alt_ctu", "cc_ctu",
                 "banks_co", "banks_cl", "cbanks_co", "cbanks_cl",
                 "cc_banks")
        for name, a in zip(names, alf["arrays"]):
            arrays[name] = a
    return key, arrays


class PendingFrame:
    """In-flight device filter result: device planes + the packed
    readback, copied without blocking into pinned host memory on CUDA."""

    __slots__ = ("planes_dev", "packed", "shapes", "bd", "pad", "_planes",
                 "_host", "_event")

    def __init__(self, planes_dev, packed, shapes, bd, pad):
        self.planes_dev = planes_dev
        self.packed = packed
        self.shapes = shapes
        self.bd = bd
        self.pad = pad
        self._planes = None
        self._event = None
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=packed.dtype,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = packed

    def resolve(self) -> list[np.ndarray]:
        """Blocking readback -> int32 planes (unpacked on host)."""
        if self._planes is None:
            with profiler.stage("readback"):
                if self._event is not None:
                    with profiler.stage("wait: readback"):
                        self._event.synchronize()
                raw = self._host.numpy()
            if self.bd <= 8:
                flat = raw.astype(np.int32)
            else:
                b = raw.reshape(-1, 5).astype(np.int32)
                flat = np.empty(b.shape[0] * 4, dtype=np.int32)
                flat[0::4] = b[:, 0] | ((b[:, 1] & 3) << 8)
                flat[1::4] = (b[:, 1] >> 2) | ((b[:, 2] & 15) << 6)
                flat[2::4] = (b[:, 2] >> 4) | ((b[:, 3] & 63) << 4)
                flat[3::4] = (b[:, 3] >> 6) | (b[:, 4] << 2)
            if self.pad:
                flat = flat[:-self.pad]
            planes = []
            pos = 0
            for (hh, ww) in self.shapes:
                planes.append(flat[pos:pos + hh * ww].reshape(hh, ww))
                pos += hh * ww
            self._planes = planes
            self.planes_dev = None
            self.packed = None
            self._host = None
        return self._planes


def filter_frame_device(cs, planes) -> PendingFrame:
    """Run the device filter chain for one reconstructed frame (planes:
    int32 tensors on the device).  Returns a PendingFrame whose readback
    has already started."""
    reason = device_filter_reject_reason(cs)
    if reason is not None:
        raise NotImplementedError(f"device_filter:{reason}")
    num_comp = cs.num_comp
    shapes = [tuple(p.shape) for p in planes[:num_comp]]
    key, arrays = _frame_key_arrays(cs, shapes)
    dev = planes[0].device
    with timed_stage("filter: params", dev):
        fn = _chain_fn(key)
        flat = upload(_flat_pack(key, arrays), dev,
                      "wait: upload filter params")
    # the chain times its own stages: filter: deblock, sao, alf, pack
    out_planes, packed = fn(tuple(planes[:num_comp]), flat)
    return PendingFrame(out_planes, packed, shapes, cs.sps.bit_depth,
                        key[-1])


_BANK_NAMES = (("banks_co", "banks_cl"), ("cbanks_co", "cbanks_cl"),
               ("cc_banks",))


def batch_key(per, at: int):
    """The one static key of a batch of pictures [(key, arrays), ...]
    whose keys may differ only in their three bank counts (key[at],
    key[at + 1], key[at + 2]: luma, chroma and CC-ALF banks).  Those
    become the batch's largest, and each picture's banks are padded in
    place with zero banks, which none of its CTUs selects, so every
    picture filters as it does alone.  Raises when another field of the
    keys differs."""
    keys = [k for k, _ in per]
    if len({k[:at] + k[at + 3:] for k in keys}) != 1:
        raise ValueError("pictures in one batch must share the static "
                         "filter config")
    counts = [max(k[at + i] for k in keys) for i in range(3)]
    for _, arrays in per:
        for names, n in zip(_BANK_NAMES, counts):
            for name in names:
                if name in arrays:
                    a = np.asarray(arrays[name])
                    arrays[name] = np.pad(
                        a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
    return keys[0][:at] + tuple(counts) + keys[0][at + 3:]


def filter_frames_device_batch(items) -> list[PendingFrame]:
    """Filter a batch of pictures [(cs, planes), ...] of one geometry and
    filter config in one pass, the frames stacked on a leading axis
    (planes: int32 tensors on one device).  Their ALF bank counts may
    differ (`batch_key`).  Returns one PendingFrame per picture, each
    with its readback started."""
    for cs, _ in items:
        reason = device_filter_reject_reason(cs)
        if reason is not None:
            raise NotImplementedError(f"device_filter:{reason}")
    num_comp = items[0][0].num_comp
    per = [_frame_key_arrays(cs, [tuple(p.shape) for p in planes[:num_comp]])
           for cs, planes in items]
    key = batch_key(per, 16)
    shapes = [tuple(p.shape) for p in items[0][1][:num_comp]]
    dev = items[0][1][0].device
    with timed_stage("filter: params", dev):
        fn = _chain_fn(key)
        flat = upload(
            np.stack([_flat_pack(key, arrays) for _, arrays in per]), dev,
            "wait: upload filter params")
        planes = tuple(torch.stack([p[c] for _, p in items])
                       for c in range(num_comp))
    out_planes, packed = fn(planes, flat)
    return [PendingFrame(tuple(o[i] for o in out_planes), packed[i], shapes,
                         key[4], key[-1]) for i in range(len(items))]
