"""Device intra prediction: the whole-frame intra chain as a wavefront
over dependency levels, each step reconstructing up to K independent
prediction units at once.

Port of vvdec_tpu/ops/intra_device.py (the wavefront path, mode classes
0-4: planar, DC and angular with PDPC, reference smoothing and the
cubic / gauss / chroma interpolation filters; MIP; CCLM off the luma
plane as the earlier steps left it; intra LMCS: the VPDU chroma
residual scale and the inverse luma map; the CIIP blend, class 5,
over the raw inter prediction the MC stage left in the plane), and the
sequential scan (`_intra_scan_fn`, one unit a step, `run_intra_scan(...,
scan="seq")`), the parity baseline the wavefront reorders.

The reference-sample geometry (availability, substitution, replication;
xFillReferenceSamples, IntraPrediction.cpp:1161) is value-independent,
so the host compiles each unit into a 33-int descriptor row
(`build_intra_descriptors`: in C from the syntax walk's records,
csrc/plan_host.c, or in `build_intra_descriptors_py`, copied from the
reference as it stands, its plain twin) and groups rows into steps of
independent units (`compute_unit_levels`, `build_wavefront_batches`,
and `wavefront_step_levels`, the level of each step).  On the card one
launch of the hand-written kernel csrc/intra_wavefront.cu runs every
step of a picture
(`ops/cuda/intra.intra_wavefront_cuda`), as the JAX package's one
`lax.scan` + `lax.switch` program a picture does, but a dependency level
at a time over a thread-block cluster; on the CPU its plain version
(`intra_wavefront_ref`) runs one Python loop iteration a level and mode
class: gather the references of the level's units, predict, add the
residual, then write the level's blocks, with the mode classes read from
the host's numpy batches.
The helpers below are that plain version's: the JAX package's `vmap`
over K becomes a leading batch dimension; its one-hot float matmul
gathers become integer indexing that returns 0 outside the source, as
the one-hot product did; `lax.dynamic_slice` / `dynamic_update_slice`
windows keep their start clamping (`_win_start`), and plain JAX gathers
keep theirs (`_jidx`: a negative index wraps once, then the index is
clamped).  MIP's int32 matrix product becomes a multiply-and-sum.

Bit-exact parity targets: IntraPrediction::predIntraAng
(IntraPrediction.cpp:471), xFillReferenceSamples (:1161),
xFilterReferenceSamples; the host golden is frame/recon_np.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vvdec_tpu_torch.ops.cuda.intra import (
    const_tables,
    intra_consts,
    intra_wavefront_cuda,
)
from vvdec_tpu_torch.ops.tables import (
    ANG_TABLE,
    INTRA_FILTER_THRESH,
    INV_ANG_TABLE,
)
from vvdec_tpu_torch.utils.trace import profiler

B = 64     # max prediction block side (the padded compute tile)
PB = 64    # plane bottom/right padding (allows 64x64 RMW at any origin)
RL = 132   # reference array length (2*64+1 samples + filter margin)
D = 33     # descriptor row width
H_OFF = 64           # refext negative-side extent (max side length)
RL2 = H_OFF + 128 + B + 4   # refext length: side ext + 2*64 main + taps
WAVEFRONT_K = 8      # units per wavefront step (the reference's K)

# descriptor row layout (int32):
#  0 comp; 1 x; 2 y; 3 w; 4 h; 5 log2w; 6 log2h;
#  7 mode_class (0 planar, 1 DC, 2 angular, 3 MIP, 4 CCLM, 5 CIIP);
#  8 filtered ([1 2 1] refs); 9 cbf; 10 avail0;
#  top fill:  value(i) = plane[ty_a if i < ty_k else ty_b,
#                              clamp(tx0 + i, txlo, txhi)]
#  11 ty_a; 12 ty_b; 13 ty_k; 14 tx0; 15 txlo; 16 txhi;
#  left fill: value(j) = plane[clamp(ly0 + j, lylo, lyhi),
#                              lx_a if j < lx_k else lx_b]
#  17 lx_a; 18 lx_b; 19 lx_k; 20 ly0; 21 lylo; 22 lyhi;
#  23 is_ver; 24 angle (signed); 25 inv_angle;
#  26 frac_kind (0 integer, 1 cubic, 2 gauss, 3 chroma 2-tap);
#  27 do_pdpc; 28 valid (0 = padding row)
#  LMCS chroma residual scaling (calculateChromaAdjVpduNei):
#  29 flags: bit0 scale-this-unit, bit1 vpdu-left nb, bit2 vpdu-above nb;
#  30 x_pos; 31 y_pos (luma coords of the VPDU's top-left CU); 32 rsvd
#  MIP reuses 24 mode, 25 transpose, 26 size id; CCLM reuses 23
#  build_left, 24 actual_top, 25 actual_left, 26 above | left << 1
#  avail, 27 build_above; CIIP reuses 24 w_intra, 25 w_merge.


def _col(d, k):
    """Descriptor field k of every unit as a [K, 1, 1] column."""
    return d[:, k, None, None]


def _win_start(start, size: int, dim: int):
    """The start lax.dynamic_slice uses: a negative start wraps once (to
    start + dim), then the start is clamped so the window fits."""
    return torch.clamp(torch.where(start < 0, start + dim, start), 0,
                       dim - size)


@functools.lru_cache(maxsize=None)
def _powers_of_two(maxbits: int, dtype, device):
    """[1, 2, 4, ..., 2^(maxbits-1)] on `device`, made once: a fresh
    host->device copy per wavefront step would synchronise the stream."""
    return torch.tensor([1 << m for m in range(maxbits)], dtype=dtype,
                        device=device)


def _bitlen(v, maxbits: int = 17):
    """int.bit_length for v >= 0 (exact, via compares)."""
    pw = _powers_of_two(maxbits, v.dtype, v.device)
    return (v[..., None] >= pw).sum(-1).to(torch.int32)


def _take(vec, idx):
    """vec[k, idx[k, ...]] for a batch of small vectors vec [K, n]; 0
    where idx falls outside [0, n), as the reference's one-hot gather
    matmul gives."""
    n = vec.shape[-1]
    flat = idx.reshape(idx.shape[0], -1)
    ok = (flat >= 0) & (flat < n)
    g = torch.gather(vec, 1, flat.clamp(0, n - 1).long())
    return torch.where(ok, g, torch.zeros_like(g)).reshape(idx.shape)


def _jidx(idx, n: int):
    """The index a JAX gather reads for `idx` along an axis of length n:
    a negative index wraps once, then the index is clamped to [0, n)."""
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1).long()


def _rows(a, idx):
    """a[k, idx[k, ...]] along dim 1 for in-range idx [K, ...]."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return torch.gather(a, 1, flat).reshape(idx.shape)


# ======================================================================
# LMCS (Reshape.cpp: rspCtuBcw inverse map, scaleSignal,
# calculateChromaAdjVpduNei; host golden frame/lmcs_np.py)
# ======================================================================
# lmcs parameter vector layout (int32):
#  [0:17]  reshape_pivot (17)
#  [17:33] input_pivot (16)
#  [33:49] inv_scale (16)
#  [49:65] chroma_adj_lut (16)
#  [65] min_bin; [66] max_bin; [67] pic_h; [68] pic_w
LM_LEN = 69


def build_lmcs_params(reshaper, cs) -> np.ndarray:
    lm = np.zeros(LM_LEN, dtype=np.int32)
    lm[0:17] = reshaper.reshape_pivot
    lm[17:33] = reshaper.input_pivot[:16]
    lm[33:49] = reshaper.inv_scale
    lm[49:65] = reshaper.chroma_adj_lut
    lm[65] = reshaper.min_bin
    lm[66] = reshaper.max_bin
    lm[67] = cs.h
    lm[68] = cs.w
    return lm


def _sel16(lm, base: int, idx):
    """lm[base + idx] over the 17-entry (base 0) or 16-entry table at
    base; 0 where idx falls outside the table, as the reference's masked
    sum gives."""
    n = 17 if base == 0 else 16
    v = lm[base + idx.clamp(0, n - 1).long()]
    return torch.where((idx >= 0) & (idx < n), v, torch.zeros_like(v))


def _pwl_idx_inv_dev(v, lm):
    """getPWLIdxInv: min_bin + the count of pivots in [min_bin, max_bin]
    that v reaches, clipped to 15."""
    i = torch.arange(16, device=v.device, dtype=torch.int32)
    hit = (i >= lm[65]) & (i <= lm[66]) & (v[..., None] >= lm[1:17])
    return torch.clamp(lm[65] + hit.sum(-1, dtype=torch.int32), max=15)


def _scale_signal_dev(r, scale, bd: int):
    """AreaBuf::scaleSignal: sign-symmetric fixed-point residual scale."""
    max_abs = (1 << bd) - 1
    rc = torch.clamp(r, -max_abs - 1, max_abs)
    sign = 1 - 2 * (rc < 0).to(torch.int32)
    val = sign * ((sign * rc * scale + (1 << 10)) >> 11)
    return torch.clamp(val, -32768, 32767)


def _chroma_scale_dev(luma, d, lm, bd: int, num_nb: int):
    """calculateChromaAdjVpduNei for K units: the average of the luma
    (reshaped domain) left of and above each unit's VPDU top-left CU,
    read through windows clamped as lax.dynamic_slice clamps them, then
    the chroma scale of its bin.  Returns [K] int32."""
    hh, ww = luma.shape
    xpos, ypos = d[:, 30, None], d[:, 31, None]
    left_ok = (d[:, 29] & 2) != 0
    above_ok = (d[:, 29] & 4) != 0
    log_nb = num_nb.bit_length() - 1
    jv = torch.arange(num_nb, device=luma.device,
                      dtype=torch.int32)[None, :]

    def weights(lim):
        return torch.where(jv < lim - 1, 1,
                           torch.where(jv == lim - 1, num_nb - lim + 1, 0))

    r0 = _win_start(ypos, num_nb, hh)
    c0 = _win_start(torch.clamp(xpos - 1, min=0), 1, ww)
    colw = luma[(r0 + jv).long(), c0.long()]
    sum_l = (colw * weights(torch.clamp(lm[67] - ypos, 1, num_nb))) \
        .sum(-1, dtype=torch.int32)
    r1 = _win_start(torch.clamp(ypos - 1, min=0), 1, hh)
    c1 = _win_start(xpos, num_nb, ww)
    roww = luma[r1.long(), (c1 + jv).long()]
    sum_t = (roww * weights(torch.clamp(lm[68] - xpos, 1, num_nb))) \
        .sum(-1, dtype=torch.int32)
    zero = torch.zeros_like(sum_l)
    rec_sum = torch.where(left_ok, sum_l, zero) \
        + torch.where(above_ok, sum_t, zero)
    pelnum = left_ok.to(torch.int32) + above_ok.to(torch.int32)
    v1 = (rec_sum + (1 << (log_nb - 1))) >> log_nb
    v2 = (rec_sum + (1 << log_nb)) >> (log_nb + 1)
    luma_val = torch.where(pelnum == 1, v1,
                           torch.where(pelnum == 2, v2,
                                       torch.full_like(v1, 1 << (bd - 1))))
    return _sel16(lm, 49, _pwl_idx_inv_dev(luma_val, lm))


def lmcs_inv_map(plane, lm, bd: int):
    """Inverse luma mapping (the RSP stage): piecewise-linear evaluation
    bit-equal to the host's inv_lut (built with the same formula)."""
    idx = _pwl_idx_inv_dev(plane, lm)
    piv = _sel16(lm, 0, idx)
    ipiv = _sel16(lm, 17, idx)
    isc = _sel16(lm, 33, idx)
    out = ipiv + ((isc * (plane - piv) + (1 << 10)) >> 11)
    return torch.clamp(out, 0, (1 << bd) - 1)


def _gather_refs(P, d, bd: int):
    """Reference arrays top[K, RL], left[K, RL] (index 0 = corner) of K
    units in the stacked planes P [3, H, W] (H, W >= RL), already
    smoothed where the descriptor says so (xFillReferenceSamples +
    xFilterReferenceSamples).

    Reads the same 2-row / 2-column windows as the reference, with the
    same clamped window starts, so the remapped fill indices agree with
    it in every case, including indices the clamp pushes out of the
    window (those read 0)."""
    _, hp, wp = P.shape
    dev = P.device
    i = torch.arange(RL, device=dev, dtype=torch.int32)[None, :]
    Pf = P.reshape(-1)
    base = (torch.clamp(d[:, 0], 0, 2).long() * (hp * wp))[:, None]
    # top run: value(i) = plane[ty(i), clip(tx0+i, txlo, txhi)]
    rt0 = torch.clamp(torch.minimum(d[:, 11], d[:, 12]), 0, hp - 2)
    ct0 = torch.clamp(d[:, 15], 0, wp - RL)[:, None]
    row_a = rt0 + (d[:, 11] != rt0).to(torch.int32)
    row_b = rt0 + (d[:, 12] != rt0).to(torch.int32)
    jt = torch.clamp(d[:, 14, None] + i, d[:, 15, None], d[:, 16, None]) - ct0
    rows = torch.where(i < d[:, 13, None], row_a[:, None], row_b[:, None])
    ok = (jt >= 0) & (jt < RL)
    idx = base + rows.long() * wp + (ct0 + jt.clamp(0, RL - 1)).long()
    top = torch.where(ok, Pf[idx], torch.zeros_like(jt))
    # left run: value(j) = plane[clip(ly0+j, lylo, lyhi), lx(j)]
    rl0 = torch.clamp(d[:, 21], 0, hp - RL)[:, None]
    cl0 = torch.clamp(torch.minimum(d[:, 17], d[:, 18]), 0, wp - 2)
    col_a = cl0 + (d[:, 17] != cl0).to(torch.int32)
    col_b = cl0 + (d[:, 18] != cl0).to(torch.int32)
    jl = torch.clamp(d[:, 20, None] + i, d[:, 21, None], d[:, 22, None]) - rl0
    cols = torch.where(i < d[:, 19, None], col_a[:, None], col_b[:, None])
    ok = (jl >= 0) & (jl < RL)
    idx = base + (rl0 + jl.clamp(0, RL - 1)).long() * wp + cols.long()
    left = torch.where(ok, Pf[idx], torch.zeros_like(jl))
    na = d[:, 10, None] == 1
    dcv = torch.full_like(top, 1 << (bd - 1))
    top = torch.where(na, dcv, top)
    left = torch.where(na, dcv, left)
    # [1 2 1] smoothing; interior only, shared filtered corner
    w2 = 2 * d[:, 3, None]
    h2 = 2 * d[:, 4, None]
    tm1 = torch.cat([top[:, :1], top[:, :-1]], 1)
    tp1 = torch.cat([top[:, 1:], top[:, -1:]], 1)
    lm1 = torch.cat([left[:, :1], left[:, :-1]], 1)
    lp1 = torch.cat([left[:, 1:], left[:, -1:]], 1)
    c = ((left[:, 1] + 2 * top[:, 0] + top[:, 1] + 2) >> 2)[:, None]
    ft = torch.where((i >= 1) & (i <= w2 - 1),
                     (tm1 + 2 * top + tp1 + 2) >> 2, top)
    ft = torch.where(i == 0, c, ft)
    fl = torch.where((i >= 1) & (i <= h2 - 1),
                     (lm1 + 2 * left + lp1 + 2) >> 2, left)
    fl = torch.where(i == 0, c, fl)
    use_f = d[:, 8, None] == 1
    return torch.where(use_f, ft, top), torch.where(use_f, fl, left)


def _grid(dev):
    """Row and column index grids [1, B, 1] and [1, 1, B]."""
    a = torch.arange(B, device=dev, dtype=torch.int32)
    return a[None, :, None], a[None, None, :]


def _pred_planar(top, left, d):
    w, h, l2w, l2h = (_col(d, k) for k in (3, 4, 5, 6))
    ys, xs = _grid(top.device)
    topv = top[:, None, 1:B + 1]
    leftv = left[:, 1:B + 1, None]
    tr = torch.gather(top, 1, (w[:, 0] + 1).long())[:, :, None]
    bl = torch.gather(left, 1, (h[:, 0] + 1).long())[:, :, None]
    hor = (leftv << l2w) + (xs + 1) * (tr - leftv)
    ver = (topv << l2h) + (ys + 1) * (bl - topv)
    off = 1 << (l2w + l2h)
    return ((hor << l2h) + (ver << l2w) + off) >> (1 + l2w + l2h)


def _pred_dc(top, left, d):
    w, h, l2w, l2h = (d[:, k, None] for k in (3, 4, 5, 6))
    i = torch.arange(RL, device=top.device, dtype=torch.int32)[None, :]
    zero = torch.zeros_like(top)
    st = torch.where((i >= 1) & (i <= w), top, zero).sum(1, keepdim=True)
    sl = torch.where((i >= 1) & (i <= h), left, zero).sum(1, keepdim=True)
    s = torch.where(w >= h, st, 0) + torch.where(w <= h, sl, 0)
    shift = torch.where(w == h, l2w + 1, torch.maximum(l2w, l2h))
    dc = (s + (1 << torch.clamp(shift - 1, min=0))) >> shift
    return dc.to(torch.int32)[:, :, None].expand(-1, B, B)


def _pdpc_dc_planar(pred, top, left, d):
    l2w, l2h = _col(d, 5), _col(d, 6)
    scale = torch.clamp((l2w + l2h - 2) >> 2, min=0)
    ys, xs = _grid(pred.device)
    wt = 32 >> torch.clamp((2 * ys) >> scale, max=31)
    wl = 32 >> torch.clamp((2 * xs) >> scale, max=31)
    lv = left[:, 1:B + 1, None]
    tv = top[:, None, 1:B + 1]
    return pred + ((wl * (lv - pred) + wt * (tv - pred) + 32) >> 6)


def _shifted_windows(vec, starts, width: int):
    """out[k, r, u] = vec[k, starts[k, r] + u] for u < width, with vec
    zero-extended by `width` on the right and rows whose start lies
    outside [0, n) all zero: the reference's one-hot [rows, n] @
    [n, width] window matmul over a zero-padded source."""
    n = vec.shape[1]
    ext = torch.cat([vec, torch.zeros((vec.shape[0], width), dtype=vec.dtype,
                                      device=vec.device)], 1)
    u = torch.arange(width, device=vec.device, dtype=torch.int32)
    idx = (starts[:, :, None] + u).clamp(0, n + width - 1)
    g = torch.gather(ext, 1, idx.reshape(vec.shape[0], -1).long()) \
        .reshape(idx.shape)
    ok = ((starts >= 0) & (starts < n))[:, :, None]
    return torch.where(ok, g, torch.zeros_like(g))


def _pred_angular(top, left, d, pel_max: int, cf, gf, kinds=None):
    """xPredIntraAng in the swapped (main-reference) space; transposed
    back for horizontal modes.  The reference row is assembled once as
    refext[j] = main[clip(j-H_OFF, 0, 2wp)] (or the inverse-angle side
    projection for j < H_OFF), and each output row's taps come from one
    contiguous window of it.  `kinds`, when the caller knows them from
    the host descriptors, limits the interpolation filters evaluated to
    those some unit uses."""
    dev = top.device
    w, h, l2w, l2h = (d[:, k, None] for k in (3, 4, 5, 6))
    is_ver = d[:, 23, None] == 1
    wp = torch.where(is_ver, w, h)
    hp = torch.where(is_ver, h, w)
    l2wp = torch.where(is_ver, l2w, l2h)
    l2hp = torch.where(is_ver, l2h, l2w)
    main = torch.where(is_ver, top, left)
    side = torch.where(is_ver, left, top)
    angle = d[:, 24, None]
    inv = d[:, 25, None]
    ar = torch.arange(B, device=dev, dtype=torch.int32)[None, :]
    delta = angle * (ar + 1)                  # [K, B] per row
    di = delta >> 5
    frac = delta & 31

    m = torch.arange(RL2, device=dev, dtype=torch.int32)[None, :] - H_OFF
    mains = _take(main, torch.minimum(m.clamp(min=0), 2 * wp))
    sidx = torch.clamp(torch.minimum(((-m) * inv + 256) >> 9, hp), 0, RL - 1)
    refext = torch.where(m < 0, _take(side, sidx), mains)
    starts = H_OFF + torch.minimum(di, 2 * wp)
    wnd = _shifted_windows(refext, starts, B + 4)   # [K, B, B+4]

    kind = torch.clamp(d[:, 26], 0, 3)
    if kinds is None:
        kinds = (1, 2, 3)
    dst = wnd[:, :, 1:B + 1]
    fr = frac[:, :, None]

    def four_tap(tab):
        co = tab[frac.long()]                 # [K, B, 4]
        return (co[..., 0:1] * wnd[:, :, 0:B]
                + co[..., 1:2] * wnd[:, :, 1:B + 1]
                + co[..., 2:3] * wnd[:, :, 2:B + 2]
                + co[..., 3:4] * wnd[:, :, 3:B + 3] + 32) >> 6

    kk = kind[:, None, None]
    if 1 in kinds:
        dst = torch.where(kk == 1, torch.clamp(four_tap(cf), 0, pel_max), dst)
    if 2 in kinds:
        dst = torch.where(kk == 2, four_tap(gf), dst)
    if 3 in kinds:
        dst = torch.where(kk == 3, ((32 - fr) * wnd[:, :, 1:B + 1]
                                    + fr * wnd[:, :, 2:B + 2] + 16) >> 5,
                          dst)

    do_pdpc = _col(d, 27) == 1
    ys, xs = _grid(dev)
    # positive-angle PDPC (side projection weights): lv[y, x] =
    # side[min(y + g(x), 2hp)]
    scale_a = torch.clamp(l2hp - (_bitlen(3 * inv - 2) - 1 - 8), max=2)
    sa = torch.clamp(scale_a, 0, 31)[:, :, None]
    nx = torch.minimum(3 << sa, wp[:, :, None])
    g = ((256 + inv * (ar + 1)) >> 9) + 1            # [K, B] per column
    wl = 32 >> torch.clamp((2 * xs) >> sa, max=31)
    next_ = 128 + B + 1
    sj = torch.arange(next_, device=dev, dtype=torch.int32)[None, :]
    sideext = _take(side, torch.clamp(torch.minimum(sj, 2 * hp), 0, RL - 1))
    gs = torch.clamp(g, 0, next_ - B)
    lv = _shifted_windows(sideext, gs, B).transpose(1, 2)
    add = (wl * (lv - dst) + 32) >> 6
    m_pos = do_pdpc & (angle[:, :, None] > 0) & (scale_a[:, :, None] >= 0) \
        & (xs < nx)
    dst = torch.where(m_pos, dst + add, dst)
    # pure hor/ver PDPC (angle == 0): refmain(1+xs) = refext[H_OFF+1+x]
    scale0 = torch.clamp((l2wp + l2hp - 2) >> 2, min=0)[:, :, None]
    lev = torch.minimum(3 << scale0, wp[:, :, None])
    wl0 = 32 >> torch.clamp((2 * xs) >> scale0, max=31)
    corner = side[:, 0, None, None]
    mrow = refext[:, None, H_OFF + 1:H_OFF + 1 + B]
    v0 = torch.clamp((wl0 * (left_of(side) - corner) + mrow * 64 + 32) >> 6,
                     0, pel_max)
    m0 = do_pdpc & (angle[:, :, None] == 0) & (xs < lev)
    dst = torch.where(m0, v0, dst)
    return torch.where(is_ver[:, :, None], dst, dst.transpose(1, 2))


def left_of(side):
    """side[1..B] as a column per unit: [K, B, 1]."""
    return side[:, 1:B + 1, None]


def _mip_matrices(device):
    """The three MIP matrix sets on `device`: views of intra_consts."""
    t = const_tables(intra_consts(device))
    return t["mip4"], t["mip8"], t["mip16"]


def _pred_mip(top, left, d, bd: int, sids=(0, 1, 2)):
    """Matrix intra prediction of K units: Haar boundary downsample, the
    rebased matrix product of each unit's size class (d[26]) and mode
    (d[24]), transpose (d[25]), linear upsampling.  Parity:
    Mip::PredictorMIP (MatrixIntraPrediction.cpp:60) / recon_np.pred_mip.
    `sids`, when the caller knows them, limits the size classes whose
    products are evaluated."""
    dev = top.device
    K = top.shape[0]
    w, h, l2w, l2h = (d[:, k, None] for k in (3, 4, 5, 6))     # [K, 1]
    mode = d[:, 24]
    transpose = (d[:, 25] == 1)[:, None, None]
    sid = d[:, 26, None]
    pel_max = (1 << bd) - 1
    ar = torch.arange(B, device=dev, dtype=torch.int32)
    # Haar downsample to bdry samples per side: group sums over
    # i >> lgf == g, i < side (lgf == 0 copies)
    log2bdry = 2 - (sid == 0).to(torch.int32)
    bdry = 1 << log2bdry
    g4 = torch.arange(4, device=dev, dtype=torch.int32)[None, :, None]

    def reduce(ref, side, l2):
        lgf = torch.clamp(l2 - log2bdry, min=0)
        m = ((ar[None, None, :] >> lgf[:, :, None]) == g4) \
            & (ar[None, None, :] < side[:, :, None])
        s = torch.where(m, ref[:, None, 1:B + 1], 0).sum(-1, dtype=torch.int32)
        rnd = (s + (1 << torch.clamp(lgf - 1, min=0))) >> lgf
        return torch.where(lgf > 0, rnd, s)

    t_red = reduce(top, w, l2w)                                # [K, 4]
    l_red = reduce(left, h, l2h)
    k8 = torch.arange(8, device=dev, dtype=torch.int32)[None, :]
    i_lo = torch.clamp(k8, 0, 3).expand(K, 8)
    i_hi = torch.clamp(k8 - bdry, 0, 3)
    lo = k8 < bdry
    bound = torch.where(lo, _rows(t_red, i_lo), _rows(l_red, i_hi))
    bound_t = torch.where(lo, _rows(l_red, i_lo), _rows(t_red, i_hi))
    inp0 = torch.where(transpose[:, 0], bound_t, bound)
    in_off = inp0[:, :1]
    first = torch.where(sid < 2, (1 << (bd - 1)) - in_off, 0)
    inp = torch.where(k8 == 0, first, inp0 - in_off)
    inp = torch.where(k8 < 2 * bdry, inp, 0)
    offset = 32 - 32 * inp.sum(-1, keepdim=True, dtype=torch.int32)
    # the int32 matrix product of each size class, as multiply-and-sum
    m4, m8, m16 = _mip_matrices(dev)
    classes = ((m4, 15, slice(0, 4), 4), (m8, 7, slice(0, 8), 4),
               (m16, 5, slice(1, 8), 8))
    pred = torch.zeros((K, 8, 8), dtype=torch.int32, device=dev)
    sid_c = torch.clamp(sid[:, 0], 0, 2)[:, None, None]
    for s in sids:
        mats, top_mode, cols, n = classes[s]
        mat = mats[torch.clamp(mode, 0, top_mode).long()]     # [K, P, I]
        acc = (mat * inp[:, None, cols]).sum(-1, dtype=torch.int32)
        o = torch.clamp(((acc + offset) >> 6) + in_off, 0, pel_max)
        blk = torch.zeros_like(pred)
        blk[:, :n, :n] = o.view(K, n, n)
        pred = torch.where(sid_c == s, blk, pred)
    pred = torch.where(transpose, pred.transpose(1, 2), pred)
    # linear upsampling (the formula degrades to a copy when up == 1)
    log2red = 3 - (sid < 2).to(torch.int32)
    lg_h = torch.clamp(l2w - log2red, min=0)[:, :, None]       # [K, 1, 1]
    lg_v = torch.clamp(l2h - log2red, min=0)[:, :, None]
    up_h = 1 << lg_h
    up_v = 1 << lg_v
    xs = ar[None, None, :]
    ys = ar[None, :, None]
    j = xs >> lg_h                                             # [K, 1, B]
    rowsel = pred[:, torch.clamp(ar, 0, 7).long(), :]          # [K, B, 8]
    bh = torch.gather(rowsel, 2, torch.clamp(j, 0, 7).long().expand(K, B, B))
    pv_in = torch.gather(rowsel, 2,
                         torch.clamp(j - 1, 0, 7).long().expand(K, B, B))
    pv0 = _rows(left, torch.clamp((ar[None, :] + 1) * up_v[:, 0], 0, RL - 1))
    pv = torch.where(j == 0, pv0[:, :, None], pv_in)
    ro_h = torch.where(lg_h > 0, 1 << torch.clamp(lg_h - 1, min=0), 0)
    hor = (pv * up_h + ro_h + ((xs & (up_h - 1)) + 1) * (bh - pv)) >> lg_h
    yv = ys >> lg_v                                            # [K, B, 1]
    bh2 = torch.gather(hor, 1,
                       torch.clamp(yv, 0, B - 1).long().expand(K, B, B))
    pv2_in = torch.gather(hor, 1,
                          torch.clamp(yv - 1, 0, B - 1).long().expand(K, B, B))
    pv2 = torch.where(yv == 0, top[:, None, 1:B + 1], pv2_in)
    ro_v = torch.where(lg_v > 0, 1 << torch.clamp(lg_v - 1, min=0), 0)
    return (pv2 * up_v + ro_v + ((ys & (up_v - 1)) + 1) * (bh2 - pv2)) >> lg_v


_CCLM_DIV = (0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0)


def _cclm_div(device):
    """The CCLM division table on `device`: a view of intra_consts."""
    return const_tables(intra_consts(device))["cclm_div"]


def _pred_cclm(top, left, d, luma, bd: int, cfmt: int, collocated: bool,
               ctu_log2: int):
    """Cross-component linear model chroma prediction of K units: 4-point
    template sampling off the luma plane `luma` ([hh, ww], as the earlier
    steps left it), the min/max parameter fit, then the dense downsample
    and linear transform.  Parity: recon_np.pred_cclm
    (xGetLumaRecPixels/xGetLMParameters/predIntraChromaLM).  Luma reads
    wrap negative rows and columns once at lh / lw (the plane less its
    PB padding) and clamp at lh - 1 / lw - 1, as the host golden does;
    the JAX gather's own wrap and clamp at hh / ww follow (`_jidx`)."""
    dev = top.device
    pel_max = (1 << bd) - 1
    cx, cy = d[:, 1, None], d[:, 2, None]                      # [K, 1]
    build_above = d[:, 27, None] == 1
    build_left = d[:, 23, None] == 1
    actual_top = d[:, 24, None]
    actual_left = d[:, 25, None]
    above_avail = (d[:, 26, None] & 1) == 1
    left_avail = (d[:, 26, None] & 2) == 2
    sub_w = 2 if cfmt in (1, 2) else 1
    sub_h = 2 if cfmt == 1 else 1
    mult, rec2 = sub_w, sub_h
    stro = 0 if sub_w == 1 else 1
    hh, ww = luma.shape
    lh, lw = hh - PB, ww - PB
    lx, ly = cx * sub_w, cy * sub_h
    first_row = (ly & ((1 << ctu_log2) - 1)) == 0
    if cfmt == 2:      # 4:2:2
        t3 = (2, 1, 1, 2, 2)
        t5 = (0, 2, 1, 1, 0, 2, 2)
        t6 = (2, 1, 1, 0, 0, 0, 2, 2)
    elif cfmt == 3:    # 4:4:4
        t3 = (1, 0, 0, 0, 0)
        t5 = (0, 1, 0, 0, 0, 0, 0)
        t6 = (1, 0, 0, 0, 0, 0, 0, 0)
    else:              # 4:2:0
        t3 = (2, 1, 1, 2, 2)
        t5 = (1, 4, 1, 1, 1, 4, 3)
        t6 = (2, 1, 1, 2, 1, 1, 4, 3)
    flat = luma.reshape(-1)

    def lum(r, c):
        r = _jidx(torch.clamp(torch.where(r < 0, r + lh, r), max=lh - 1), hh)
        c = _jidx(torch.clamp(torch.where(c < 0, c + lw, c), max=lw - 1), ww)
        return flat[r * ww + c]

    def taps(coef, points, rnd, shift):
        """(sum of coef * lum(point) + rnd) >> shift, zero taps skipped."""
        acc = None
        for k, (r, c) in zip(coef, points):
            if k:
                v = k * lum(r, c)
                acc = v if acc is None else acc + v
        return (acc + rnd) >> shift

    def ds_top(i):
        xx = lx + mult * i
        left_tap = torch.where((i == 0) & ~build_left, xx, xx - 1)
        r3 = ly - 1
        v3 = taps(t3[:3], ((r3, xx), (r3, left_tap), (r3, xx + 1)),
                  t3[3], t3[4])
        r = ly - rec2
        if collocated:
            vn = taps(t5[:5], ((r - stro, xx), (r, xx), (r, left_tap),
                               (r, xx + 1), (r + stro, xx)), t5[5], t5[6])
        else:
            vn = taps(t6[:6], ((r, xx), (r, left_tap), (r, xx + 1),
                               (r + stro, xx), (r + stro, left_tap),
                               (r + stro, xx + 1)), t6[6], t6[7])
        return torch.where(first_row, v3, vn)

    def ds_left(j):
        yy = ly + rec2 * j
        base = lx - 2 - (sub_w - 1)
        if collocated:
            top_tap = torch.where((j == 0) & ~build_above, yy, yy - stro)
            return taps(t5[:5], ((top_tap, base + 1), (yy, base + 1),
                                 (yy, base), (yy, base + 2),
                                 (yy + stro, base + 1)), t5[5], t5[6])
        return taps(t6[:6], ((yy, base + 1), (yy, base), (yy, base + 2),
                             (yy + stro, base + 1), (yy + stro, base),
                             (yy + stro, base + 2)), t6[6], t6[7])

    above_is4 = (~left_avail).to(torch.int32)
    left_is4 = (~above_avail).to(torch.int32)
    start_t = actual_top >> (2 + above_is4)
    step_t = torch.clamp(actual_top >> (1 + above_is4), min=1)
    start_l = actual_left >> (2 + left_is4)
    step_l = torch.clamp(actual_left >> (1 + left_is4), min=1)
    cnt_t = torch.where(above_avail,
                        torch.minimum(actual_top, (1 + above_is4) << 1), 0)
    cnt_l = torch.where(left_avail,
                        torch.minimum(actual_left, (1 + left_is4) << 1), 0)
    k4 = torch.arange(4, device=dev, dtype=torch.int32)[None, :]
    pos_t = start_t + k4 * step_t                              # [K, 4]
    pos_l = start_l + torch.clamp(k4 - cnt_t, min=0) * step_l
    lum_t = ds_top(pos_t)
    chr_t = _rows(top, torch.clamp(1 + pos_t, 0, RL - 1))
    lum_l = ds_left(pos_l)
    chr_l = _rows(left, torch.clamp(1 + pos_l, 0, RL - 1))
    use_t = k4 < cnt_t
    use_l = (k4 >= cnt_t) & (k4 < cnt_t + cnt_l)
    sel_l = torch.where(use_t, lum_t, torch.where(use_l, lum_l, 0))
    sel_c = torch.where(use_t, chr_t, torch.where(use_l, chr_l, 0))
    # two samples: duplicate the pair ([1], [0], [1], [0])
    two = (cnt_t + cnt_l) == 2
    # (a flip, not a list index: that would be a host->device copy)
    sel_l = torch.where(two, sel_l[:, :2].flip(1).repeat(1, 2), sel_l)
    sel_c = torch.where(two, sel_c[:, :2].flip(1).repeat(1, 2), sel_c)
    # min/max grouping (xGetLMParameters sorting network): min group
    # (0, 2), max group (1, 3)
    m0l, m0c, m1l, m1c = sel_l[:, 0:1], sel_c[:, 0:1], sel_l[:, 2:3], \
        sel_c[:, 2:3]
    x0l, x0c, x1l, x1c = sel_l[:, 1:2], sel_c[:, 1:2], sel_l[:, 3:4], \
        sel_c[:, 3:4]

    def swap(cond, a, b):
        """(a, b) exchanged where cond, as pairs (luma, chroma)."""
        return (torch.where(cond, b[0], a[0]), torch.where(cond, b[1], a[1]),
                torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1]))

    m0l, m0c, m1l, m1c = swap(m0l > m1l, (m0l, m0c), (m1l, m1c))
    x0l, x0c, x1l, x1c = swap(x0l > x1l, (x0l, x0c), (x1l, x1c))
    c_sw = m0l > x1l
    m0l, m0c, x0l, x0c = swap(c_sw, (m0l, m0c), (x0l, x0c))
    m1l, m1c, x1l, x1c = swap(c_sw, (m1l, m1c), (x1l, x1c))
    m1l, m1c, x0l, x0c = swap(m1l > x0l, (m1l, m1c), (x0l, x0c))
    min_l = (m0l + m1l + 1) >> 1
    min_c = (m0c + m1c + 1) >> 1
    max_l = (x0l + x1l + 1) >> 1
    max_c = (x0c + x1c + 1) >> 1

    diff = max_l - min_l
    diff_c = max_c - min_c
    xsh = _bitlen(torch.clamp(diff, min=0)) - 1
    norm_diff = ((diff << 4) >> torch.clamp(xsh, 0, 31)) & 15
    v = _cclm_div(dev)[norm_diff.long()] | 8
    xsh = xsh + (norm_diff != 0).to(torch.int32)
    ysh = torch.where(diff_c == 0, 0, _bitlen(torch.abs(diff_c)))
    ysh_c = torch.clamp(ysh, 0, 31)
    a = (diff_c * v + ((1 << ysh_c) >> 1)) >> ysh_c
    shift = 3 + xsh - ysh
    sat = 15 - 30 * (a < 0).to(torch.int32)
    a = torch.where(shift < 1, torch.where(a == 0, 0, sat), a)
    shift = torch.clamp(shift, min=1)
    b = min_c - ((a * min_l) >> shift)
    fit = (left_avail | above_avail) & (diff > 0)
    a = torch.where(fit, a, 0)
    b = torch.where(left_avail | above_avail,
                    torch.where(diff > 0, b, min_c), 1 << (bd - 1))
    shift = torch.where(fit, shift, 0)

    # dense downsampled luma + linear transform on the chroma grid
    iv = torch.arange(B, device=dev, dtype=torch.int32)[None, None, :]
    jv = iv.transpose(1, 2)
    yy = ly[:, :, None] + rec2 * jv                            # [K, B, 1]
    xx = lx[:, :, None] + mult * iv                            # [K, 1, B]
    no_left = (iv == 0) & ~build_left[:, :, None]
    if collocated:
        left_tap = torch.where(no_left, xx, xx - 1)
        top_tap = torch.where((jv == 0) & ~build_above[:, :, None], yy,
                              yy - stro)
        ds = taps(t5[:5], ((top_tap, xx), (yy, xx), (yy, left_tap),
                           (yy, xx + 1), (yy + stro, xx)), t5[5], t5[6])
    else:
        lx0 = torch.where(no_left, xx, torch.clamp(xx - 1, min=0))
        xs1 = torch.clamp(xx + 1, max=lw - 1)
        ds = taps(t6[:6], ((yy, xx), (yy, lx0), (yy, xs1), (yy + stro, xx),
                           (yy + stro, lx0), (yy + stro, xs1)), t6[6],
                  t6[7])
    sh = shift[:, :, None]
    return torch.clamp(b[:, :, None] + ((a[:, :, None] * ds) >> sh), 0,
                       pel_max)


def _block_index(d, hh: int, ww: int):
    """Flat indices [K, B, B] of each unit's B x B window (start clamped
    as lax.dynamic_slice clamps it) in a stacked [3, hh, ww] plane."""
    ys, xs = _grid(d.device)
    c = torch.clamp(d[:, 0], 0, 2).long()
    y0 = _win_start(d[:, 2], B, hh).long()
    x0 = _win_start(d[:, 1], B, ww).long()
    base = (c * (hh * ww) + y0 * ww + x0)[:, None, None]
    return base + ys.long() * ww + xs.long()


def _angular_filters(device):
    """The cubic and gauss interpolation filters on `device`: views of
    intra_consts."""
    t = const_tables(intra_consts(device))
    return t["cubic"], t["gauss"]


@functools.lru_cache(maxsize=None)
def _intra_wavefront_fn(bd: int, cfmt: int, collocated: bool,
                        ctu_log2: int, K: int, has_lmcs: bool = False):
    """Wavefront-batched intra chain: every dependency step of a picture,
    each reconstructing up to K independent units (gather -> predict ->
    residual add -> masked block write into a stacked [3, H, W] plane,
    so a step can mix luma and chroma units).

    run(planes, resis, batches, lm, *, levels=None): planes / resis are
    3 padded int32 tensors on one device; batches is the host's
    [S, K, D] numpy array; lm is the build_lmcs_params table as an int32
    tensor on that device, read only with has_lmcs (then chroma
    residuals flagged in d[29] are scaled by their VPDU's luma average);
    levels is each step's dependency level (wavefront_step_levels), or
    None for one phase a step, the reference's own schedule.  Returns
    the 3 planes.  The steps run in intra_wavefront_cuda: one kernel
    launch on a CUDA device, the plain loop on the CPU, a phase (the
    steps of one level) at a time.  CCLM and the LMCS scale read the
    luma plane as the earlier levels left it.  Units of one level never
    read each other's output, so the result is bit-identical to the
    reference's step scan and to a sequential scan."""

    def run(planes, resis, batches, lm=None, *, levels=None):
        from vvdec_tpu_torch.ops.device_pipeline import timed_stage
        dev = planes[0].device
        with timed_stage("intra: planes set-up", dev):
            hh = max(max(p.shape[0] for p in planes), RL)
            ww = max(max(p.shape[1] for p in planes), RL)
            P = torch.zeros((3, hh, ww), dtype=torch.int32, device=dev)
            R = torch.zeros((3, hh, ww), dtype=torch.int32, device=dev)
            for c in range(3):
                P[c, :planes[c].shape[0], :planes[c].shape[1]] = planes[c]
                R[c, :resis[c].shape[0], :resis[c].shape[1]] = resis[c]
        with timed_stage("intra: kernel", dev):
            intra_wavefront_cuda(P, R, batches, intra_consts(dev), lm, bd=bd,
                                 cfmt=cfmt, collocated=collocated,
                                 ctu_log2=ctu_log2, K=K, has_lmcs=has_lmcs,
                                 levels=levels)
        return tuple(P[c, :planes[c].shape[0], :planes[c].shape[1]]
                     for c in range(3))

    return run


def _host_start(start: int, size: int, dim: int) -> int:
    """_win_start for one host int: the start lax.dynamic_slice uses."""
    if start < 0:
        start += dim
    return min(max(start, 0), dim - size)


def _make_unit_kernels(bd: int, cfmt: int, collocated: bool, ctu_log2: int,
                       cf, gf):
    """The 6 prediction kernels of one unit, by mode class d[7], each
    (top, left, plane, luma, d, hd) -> [1, B, B] predicted block (before
    the residual): top / left [1, RL] its references, plane [H, W] its
    component's plane, luma the luma plane, d its [1, D] descriptor row
    on the device and hd the same row on the host, which picks what the
    kernel evaluates (PDPC, the interpolation filter, the MIP size class,
    the CIIP window) without a device sync."""
    pel_max = (1 << bd) - 1

    def pdpc(p, top, left, d, hd):
        return _pdpc_dc_planar(p, top, left, d) if hd[27] == 1 else p

    def k_planar(top, left, plane, luma, d, hd):
        return pdpc(_pred_planar(top, left, d), top, left, d, hd)

    def k_dc(top, left, plane, luma, d, hd):
        return pdpc(_pred_dc(top, left, d), top, left, d, hd)

    def k_ang(top, left, plane, luma, d, hd):
        return _pred_angular(top, left, d, pel_max, cf, gf,
                             {min(max(int(hd[26]), 0), 3)})

    def k_mip(top, left, plane, luma, d, hd):
        return _pred_mip(top, left, d, bd, [min(max(int(hd[26]), 0), 2)])

    def k_cclm(top, left, plane, luma, d, hd):
        return _pred_cclm(top, left, d, luma, bd, cfmt, collocated, ctu_log2)

    def k_ciip(top, left, plane, luma, d, hd):
        # planar intra blended 1:3..3:1 with the raw inter prediction the
        # MC stage left in the plane (d[24] = w_intra, d[25] = w_merge)
        p = k_planar(top, left, plane, luma, d, hd)
        y0 = _host_start(int(hd[2]), B, plane.shape[0])
        x0 = _host_start(int(hd[1]), B, plane.shape[1])
        cur = plane[y0:y0 + B, x0:x0 + B][None]
        return (_col(d, 25) * cur + _col(d, 24) * p + 2) >> 2

    return [k_planar, k_dc, k_ang, k_mip, k_cclm, k_ciip]


def _make_unit_update(bd: int, cfmt: int, collocated: bool, ctu_log2: int,
                      cf, gf, has_lmcs: bool = False):
    """One prediction unit's gather -> predict -> reconstruct -> masked
    write, in place on its plane: update(plane, luma, resi, d, hd, lm)
    with d the unit's [1, D] device row whose comp field (d[0]) is 0,
    since `plane` is already the unit's own, and hd its host row."""
    pel_max = (1 << bd) - 1
    kernels = _make_unit_kernels(bd, cfmt, collocated, ctu_log2, cf, gf)
    num_nb = min(64, 1 << ctu_log2)

    def update(plane, luma, resi, d, hd, lm=None):
        top, left = _gather_refs(plane[None], d, bd)
        blk = kernels[min(max(int(hd[7]), 0), 5)](top, left, plane, luma,
                                                   d, hd)
        ry = _host_start(int(hd[2]), B, resi.shape[0])
        rx = _host_start(int(hd[1]), B, resi.shape[1])
        r = resi[ry:ry + B, rx:rx + B][None]
        if has_lmcs and hd[29] & 1:
            scale = _chroma_scale_dev(luma, d, lm, bd, num_nb)
            r = _scale_signal_dev(r, scale[:, None, None], bd)
        out = torch.clamp(blk + r, 0, pel_max) if hd[9] == 1 \
            else torch.clamp(blk, 0, pel_max)
        # the masked write: the unit's h x w corner of the window
        y0 = _host_start(int(hd[2]), B, plane.shape[0])
        x0 = _host_start(int(hd[1]), B, plane.shape[1])
        h, w = min(int(hd[4]), B), min(int(hd[3]), B)
        if hd[28] == 1 and h > 0 and w > 0:
            plane[y0:y0 + h, x0:x0 + w] = out[0, :h, :w].to(plane.dtype)

    return update


@functools.lru_cache(maxsize=None)
def _intra_scan_fn(bd: int, cfmt: int = 1, collocated: bool = True,
                   ctu_log2: int = 7, has_lmcs: bool = False):
    """The sequential intra scan: one unit a step, in descriptor order.

    run(planes, resis, desc, lm=None): planes / resis are 3 padded int32
    tensors on one device (planes are not modified); desc is the host's
    [n, D] descriptor array, whose rows pick each step's plane (d[0])
    and kernel (d[7]) without a device sync; lm is the LMCS table on
    that device, read only with has_lmcs.  Returns the 3 planes.  Each
    plane is first zero-padded to at least RL x RL (the reference fill's
    window), as the reference's scan pads it; a row with d[28] != 1 (a
    padding row) writes nothing.  Bit-identical to the wavefront, which
    reorders only units that do not read each other's output."""
    updates: dict = {}   # the unit update of each device

    def run(planes, resis, desc, lm=None):
        desc = np.asarray(desc)
        dev = planes[0].device
        upd = updates.get(dev)
        if upd is None:
            upd = updates[dev] = _make_unit_update(
                bd, cfmt, collocated, ctu_log2, *_angular_filters(dev),
                has_lmcs)

        def padded(p):
            out = torch.zeros((max(p.shape[0], RL), max(p.shape[1], RL)),
                              dtype=torch.int32, device=dev)
            out[:p.shape[0], :p.shape[1]] = p
            return out

        shapes = [p.shape for p in planes]
        P = [padded(p) for p in planes]
        R = [padded(r) for r in resis]
        dz = desc.copy()
        dz[:, 0] = 0
        dt = torch.as_tensor(dz, dtype=torch.int32, device=dev)
        for i in range(desc.shape[0]):
            hd = desc[i]
            if hd[28] != 1:
                continue
            c = min(max(int(hd[0]), 0), 2)
            upd(P[c], P[0], R[c], dt[i:i + 1], hd, lm)
        return tuple(p[:s[0], :s[1]] for p, s in zip(P, shapes))

    return run


def _subsampling(cfmt: int) -> tuple:
    sub_w = 2 if cfmt in (1, 2) else 1
    sub_h = 2 if cfmt == 1 else 1
    return sub_w, sub_h


def compute_unit_levels(desc: np.ndarray, cfmt: int) -> np.ndarray:
    """Exact dependency level per descriptor row (host, numpy).

    Maintains one level map per component plane (granularity 4 px luma,
    2 px chroma — every intra unit and its reference rows/columns are
    aligned to those grids).  A unit's level is 1 + the max level over
    the cells its top/left fill runs read (plus, for CCLM, the
    co-located luma region); its own block cells are then stamped with
    that level.  Cells never written (picture border, MC output,
    unavailable-substituted) stay at level 0."""
    n = desc.shape[0]
    lvl = np.zeros(n, dtype=np.int32)
    if n == 0:
        return lvl
    sub_w, sub_h = _subsampling(cfmt)
    gsh = {0: 2, 1: 1, 2: 1}
    maps = {}
    for comp in (0, 1, 2):
        sel = desc[:, 0] == comp
        if not sel.any():
            continue
        dd = desc[sel]
        hh = int(max(dd[:, 2].max() + dd[:, 4].max() * 2,
                     dd[:, 22].max() + 1)) + 4
        ww = int(max(dd[:, 1].max() + dd[:, 3].max() * 2,
                     dd[:, 16].max() + 1)) + 4
        maps[comp] = np.zeros(((hh >> gsh[comp]) + 2,
                               (ww >> gsh[comp]) + 2), dtype=np.int32)
    for i in range(n):
        d = desc[i]
        comp = int(d[0])
        g = gsh[comp]
        m = maps[comp]
        dep = 0
        if d[10] != 1:  # has references
            c0, c1 = int(d[15]) >> g, int(d[16]) >> g
            for rr in {int(d[11]), int(d[12])}:
                if rr >= 0:
                    seg = m[rr >> g, c0:c1 + 1]
                    if seg.size:
                        dep = max(dep, int(seg.max()))
            r0, r1 = int(d[21]) >> g, int(d[22]) >> g
            for cc in {int(d[17]), int(d[18])}:
                if cc >= 0:
                    seg = m[max(r0, 0):r1 + 1, cc >> g]
                    if seg.size:
                        dep = max(dep, int(seg.max()))
        if d[29] & 1:  # LMCS chroma scale reads luma left/above the VPDU
            lm_ = maps[0]
            xp, yp = int(d[30]), int(d[31])
            r0 = max(0, yp - 1) >> 2
            r1 = min((yp + 64) >> 2, lm_.shape[0] - 1)
            c0 = max(0, xp - 1) >> 2
            c1 = min((xp + 64) >> 2, lm_.shape[1] - 1)
            seg = lm_[r0:r1 + 1, c0:c1 + 1]
            if seg.size:
                dep = max(dep, int(seg.max()))
        if d[7] == 4:  # CCLM reads the co-located reconstructed luma
            lm = maps[0]
            x, y, w, h = int(d[1]), int(d[2]), int(d[3]), int(d[4])
            ext_r = y + max(h, int(d[25])) + 1
            ext_c = x + max(w, int(d[24])) + 1
            r0 = max(0, (y - 1) * sub_h) >> 2
            r1 = min((ext_r * sub_h) >> 2, lm.shape[0] - 1)
            c0 = max(0, (x - 1) * sub_w) >> 2
            c1 = min((ext_c * sub_w) >> 2, lm.shape[1] - 1)
            seg = lm[r0:r1 + 1, c0:c1 + 1]
            if seg.size:
                dep = max(dep, int(seg.max()))
        li = dep + 1
        lvl[i] = li
        x, y, w, h = int(d[1]), int(d[2]), int(d[3]), int(d[4])
        m[y >> g:(y + h) >> g, x >> g:(x + w) >> g] = li
    return lvl


def build_wavefront_batches(desc: np.ndarray, lvl: np.ndarray,
                            K: int) -> np.ndarray:
    """[S, K, D] scan input: units grouped by (level, mode_class) — each
    step homogeneous in kernel family (components mix freely; the scan
    carries a stacked [3, H, W] plane) — chunked to K units per step,
    padding rows marked invalid (d[28] = 0)."""
    order = np.argsort(lvl, kind="stable")
    groups: dict = {}
    for i in order:
        kkey = (int(lvl[i]), int(desc[i, 7]))
        groups.setdefault(kkey, []).append(i)
    steps = []
    for kkey in groups:
        idxs = groups[kkey]
        for j in range(0, len(idxs), K):
            chunk = idxs[j:j + K]
            b = np.zeros((K, D), dtype=np.int32)
            b[:len(chunk)] = desc[chunk]
            steps.append(b)
    return np.stack(steps) if steps \
        else np.zeros((0, K, D), dtype=np.int32)


def wavefront_step_levels(desc: np.ndarray, lvl: np.ndarray,
                          K: int) -> np.ndarray:
    """The dependency level of each step of build_wavefront_batches(desc,
    lvl, K), [S] int32, without building the batches: its (level,
    mode_class) groups, in order of first appearance among the units
    sorted by level, each cut into ceil(n / K) steps.  Never decreasing."""
    if desc.shape[0] == 0:
        return np.zeros(0, dtype=np.int32)
    order = np.argsort(lvl, kind="stable")
    keys, first, counts = np.unique(
        np.stack([lvl[order], desc[order, 7]], 1).astype(np.int64), axis=0,
        return_index=True, return_counts=True)
    g = np.argsort(first)
    return np.repeat(keys[g, 0], -(-counts[g] // K)).astype(np.int32)


def scan_key(cs) -> tuple:
    """Static configuration of the intra scan program for this stream."""
    return (cs.sps.bit_depth, cs.sps.chroma_format_idc,
            bool(cs.sps.chroma_ver_collocated), cs.sps.ctu_log2)


def run_intra_scan(planes_pad, resi_pad, desc: np.ndarray, key, lmcs=None,
                   scan: str = "wavefront"):
    """Run the intra chain on the planes' device.  planes_pad/resi_pad:
    3 padded int32 tensors; desc is the [n, D] host descriptor array;
    key = scan_key(cs); lmcs, when the picture uses LMCS, is the
    build_lmcs_params table as an int32 tensor on that device.  scan:
    "wavefront" (units grouped by exact dependency level into steps of
    at most WAVEFRONT_K, run a level at a time) or "seq" (one unit a
    step, the parity baseline; the reference's VVDEC_INTRA_SCAN=seq).
    The wavefront's profiler stages: "intra: levels (host)", "intra:
    batches (host)", "intra: planes set-up" and "intra: kernel"."""
    if desc.shape[0] == 0:
        return tuple(planes_pad)
    if scan == "seq":
        return _intra_scan_fn(*key, lmcs is not None)(
            tuple(planes_pad), tuple(resi_pad), desc, lmcs)
    if scan != "wavefront":
        raise ValueError(f"run_intra_scan: unknown scan {scan!r}")
    from vvdec_tpu_torch.ops.device_pipeline import timed_stage
    dev = planes_pad[0].device
    with timed_stage("intra: levels (host)", dev):
        lvl = compute_unit_levels(desc, key[1])
        levels = wavefront_step_levels(desc, lvl, WAVEFRONT_K)
    with timed_stage("intra: batches (host)", dev):
        batches = build_wavefront_batches(desc, lvl, WAVEFRONT_K)
    fn = _intra_wavefront_fn(*key, WAVEFRONT_K, lmcs is not None)
    return fn(tuple(planes_pad), tuple(resi_pad), batches, lmcs,
              levels=levels)


# ======================================================================
# host descriptor builder (the C builder's dispatch; its Python twin,
# copied from the reference as it stands)
# ======================================================================
def _fill_params(cs, order_map, wpp, ctu_log2, tu, cu, comp):
    """Reference-fill geometry for one unit -> 13 ints, avail0 flag; or
    None for the degenerate corner-only layout the golden zero-fills
    (frame falls back whole to the host plane).  Mirrors
    recon_np.fill_reference (mrl = 0) exactly, index-space only."""
    from vvdec_tpu_torch.frame.recon_np import sample_available

    x, y, w, h = tu.blocks[comp]
    wp_, hp_ = cs.comp_size[comp]
    sx = cs.sub_w if comp else 1
    sy = cs.sub_h if comp else 1
    unit_w = 4 // sx
    unit_h = 4 // sy
    order = tu.order

    def av(px, py):
        return sample_available(cs, order_map, wpp, ctu_log2, px, py,
                                comp, cu, order)

    total_above = (2 * w + unit_w - 1) // unit_w
    total_left = (2 * h + unit_h - 1) // unit_h
    n_topleft = 1 if av(x - 1, y - 1) else 0
    n_above = 0
    for u in range(total_above):
        if av(x + u * unit_w, y - 1):
            n_above += 1
        else:
            break
    n_left = 0
    for u in range(total_left):
        if av(x - 1, y + u * unit_h):
            n_left += 1
        else:
            break
    if n_topleft + n_above + n_left == 0:
        return (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0), 1
    if n_topleft + n_above + n_left == total_above + total_left + 1:
        txhi = min(x - 1 + 2 * w, wp_ - 1)
        lyhi = min(y + 2 * h - 1, hp_ - 1)
        return (y - 1, y - 1, 0, x - 1, x - 1, txhi,
                x - 1, x - 1, 0, y - 1, y - 1, lyhi), 0
    if n_left > 0:
        n_l = min(n_left * unit_h, 2 * h, hp_ - y)
        lylo = y - 1 if n_topleft else y
        lyhi = y + n_l - 1
        if n_above > 0:
            n_a = min(n_above * unit_w, 2 * w, wp_ - x)
            txhi = x + n_a - 1
        else:
            txhi = x - 1
        if n_topleft:
            ty_a = ty_b = y - 1
            ty_k = 0
        elif n_above > 0:
            ty_a, ty_b, ty_k = y, y - 1, 1
        else:
            ty_a = ty_b = y
            ty_k = 0
        return (ty_a, ty_b, ty_k, x - 1, x - 1, txhi,
                x - 1, x - 1, 0, y - 1, lylo, lyhi), 0
    # left column unavailable: top row drives everything
    if n_above == 0:
        # corner-only layout (golden zero-fills top[1:]); host fallback
        return None
    n_a = min(n_above * unit_w, 2 * w, wp_ - x)
    return (y - 1, y - 1, 0, x - 1, x, x + n_a - 1,
            x, x, 0, 0, y - 1, y - 1), 0


def _picture_gates(cs):
    """(reason, chroma_scale_on): the first picture-level rejection of
    the descriptor builders (bit depth, mixed LMCS slices, IBC, ACT), or
    None, and whether LMCS scales the picture's chroma residuals."""
    if cs.sps.bit_depth > 10:
        return "bit_depth>10", False
    lmcs_on = bool(cs.ph.lmcs_enabled
                   and getattr(cs, "lmcs_info", None) is not None)
    if lmcs_on and len({bool(s.lmcs_enabled) for s in cs.shs}) > 1:
        # mixed per-slice reshaping would need a masked inverse map
        return "lmcs_mixed_slices", False
    if cs.sps.ibc_enabled:
        return "ibc", False
    if cs.sps.act_enabled:
        return "act", False
    if lmcs_on and not cs.shs[0].lmcs_enabled:
        lmcs_on = False  # model present but disabled for every slice
    return None, bool(lmcs_on and cs.ph.chroma_residual_scale
                      and cs.num_comp > 1)


def plan_intra_descriptors(cs):
    """(desc, reason, has_inter): build_intra_descriptors' pair, and
    whether any CU of the picture is not intra (None where the builder
    did not look).  A picture that carries the native syntax walk's
    records is planned in C from them (ops/plan_host.py); one parsed by
    the Python walk, or where the C builder is unavailable or meets an
    input it does not model, by build_intra_descriptors_py.  Both give
    the same table, bit for bit.  Counts "plan: TUs" and the picture
    under "plan: C pictures" or "plan: Python pictures"."""
    from vvdec_tpu_torch.ops.plan_host import build_rows
    reason, chroma_scale_on = _picture_gates(cs)
    if reason is not None:
        return None, reason, None
    out = build_rows(cs, chroma_scale_on)
    if out is not None:
        profiler.count("plan: TUs", len(cs.tus))
        profiler.count("plan: C pictures")
        return out
    profiler.count("plan: Python pictures")
    desc, reason = build_intra_descriptors_py(cs)
    return desc, reason, None


def build_intra_descriptors(cs):
    """(desc [n, D] int32, None) for a device-eligible picture, or
    (None, reason) naming the first tool outside the device intra set;
    from the C builder where the picture carries the syntax walk's
    records, else from build_intra_descriptors_py
    (plan_intra_descriptors)."""
    desc, reason, _ = plan_intra_descriptors(cs)
    return desc, reason


def build_intra_descriptors_py(cs):
    """build_intra_descriptors in Python, the reference's builder as it
    stands and the C builder's plain twin: walks cs.tus in parse order,
    maintaining the TU order map the availability rule needs (recon_np
    parity)."""
    from vvdec_tpu_torch.frame.recon_np import (
        CHROMA422_MAP,
        DIA_IDX,
        HOR_IDX,
        VER_IDX,
        co_located_luma_mode_of,
        sample_available,
        wide_angle,
    )
    from vvdec_tpu_torch.frame.structure import (
        DC_IDX,
        DM_CHROMA_IDX,
        LM_CHROMA_IDX,
        MDLM_L_IDX,
        MDLM_T_IDX,
        MODE_INTRA,
        MTS_SKIP,
        NUM_LUMA_MODE,
        PLANAR_IDX,
    )

    reason, chroma_scale_on = _picture_gates(cs)
    if reason is not None:
        return None, reason
    wpp = cs.sps.entropy_coding_sync_enabled
    ctu_log2 = cs.sps.ctu_log2
    order_map = np.full((cs.h >> 2, cs.w >> 2), -1, dtype=np.int32)
    if type(cs.tus) is list:
        for i, tu in enumerate(cs.tus):
            tu.order = i

    def final_mode(cu, comp):
        if comp == 0:
            return cu.intra_dir[0]
        mode = cu.intra_dir[1]
        if mode == DM_CHROMA_IDX:
            mode = co_located_luma_mode_of(cs, cu)
        if cs.sps.chroma_format_idc == 2 and mode < 67:
            mode = CHROMA422_MAP[mode]
        return mode

    rows = []
    seen_ciip: set = set()
    vpdu_cache: dict = {}

    def lmcs_fields(tu_, comp_):
        """(flags, x_pos, y_pos, 0) for the device chroma residual
        scale (calculateChromaAdjVpduNei geometry; value-independent —
        the average itself runs on device)."""
        if not chroma_scale_on or comp_ not in (1, 2):
            return (0, 0, 0, 0)
        if tu_.blocks[1] is None:
            return (0, 0, 0, 0)
        _, _, cw_, ch_ = tu_.blocks[1]
        if cw_ * ch_ <= 4 or not (tu_.cbf[1] or tu_.cbf[2]
                                  or tu_.joint_cbcr):
            return (0, 0, 0, 0)
        if not (tu_.cbf[comp_] or tu_.joint_cbcr):
            return (0, 0, 0, 0)
        if tu_.blocks[0] is not None:
            lx, ly = tu_.blocks[0][0], tu_.blocks[0][1]
        else:
            lx = tu_.blocks[1][0] * cs.sub_w
            ly = tu_.blocks[1][1] * cs.sub_h
        ctu_sz = cs.sps.ctu_size
        vmask = 63 if ctu_sz == 128 else (ctu_sz - 1)
        vx, vy = lx & ~vmask, ly & ~vmask
        if (vx, vy) not in vpdu_cache:
            top_left = cs.cu_at(vx, vy, 0)
            x_pos, y_pos = top_left.x, top_left.y
            above = cs.cu_at_restricted(x_pos, y_pos - 1, top_left, 0)
            left_n = cs.cu_at_restricted(x_pos - 1, y_pos, top_left, 0)
            vpdu_cache[(vx, vy)] = (
                x_pos, y_pos, (2 if left_n is not None else 0)
                | (4 if above is not None else 0))
        x_pos, y_pos, nbf = vpdu_cache[(vx, vy)]
        return (1 | nbf, x_pos, y_pos, 0)
    # the plan layer's work count: the TUs this walk visits (all of the
    # picture's; a picture rejected below stops part way)
    profiler.count("plan: TUs", len(cs.tus))
    for tu in cs.tus:
        cu = cs.cus[tu.cu_idx]
        is_intra = cu.pred_mode == MODE_INTRA
        if not is_intra:
            # inter CUs reconstruct in the device MC stage; gate the
            # tools outside its family (ops/mc_device._cu_mc_eligible
            # re-checks the motion-dependent gates post-derivation)
            if cu.pred_mode != 0:  # not MODE_INTER -> MODE_IBC
                return None, "ibc"
            if cu.ciip_flag and cu.idx not in seen_ciip:
                # CIIP: the planar-intra blend runs as a scan unit at
                # this CU's parse position, over the RAW inter pred the
                # MC stage stores (predBlendIntraCiip,
                # IntraPrediction.cpp:884); weights from the neighbor
                # prediction modes (value-independent)
                seen_ciip.add(cu.idx)
                if cu.w > 64 or cu.h > 64:
                    return None, "ciip_size"
                lnb = cs.cu_at_restricted(cu.x - 1, cu.y + cu.h - 1,
                                          cu, 0)
                anb = cs.cu_at_restricted(cu.x + cu.w - 1, cu.y - 1,
                                          cu, 0)
                n0 = bool(lnb and lnb.pred_mode == MODE_INTRA
                          and lnb.idx < cu.idx)
                n1 = bool(anb and anb.pred_mode == MODE_INTRA
                          and anb.idx < cu.idx)
                w_intra = 3 - (not n0) - (not n1)
                w_merge = 3 - n0 - n1
                ncomp = cs.num_comp \
                    if (cs.num_comp > 1 and cu.cw > 2) else 1
                import types
                for comp in range(ncomp):
                    blocks = [None, None, None]
                    if comp == 0:
                        blocks[0] = (cu.x, cu.y, cu.w, cu.h)
                        w_, h_ = cu.w, cu.h
                    else:
                        blocks[comp] = (cu.cx, cu.cy, cu.cw, cu.ch)
                        if blocks[1] is None:
                            blocks[1] = blocks[comp]
                        w_, h_ = cu.cw, cu.ch
                    tmp = types.SimpleNamespace(blocks=blocks,
                                                order=tu.order)
                    fp = _fill_params(cs, order_map, wpp, ctu_log2,
                                      tmp, cu, comp)
                    if fp is None:
                        return None, "fill_corner_case"
                    fill, avail0 = fp
                    x_, y_ = blocks[comp][0], blocks[comp][1]
                    rows.append((
                        comp, x_, y_, w_, h_, w_.bit_length() - 1,
                        h_.bit_length() - 1, 5,
                        1 if (comp == 0 and w_ * h_ > 32) else 0, 1,
                        avail0, *fill, 0, w_intra, w_merge, 0,
                        1 if (w_ >= 4 and h_ >= 4) else 0, 1,
                        0, 0, 0, 0))
        if is_intra:
            if cu.isp_mode:
                return None, "isp"
            if cu.multi_ref_idx:
                return None, "mrl"
            if cu.bdpcm_mode or cu.bdpcm_mode_chroma:
                return None, "bdpcm"
            if cu.color_transform:
                return None, "act"
        comps = []
        if tu.blocks[0] is not None and cu.has_luma:
            comps.append(0)
        if tu.blocks[1] is not None and cu.has_chroma and cs.num_comp > 1:
            comps += [1, 2]
        for comp in comps:
            x, y, w, h = tu.blocks[comp]
            # joint Cb-Cr: BOTH chroma planes carry residual (the device
            # ITX stage derives the uncoded one, frame_device._jccr_fn)
            cbf = bool(tu.cbf[comp]
                       or (comp in (1, 2) and tu.joint_cbcr))
            # transform-skip residuals run in the device TS-dequant
            # stage (itx_residual_device); BDPCM is rejected above
            if not is_intra:
                continue
            if w > 64 or h > 64 or w < 1 or h < 1:
                return None, "block_size"
            fp = _fill_params(cs, order_map, wpp, ctu_log2, tu, cu, comp)
            if fp is None:
                return None, "fill_corner_case"
            fill, avail0 = fp
            l2w, l2h = w.bit_length() - 1, h.bit_length() - 1
            if comp == 0 and cu.mip_flag:
                from vvdec_tpu_torch.frame.recon_np import mip_size_id
                rows.append((
                    comp, x, y, w, h, l2w, l2h, 3, 0,
                    1 if cbf else 0, avail0, *fill, 0, cu.intra_dir[0],
                    1 if cu.mip_transpose else 0, mip_size_id(w, h), 0, 1,
                    0, 0, 0, 0))
                continue
            mode = final_mode(cu, comp)
            if mode >= NUM_LUMA_MODE:
                # CCLM chroma modes: template availability geometry on
                # the host, the sampling + fit + transform on device
                if not (LM_CHROMA_IDX <= mode <= MDLM_T_IDX):
                    return None, "chroma_mode"

                def av(px, py):
                    return sample_available(cs, order_map, wpp, ctu_log2,
                                            px, py, comp, cu, tu.order)

                unit = 2
                tu_w_units = w // unit
                tu_h_units = h // unit
                cu_above = av(cu.cx, cu.cy - 1)
                cu_left = av(cu.cx - 1, cu.cy)
                above_flag = cu_above or y > cu.cy
                left_flag = cu_left or x > cu.cx
                above_avail = left_avail = False
                actual_top = actual_left = 0
                if mode == MDLM_T_IDX:
                    avai_above = 0
                    if above_flag:
                        avai_above = tu_w_units
                        ar_units = min((2 * w) // unit - tu_w_units,
                                       h // unit)
                        for u in range(ar_units):
                            if av(x + w + u * unit, y - 1):
                                avai_above += 1
                            else:
                                break
                    above_avail = avai_above >= tu_w_units
                    actual_top = unit * avai_above
                elif mode == MDLM_L_IDX:
                    avai_left = 0
                    if left_flag:
                        avai_left = tu_h_units
                        lb_units = min((2 * h) // unit - tu_h_units,
                                       w // unit)
                        for u in range(lb_units):
                            if av(x - 1, y + h + u * unit):
                                avai_left += 1
                            else:
                                break
                    left_avail = avai_left >= tu_h_units
                    actual_left = unit * avai_left
                else:
                    above_avail = bool(above_flag)
                    left_avail = bool(left_flag)
                    actual_top = w if above_avail else 0
                    actual_left = h if left_avail else 0
                rows.append((
                    comp, x, y, w, h, w.bit_length() - 1,
                    h.bit_length() - 1, 4, 0, 1 if cbf else 0, avail0,
                    *fill, 1 if left_flag else 0, actual_top, actual_left,
                    (1 if above_avail else 0) | (2 if left_avail else 0),
                    1 if above_flag else 0, 1, *lmcs_fields(tu, comp)))
                continue
            do_pdpc = 1 if (w >= 4 and h >= 4) else 0
            # mode classification + angular parameters
            filtered = 0
            if mode == PLANAR_IDX:
                mode_class, is_ver, angle, inv, kind = 0, 0, 0, 0, 0
                if comp == 0 and w * h > 32:
                    filtered = 1
            elif mode == DC_IDX:
                mode_class, is_ver, angle, inv, kind = 1, 0, 0, 0, 0
            else:
                mode_class = 2
                pred_mode = wide_angle(w, h, mode)
                is_ver = 1 if pred_mode >= DIA_IDX else 0
                ang_mode = (pred_mode - VER_IDX) if is_ver \
                    else -(pred_mode - HOR_IDX)
                abs_ang = int(ANG_TABLE[abs(ang_mode)])
                inv = int(INV_ANG_TABLE[abs(ang_mode)])
                angle = abs_ang if ang_mode >= 0 else -abs_ang
                diff = min(abs(pred_mode - HOR_IDX),
                           abs(pred_mode - VER_IDX))
                log2_size = (l2w + l2h) >> 1
                thresh_ok = diff > INTRA_FILTER_THRESH[0][log2_size]
                if (abs_ang & 0x1F) == 0:
                    kind = 0
                    if comp == 0 and thresh_ok:
                        filtered = 1
                elif comp != 0:
                    kind = 3
                else:
                    kind = 2 if thresh_ok else 1
            rows.append((
                comp, x, y, w, h, l2w, l2h, mode_class, filtered,
                1 if cbf else 0, avail0, *fill, is_ver, angle, inv,
                kind, do_pdpc, 1, *lmcs_fields(tu, comp)))
        # mark the TU decoded (luma-granularity availability map)
        if tu.blocks[0] is not None:
            mx, my, mw, mh = tu.blocks[0]
        else:
            cxx, cyy, cww, chh = tu.blocks[1]
            mx, my = cxx * cs.sub_w, cyy * cs.sub_h
            mw, mh = cww * cs.sub_w, chh * cs.sub_h
        order_map[my >> 2: (my + mh) >> 2, mx >> 2: (mx + mw) >> 2] \
            = tu.order
    if not rows:
        # all-inter picture: valid, the intra scan is a no-op
        return np.zeros((0, D), dtype=np.int32), None
    return np.asarray(rows, dtype=np.int32), None
