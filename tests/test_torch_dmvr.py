"""The port's DMVR and BDOF stages against the JAX package's, on the CPU.

Tolerance: bit-equal.  Each test feeds the same numpy inputs, made from a
seed and handed over through vvdec_tpu_torch.state with an explicit
device, to the JAX function (vvdec_tpu/ops/mc_device.py,
vvdec_tpu/ops/dmvr_device.py) and to its counterpart in
vvdec_tpu_torch: the 25-point SAD and the search decision (with
quantised blocks that force ties, and with the early exit), the
sub-pel divide over a grid, the bilinear pre-MC, the final MC at the
refined MV with and without the BDOF borders (merge MVs and refinement
deltas past both picture edges, on the prefetch-window path and on the
plain path), the static BDOF MC, the BDOF blend and select, and the
refined-MV fixups.
"""

import numpy as np
import pytest
import torch

from vvdec_tpu_torch.state import to_numpy, to_torch


def _jnp(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a) for a in arrays]


def _port(*arrays):
    return to_torch(list(arrays), "cpu")


def _blocks(rng, n, dy, dx, quantised):
    bl0 = rng.integers(0, 1 << 10, size=(n, dy + 4, dx + 4)).astype(np.int32)
    if quantised:
        # few distinct values: many SAD ties between the 25 positions
        bl0 = (bl0 // 200) * 200
    bl1 = np.roll(bl0, tuple(rng.integers(-2, 3, size=2)), axis=(1, 2))
    bl1 = bl1 + rng.integers(-6, 7, size=bl1.shape).astype(np.int32)
    # identical blocks: a zero centre cost, the early exit
    bl1[:3] = bl0[:3]
    return bl0, bl1


@pytest.mark.parametrize("dx,dy", [(8, 16), (16, 8), (16, 16)])
@pytest.mark.parametrize("quantised", [False, True])
def test_sad25_and_decide_match_jax(dx, dy, quantised):
    from vvdec_tpu.ops.dmvr_device import dmvr_decide_core as ref_decide
    from vvdec_tpu.ops.mc_device import dmvr_sad25_core as ref_sad
    from vvdec_tpu_torch.ops.dmvr_device import dmvr_decide_core
    from vvdec_tpu_torch.ops.mc_device import dmvr_sad25_core
    rng = np.random.default_rng(dx * 3 + dy + quantised)
    bl0, bl1 = _blocks(rng, 64, dy, dx, quantised)
    want_sads = ref_sad(dx, dy)(*_jnp(bl0, bl1))
    want_dmv, want_cost = ref_decide(dx, dy)(want_sads)
    sads = dmvr_sad25_core(dx, dy)(*_port(bl0, bl1))
    assert sads.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(sads), np.asarray(want_sads))
    dmv, cost = dmvr_decide_core(dx, dy)(sads)
    np.testing.assert_array_equal(to_numpy(dmv), np.asarray(want_dmv))
    np.testing.assert_array_equal(to_numpy(cost), np.asarray(want_cost))
    assert not to_numpy(dmv)[:3].any()       # the early exit
    assert to_numpy(dmv)[3:].any()


def test_decide_ties_pick_the_first_minimum():
    """Hand-made SAD rows: ties between ring cells, between the centre
    and a cell, and all-equal rows; the first minimum in raster order
    wins, the centre wins its ties."""
    from vvdec_tpu.ops.dmvr_device import dmvr_decide_core as ref_decide
    from vvdec_tpu_torch.ops.dmvr_device import dmvr_decide_core
    rng = np.random.default_rng(5)
    sads = rng.integers(200, 400, size=(48, 25)).astype(np.int32)
    sads[0] = 500
    sads[1, [3, 7, 21]] = 100
    sads[2, [12, 13]] = (200, 150)       # the centre's reduced cost ties
    sads[3] = 300
    sads[3, [0, 24]] = 10
    sads[4:24, 12] = 1000
    for k in range(24, 48):
        cells = rng.choice(25, size=3, replace=False)
        sads[k, cells] = sads[k].min()
    want = ref_decide(8, 16)(*_jnp(sads))
    got = dmvr_decide_core(8, 16)(*_port(sads))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


def test_div_for_maxq7_over_a_grid():
    from vvdec_tpu.ops.dmvr_device import _div_for_maxq7 as ref_div
    from vvdec_tpu_torch.ops.dmvr_device import _div_for_maxq7
    n, d = np.meshgrid(np.arange(-4096, 4097, 7, dtype=np.int32),
                       np.concatenate([np.arange(1, 130), [257, 1023, 4095,
                                                           65535]]).astype(
                           np.int32))
    want = np.asarray(ref_div(*_jnp(n.ravel(), d.ravel())))
    got = _div_for_maxq7(*_port(n.ravel(), d.ravel()))
    np.testing.assert_array_equal(to_numpy(got), want)


def test_rshift_msb_matches_jax():
    from vvdec_tpu.ops.mc_device import _rshift_msb as ref_shift
    from vvdec_tpu_torch.ops.mc_device import _rshift_msb
    rng = np.random.default_rng(2)
    numer = rng.integers(-(1 << 24), 1 << 24, size=4000).astype(np.int32)
    denom = np.concatenate([np.arange(1, 1000), rng.integers(
        1, 1 << 23, size=3001)]).astype(np.int32)
    want = np.asarray(ref_shift(*_jnp(numer, denom)))
    np.testing.assert_array_equal(to_numpy(_rshift_msb(*_port(numer, denom))),
                                  want)


def _planes(rng, bd, h, w, m, n_refs=3):
    """n_refs edge-padded planes [R, h + 2m, w + 2m]."""
    raw = rng.integers(0, 1 << bd, size=(n_refs, h, w)).astype(np.int32)
    return np.stack([np.pad(p, m, mode="edge") for p in raw])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bw,bh", [(12, 20), (20, 12), (20, 20)])
def test_bilin_cu_core_matches_jax(bd, bw, bh):
    from vvdec_tpu.frame.inter_np import BILINEAR_IF
    from vvdec_tpu.ops.dmvr_device import bilin_cu_core as ref_core
    from vvdec_tpu_torch.ops.dmvr_device import bilin_cu_core
    rng = np.random.default_rng(bd + bw)
    refs = _planes(rng, bd, 48, 64, 24)
    n = 40
    _, hp, wp = refs.shape
    # window origins past both edges of the padded planes
    y0 = rng.integers(-hp // 2, hp + hp // 2, n).astype(np.int32)
    x0 = rng.integers(-wp // 2, wp + wp // 2, n).astype(np.int32)
    ridx = rng.integers(0, 3, n).astype(np.int32)
    cfy = np.asarray(BILINEAR_IF, np.int32)[rng.integers(0, 16, n)]
    cfx = np.asarray(BILINEAR_IF, np.int32)[rng.integers(0, 16, n)]
    args = (refs, y0, x0, ridx, cfy, cfx)
    want = ref_core(bw, bh, bd, hp, wp, 3)(*_jnp(*args))
    got = bilin_cu_core(bw, bh, bd)(*_port(*args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _final_inputs(rng, comp, n, W, H, ctu, dx, dy, zero_delta):
    """Subblocks of (dx, dy) luma samples at random 4-aligned positions,
    merge MVs around the clip window (so the clip and the picture clamp
    act past both edges) and refinement deltas (zero: the plain path)."""
    bx = (rng.integers(0, (W - dx) // 4 + 1, n) * 4).astype(np.int32)
    by = (rng.integers(0, (H - dy) // 4 + 1, n) * 4).astype(np.int32)
    bxmin = (-ctu - 8 - bx + 1) << 4
    bxmax = (W + 8 - bx - 1) << 4
    bymin = (-ctu - 8 - by + 1) << 4
    bymax = (H + 8 - by - 1) << 4
    mvx = rng.integers(bxmin - 96, bxmax + 96).astype(np.int32)
    mvy = rng.integers(bymin - 96, bymax + 96).astype(np.int32)
    mvx[: n // 4] = rng.integers(-300, 300, n // 4)
    mvy[: n // 4] = rng.integers(-300, 300, n // 4)
    if zero_delta:
        dvx = np.zeros(n, np.int32)
        dvy = np.zeros(n, np.int32)
    else:
        dvx = rng.integers(-40, 41, n).astype(np.int32)
        dvy = rng.integers(-40, 41, n).astype(np.int32)
    alt = rng.integers(0, 2, n).astype(bool)
    ridx = rng.integers(0, 3, n).astype(np.int32)
    return (ridx, bx, by, mvx, mvy, bxmin.astype(np.int32),
            bxmax.astype(np.int32), bymin.astype(np.int32),
            bymax.astype(np.int32), dvx, dvy, alt)


@pytest.mark.parametrize("comp,with_ext", [(0, True), (0, False), (1, False),
                                           (2, False)])
@pytest.mark.parametrize("zero_delta", [False, True])
def test_dmvr_final_core_matches_jax(comp, with_ext, zero_delta):
    """Luma (8-tap, with and without the BDOF borders) and chroma (4-tap,
    4:2:0, 1/32 fractions) at the refined MV, on the prefetch-window path
    (a delta moves the integer position) and on the plain path."""
    from vvdec_tpu.ops.dmvr_device import dmvr_final_core as ref_core
    from vvdec_tpu_torch.ops.dmvr_device import dmvr_final_core
    rng = np.random.default_rng(10 * comp + with_ext + 3 * zero_delta)
    W, H, ctu, bd, dx, dy = 96, 64, 32, 10, 16, 16
    m = ctu + 24
    sub = 2 if comp else 1
    shx = shy = 4 + (sub - 1)
    args = _final_inputs(rng, comp, 128, W, H, ctu, dx, dy, zero_delta)
    if comp:
        args = (args[0], args[1] // 2, args[2] // 2) + args[3:]
    refs = _planes(rng, bd, H // sub, W // sub, m // sub)
    _, hp, wp = refs.shape
    bw, bh = dx // sub, dy // sub
    want = ref_core(bw, bh, comp, shx, shy, bd, hp, wp, 3, m // sub,
                    W // sub, H // sub, with_ext)(*_jnp(refs, *args))
    got = dmvr_final_core(bw, bh, comp, shx, shy, bd, with_ext)(
        *_port(refs, *args), m // sub, W // sub, H // sub)
    if not with_ext:
        want, got = (want,), (got,)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    # the paths the test meant to take
    rmv = np.clip(args[3] + args[9], -(1 << 17), (1 << 17) - 1)
    moved = ((rmv >> shx) - (args[3] >> shx)) != 0
    assert moved.any() != zero_delta
    # positions past both picture edges
    mvc = np.clip(args[3], args[5], args[6])
    x = args[1] + (mvc >> shx)
    assert (x < 0).any() and (x + bw > W // sub).any()


@pytest.mark.parametrize("tw,th", [(16, 16), (8, 16), (16, 8)])
def test_mc_ext_core_matches_jax(tw, th):
    from vvdec_tpu.ops.dmvr_device import mc_ext_core as ref_core
    from vvdec_tpu.ops.mc_device import mc_coeff_rows
    from vvdec_tpu_torch.ops.dmvr_device import mc_ext_core
    rng = np.random.default_rng(tw + 2 * th)
    bd, n = 10, 48
    refs = _planes(rng, bd, 48, 64, 40)
    _, hp, wp = refs.shape
    y0 = rng.integers(-hp // 2, hp + hp // 2, n).astype(np.int32)
    x0 = rng.integers(-wp // 2, wp + wp // 2, n).astype(np.int32)
    yb = y0 + 2 + rng.integers(0, 2, n).astype(np.int32)
    xb = x0 + 2 + rng.integers(0, 2, n).astype(np.int32)
    ridx = rng.integers(0, 3, n).astype(np.int32)
    fy, fx = rng.integers(0, 16, n), rng.integers(0, 16, n)
    fy[:3], fx[:3] = (0, 8, 8), (8, 0, 8)
    alt = rng.random(n) < 0.5
    args = (refs, y0, x0, yb, xb, ridx, mc_coeff_rows(fy, 0, alt_hpel=alt),
            mc_coeff_rows(fx, 0, alt_hpel=alt))
    want = ref_core(tw, th, bd, hp, wp, 3)(*_jnp(*args))
    got = mc_ext_core(tw, th, bd)(*_port(*args))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _ext_pair(rng, n, h, w):
    """14-bit MC blocks with borders: a smooth gradient (a real optical
    flow) plus noise, the second block shifted against the first."""
    yy, xx = np.mgrid[0:h + 2, 0:w + 2]
    base = rng.integers(200, 800, (n, 1, 1)) \
        + rng.integers(-30, 31, (n, 1, 1)) * yy \
        + rng.integers(-30, 31, (n, 1, 1)) * xx
    e0 = (base << 4) - 8192 + rng.integers(-200, 201, (n, h + 2, w + 2))
    e1 = np.roll(e0, 1, axis=2) + rng.integers(-300, 301, (n, h + 2, w + 2))
    # the full 14-bit range on a few blocks
    e0[:2] = rng.integers(-8192, 24576, (2, h + 2, w + 2))
    e1[:2] = rng.integers(-8192, 24576, (2, h + 2, w + 2))
    e1[2] = e0[2]                                   # no flow
    return e0.astype(np.int32), e1.astype(np.int32)


@pytest.mark.parametrize("w,h", [(16, 16), (8, 16), (16, 8), (8, 8)])
@pytest.mark.parametrize("bd", [8, 10])
def test_bdof_blend_core_matches_jax(w, h, bd):
    from vvdec_tpu.ops.mc_device import bdof_blend_core as ref_core
    from vvdec_tpu_torch.ops.mc_device import bdof_blend_core
    rng = np.random.default_rng(w * h + bd)
    e0, e1 = _ext_pair(rng, 40, h, w)
    want = ref_core(w, h, bd)(*_jnp(e0, e1))
    got = bdof_blend_core(w, h, bd)(*_port(e0, e1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_bdof_select_core_matches_jax():
    from vvdec_tpu.ops.dmvr_device import _bdof_select_core as ref_core
    from vvdec_tpu_torch.ops.dmvr_device import _bdof_select_core
    rng = np.random.default_rng(4)
    e0, e1 = _ext_pair(rng, 32, 16, 16)
    blk0, blk1 = e0[:, 1:17, 1:17].copy(), e1[:, 1:17, 1:17].copy()
    bio = rng.random(32) < 0.5
    args = (blk0, blk1, e0, e1, bio)
    want = ref_core(16, 16, 10)(*_jnp(*args))
    got = _bdof_select_core(16, 16, 10)(*_port(*args))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_fixup_mv_core_matches_jax():
    from vvdec_tpu.ops.dmvr_device import _fixup_mv_core as ref_core
    from vvdec_tpu_torch.ops.dmvr_device import _fixup_mv_core
    rng = np.random.default_rng(8)
    n = 64
    # merge MVs up to the 18-bit limits, so the clip acts
    mvs = [rng.integers(-(1 << 17) - 40, (1 << 17) + 40, n).astype(np.int32)
           for _ in range(4)]
    dmv = rng.integers(-40, 41, (n, 2)).astype(np.int32)
    want = ref_core()(*_jnp(*mvs, dmv))
    got = _fixup_mv_core()(*_port(*mvs, dmv))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_lazy_fixups_yield_the_reference_records():
    """The fixup positions of the port's plan (numpy) equal the
    reference's loop, and LazyDmvrFixups yields the reference's
    records."""
    from vvdec_tpu.ops.dmvr_device import LazyDmvrFixups as RefFixups
    from vvdec_tpu_torch.ops.dmvr_device import (LazyDmvrFixups,
                                                 _fixup_positions)
    rng = np.random.default_rng(11)
    for dx, dy in ((8, 16), (16, 8), (16, 16)):
        sbx = (rng.integers(0, 60, 30) * 4).astype(np.int64)
        sby = (rng.integers(0, 40, 30) * 4).astype(np.int64)
        want = []
        for k, (sx, sy) in enumerate(zip(sbx.tolist(), sby.tolist())):
            y2 = ((sy - 1) & ~7) + 8
            while y2 < sy + dy:
                x2 = ((sx - 1) & ~7) + 8
                while x2 < sx + dx:
                    want.append((x2, y2, k))
                    x2 += 8
                y2 += 8
        pos = _fixup_positions(sbx, sby, dx, dy)
        assert [tuple(p) for p in pos.tolist()] == want
        mv = rng.integers(-500, 500, (30, 4)).astype(np.int32)
        ref = RefFixups()
        ref.add(want, *_jnp(mv))
        port = LazyDmvrFixups()
        port.add(pos, to_torch(mv, "cpu"))
        assert bool(port) and list(port) == list(ref)
    assert not LazyDmvrFixups()


def test_exact_product_scan_covers_dmvr_device():
    """TestExactIntegerProducts scans every module under ops/; the DMVR
    module is among them and holds no product call, and a decode through
    the DMVR and BDOF stages makes float64 products only."""
    import pathlib

    import vvdec_tpu_torch.ops as ops
    from tests.test_torch_stages import TestExactIntegerProducts
    path = pathlib.Path(ops.__file__).parent / "dmvr_device.py"
    assert path in set(pathlib.Path(ops.__file__).parent.rglob("*.py"))
    code = [ln.split("#")[0] for ln in path.read_text().splitlines()]
    assert not [c for c in code
                if any(p in c for p in TestExactIntegerProducts.CALLS)]
    # the runtime products of a decode through DMVR and BDOF
    from tests.test_dmvr_bdof import _bpyramid_stream
    from vvdec_tpu_torch.decoder import decode_annexb
    seen = []
    real = torch.einsum

    def spy(eq, *args):
        seen.extend(a.dtype for a in args)
        return real(eq, *args)

    torch.einsum = spy
    try:
        decode_annexb(_bpyramid_stream(
            3, dict(dmvr_enabled=True, bdof_enabled=True),
            dict(split_prob=0.4, inter_prob=0.8, skip_prob=0.25,
                 mv_range=40, bi_prob=0.7)), device="cpu")
    finally:
        torch.einsum = real
    assert seen and set(seen) == {torch.float64}, set(seen)
