"""The port's ITX stage against the JAX reference.

Tolerance: bit-equal everywhere (integer arithmetic).  Inputs are made
with numpy from a seed and handed to both packages.  The Pallas kernel
runs in interpret mode, as tests/test_pallas.py runs it; the port's
`itx_batch_cuda` runs its plain version on CPU tensors, and the CUDA
kernel itself only in the `cuda`-marked test, on the card.
"""

import numpy as np
import pytest
import torch

from vvdec_tpu_torch.ops.cuda.itx import POOL_MATRICES

SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 16), (32, 8), (64, 64),
          (8, 32)]
# TUs of height or width 2 (chroma 8x2, 16x2, ... in 4:2:0), which the
# headline stream has and tests/test_pallas.py does not
SHAPES_2 = [(2, 8), (2, 16), (2, 32), (8, 2), (16, 2), (32, 2)]
KINDS = [("DCT2", "DCT2"), ("DST7", "DST7"), ("DCT8", "DST7"),
         ("DST7", "DCT8")]
BD = 10


def _kinds(h, w):
    """The transform pairs tests/test_pallas.py runs for this shape."""
    return [k for k in KINDS
            if k == ("DCT2", "DCT2") or (4 <= h <= 32 and 4 <= w <= 32)]


def _case(h, w, dep_quant, n=17, seed=0, extreme=False):
    from vvdec_tpu_torch.ops.cuda.itx import dequant_params

    rng = np.random.default_rng(seed * 1000 + h * 100 + w + dep_quant)
    lo, hi = (-32768, 32768) if extreme else (-1024, 1024)
    levels = rng.integers(lo, hi, size=(n, h, w)).astype(np.int32)
    if extreme:
        levels[:, 0, 0] = -32768
        levels[:, -1, -1] = 32767
    levels[rng.random((n, h, w)) < 0.3] = 0
    qp = rng.integers(1, 69, size=(n,)).astype(np.int32)
    return (levels, qp) + dequant_params(qp, w, h, BD, dep_quant)


def _pallas(levels, scale, rshift, imax, hor, ver, h, w):
    import jax.numpy as jnp

    from vvdec_tpu.ops.pallas.itx import itx_batch_pallas
    from vvdec_tpu.ops.tables import tr_matrix
    return np.asarray(itx_batch_pallas(
        jnp.asarray(levels), jnp.asarray(scale), jnp.asarray(rshift),
        jnp.asarray(imax), jnp.asarray(tr_matrix(ver, h), dtype=jnp.int32),
        jnp.asarray(tr_matrix(hor, w), dtype=jnp.int32),
        h=h, w=w, bit_depth=BD, interpret=True))


def _port_args(levels, scale, rshift, imax, hor, ver, h, w, device="cpu"):
    from vvdec_tpu_torch.ops.tables import tr_matrix
    from vvdec_tpu_torch.state import to_torch
    return to_torch((levels, scale, rshift, imax,
                     np.asarray(tr_matrix(ver, h), dtype=np.int32),
                     np.asarray(tr_matrix(hor, w), dtype=np.int32)), device)


@pytest.mark.parametrize("h,w", SHAPES + SHAPES_2)
@pytest.mark.parametrize("dep_quant", [False, True])
def test_itx_ref_matches_pallas(h, w, dep_quant):
    """itx_batch_ref (and the wrapper on CPU tensors) == the Pallas
    kernel in interpret mode, on every test_pallas.py case plus the
    2-row and 2-column shapes, levels at the int16 extremes included."""
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_batch_ref

    for extreme in (False, True):
        levels, qp, scale, rshift, imax = _case(h, w, dep_quant,
                                                extreme=extreme)
        for hor, ver in _kinds(h, w):
            want = _pallas(levels, scale, rshift, imax, hor, ver, h, w)
            args = _port_args(levels, scale, rshift, imax, hor, ver, h, w)
            got = itx_batch_ref(*args, h=h, w=w, bit_depth=BD).numpy()
            assert np.array_equal(got, want), (hor, ver, extreme)
            got = itx_batch_cuda(*args, h=h, w=w, bit_depth=BD).numpy()
            assert np.array_equal(got, want), (hor, ver, extreme)


def test_itx_zero_levels():
    from vvdec_tpu_torch.ops.cuda.itx import dequant_params, itx_batch_cuda
    levels = np.zeros((3, 8, 8), dtype=np.int32)
    scale, rshift, imax = dequant_params(np.full(3, 30, np.int32), 8, 8,
                                         BD, False)
    args = _port_args(levels, scale, rshift, imax, "DCT2", "DCT2", 8, 8)
    assert not itx_batch_cuda(*args, h=8, w=8, bit_depth=BD).any()


@pytest.mark.parametrize("dep_quant", [False, True])
def test_dequant_params_matches_reference(dep_quant):
    """Floor division and modulo on negative QPs (the qp path), numpy
    and torch inputs alike."""
    from vvdec_tpu.ops.pallas.itx import dequant_params as ref
    from vvdec_tpu_torch.ops.cuda.itx import dequant_params as port
    qp = np.arange(-18, 70, dtype=np.int32)
    for h, w in SHAPES + SHAPES_2:
        want = ref(qp, w, h, BD, dep_quant)
        for got in (port(qp, w, h, BD, dep_quant),
                    port(torch.from_numpy(qp), w, h, BD, dep_quant)):
            for a, b in zip(got, want):
                assert np.array_equal(np.asarray(a), np.asarray(b))


def test_wrapper_rejects_bad_inputs():
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda
    levels, qp, scale, rshift, imax = _case(8, 8, False, n=4)
    args = _port_args(levels, scale, rshift, imax, "DCT2", "DCT2", 8, 8)
    with pytest.raises(TypeError):
        itx_batch_cuda(args[0].to(torch.int64), *args[1:], h=8, w=8,
                       bit_depth=BD)
    with pytest.raises(ValueError):
        itx_batch_cuda(*args, h=8, w=4, bit_depth=BD)
    with pytest.raises(ValueError):
        itx_batch_cuda(args[0].transpose(1, 2), *args[1:], h=8, w=8,
                       bit_depth=BD)
    with pytest.raises(ValueError):
        itx_batch_cuda(*args, h=8, w=8 * 3, bit_depth=BD)
    with pytest.raises(ValueError):
        itx_batch_cuda(args[0], args[1][:3], *args[2:], h=8, w=8,
                       bit_depth=BD)


def test_wrapper_on_cpu_does_not_count_launches():
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_frame_cuda
    levels, qp, scale, rshift, imax = _case(4, 4, False, n=2)
    before = itx_batch_cuda.launches, itx_frame_cuda.launches
    itx_batch_cuda(*_port_args(levels, scale, rshift, imax, "DCT2", "DCT2",
                               4, 4), h=4, w=4, bit_depth=BD)
    _frame_path(levels, qp, 4, 4, "DCT2", "DCT2", False)
    assert (itx_batch_cuda.launches, itx_frame_cuda.launches) == before


def test_frame_wrapper_rejects_bad_inputs():
    """itx_frame_cuda checks types, shapes, devices and the table's
    length before any launch."""
    from vvdec_tpu_torch.ops.cuda.itx import (
        frame_table,
        itx_frame_cuda,
        matrix_pool,
    )
    table, n_tasks = frame_table(
        [((0, 8, 8, "DCT2", "DCT2", False), [(0, 0, 30), (8, 0, 30)])], BD)
    table = torch.from_numpy(table)
    coef = [torch.zeros((8, 16), dtype=torch.int16), None, None]
    resi = [torch.zeros((72, 80), dtype=torch.int32)] \
        + [torch.zeros((1, 1), dtype=torch.int32) for _ in range(2)]
    pool = matrix_pool("cpu")
    kw = dict(n_tasks=n_tasks, bit_depth=BD)
    itx_frame_cuda(coef, resi, table, pool, **kw)
    with pytest.raises(TypeError):
        itx_frame_cuda([coef[0].to(torch.int64), None, None], resi, table,
                       pool, **kw)
    with pytest.raises(TypeError):
        itx_frame_cuda(coef, resi, table, pool.to(torch.int32), **kw)
    with pytest.raises(ValueError):
        itx_frame_cuda(coef, [resi[0].t(), *resi[1:]], table, pool, **kw)
    with pytest.raises(ValueError):
        itx_frame_cuda(coef, resi[:2], table, pool, **kw)
    with pytest.raises(ValueError):
        itx_frame_cuda(coef, resi, table[:-1], pool, **kw)
    with pytest.raises(ValueError):
        itx_frame_cuda(coef, resi, table.view(1, -1), pool, **kw)


# ---- the stage functions: _itx_fn, _ts_fn, _itx_lfnst_fn ----
ITX_FN_CASES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 16),
                (32, 8), (2, 8), (16, 2)]


def _frame_path(levels, qp, h, w, hor, ver, dep_quant):
    """The port's ITX of plain TUs on the CPU: the N TUs stacked in rows
    of one int16 coefficient plane, through frame_table and
    itx_frame_cuda (its plain version), read back as [N, h, w]."""
    from vvdec_tpu_torch.ops.cuda.itx import (
        frame_table,
        itx_frame_cuda,
        matrix_pool,
    )
    n = len(qp)
    table, n_tasks = frame_table(
        [((0, w, h, hor, ver, dep_quant),
          [(0, i * h, int(q)) for i, q in enumerate(qp)])], BD)
    plane = torch.from_numpy(levels.reshape(n * h, w).astype(np.int16))
    resi = [torch.zeros((n * h, w), dtype=torch.int32)] \
        + [torch.zeros((1, 1), dtype=torch.int32) for _ in range(2)]
    out = itx_frame_cuda([plane, None, None], resi, torch.from_numpy(table),
                         matrix_pool("cpu"), n_tasks=n_tasks, bit_depth=BD)
    return out[0].reshape(n, h, w).numpy()


@pytest.mark.parametrize("h,w", ITX_FN_CASES)
@pytest.mark.parametrize("dep_quant,use_sl", [(False, False), (True, False),
                                              (False, True)])
def test_itx_fn_matches_jax(h, w, dep_quant, use_sl):
    """The port's ITX == the JAX _itx_fn (its XLA path on CPU) on
    negative and positive levels: without a scaling list through the
    frame path (frame_table, itx_frame_cuda), with one through the
    port's _itx_fn."""
    import jax.numpy as jnp

    from vvdec_tpu.ops.pipeline import _itx_fn as jax_fn
    from vvdec_tpu_torch.ops.pipeline import _itx_fn as port_fn
    from vvdec_tpu_torch.state import to_numpy, to_torch

    rng = np.random.default_rng(h * 64 + w + 7 * dep_quant + 3 * use_sl)
    n = 9
    levels = rng.integers(-2048, 2048, size=(n, h, w)).astype(np.int32)
    levels[rng.random((n, h, w)) < 0.4] = 0
    qp = rng.integers(-6, 64, size=(n,)).astype(np.int32)
    smat = rng.integers(1, 64, size=(h, w)).astype(np.int32)
    for hor, ver in _kinds(h, w):
        extra = (smat,) if use_sl else ()
        want = jax_fn(h, w, hor, ver, BD, dep_quant, use_sl)(
            jnp.asarray(levels), jnp.asarray(qp),
            *(jnp.asarray(a) for a in extra))
        if use_sl:
            got = to_numpy(port_fn(h, w, hor, ver, BD, dep_quant, True)(
                *to_torch((levels, qp, smat), "cpu")))
        else:
            got = _frame_path(levels, qp, h, w, hor, ver, dep_quant)
        assert np.array_equal(got, np.asarray(want)), (hor, ver)


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (4, 16), (32, 32), (2, 8)])
@pytest.mark.parametrize("imi", [0, 2])
def test_ts_fn_matches_jax(h, w, imi):
    """Per TU against the JAX _ts_fn.  The reference is called one TU at
    a time: its scale lookup comes out shaped [1, N, 1] and so broadcasts
    along rows for N > 1 (it raises unless N is 1 or h); the port keeps
    the per-TU [N, 1, 1] scale."""
    import jax.numpy as jnp

    from vvdec_tpu.ops.pipeline import _ts_fn as jax_fn
    from vvdec_tpu_torch.ops.pipeline import _ts_fn as port_fn
    from vvdec_tpu_torch.state import to_numpy, to_torch

    rng = np.random.default_rng(h * 10 + w + imi)
    levels = rng.integers(-40000, 40000, size=(11, h, w)).astype(np.int32)
    levels[rng.random(levels.shape) < 0.3] = 0
    qp = rng.integers(-12, 64, size=(11,)).astype(np.int32)
    got = to_numpy(port_fn(h, w, BD, imi)(*to_torch((levels, qp), "cpu")))
    for i in range(len(qp)):
        want = jax_fn(h, w, BD, imi)(jnp.asarray(levels[i:i + 1]),
                                     jnp.asarray(qp[i:i + 1]))
        assert np.array_equal(got[i:i + 1], np.asarray(want)), i


@pytest.mark.parametrize("h,w,sb,zero_out", [
    (4, 4, 4, 8), (8, 8, 8, 8), (16, 16, 8, 16), (4, 16, 4, 16),
    (8, 32, 8, 16), (16, 4, 4, 16)])
@pytest.mark.parametrize("dep_quant,use_sl", [(False, False), (True, True)])
def test_itx_lfnst_fn_matches_jax(h, w, sb, zero_out, dep_quant, use_sl):
    """Dequant + inverse LFNST + ITX, both output placements (normal and
    transposed), negative levels."""
    import jax.numpy as jnp

    from vvdec_tpu.ops.pipeline import _itx_lfnst_fn as jax_fn
    from vvdec_tpu_torch.ops.pipeline import _itx_lfnst_fn as port_fn
    from vvdec_tpu_torch.state import to_numpy, to_torch

    rng = np.random.default_rng(h * 100 + w + sb + zero_out + dep_quant)
    n = 8
    levels = rng.integers(-600, 600, size=(n, h, w)).astype(np.int32)
    qp = rng.integers(10, 50, size=(n,)).astype(np.int32)
    kern = rng.integers(-128, 128, size=(n, 16 if sb == 4 else 48,
                                         zero_out)).astype(np.int32)
    trans = rng.random(n) < 0.5
    smat = rng.integers(1, 64, size=(h, w)).astype(np.int32)
    extra = (smat,) if use_sl else ()
    for hor, ver in (("DCT2", "DCT2"), ("DST7", "DST7")):
        want = jax_fn(h, w, hor, ver, BD, dep_quant, sb, zero_out, use_sl)(
            *(jnp.asarray(a) for a in (levels, qp, kern, trans) + extra))
        got = port_fn(h, w, hor, ver, BD, dep_quant, sb, zero_out, use_sl)(
            *to_torch((levels, qp, kern, trans) + extra, "cpu"))
        assert np.array_equal(to_numpy(got), np.asarray(want)), (hor, ver)


def test_itx_residual_device_lfnst_stream():
    """The LFNST set-up of test_pipeline_jax.py::test_device_itx_lfnst_parity:
    itx_residual_device of both packages agrees on every frame of an
    LFNST-heavy stream."""
    import vvdec_tpu.testenc.encoder as E
    from vvdec_tpu.decoder import parse_annexb
    from vvdec_tpu.ops.frame_device import itx_residual_device as jax_itx
    from vvdec_tpu.testenc.encoder import RandomDecisions, generate_stream
    from vvdec_tpu_torch.ops.frame_device import itx_residual_device
    from vvdec_tpu_torch.state import to_numpy

    class LfnstDec(RandomDecisions):
        def lfnst_idx(self, cu):
            return self.rnd.choice([1, 2])

    orig = E.RandomDecisions
    E.RandomDecisions = LfnstDec
    try:
        s, css = generate_stream(
            width=96, height=64, ctu=32, n_frames=2, seed=1, qp=30,
            sps_kw=dict(lfnst_enabled=True),
            dec_kw=dict(split_prob=0.5, density=0.08, max_level=20))
    finally:
        E.RandomDecisions = orig
    assert sum(1 for cs in css for cu in cs.cus if cu.lfnst_idx) >= 4
    for f in parse_annexb(s):
        want = [np.asarray(r) for r in jax_itx(f.cs)]
        got = to_numpy(itx_residual_device(f.cs, "cpu"))
        for (w_c, h_c), a, b in zip(f.cs.comp_size, got, want):
            # the picture area only: the reference pads each batch to a
            # power of two and parks the padding TUs' residuals in the
            # plane's bottom/right margin, which no stage reads
            assert np.array_equal(a[:h_c, :w_c], b[:h_c, :w_c])


@pytest.mark.cuda
def test_itx_kernel_matches_ref_on_card():
    """The CUDA kernel == itx_batch_ref on the card, bit for bit, on the
    shapes above, N = 17 and N = 4096, levels at the int16 extremes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda, itx_batch_ref

    for h, w in SHAPES + SHAPES_2:
        for n in (17, 4096):
            for extreme in (False, True):
                levels, qp, scale, rshift, imax = _case(h, w, True, n=n,
                                                        extreme=extreme)
                for hor, ver in _kinds(h, w):
                    args = _port_args(levels, scale, rshift, imax, hor, ver,
                                      h, w, device="cuda")
                    before = itx_batch_cuda.launches
                    got = itx_batch_cuda(*args, h=h, w=w, bit_depth=BD)
                    assert itx_batch_cuda.launches == before + 1
                    want = itx_batch_ref(*args, h=h, w=w, bit_depth=BD)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (h, w, n, hor, ver)


# ---- the frame path: frame_table, itx_frame_cuda, itx_frame_ref ----
FUZZ_LUMA = (200, 136)   # (w, h): neither side a multiple of 64


def _tile(rng, x0, y0, w, h, out):
    """Split the (w, h) rectangle at (x0, y0) at random into disjoint
    power-of-two TUs, sides 2 to 64 and at least 16 samples."""
    can = [d for d, s, o in (("v", w, h), ("h", h, w)) if s * o >= 32
           and s >= 4]
    if not can or (w <= 64 and h <= 64 and rng.random() < 0.3):
        out.append((x0, y0, w, h))
    elif rng.choice(can) == "v":
        _tile(rng, x0, y0, w // 2, h, out)
        _tile(rng, x0 + w // 2, y0, w // 2, h, out)
    else:
        _tile(rng, x0, y0, w, h // 2, out)
        _tile(rng, x0, y0 + h // 2, w, h // 2, out)


def _fuzz_cs(seed, dep_quant):
    """A 4:2:0 picture description that both packages'
    itx_residual_device accept: every component tiled with TUs of
    random shapes 2x8 to 64x64 in 64x64 cells that run past the plane's
    right and bottom edges (those TUs' windows start past the edge and
    are read at the clamped start), random QPs, explicit MTS kinds,
    levels up to the int16 extremes, one transform-skip TU per shape at
    most (the reference's _ts_fn takes one TU a call) and scaling-list
    matrices for two shapes, so the kernel's TUs mix with the PyTorch
    paths' TUs."""
    from types import SimpleNamespace as NS

    from vvdec_tpu_torch.frame.structure import MODE_INTRA, MTS_SKIP
    rng = np.random.default_rng(seed)
    lw, lh = FUZZ_LUMA
    sizes = [(lw, lh), (lw // 2, lh // 2), (lw // 2, lh // 2)]
    coef = []
    for w_c, h_c in sizes:
        c = rng.integers(-3000, 3000, size=(h_c, w_c))
        c[rng.random(c.shape) < 0.4] = 0
        c[rng.random(c.shape) < 0.01] = -32768
        c[rng.random(c.shape) < 0.01] = 32767
        coef.append(c.astype(np.int32))
    tus, cus, ts_used = [], [], set()
    for comp in (0, 1):
        w_c, h_c = sizes[comp]
        rects = []
        for y0 in range(0, h_c, 64):
            for x0 in range(0, w_c, 64):
                _tile(rng, x0, y0, 64, 64, rects)
        for x, y, w, h in rects:
            mts = [0, 0, 0]
            comps = (0,) if comp == 0 else (1, 2)
            for c in comps:
                if max(w, h) <= 32 and (c, w, h) not in ts_used \
                        and rng.random() < 0.1:
                    mts[c] = MTS_SKIP
                    ts_used.add((c, w, h))
                elif c == 0 and 4 <= min(w, h) and max(w, h) <= 32:
                    mts[0] = int(rng.choice([0, 2, 3, 4, 5]))
            cbf = [1, 0, 0] if comp == 0 else \
                [0] + [[1, 1], [1, 0], [0, 1]][rng.integers(3)]
            blocks = [(x, y, w, h), None, None] if comp == 0 \
                else [None, (x, y, w, h), (x, y, w, h)]
            tus.append(NS(cu_idx=len(cus), blocks=blocks, cbf=cbf,
                          joint_cbcr=0, mts_idx=mts,
                          qp=int(rng.integers(0, 52)),
                          chroma_qp=[int(q) for q in
                                     rng.integers(0, 64, 2)]))
            cus.append(NS(pred_mode=MODE_INTRA, lfnst_idx=0, mip_flag=False,
                          isp_mode=0, sbt_info=0, color_transform=False,
                          tree_type=0, intra_dir=[0, 0]))
    sps = NS(bit_depth=BD, chroma_format_idc=1, mts_enabled=True,
             explicit_mts_intra=True, qp_bd_offset=12,
             internal_minus_input_bit_depth=0,
             scaling_matrix_for_lfnst_disabled=False,
             scaling_matrix_for_alt_cs_disabled=False,
             scaling_matrix_designated_cs=False)
    # scaling lists for luma 8x8 and Cb 4x4 (key: list type, log2 w, log2 h)
    dq_tables = {(0, 3, 3): rng.integers(1, 64, (8, 8)).astype(np.int32),
                 (1, 2, 2): rng.integers(1, 64, (4, 4)).astype(np.int32)}
    return NS(sps=sps, ph=NS(joint_cbcr_sign=0), num_comp=3,
              comp_size=sizes, coef=coef, tus=tus, cus=cus,
              scaling_list=object(), _dq_tables=dq_tables,
              sh_of=lambda cu: NS(dep_quant_used=dep_quant))


def _planes_equal(cs, got, want) -> bool:
    """Residual planes equal everywhere but their bottom-right margin
    corner, where the reference parks its power-of-two padding TUs: the
    picture area and the right and bottom margins, which the TUs that
    run past the edges write."""
    return all(np.array_equal(a[:h_c], b[:h_c])
               and np.array_equal(a[:, :w_c], b[:, :w_c])
               for (w_c, h_c), a, b in zip(cs.comp_size, got, want))


@pytest.mark.parametrize("dep_quant", [False, True])
def test_itx_frame_ref_matches_jax_fuzzed(dep_quant):
    """itx_residual_device of both packages on a fuzzed mixed-shape
    frame (the port's kernel TUs through itx_frame_ref on the CPU):
    all three components, shapes 2x8 to 64x64, TU windows that start
    past the plane edges, transform-skip and scaling-list TUs between
    them; bit-equal."""
    from vvdec_tpu.ops.frame_device import itx_residual_device as ref
    from vvdec_tpu_torch.ops.frame_device import itx_residual_device
    from vvdec_tpu_torch.state import to_numpy

    cs = _fuzz_cs(5 + dep_quant, dep_quant)
    shapes = {(t.blocks[c][3], t.blocks[c][2]) for t in cs.tus
              for c in range(3) if t.blocks[c] is not None}
    assert {(64, 64), (32, 32), (16, 16), (2, 8), (8, 2)} <= shapes
    edge = [t for t in cs.tus for c in range(3) if t.blocks[c] is not None
            and (t.blocks[c][0] >= cs.comp_size[c][0]
                 or t.blocks[c][1] >= cs.comp_size[c][1])]
    assert len(edge) >= 10
    want = [np.asarray(r) for r in ref(cs)]
    got = to_numpy(itx_residual_device(cs, "cpu"))
    assert _planes_equal(cs, got, want)


def test_itx_residual_device_one_kernel_call_per_frame(monkeypatch):
    """All plain TUs of a frame go through one itx_frame_cuda call; the
    stage's own per-group gather (outside that call, whose plain version
    gathers on the CPU) runs only for the transform-skip and
    scaling-list groups."""
    import vvdec_tpu_torch.ops.frame_device as F

    cs = _fuzz_cs(5, False)
    calls, extracts = [], []
    real_frame, real_extract = F.itx_frame_cuda, F._extract_fn

    def frame(*args, **kw):
        calls.append(kw["n_tasks"])
        monkeypatch.setattr(F, "_extract_fn", real_extract)
        try:
            return real_frame(*args, **kw)
        finally:
            monkeypatch.setattr(F, "_extract_fn", extract)

    def extract(h, w):
        extracts.append((h, w))
        return real_extract(h, w)

    monkeypatch.setattr(F, "itx_frame_cuda", frame)
    monkeypatch.setattr(F, "_extract_fn", extract)
    F.itx_residual_device(cs, "cpu")
    assert len(calls) == 1 and calls[0] > 0
    ts_shapes = {(t.blocks[c][3], t.blocks[c][2]) for t in cs.tus
                 for c in range(3) if t.mts_idx[c] == 1 and t.cbf[c]
                 and t.blocks[c] is not None}
    assert ts_shapes and extracts
    assert set(extracts) <= ts_shapes | {(8, 8), (4, 4)}


SIDES_ALL = (2, 4, 8, 16, 32, 64)
CELLS = 22      # the random tables' TUs sit in distinct cells of 64x64


def _random_groups(rng, n_groups=16):
    """Kernel groups for frame_table, (comp, w, h, hor, ver, dep_quant)
    with (x, y, qp) items; every TU in a 64x64 cell of its own on a
    CELLS x CELLS grid, so no two TUs of a component overlap."""
    cells = rng.permutation(CELLS * CELLS)
    groups, used = [], 0
    for _ in range(n_groups):
        h, w = (int(s) for s in rng.choice(SIDES_ALL, 2))
        kinds = _kinds(h, w) if min(h, w) >= 4 else [("DCT2", "DCT2")]
        hor, ver = kinds[rng.integers(len(kinds))]
        items = []
        for cell in cells[used:used + int(rng.integers(1, 30))]:
            cy, cx = divmod(int(cell), CELLS)
            items.append((cx * 64 + w * int(rng.integers(64 // w)),
                          cy * 64 + h * int(rng.integers(64 // h)),
                          int(rng.integers(-10, 70))))
        used += len(items)
        groups.append(((int(rng.integers(3)), w, h, hor, ver,
                        bool(rng.integers(2))), items))
    return groups


def test_frame_table_dequant_params_match_device_path():
    """The numpy work table's scale / rshift / imax equal what
    dequant_params gives on torch QP tensors (the device path), and each
    row carries its group's component, position, sizes and matrices."""
    from vvdec_tpu_torch.ops.cuda.itx import (
        dequant_params,
        frame_table,
        pool_offset,
        table_rows,
    )
    groups = _random_groups(np.random.default_rng(2))
    table, n_tasks = frame_table(groups, BD)
    rows = sorted(map(tuple, table_rows(table, n_tasks).tolist()))
    want = []
    for (comp, w, h, hor, ver, dq), items in groups:
        qp = torch.tensor([q for _, _, q in items], dtype=torch.int32)
        params = torch.stack(dequant_params(qp, w, h, BD, dq), 1).tolist()
        want += [(comp, y, x, h.bit_length() - 1, w.bit_length() - 1,
                  pool_offset(ver, h), pool_offset(hor, w), *prm)
                 for (x, y, _), prm in zip(items, params)]
    assert rows == sorted(want)


def test_frame_table_schedule():
    """Tasks: every TU with both sides >= 16 alone, largest first; then
    small TUs of one shape per task, at most SMALL_CAP coefficients (one
    TU where it alone has more, as 8x64 has)."""
    from vvdec_tpu_torch.ops.cuda.itx import (
        SMALL_CAP,
        frame_table,
        table_rows,
    )
    table, n_tasks = frame_table(_random_groups(np.random.default_rng(4)),
                                 BD)
    starts = table[:n_tasks + 1]
    rows = table_rows(table, n_tasks)
    assert starts[0] == 0 and starts[-1] == len(rows)
    assert (np.diff(starts) > 0).all()
    large = (rows[:, 3] >= 4) & (rows[:, 4] >= 4)
    n_large = int(large.sum())
    assert 0 < n_large < len(rows)
    assert large[:n_large].all() and not large[n_large:].any()
    assert (np.diff(rows[:n_large, 3] + rows[:n_large, 4]) <= 0).all()
    assert list(starts[:n_large + 1]) == list(range(n_large + 1))
    big = []
    for a, b in zip(starts[n_large:-1], starts[n_large + 1:]):
        shape = {(r[3], r[4]) for r in rows[a:b]}
        assert len(shape) == 1
        lh, lw = shape.pop()
        assert b - a == max(1, min(SMALL_CAP >> (lh + lw), b - a))
        big.append((lh + lw > 8) and b - a == 1)
    assert any(big)
    assert frame_table([], BD)[1] == 0


def _split_product(a, m):
    """sum_k a[i, k] * m[k, j] the way the kernel's tensor cores form it:
    a (|a| <= 2^15) split into hi = a >> 8 (s8) and lo = a & 255 (u8),
    each multiplied by the s8 matrix in depth steps of 32 (a side of 16
    padded with zeros) with int32 accumulation, recombined as
    (hi << 8) + lo in int32."""
    k = a.shape[1]
    kd = max(k, 32)
    hi = np.zeros((a.shape[0], kd), np.int8)
    lo = np.zeros((a.shape[0], kd), np.uint8)
    hi[:, :k] = a >> 8
    lo[:, :k] = a & 255
    m8 = np.zeros((kd, m.shape[1]), np.int8)
    m8[:k] = m
    assert np.array_equal(m8[:k], m)
    acc_hi = np.zeros((a.shape[0], m.shape[1]), np.int32)
    acc_lo = np.zeros_like(acc_hi)
    for k0 in range(0, kd, 32):
        mk = m8[k0:k0 + 32].astype(np.int32)
        acc_hi += hi[:, k0:k0 + 32].astype(np.int32) @ mk
        acc_lo += lo[:, k0:k0 + 32].astype(np.int32) @ mk
        assert np.abs(acc_hi).max() < 2 ** 21
        assert np.abs(acc_lo).max() < 2 ** 21
    return (acc_hi << 8) + acc_lo


@pytest.mark.parametrize("kind,n", POOL_MATRICES)
def test_imma_split_is_exact(kind, n):
    """The hi/lo int8 split of the tensor-core passes equals the direct
    int32 product for every transform matrix, in the vertical pass
    (deq^T x Mv) and the horizontal pass (tmp^T x Mh), with operands at
    +-2^15 and rows chosen to drive each output to its largest
    magnitude; the pool holds each matrix as s8, transposed and then as
    it stands."""
    from vvdec_tpu_torch.ops.cuda.itx import matrix_pool, pool_offset
    from vvdec_tpu_torch.ops.tables import tr_matrix
    m = np.asarray(tr_matrix(kind, n), dtype=np.int64)
    off = pool_offset(kind, n)
    pool = matrix_pool("cpu").numpy()
    assert np.array_equal(pool[off:off + n * n].reshape(n, n).T, m)
    plain = off + -(-n * n // 16) * 16
    assert np.array_equal(pool[plain:plain + n * n].reshape(n, n), m)
    rng = np.random.default_rng(n)
    ext = np.where(m.T >= 0, 32767, -32768)     # row j maximises column j
    extremes = np.concatenate([np.full((2, n), -32768),
                               np.full((2, n), 32767), ext, -ext - 1])
    deq = np.concatenate([extremes, rng.integers(-32768, 32768, (16, n))])
    vert = deq @ m
    assert np.abs(vert).max() < 2 ** 28
    assert np.array_equal(_split_product(deq, m), vert)
    tmp = np.concatenate([np.clip((vert + 64) >> 7, -32768, 32767),
                          extremes])
    assert np.array_equal(_split_product(tmp, m), tmp @ m)


@pytest.mark.cuda
def test_itx_frame_kernel_matches_ref_on_card():
    """On the card: the port's itx_residual_device on CUDA == on the CPU
    on fuzzed frames, and itx_frame_cuda == itx_frame_ref on random work
    tables whose TUs run past the coefficient planes' edges (reads
    clamped), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.ops.cuda.itx import (
        frame_table,
        itx_frame_cuda,
        itx_frame_ref,
        matrix_pool,
    )
    from vvdec_tpu_torch.ops.frame_device import itx_residual_device
    from vvdec_tpu_torch.state import to_numpy, to_torch

    for seed, dq in ((5, False), (6, True)):
        cs = _fuzz_cs(seed, dq)
        got = to_numpy(itx_residual_device(cs, "cuda"))
        want = to_numpy(itx_residual_device(cs, "cpu"))
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), seed
    rng = np.random.default_rng(8)
    pool = matrix_pool("cuda")
    side = CELLS * 64
    for seed in range(3):
        table, n_tasks = frame_table(_random_groups(rng), BD)
        table = to_torch(table, "cuda")
        coef = to_torch([rng.integers(-32768, 32768, (side - 90, side - 60))
                         .astype(np.int16) for _ in range(3)], "cuda")
        resi = [torch.full((side + 64, side + 64), 7, dtype=torch.int32,
                           device="cuda") for _ in range(3)]
        before = itx_frame_cuda.launches
        got = itx_frame_cuda(coef, [r.clone() for r in resi], table, pool,
                             n_tasks=n_tasks, bit_depth=BD)
        assert itx_frame_cuda.launches == before + 1
        want = itx_frame_ref(coef, [r.clone() for r in resi], table, pool,
                             n_tasks=n_tasks, bit_depth=BD)
        torch.cuda.synchronize()
        for c in range(3):
            assert torch.equal(got[c], want[c]), (seed, c)
