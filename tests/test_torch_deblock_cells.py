"""Fuzz tests of the port's whole-frame filter cores against the JAX
cores of vvdec_tpu/ops/pipeline.py, on the CPU: the deblocking cell
filters (_deblock_luma_cells_core, _deblock_chroma_cells_core), the ALF
diamond (_alf_diamond_core), CC-ALF (_ccalf_core) and SAO
(_sao_apply_core).

Tolerance: bit-equal (integer arithmetic).  The inputs are made with
numpy from a seed, at 10 and at 8 bits (the tc rounding branch below 10
bits): smooth planes with steps and noise, so that every decision of the
deblocking tree is taken; every max filter length in {1, 2, 3, 5, 7} on
each side, bs in {0, 1, 2}, QP 0-63, offsets -6..6, cells on the
picture's first and last rows and columns (their 16-sample windows read
past the picture and are clamped) and padding rows beyond n_valid.  The
edges are laid out so that no two cells write one sample, as in a
picture; a spy on _scatter_cells checks that every write is distinct.
The ALF and CC-ALF clamp windows are random, a few empty (lo > hi).
The JAX cores are called directly (eager), not through their jit
wrappers.
"""

import numpy as np
import pytest

import vvdec_tpu_torch.ops.pipeline as TP
from vvdec_tpu_torch.state import to_numpy, to_torch

H, W = 64, 96          # luma plane
HC, WC = 32, 48        # 4:2:0 chroma plane
CTU = 32
N_PAD = 256
LENGTHS = (1, 2, 3, 5, 7)


def _jax(core, *args):
    import jax.numpy as jnp
    return np.asarray(core(*(jnp.asarray(a) for a in args)))


def _port(core, *args):
    return to_numpy(core(*to_torch(args, "cpu")))


def _plane(rng, h, w, bd):
    """A smooth plane (bilinear ramps between random anchors) with
    random steps and noise, in [0, 2^bd)."""
    ys = np.linspace(0, 3, h)[:, None]
    xs = np.linspace(0, 3, w)[None, :]
    a = rng.integers(0, 1 << bd, size=4)
    base = a[0] + (a[1] - a[0]) * xs / 3 + (a[2] - a[0]) * ys / 3
    steps = rng.integers(-(1 << (bd - 5)), 1 << (bd - 5), size=(h // 8 + 1,
                                                                 w // 8 + 1))
    base = base + np.kron(steps, np.ones((8, 8)))[:h, :w]
    base = base + rng.integers(-2, 3, size=(h, w))
    return np.clip(base, 0, (1 << bd) - 1).astype(np.int32)


def _edges(rng, extent, exts):
    """Edge positions along one axis of length `extent` with (p, q)
    write extents drawn from `exts`: the first edge's p side reaches
    sample 0, the last edge lies within 7 samples of the end (its window
    reads past it), and no two edges' writes overlap."""
    out = []
    p = int(rng.choice(exts))
    x = p
    while x + 3 * max(exts) < extent:
        q = int(rng.choice(exts))
        out.append((x, p, q))
        p = int(rng.choice(exts))
        x = x + q + p + int(rng.integers(0, 5))
    q = int(rng.choice(exts))
    last = extent - q
    while out and last - (out[-1][0] + out[-1][2]) < 1:
        out.pop()
    room = last - (out[-1][0] + out[-1][2]) if out else last
    out.append((last, max(e for e in exts if e <= room), q))
    return out


def _luma_cells(rng, direction, bd):
    """cells [N_PAD, 2] and params [N_PAD, 6] for one direction; each
    cell's writes fit its edge's write extents."""
    along, across = (H, W) if direction == 0 else (W, H)
    cells, params = [], []
    # edges with room for the long filters more often than not
    for e, p_ext, q_ext in _edges(rng, across, LENGTHS + (5, 7)):
        for t in range(0, along, 4):
            if rng.random() < 0.35 and t not in (0, along - 4):
                continue
            # a long filter writes 3 samples on the other side whatever
            # that side's own length
            mfp = int(rng.choice([v for v in LENGTHS if v <= p_ext
                                  and (v <= 3 or q_ext >= 3)]))
            mfq = int(rng.choice([v for v in LENGTHS if v <= q_ext
                                  and (v <= 3 or p_ext >= 3)]))
            x, y = (e, t) if direction == 0 else (t, e)
            cells.append((x, y))
            params.append((int(rng.choice([0, 1, 2, 2])),
                           int(rng.integers(0, 64)), mfp, mfq,
                           int(rng.integers(-6, 7)), int(rng.integers(-6, 7))))
    n = len(cells)
    assert 0 < n <= N_PAD
    c = np.zeros((N_PAD, 2), np.int32)
    prm = np.zeros((N_PAD, 6), np.int32)
    c[:n] = cells
    prm[:n] = params
    return c, prm, n


def _chroma_cells(rng, direction, loop_len):
    along, across = (HC, WC) if direction == 0 else (WC, HC)
    cells, params = [], []
    for e, p_ext, q_ext in _edges(rng, across, (1, 3, 3)):
        for t in range(0, along, loop_len):
            if rng.random() < 0.35 and t not in (0, along - loop_len):
                continue
            large = int(p_ext == 3 and q_ext == 3 and rng.random() < 0.8)
            # the hor_ctb variant writes one sample on the p side
            hor_ctb = int(direction == 1 and rng.random() < 0.4)
            x, y = (e, t) if direction == 0 else (t, e)
            cells.append((x, y))
            params.append((int(rng.choice([0, 1, 2, 2])),
                           int(rng.integers(0, 64)), large,
                           int(rng.integers(-6, 7)), int(rng.integers(-6, 7)),
                           hor_ctb))
    n = len(cells)
    assert 0 < n <= N_PAD
    c = np.zeros((N_PAD, 2), np.int32)
    prm = np.zeros((N_PAD, 6), np.int32)
    c[:n] = cells
    prm[:n] = params
    return c, prm, n


LOOP_LEN = 2           # 4:2:0 chroma lines per cell


def _luma_case(direction, bd):
    rng = np.random.default_rng(100 * bd + direction)
    return (_plane(rng, H, W, bd),) + _luma_cells(rng, direction, bd)


def _chroma_case(direction, bd):
    rng = np.random.default_rng(200 * bd + direction)
    return (_plane(rng, HC, WC, bd),) + _chroma_cells(rng, direction,
                                                       LOOP_LEN)


@pytest.fixture
def distinct_writes(monkeypatch):
    """Counts the samples each core call writes, failing on a repeat."""
    counts = []
    real = TP._scatter_cells

    def spy(flat, idx, val):
        assert idx.unique().numel() == idx.numel(), "a sample written twice"
        counts.append(idx.numel())
        return real(flat, idx, val)

    monkeypatch.setattr(TP, "_scatter_cells", spy)
    return counts


@pytest.mark.parametrize("bd", [10, 8])
@pytest.mark.parametrize("direction", [0, 1])
def test_luma_cells_match_jax(direction, bd, distinct_writes):
    import vvdec_tpu.ops.pipeline as JP
    plane, cells, params, n = _luma_case(direction, bd)
    want = _jax(JP._deblock_luma_cells_core(H, W, direction, bd, CTU, N_PAD),
                plane, cells, params, n)
    got = _port(TP._deblock_luma_cells_core(H, W, direction, bd, CTU, N_PAD),
                plane, cells, params, n)
    assert np.array_equal(got, want)
    # the cells changed the plane, and wrote distinct samples
    assert distinct_writes[-1] > 0 and not np.array_equal(want, plane)


@pytest.mark.parametrize("bd", [10, 8])
@pytest.mark.parametrize("direction", [0, 1])
def test_chroma_cells_match_jax(direction, bd, distinct_writes):
    import vvdec_tpu.ops.pipeline as JP
    plane, cells, params, n = _chroma_case(direction, bd)
    args = (HC, WC, direction, bd, LOOP_LEN, 1, N_PAD)
    want = _jax(JP._deblock_chroma_cells_core(*args), plane, cells, params, n)
    got = _port(TP._deblock_chroma_cells_core(*args), plane, cells, params, n)
    assert np.array_equal(got, want)
    assert distinct_writes[-1] > 0 and not np.array_equal(want, plane)


@pytest.mark.parametrize("bd", [10, 8])
@pytest.mark.parametrize("direction", [0, 1])
def test_cell_layout_reaches_every_edge(direction, bd):
    """The layouts of the two tests above put cells on the first and
    last lines along each edge, edges whose windows read past both ends
    of the picture, and draw every max filter length (luma), large and
    small chroma cells, and every bs."""
    for case, (h, w), step, reach in ((_luma_case, (H, W), 4, 8),
                                      (_chroma_case, (HC, WC), LOOP_LEN, 4)):
        _, cells, params, n = case(direction, bd)
        along, across = (cells[:n, 1], cells[:n, 0]) if direction == 0 \
            else (cells[:n, 0], cells[:n, 1])
        size_along, size_across = (h, w) if direction == 0 else (w, h)
        assert along.min() == 0 and along.max() == size_along - step
        assert across.min() - reach < 0
        assert across.max() + reach > size_across
        assert set(params[:n, 0]) == {0, 1, 2}
        if case is _luma_case:
            assert set(params[:n, 2]) | set(params[:n, 3]) == set(LENGTHS)
        else:
            assert set(params[:n, 2]) == {0, 1}


def _windows(rng, h, w):
    """Random per-pixel clamp windows [lo, hi] around each sample, a few
    of them empty (lo > hi)."""
    ys, xs = np.mgrid[0:h, 0:w]
    lo_x = np.clip(xs - rng.integers(0, 6, (h, w)), 0, w - 1)
    hi_x = np.clip(xs + rng.integers(0, 6, (h, w)), 0, w - 1)
    lo_y = np.clip(ys - rng.integers(0, 6, (h, w)), 0, h - 1)
    hi_y = np.clip(ys + rng.integers(0, 6, (h, w)), 0, h - 1)
    empty = rng.random((h, w)) < 0.02
    lo_x[empty] = np.minimum(hi_x[empty] + 1, w - 1)
    return [a.astype(np.int32) for a in (lo_x, lo_y, hi_x, hi_y)]


@pytest.mark.parametrize("bd", [10, 8])
@pytest.mark.parametrize("n_taps", [12, 6])
def test_alf_diamond_matches_jax(n_taps, bd):
    import vvdec_tpu.ops.pipeline as JP
    rng = np.random.default_rng(n_taps * 10 + bd)
    h, w = (H, W) if n_taps == 12 else (HC, WC)
    src = _plane(rng, h, w, bd)
    co = rng.integers(-64, 64, size=(h, w, n_taps)).astype(np.int32)
    cl = rng.choice([0, 1 << (bd - 7), 1 << (bd - 5), 1 << (bd - 3),
                     (1 << bd) - 1], size=(h, w, n_taps)).astype(np.int32)
    dmap = np.zeros((h, 4), np.int32)
    dmap[:, 1:] = rng.integers(0, 4, size=(h, 3))
    near = rng.random(h) < 0.2
    mask = rng.random((h, w)) < 0.9
    args = (src, co, cl, dmap, near, *_windows(rng, h, w), mask)
    want = _jax(JP._alf_diamond_core(h, w, bd, n_taps), *args)
    assert np.array_equal(_port(TP._alf_diamond_core(h, w, bd, n_taps),
                                *args), want)
    assert not np.array_equal(want, src)


@pytest.mark.parametrize("bd", [10, 8])
def test_ccalf_matches_jax(bd):
    import vvdec_tpu.ops.pipeline as JP
    rng = np.random.default_rng(300 + bd)
    luma = _plane(rng, H, W, bd)
    dst = _plane(rng, HC, WC, bd)
    coeff = rng.integers(-64, 65, size=(HC, WC, 7)).astype(np.int32)
    off_rows = np.array([(1, -1, 2), (1, -1, 1), (0, 0, 0)],
                        np.int32)[rng.integers(0, 3, HC)]
    skip_rows = rng.random(HC) < 0.1
    # luma-coordinate windows gathered at each chroma sample's luma
    windows = [a[::2, ::2] for a in _windows(rng, H, W)]
    active = rng.random((HC, WC)) < 0.8
    args = (luma, dst, coeff, off_rows, skip_rows, *windows, active)
    want = _jax(JP._ccalf_core(HC, WC, bd, 1, 1), *args)
    assert np.array_equal(_port(TP._ccalf_core(HC, WC, bd, 1, 1), *args),
                          want)
    assert not np.array_equal(want, dst)


@pytest.mark.parametrize("bd", [10, 8])
def test_sao_apply_matches_jax(bd):
    """Every SAO type (EO classes 0-3, band offset, off) per CTU, the
    parameter table looked up by the per-pixel CTU index."""
    import vvdec_tpu.ops.pipeline as JP
    rng = np.random.default_rng(400 + bd)
    src = _plane(rng, H, W, bd)
    n_ctu = (H // 16) * (W // 16)
    ctu = (np.arange(H)[:, None] // 16) * (W // 16) + np.arange(W)[None] // 16
    types = rng.choice([0, 1, 2, 3, 4, 255], size=n_ctu)
    typ = types[ctu].astype(np.uint8)
    tables = rng.integers(-7, 8, size=(n_ctu, 37)).astype(np.int32)
    mask = (typ != 255) & (rng.random((H, W)) < 0.95)
    args = (src, typ, ctu.astype(np.int32), tables, mask)
    want = _jax(JP._sao_apply_core(H, W, bd), *args)
    assert np.array_equal(_port(TP._sao_apply_core(H, W, bd), *args), want)
    assert not np.array_equal(want, src)
