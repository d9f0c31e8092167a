"""The port's MIP, CCLM and LMCS stages against the JAX reference.

Tolerance: bit-equal everywhere (integer arithmetic).  Both packages get
the same inputs: descriptor rows, reference arrays, planes and LMCS
tables made with numpy from a seed (or parsed from 128x96 streams by the
reference), handed over through vvdec_tpu_torch.state.  The fuzzed rows
push the reads past the plane edges and the table indices past both
ends of their tables, where the reference's gathers clamp (or wrap a
negative index once) and its masked sums give 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.test_frame_device as tfd
from vvdec_tpu.testenc.encoder import generate_stream
from vvdec_tpu_torch.state import to_numpy, to_torch

BD = 10


def _jax(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_jax(v) for v in x)
    return jnp.asarray(x)


def _refs(rng, n):
    from vvdec_tpu_torch.ops.intra_device import RL
    return (rng.integers(0, 1 << BD, size=(n, RL)).astype(np.int32),
            rng.integers(0, 1 << BD, size=(n, RL)).astype(np.int32))


# ---------------------------------------------------------------- MIP
_MIP_SIZES = {0: [(4, 4)],
              1: [(4, 8), (8, 4), (8, 8), (4, 16), (16, 4), (4, 64),
                  (64, 4)],
              2: [(8, 16), (16, 8), (16, 16), (32, 32), (64, 64), (8, 64),
                  (64, 8), (32, 16)]}
_MIP_MODES = {0: 16, 1: 8, 2: 6}


def _mip_rows(rng, sid):
    from vvdec_tpu_torch.ops.intra_device import D
    rows = []
    # every mode of the size class, transposed and not, plus modes past
    # both ends of the class's matrix set (the reference clamps them)
    modes = list(range(_MIP_MODES[sid])) + [-2, _MIP_MODES[sid] + 3]
    for w, h in _MIP_SIZES[sid]:
        for mode in modes:
            for tr in (0, 1):
                d = np.zeros(D, dtype=np.int32)
                d[[3, 4, 5, 6]] = (w, h, w.bit_length() - 1,
                                   h.bit_length() - 1)
                d[[7, 24, 25, 26, 28]] = (3, mode, tr, sid, 1)
                rows.append(d)
    return np.stack(rows)


@functools.lru_cache(maxsize=None)
def _jax_mip():
    import vvdec_tpu.ops.intra_device as R
    from vvdec_tpu.ops.tables import MIP_4x4, MIP_8x8, MIP_16x16
    m = [jnp.asarray(a, dtype=jnp.int32) for a in (MIP_4x4, MIP_8x8,
                                                   MIP_16x16)]
    return jax.jit(jax.vmap(lambda t, l, d: R._pred_mip(t, l, d, BD, *m)))


@pytest.mark.parametrize("sid", [0, 1, 2])
def test_pred_mip_matches(sid):
    """_pred_mip of K units at once == the reference's per unit: every
    mode of the size class, transposed and not, every block shape of the
    class, modes outside the matrix set."""
    import vvdec_tpu_torch.ops.intra_device as T
    rng = np.random.default_rng(100 + sid)
    d = _mip_rows(rng, sid)
    top, left = _refs(rng, d.shape[0])
    want = np.asarray(_jax_mip()(*_jax((top, left, d))))
    got = to_numpy(T._pred_mip(*to_torch((top, left, d), "cpu"), BD))
    only = to_numpy(T._pred_mip(*to_torch((top, left, d), "cpu"), BD,
                                sids=[sid]))
    for i in range(d.shape[0]):
        w, h = d[i, 3], d[i, 4]
        assert np.array_equal(got[i, :h, :w], want[i, :h, :w]), d[i]
    assert np.array_equal(got, want)
    assert np.array_equal(only, want)


# --------------------------------------------------------------- CCLM
def _cclm_rows(rng, n, cfmt, lh, lw):
    from vvdec_tpu_torch.ops.intra_device import D
    sub_w = 2 if cfmt in (1, 2) else 1
    sub_h = 2 if cfmt == 1 else 1
    cw, ch = lw // sub_w, lh // sub_h
    d = np.zeros((n, D), dtype=np.int32)
    sides = np.array([2, 4, 8, 16, 32])
    d[:, 0] = rng.integers(1, 3, n)
    d[:, 3] = rng.choice(sides, n)
    d[:, 4] = rng.choice(sides, n)
    # positions at the top-left corner (luma reads at -1, -2 wrap), in
    # the picture, and past its right / bottom edge (reads clamp)
    d[:, 1] = rng.integers(-2, cw + 8, n)
    d[:, 2] = rng.integers(-2, ch + 8, n)
    d[: n // 8, 1:3] = 0
    d[:, 7] = 4
    d[:, 23] = rng.integers(0, 2, n)                 # build_left
    d[:, 27] = rng.integers(0, 2, n)                 # build_above
    d[:, 24] = d[:, 3] * rng.integers(0, 3, n)       # actual_top
    d[:, 25] = d[:, 4] * rng.integers(0, 3, n)       # actual_left
    d[:, 26] = rng.integers(0, 4, n)                 # above | left << 1
    d[:, 28] = 1
    return d


@pytest.mark.parametrize("cfmt", [1, 2, 3])
@pytest.mark.parametrize("collocated", [True, False])
def test_pred_cclm_matches(cfmt, collocated):
    """_pred_cclm of K units == the reference's per unit, on a luma
    plane of the stacked scan shape (picture 128x96 plus PB, at least
    RL), with units whose luma reads leave the picture on every side."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    rng = np.random.default_rng(10 * cfmt + collocated)
    lw, lh = tfd.WH
    hh, ww = max(lh + T.PB, T.RL), max(lw + T.PB, T.RL)
    luma = rng.integers(0, 1 << BD, size=(hh, ww)).astype(np.int32)
    d = _cclm_rows(rng, 160, cfmt, lh, lw)
    top, left = _refs(rng, d.shape[0])
    for ctu_log2 in (5, 6):
        fn = jax.jit(jax.vmap(
            lambda t, l, dd, lu: R._pred_cclm(t, l, dd, lu, BD, cfmt,
                                              collocated, ctu_log2),
            in_axes=(0, 0, 0, None)))
        want = np.asarray(fn(*_jax((top, left, d, luma))))
        got = to_numpy(T._pred_cclm(*to_torch((top, left, d, luma), "cpu"),
                                    BD, cfmt, collocated, ctu_log2))
        assert np.array_equal(got, want)


# --------------------------------------------------------------- LMCS
def _lm(rng):
    """A fuzzed LMCS table: non-decreasing pivots, bins anywhere."""
    from vvdec_tpu_torch.ops.intra_device import LM_LEN
    lm = np.zeros(LM_LEN, dtype=np.int32)
    lm[0:17] = np.sort(rng.integers(0, 1 << BD, 17))
    lm[17:33] = np.sort(rng.integers(0, 1 << BD, 16))
    lm[33:49] = rng.integers(0, 1 << 12, 16)
    lm[49:65] = rng.integers(0, 1 << 13, 16)
    lm[65] = rng.integers(0, 8)
    lm[66] = rng.integers(lm[65], 16)
    lm[67], lm[68] = 96, 128
    return lm


def test_lmcs_table_helpers_match():
    """_sel16 (indices past both ends of each table read 0),
    _pwl_idx_inv_dev, _scale_signal_dev and lmcs_inv_map on fuzzed
    tables and values outside the sample range."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    rng = np.random.default_rng(7)
    for _ in range(8):
        lm = _lm(rng)
        lm_t = to_torch(lm, "cpu")
        idx = rng.integers(-4, 21, size=(6, 7)).astype(np.int32)
        for base in (0, 17, 33, 49):
            assert np.array_equal(
                to_numpy(T._sel16(lm_t, base, to_torch(idx, "cpu"))),
                np.asarray(R._sel16(jnp.asarray(lm), base,
                                    jnp.asarray(idx))))
        v = rng.integers(-100, 1200, size=(9, 11)).astype(np.int32)
        assert np.array_equal(
            to_numpy(T._pwl_idx_inv_dev(to_torch(v, "cpu"), lm_t)),
            np.asarray(R._pwl_idx_inv_dev(jnp.asarray(v), jnp.asarray(lm))))
        assert np.array_equal(
            to_numpy(T.lmcs_inv_map(to_torch(v, "cpu"), lm_t, BD)),
            np.asarray(R.lmcs_inv_map(jnp.asarray(v), jnp.asarray(lm), BD)))
    r = rng.integers(-3000, 3000, size=(5, 8, 8)).astype(np.int32)
    scale = rng.integers(0, 1 << 14, size=5).astype(np.int32)
    want = np.stack([np.asarray(R._scale_signal_dev(jnp.asarray(r[k]),
                                                    int(scale[k]), BD))
                     for k in range(5)])
    got = to_numpy(T._scale_signal_dev(to_torch(r, "cpu"),
                                       to_torch(scale[:, None, None], "cpu"),
                                       BD))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("num_nb", [32, 64])
def test_chroma_scale_matches(num_nb):
    """_chroma_scale_dev of K units == the reference's per unit, with
    VPDU positions whose luma windows the clamp moves (at and past every
    edge) and every neighbour flag combination."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    rng = np.random.default_rng(num_nb)
    hh, ww = 160, 192
    luma = rng.integers(0, 1 << BD, size=(hh, ww)).astype(np.int32)
    n = 96
    d = np.zeros((n, T.D), dtype=np.int32)
    d[:, 29] = 1 | (rng.integers(0, 4, n) << 1)
    d[:, 30] = rng.integers(-4, ww + 4, n)
    d[:, 31] = rng.integers(-4, hh + 4, n)
    d[:4, 30:32] = ((0, 0), (ww - 1, hh - 1), (ww - num_nb, 0),
                    (0, hh - num_nb))
    for _ in range(3):
        lm = _lm(rng)
        lm[67], lm[68] = rng.integers(1, hh), rng.integers(1, ww)

        def one(dd, lm_=jnp.asarray(lm), lu=jnp.asarray(luma)):
            def rl(r, c, sh, sw):
                return jax.lax.dynamic_slice(lu, (r, c), (sh, sw))
            return R._chroma_scale_dev(rl, dd, lm_, BD, num_nb)

        want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(d)))
        got = to_numpy(T._chroma_scale_dev(to_torch(luma, "cpu"),
                                           to_torch(d, "cpu"),
                                           to_torch(lm, "cpu"), BD, num_nb))
        assert np.array_equal(got, want)


# ------------------------------------------------- the wavefront, whole
def _lmcs_stream(seed, chroma_scale, sps_kw=None, dec_kw=None):
    from tests.test_lmcs import _lmcs_stream as make
    return make(seed, 2, 2, sps_kw or {},
                dec_kw or dict(split_prob=0.5, density=0.4), chroma_scale,
                ctu=32, wh=tfd.WH)


# name -> stream maker (the tests/test_frame_device.py streams of each
# tool, and LMCS with MIP and CCLM in one picture)
FRAMES = {
    "mip": lambda: generate_stream(
        width=tfd.WH[0], height=tfd.WH[1], ctu=32, n_frames=1, seed=13,
        qp=30, sps_kw=dict(mip_enabled=True),
        dec_kw=dict(split_prob=0.4, density=0.3, mip_prob=0.9))[0],
    "cclm": lambda: generate_stream(
        width=tfd.WH[0], height=tfd.WH[1], ctu=32, n_frames=1, seed=51,
        qp=30, sps_kw=dict(cclm_enabled=True),
        dec_kw=dict(split_prob=0.4, density=0.3))[0],
    "lmcs_chroma_scale": lambda: _lmcs_stream(33, True),
    "lmcs_mip_cclm": lambda: _lmcs_stream(
        36, True, dict(mip_enabled=True, cclm_enabled=True),
        dict(split_prob=0.5, density=0.4, mip_prob=0.3)),
}


def _scan_inputs(name):
    """The reference's inputs of one frame's intra scan: residual
    planes, descriptors, key and (LMCS pictures) the LMCS table."""
    from vvdec_tpu.decoder import parse_annexb
    from vvdec_tpu.ops.frame_device import _lmcs_on, itx_residual_device
    from vvdec_tpu.ops.intra_device import (build_intra_descriptors,
                                            build_lmcs_params, scan_key)
    cs = parse_annexb(FRAMES[name]())[0].cs
    resi = tuple(np.asarray(r) for r in itx_residual_device(cs))
    desc, reason = build_intra_descriptors(cs)
    assert reason is None
    lm = None
    if _lmcs_on(cs):
        from vvdec_tpu.frame.lmcs_np import Reshaper
        lm = build_lmcs_params(Reshaper(cs.lmcs_info, cs.sps.bit_depth,
                                        bool(cs.ph.chroma_residual_scale)),
                               cs)
    return resi, desc, scan_key(cs), lm


@pytest.mark.parametrize("name,has_lmcs", [
    ("mip", False), ("mip", True), ("cclm", False), ("cclm", True),
    ("lmcs_chroma_scale", True), ("lmcs_mip_cclm", True)])
def test_intra_wavefront_tools_match(name, has_lmcs):
    """_intra_wavefront_fn(..., has_lmcs) on identical (planes, resis,
    batches, lm): a frame's real descriptors (MIP, CCLM and LMCS-scaled
    units among them), the reference's residual planes and planes of
    seeded noise, so every sample the units read shows in the output.
    Frames without LMCS get a fuzzed table, which no unit reads."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    rng = np.random.default_rng(len(name))
    resi, desc, key, lm = _scan_inputs(name)
    if lm is None:
        lm = _lm(rng)
    cls = set(desc[:, 7].tolist())
    assert {"mip": {3}, "cclm": {4}}.get(name, set()) <= cls
    if name.startswith("lmcs"):
        assert (desc[:, 29] & 1).any()
    if name == "lmcs_mip_cclm":
        assert {3, 4} <= cls
    lvl = R.compute_unit_levels(desc, key[1])
    batches = R.build_wavefront_batches(desc, lvl, T.WAVEFRONT_K)
    planes = tuple(rng.integers(0, 1 << BD, size=r.shape).astype(np.int32)
                   for r in resi)
    want = R._intra_wavefront_fn(*key, T.WAVEFRONT_K, has_lmcs)(
        *_jax((planes, resi, batches, lm)))
    got = T._intra_wavefront_fn(*key, T.WAVEFRONT_K, has_lmcs)(
        to_torch(planes, "cpu"), to_torch(resi, "cpu"), batches,
        to_torch(lm, "cpu"))
    for a, b in zip(to_numpy(got), want):
        assert np.array_equal(a, np.asarray(b))


def test_lmcs_params_match():
    """build_lmcs_params from each package's own parse and Reshaper."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu.frame.lmcs_np import Reshaper as RR
    from vvdec_tpu_torch.decoder import parse_annexb as parse_port
    from vvdec_tpu_torch.frame.lmcs_np import Reshaper as TR
    s = FRAMES["lmcs_chroma_scale"]()
    for fr, fp in zip(parse_ref(s), parse_port(s)):
        a = R.build_lmcs_params(RR(fr.cs.lmcs_info, BD, True), fr.cs)
        b = T.build_lmcs_params(TR(fp.cs.lmcs_info, BD, True), fp.cs)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(FRAMES))
def test_plan_accepts_intra_tools(name):
    """plan_frame_device takes MIP, CCLM and intra LMCS pictures, with
    the reference's descriptor rows."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu.ops.frame_device import plan_frame_device as plan_ref
    from vvdec_tpu_torch.decoder import parse_annexb as parse_port
    from vvdec_tpu_torch.ops.frame_device import plan_frame_device
    s = FRAMES[name]()
    for fr, fp in zip(parse_ref(s), parse_port(s)):
        want, r_ref = plan_ref(fr.cs)
        got, r_port = plan_frame_device(fp.cs)
        assert r_ref is None and r_port is None
        assert np.array_equal(got, want)


def test_window_starts_wrap_like_dynamic_slice():
    """A negative window start wraps once to start + dim before the
    clamp, as lax.dynamic_slice / dynamic_update_slice place it: the
    ITX stage's tile extract and scatter at starts below zero and past
    the far edge."""
    import vvdec_tpu.ops.frame_device as R
    import vvdec_tpu_torch.ops.frame_device as T
    rng = np.random.default_rng(12)
    plane = rng.integers(-3000, 3000, size=(40, 56)).astype(np.int16)
    ys = np.array([-1, -8, -39, -45, 36, 3], dtype=np.int32)
    xs = np.array([-3, 50, -60, -1, -20, 60], dtype=np.int32)
    h, w = 8, 4
    want = np.asarray(R._extract_fn(h, w, 6)(*_jax((plane, ys, xs))))
    got = to_numpy(T._extract_fn(h, w)(*to_torch((plane, ys, xs), "cpu")))
    assert np.array_equal(got, want)
    # disjoint destinations after the wrap, so the write order is moot
    ys, xs = ys[[0, 2, 5]], xs[[0, 2, 5]]
    blocks = rng.integers(-500, 500, size=(3, h, w)).astype(np.int32)
    base = np.zeros((40, 56), np.int32)
    want = np.asarray(R._scatter_fn(40, 56, h, w, 3)(
        *_jax((base, blocks, ys, xs))))
    got = to_numpy(T._scatter_fn(h, w)(
        *to_torch((base, blocks, ys, xs), "cpu")))
    assert np.array_equal(got, want)
