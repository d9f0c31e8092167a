"""The port's device stages against the JAX reference, stage by stage.

Tolerance: bit-equal everywhere (integer arithmetic).  Both packages get
the same inputs: the same parsed 128x96 frames and planes made with
numpy from a seed, handed over through vvdec_tpu_torch.state.  The
frames have intra units on the right and bottom picture borders, where
the reference's clamped `lax.dynamic_slice` windows and one-hot gathers
matter; the fuzzed descriptor rows below push the reference-sample
windows past the plane edges on purpose.
"""

import numpy as np
import pytest
import torch

from vvdec_tpu.testenc.encoder import generate_stream

WH = (128, 96)
STREAMS = {
    # tests/test_frame_device.py::TestFrameDevice::test_all_intra_basic
    "420": dict(n_frames=2, seed=5, qp=30,
                dec_kw=dict(split_prob=0.5, density=0.3)),
    # ... ::test_chroma_444
    "444": dict(n_frames=1, seed=11, qp=30, sps_kw=dict(chroma_format=3),
                dec_kw=dict(split_prob=0.4, density=0.3)),
}


@pytest.fixture(scope="module")
def frames():
    """{name: [(reference cs, port cs), ...]}: each stream parsed by both
    packages' own host planes."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu_torch.decoder import parse_annexb as parse_port
    out = {}
    for name, kw in STREAMS.items():
        s, _ = generate_stream(width=WH[0], height=WH[1], ctu=32, **kw)
        out[name] = list(zip([f.cs for f in parse_ref(s)],
                             [f.cs for f in parse_port(s)]))
    return out


def _jax(x):
    import jax.numpy as jnp
    if isinstance(x, (list, tuple)):
        return type(x)(_jax(v) for v in x)
    return jnp.asarray(x)


def _np(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return np.asarray(x)


def _recon_inputs(cs_ref):
    """Reference residual planes, descriptors and the zero planes the
    intra scan starts from (numpy)."""
    from vvdec_tpu.ops.frame_device import itx_residual_device
    from vvdec_tpu.ops.intra_device import build_intra_descriptors
    resi = _np(itx_residual_device(cs_ref))
    desc, reason = build_intra_descriptors(cs_ref)
    assert reason is None
    return resi, desc


def test_host_schedule_matches(frames):
    """build_intra_descriptors, compute_unit_levels and
    build_wavefront_batches are copies of the reference: same rows, same
    levels, same steps, including units on the right/bottom borders."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    for name, pairs in frames.items():
        for cs_ref, cs_port in pairs:
            d_ref, r_ref = R.build_intra_descriptors(cs_ref)
            d_port, r_port = T.build_intra_descriptors(cs_port)
            assert r_ref is None and r_port is None
            assert np.array_equal(d_ref, d_port)
            cfmt = cs_ref.sps.chroma_format_idc
            lv = R.compute_unit_levels(d_ref, cfmt)
            assert np.array_equal(lv, T.compute_unit_levels(d_port, cfmt))
            for k in (3, 8):
                assert np.array_equal(R.build_wavefront_batches(d_ref, lv, k),
                                      T.build_wavefront_batches(d_port, lv, k))
            w, h = cs_ref.comp_size[0]
            luma = d_ref[:, 0] == 0
            assert ((d_ref[:, 1] + d_ref[:, 3] == w) & luma).any()
            assert ((d_ref[:, 2] + d_ref[:, 4] == h) & luma).any()


@pytest.mark.parametrize("name", list(STREAMS))
def test_itx_residual_device_matches(frames, name):
    """itx_residual_device on parsed frames, picture area bit-equal (the
    reference parks its power-of-two batch padding in the margin)."""
    from vvdec_tpu.ops.frame_device import itx_residual_device as ref
    from vvdec_tpu_torch.ops.frame_device import itx_residual_device
    from vvdec_tpu_torch.state import to_numpy
    for cs_ref, cs_port in frames[name]:
        want = _np(ref(cs_ref))
        got = to_numpy(itx_residual_device(cs_port, "cpu"))
        for (w_c, h_c), a, b in zip(cs_ref.comp_size, got, want):
            assert a.shape == b.shape
            assert np.array_equal(a[:h_c, :w_c], b[:h_c, :w_c])


def test_int16_upload_wraps_like_reference(frames):
    """A level outside int16 (only a malformed stream has one) wraps in
    the one int16 upload per plane, in the port as in the reference."""
    from vvdec_tpu.ops.frame_device import itx_residual_device as ref
    from vvdec_tpu_torch.ops.frame_device import itx_residual_device
    from vvdec_tpu_torch.state import to_numpy
    cs_ref, cs_port = frames["420"][0]
    tu = next(t for t in cs_ref.tus if t.cbf[0] and t.blocks[0] is not None
              and not t.mts_idx[0])
    x, y = tu.blocks[0][:2]
    saved = cs_ref.coef[0][y, x], cs_port.coef[0][y, x]
    try:
        cs_ref.coef[0][y, x] = 40000
        cs_port.coef[0][y, x] = 40000
        want = _np(ref(cs_ref))[0]
        got = to_numpy(itx_residual_device(cs_port, "cpu"))[0]
    finally:
        cs_ref.coef[0][y, x], cs_port.coef[0][y, x] = saved
    w_c, h_c = cs_ref.comp_size[0]
    assert np.array_equal(got[:h_c, :w_c], want[:h_c, :w_c])


def test_extract_and_scatter_clamp_like_dynamic_slice():
    """Tiles whose start lies past the plane edge are read and written
    at the clamped start, as lax.dynamic_slice / dynamic_update_slice
    place them."""
    import vvdec_tpu.ops.frame_device as R
    import vvdec_tpu_torch.ops.frame_device as T
    from vvdec_tpu_torch.state import to_numpy, to_torch
    rng = np.random.default_rng(3)
    plane = rng.integers(-3000, 3000, size=(40, 56)).astype(np.int16)
    ys = np.array([0, 36, 39, 45, 8], dtype=np.int32)
    xs = np.array([52, 0, 55, 60, 16], dtype=np.int32)
    h, w = 8, 4
    want = _np(R._extract_fn(h, w, 5)(*_jax((plane, ys, xs))))
    got = to_numpy(T._extract_fn(h, w)(*to_torch((plane, ys, xs),
                                                    "cpu")))
    assert np.array_equal(got, want)
    blocks = rng.integers(-500, 500, size=(5, h, w)).astype(np.int32)
    base = np.zeros((40, 56), np.int32)
    want = _np(R._scatter_fn(40, 56, h, w, 5)(*_jax((base, blocks, ys, xs))))
    got = to_numpy(T._scatter_fn(h, w)(
        *to_torch((base, blocks, ys, xs), "cpu")))
    assert np.array_equal(got, want)


def _fuzz_rows(rng, n, hh, ww):
    """Descriptor rows with random reference-fill geometry, window
    starts and run ends beyond the plane included."""
    from vvdec_tpu_torch.ops.intra_device import D
    d = np.zeros((n, D), dtype=np.int32)
    sides = np.array([4, 8, 16, 32, 64])
    d[:, 0] = rng.integers(0, 3, n)
    d[:, 3] = rng.choice(sides, n)
    d[:, 4] = rng.choice(sides, n)
    d[:, 1] = rng.integers(0, ww - 3, n)
    d[:, 2] = rng.integers(0, hh - 3, n)
    d[:, 8] = rng.integers(0, 2, n)
    d[:, 10] = rng.random(n) < 0.1
    for a, b, k, t0, lo, hi, pos, size in ((11, 12, 13, 14, 15, 16, 2, ww),
                                           (17, 18, 19, 20, 21, 22, 1, hh)):
        # fill rows/cols adjacent (pos-1 or pos); runs clamp to [lo, hi]
        d[:, a] = d[:, pos] - rng.integers(0, 2, n)
        d[:, b] = d[:, pos] - rng.integers(0, 2, n)
        d[:, k] = rng.integers(0, 140, n)
        d[:, lo] = rng.integers(-2, size + 2, n)
        d[:, hi] = d[:, lo] + rng.integers(0, 131, n)
        d[:, t0] = d[:, lo] + rng.integers(-70, 70, n)
    d[:, 28] = 1
    return d


def test_gather_refs_matches(frames):
    """_gather_refs of the port (batched) == the reference's per unit,
    on the frame's real descriptor rows and on fuzzed rows whose windows
    the clamp moves and whose runs leave the window (those read 0)."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    from vvdec_tpu_torch.state import to_numpy, to_torch
    rng = np.random.default_rng(11)
    cs_ref, _ = frames["420"][0]
    _, desc = _recon_inputs(cs_ref)
    hh, ww = WH[1] + T.PB, WH[0] + T.PB
    P = rng.integers(0, 1024, size=(3, hh, ww)).astype(np.int32)
    rows = np.concatenate([desc, _fuzz_rows(rng, 300, hh, ww)])
    top, left = to_numpy(T._gather_refs(to_torch(P, "cpu"),
                                        to_torch(rows, "cpu"), 10))
    for i, d in enumerate(rows):
        t, le = R._gather_refs(_jax(P[d[0]]), _jax(d), 10)
        assert np.array_equal(top[i], _np(t)), i
        assert np.array_equal(left[i], _np(le)), i


@pytest.mark.parametrize("K", [8, 3])
def test_intra_wavefront_matches(frames, K):
    """_intra_wavefront_fn on identical (planes, resis, batches): the
    reference's residual planes, planes filled with seeded noise (so
    every reference sample read is visible in the output), and an LMCS
    table of zeros, which has_lmcs=False leaves unread in both; the LMCS
    scan is held to the reference in tests/test_torch_intra_tools.py."""
    import vvdec_tpu.ops.intra_device as R
    import vvdec_tpu_torch.ops.intra_device as T
    from vvdec_tpu_torch.state import to_numpy, to_torch
    rng = np.random.default_rng(K)
    for cs_ref, _ in frames["420"]:
        resi, desc = _recon_inputs(cs_ref)
        key = R.scan_key(cs_ref)
        lvl = R.compute_unit_levels(desc, key[1])
        batches = R.build_wavefront_batches(desc, lvl, K)
        planes = tuple(rng.integers(0, 1024, size=r.shape).astype(np.int32)
                       for r in resi)
        lm = np.zeros(R.LM_LEN, dtype=np.int32)
        want = _np(R._intra_wavefront_fn(*key, K, False)(
            *_jax((planes, tuple(resi), batches, lm))))
        got = to_numpy(T._intra_wavefront_fn(*key, K, False)(
            to_torch(planes, "cpu"), to_torch(tuple(resi), "cpu"), batches,
            to_torch(lm, "cpu")))
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def _blocky(rng, h, w, bd=10):
    """Planes of flat 4x4 blocks plus small noise: every block edge is a
    candidate for the strong, weak and long deblocking filters."""
    base = rng.integers(200, 800, size=(-(-h // 4), -(-w // 4)))
    step = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    return np.clip(step + rng.integers(-3, 4, size=(h, w)), 0,
                   (1 << bd) - 1).astype(np.int32)


@pytest.mark.parametrize("name", list(STREAMS))
def test_chain_fn_matches(frames, name):
    """_chain_fn(key) (deblock + 10-bit pack) on identical (planes, flat):
    the same packed parameter vector from both packages' host inputs,
    then the real pre-filter recon and blocky noise planes."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    from vvdec_tpu.ops.intra_device import run_intra_scan, scan_key
    from vvdec_tpu_torch.state import to_numpy, to_torch
    rng = np.random.default_rng(5)
    cs_ref, cs_port = frames[name][0]
    resi, desc = _recon_inputs(cs_ref)
    rec = run_intra_scan(_jax(tuple(np.zeros_like(r) for r in resi)),
                         _jax(tuple(resi)), desc, scan_key(cs_ref))
    real = [_np(rec[c])[:h, :w] for c, (w, h) in enumerate(cs_ref.comp_size)]
    key, arrays = R._frame_key_arrays(cs_ref, real)
    db_port = T._deblock_grid_inputs(cs_port)
    assert sorted(db_port) == sorted(arrays)
    for k, v in db_port.items():
        assert np.array_equal(v, arrays[k]), k
    flat = R._flat_pack(key, arrays)
    assert np.array_equal(T._flat_pack(key, db_port), flat)
    unpacked = T._flat_unpack(key, to_torch(flat, "cpu"))
    for k, v in R._flat_unpack(key, _jax(flat)).items():
        assert np.array_equal(to_numpy(unpacked[k]), _np(v)), k
    blocky = [_blocky(rng, p.shape[0], p.shape[1]) for p in real]
    for planes in (real, blocky):
        want_p, want_b = _np(R._chain_fn(key)(_jax(tuple(planes)),
                                              _jax(flat)))
        got_p, got_b = to_numpy(T._chain_fn(key)(
            to_torch(tuple(planes), "cpu"), to_torch(flat, "cpu")))
        assert np.array_equal(got_b, want_b)
        for a, b in zip(got_p, want_p):
            assert np.array_equal(a, b)
        assert any(not np.array_equal(a, b) for a, b in zip(got_p, planes))


def test_deblock_table_indices_stay_in_range():
    """The dense deblock cores, fed grids whose tc / beta table indices
    run far outside _DB_TC (0..65) and _DB_BETA (0..63) at both ends
    (QP 0 and 127, bS 0..3, slice offsets of -12 and +12), match the JAX
    cores, whose gathers clamp such indices; torch indexing would raise
    or wrap instead, so this holds only if the port clamps them too."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.deblock_dense as R
    import vvdec_tpu_torch.ops.deblock_dense as T
    rng = np.random.default_rng(4)
    H, W, n_sl, ctu = 32, 64, 2, 32
    h4, w4 = H // 4, W // 4
    qp = rng.choice([0, 1, 30, 63, 64, 100, 127], size=(h4, w4))
    bs = rng.integers(0, 4, size=(h4, w4))
    si = rng.integers(0, n_sl, size=(h4, w4)).astype(np.int16)
    sltab = np.array([[-12] * 6, [12] * 6], dtype=np.int32)
    idx_tc = qp + 2 * (bs - 1) + 2 * sltab[si, 0]
    assert idx_tc.min() < 0 and idx_tc.max() > 65
    mfl = rng.choice([1, 2, 3, 5, 7], size=(2, h4, w4))
    luma = (bs | qp << 2 | mfl[0] << 9 | mfl[1] << 12).astype(np.int16)
    chroma = (bs | qp << 2 | (rng.random((h4, w4)) < 0.5) << 9) \
        .astype(np.int16)
    for bd in (8, 10):
        plane = _blocky(rng, H, W, bd)
        cplane = _blocky(rng, H // 2, W // 2, bd)
        cases = [(R.deblock_luma_dense_core(H, W, bd, ctu, d1, n_sl),
                  T.deblock_luma_dense_core(H, W, bd, ctu, d1, n_sl, "cpu"),
                  plane, luma) for d1 in (False, True)]
        cases += [(R.deblock_chroma_dense_core(H // 2, W // 2, bd, ctu // 2,
                                               2, d1, 2, 2, n_sl, comp),
                   T.deblock_chroma_dense_core(H // 2, W // 2, bd, ctu // 2,
                                               2, d1, 2, 2, n_sl, comp,
                                               "cpu"),
                   cplane, chroma) for d1 in (False, True) for comp in (1, 2)]
        for ref, port, pl, grid in cases:
            want = np.asarray(ref(*(jnp.asarray(a)
                                    for a in (pl, grid, si, sltab))))
            got = port(*(torch.from_numpy(a)
                         for a in (pl, grid, si, sltab))).numpy()
            assert np.array_equal(got, want)
            assert not np.array_equal(got, pl)


def test_readback_unpacks_planes(frames):
    """PendingFrame.resolve unpacks the 10-bit pack to the filtered
    planes (CPU path: the packed tensor is read in place)."""
    from vvdec_tpu_torch.ops.device_pipeline import filter_frame_device
    from vvdec_tpu_torch.state import to_numpy, to_torch
    cs_ref, cs_port = frames["420"][0]
    rng = np.random.default_rng(9)
    planes = [_blocky(rng, h, w) for (w, h) in cs_port.comp_size]
    pending = filter_frame_device(cs_port, to_torch(planes, "cpu"))
    dev_planes = to_numpy(pending.planes_dev)
    host = pending.resolve()
    for a, b in zip(host, dev_planes):
        assert np.array_equal(a, b)
    assert pending.resolve() is host


class TestExactIntegerProducts:
    """No float product on integer data unless it is float64: float32 is
    not exact at the ITX's 2^28 sums, and TF32 (a CUDA default for some
    float32 paths) keeps ~10 mantissa bits."""

    CALLS = ("einsum(", "matmul(", ".mm(", "bmm(", " @ ")

    def test_products_only_in_exact_dot(self):
        import pathlib

        import vvdec_tpu_torch.ops as ops
        root = pathlib.Path(ops.__file__).parent
        hits = []
        for path in sorted(root.rglob("*.py")):
            for n, line in enumerate(path.read_text().splitlines(), 1):
                code = line.split("#")[0]
                if any(c in code for c in self.CALLS) \
                        and not code.lstrip().startswith(('"', "'")):
                    hits.append((path.name, n, code.strip()))
        # the one product in the port: _exact_dot's float64 einsum
        assert [h[0] for h in hits] == ["itx.py"], hits
        assert "a.to(torch.float64)" in hits[0][2]

    def test_runtime_products_are_float64(self, monkeypatch):
        from vvdec_tpu_torch.decoder import decode_annexb
        seen = []
        real = torch.einsum

        def spy(eq, *ops):
            seen.extend(o.dtype for o in ops)
            return real(eq, *ops)

        monkeypatch.setattr(torch, "einsum", spy)
        for name in ("matmul", "bmm", "mm"):
            fn = getattr(torch, name)
            monkeypatch.setattr(
                torch, name,
                lambda *a, _f=fn, **k: seen.extend(
                    x.dtype for x in a if isinstance(x, torch.Tensor))
                or _f(*a, **k))
        s, _ = generate_stream(width=64, height=64, ctu=32, n_frames=1,
                               seed=3, qp=30,
                               sps_kw=dict(lfnst_enabled=True),
                               dec_kw=dict(split_prob=0.5, density=0.4))
        decode_annexb(s, device="cpu")
        assert seen and set(seen) == {torch.float64}, set(seen)


def test_state_round_trip_keeps_values_and_dtypes():
    """state.to_torch takes numpy and JAX arrays (nested in tuples and
    lists, None kept) and state.to_numpy brings them back unchanged."""
    import jax.numpy as jnp

    from vvdec_tpu_torch.state import to_numpy, to_torch
    rng = np.random.default_rng(1)
    arrays = (rng.integers(-2**15, 2**15, (3, 5)).astype(np.int16),
              rng.integers(-2**31, 2**31, (4,)).astype(np.int32),
              rng.random(6) < 0.5)
    for src in (arrays, [jnp.asarray(a) for a in arrays]):
        t = to_torch(src, "cpu")
        assert type(t) is type(src)
        back = to_numpy(t)
        for a, b in zip(arrays, back):
            assert b.dtype == a.dtype and np.array_equal(a, b)
    assert to_torch(None, "cpu") is None and to_numpy(None) is None
