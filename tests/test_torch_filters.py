"""The port's SAO, ALF and CC-ALF stages and the full filter chain against
the JAX reference.

Tolerance: bit-equal everywhere (integer arithmetic).  Both packages get
the same inputs: planes, per-CTU parameters and coefficient banks made
with numpy from a seed, or parsed by both packages' own host planes from
the same streams, handed over through vvdec_tpu_torch.state.  Picture
sizes put virtual-boundary rows and partial CTUs inside the planes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vvdec_tpu_torch.state import to_numpy, to_torch

BD = 10


def _jax(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_jax(v) for v in x)
    return jnp.asarray(x)


def _np(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return np.asarray(x)


def _textured(rng, h, w, hi=1 << BD):
    """Flat 4x4 blocks, ramps and noise: every laplacian direction, edge
    class and band shows up."""
    base = rng.integers(0, hi, size=(-(-h // 4), -(-w // 4)))
    flat = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    ramp = (np.arange(h)[:, None] * 7 + np.arange(w)[None, :] * 3) % hi
    noise = rng.integers(0, hi, size=(h, w))
    pick = rng.integers(0, 3, size=(h, w))
    return np.choose(pick, [flat, ramp, noise]).astype(np.int32)


# ------------------------------------------------------ classification
@pytest.mark.parametrize("h,w,vb_h,vb_pos", [
    (64, 96, 32, 28), (96, 64, 64, 60), (48, 40, 16, 12), (128, 32, 128, 124)])
def test_classify_dense_matches(h, w, vb_h, vb_pos):
    """_classify_dense == both JAX classifiers (_classify_dense and
    _classify_jnp), with virtual-boundary rows inside the picture."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    rng = np.random.default_rng(h + w)
    assert any(((4 * i) % vb_h) in (vb_pos - 4, vb_pos)
               for i in range(h // 4))
    for src in (_textured(rng, h, w),
                rng.integers(0, 1 << BD, size=(h, w)).astype(np.int32)):
        got = to_numpy(T._classify_dense(to_torch(src, "cpu"), h, w, BD,
                                         vb_h, vb_pos))
        for ref in (R._classify_dense, R._classify_jnp):
            want = _np(ref(jnp.asarray(src), h, w, BD, vb_h, vb_pos))
            for a, b in zip(got, want):
                assert a.dtype == np.int32
                assert np.array_equal(a, b)


def _exact_block_sums(src):
    """[4, h/4, w/4] int64 laplacian block sums (v, h, d0, d1), no
    virtual boundary, straight from the definition (ALF classification,
    alf_np.classify)."""
    h, w = src.shape
    s = src.astype(np.int64)

    def at(y, x):
        return s[min(max(y, 0), h - 1), min(max(x, 0), w - 1)]

    out = np.zeros((4, h // 4, w // 4), dtype=np.int64)
    for by in range(h // 4):
        for bx in range(w // 4):
            for y in range(4 * by - 2, 4 * by + 6, 2):
                for x in range(4 * bx - 2, 4 * bx + 6, 2):
                    c0, c1 = 2 * at(y, x), 2 * at(y + 1, x + 1)
                    out[0, by, bx] += (abs(c0 - at(y - 1, x) - at(y + 1, x))
                                       + abs(c1 - at(y, x + 1)
                                             - at(y + 2, x + 1)))
                    out[1, by, bx] += (abs(c0 - at(y, x + 1) - at(y, x - 1))
                                       + abs(c1 - at(y + 1, x + 2)
                                             - at(y + 1, x)))
                    out[2, by, bx] += (abs(c0 - at(y - 1, x - 1)
                                           - at(y + 1, x + 1))
                                       + abs(c1 - at(y, x) - at(y + 2, x + 2)))
                    out[3, by, bx] += (abs(c0 - at(y + 1, x - 1)
                                           - at(y - 1, x + 1))
                                       + abs(c1 - at(y + 2, x) - at(y, x + 2)))
    return out


def test_classify_uint32_overflow():
    """Samples far above 10 bits make the direction test's products
    d1 * hv0 and hv1 * d0 exceed 32 bits; the reference compares them as
    uint32 (wrapping mod 2^32), as the C reference does, and so does the
    port (int64 masked to 32 bits).  The input is fuzzed until the wrap
    changes some block's decision."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    rng = np.random.default_rng(2)
    h, w = 32, 48
    for _ in range(20):
        src = rng.integers(0, 1 << 22, size=(h, w)).astype(np.int32)
        sv, sh, s0, s1 = _exact_block_sums(src)
        assert sv.max() < 2 ** 31 and sh.max() < 2 ** 31
        hv1, hv0 = np.maximum(sv, sh), np.minimum(sv, sh)
        d1, d0 = np.maximum(s0, s1), np.minimum(s0, s1)
        exact = d1 * hv0 > hv1 * d0
        m = 0xFFFFFFFF
        wrapped = ((d1 * hv0) & m) > ((hv1 * d0) & m)
        if (exact != wrapped).any():
            break
    else:
        pytest.fail("no input made the uint32 wrap matter")
    got = to_numpy(T._classify_dense(to_torch(src, "cpu"), h, w, BD, 1024,
                                     1020))
    for ref in (R._classify_dense, R._classify_jnp):
        want = _np(ref(jnp.asarray(src), h, w, BD, 1024, 1020))
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


# ----------------------------------------------------------------- SAO
@pytest.mark.parametrize("kind", ["eo0", "eo90", "eo135", "eo45", "bo",
                                  "mixed"])
def test_sao_plane_matches(kind):
    """_sao_plane for each edge class and band offset, every CTU (some
    off) of a picture with partial CTUs at the right and bottom, so the
    picture-border trimming and the CTU expansion show."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    rng = np.random.default_rng(len(kind))
    h, w, ctu = 80, 112, 32
    w_ctu, h_ctu = -(-w // ctu), -(-h // ctu)
    n_ctu = w_ctu * h_ctu
    if kind == "mixed":
        types = rng.choice([0, 1, 2, 3, 4, 255], size=n_ctu)
    else:
        t = ["eo0", "eo90", "eo135", "eo45", "bo"].index(kind)
        types = np.where(rng.random(n_ctu) < 0.2, 255, t)
    vals = rng.integers(-7, 8, size=(n_ctu, 6))
    vals[:, 0] = rng.integers(0, 32, n_ctu)
    src = _textured(rng, h, w)
    args = (types.astype(np.int32), vals.astype(np.int32))
    kw = dict(h=h, w=w, ctu_w=ctu, ctu_h=ctu, w_ctu=w_ctu, bd=BD)
    want = _np(R._sao_plane(jnp.asarray(src), *_jax(args), **kw))
    got = to_numpy(T._sao_plane(to_torch(src, "cpu"),
                                *to_torch(args, "cpu"), **kw))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, src)


# ----------------------------------------------------------------- ALF
@pytest.mark.parametrize("chroma", [False, True])
def test_alf_diamond_dense_core_matches(chroma):
    """_alf_diamond_dense_core (luma 7x7, chroma 5x5) with per-pixel
    coefficients, clip bounds (zero and negative ones too) and mask, on a
    picture whose rows cross the virtual boundaries."""
    import vvdec_tpu.ops.pipeline as R
    import vvdec_tpu_torch.ops.pipeline as T
    rng = np.random.default_rng(int(chroma))
    h, w = (48, 64) if chroma else (96, 128)
    n_taps = 6 if chroma else 12
    vb_h = 16 if chroma else 32
    vb_pos = vb_h - (2 if chroma else 4)
    src = _textured(rng, h, w)
    co = rng.integers(-128, 128, size=(h, w, n_taps)).astype(np.int32)
    cl = rng.choice([-3, 0, 1, 8, 64, 1023], size=(h, w, n_taps)) \
        .astype(np.int32)
    mask = rng.random((h, w)) < 0.8
    want = _np(R._alf_diamond_dense_core(h, w, BD, n_taps, vb_h, vb_pos,
                                         chroma)(*_jax((src, co, cl, mask))))
    got = to_numpy(T._alf_diamond_dense_core(h, w, BD, n_taps, vb_h, vb_pos,
                                             chroma, "cpu")(
        *to_torch((src, co, cl, mask), "cpu")))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, src)


@pytest.mark.parametrize("cfmt", [1, 2, 3])
def test_ccalf_dense_core_matches(cfmt):
    """_ccalf_dense_core for 4:2:0, 4:2:2 and 4:4:4: per-CTU filter
    indices (0 = off, and indices outside the bank, which filter with
    zero coefficients), rows at the virtual boundary."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    rng = np.random.default_rng(cfmt)
    sub_w = 2 if cfmt in (1, 2) else 1
    sub_h = 2 if cfmt == 1 else 1
    h, w, ctu, n_cc = 96, 128, 32, 4
    hc, wc = h // sub_h, w // sub_w
    w_ctu = w // ctu
    n_ctu = w_ctu * (h // ctu)
    luma = _textured(rng, h, w)
    dst = _textured(rng, hc, wc)
    banks = rng.integers(-64, 65, size=(n_cc, 7)).astype(np.int32)
    banks[0] = 0
    cc_ctu = rng.integers(-1, n_cc + 2, size=n_ctu).astype(np.int32)
    args = (luma, dst, banks, cc_ctu)
    want = _np(R._ccalf_dense_core(h, w, hc, wc, BD, sub_w, sub_h, ctu,
                                   w_ctu, n_cc)(*_jax(args)))
    got = to_numpy(T._ccalf_dense_core(h, w, hc, wc, BD, sub_w, sub_h, ctu,
                                       w_ctu, n_cc, "cpu")(
        *to_torch(args, "cpu")))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, dst)


# ------------------------------------------- host inputs and the chain
def _filter_streams():
    from tests.test_alf import _alf_stream
    from vvdec_tpu.testenc.encoder import generate_stream
    from vvdec_tpu_torch.streams import sao_alf_stream
    return {
        # tests/test_frame_device.py::test_sao_alf_configs_still_exact
        "sao": generate_stream(
            width=128, height=96, ctu=32, n_frames=1, seed=12, qp=30,
            sps_kw=dict(sao_enabled=True),
            sh_kw=dict(sao_enabled_luma=True, sao_enabled_chroma=True),
            dec_kw=dict(split_prob=0.4, density=0.3, sao_prob=0.6))[0],
        # tests/test_device_pipeline.py::test_alf_ccalf_intra
        "alf_ccalf": _alf_stream(2, 1, 2, {},
                                 dict(split_prob=0.4, jccr_prob=0.2),
                                 n_aps=3),
        # bench.py's SAO/ALF configuration at 128x96: every stage on
        "sao_alf": sao_alf_stream(w=128, h=96, n=1, seed=1),
    }


@pytest.fixture(scope="module")
def filter_frames():
    """{name: (reference cs, port cs)} of each stream's first picture,
    parsed by both packages."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu_torch.decoder import parse_annexb as parse_port
    return {name: (parse_ref(s)[0].cs, parse_port(s)[0].cs)
            for name, s in _filter_streams().items()}


def _shapes(cs):
    return [(h, w) for (w, h) in cs.comp_size[:cs.num_comp]]


@pytest.mark.parametrize("name", ["sao", "alf_ccalf", "sao_alf"])
def test_filter_inputs_match(filter_frames, name):
    """_sao_inputs, _alf_inputs, the frame key and its arrays, and the
    packed int16 vector from each package's own parse are identical."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    cs_ref, cs_port = filter_frames[name]
    sao_r, sao_p = R._sao_inputs(cs_ref), T._sao_inputs(cs_port)
    assert (sao_r is None) == (sao_p is None)
    if sao_r is not None:
        for a, b in zip(sao_r, sao_p):
            assert np.array_equal(a, b)
    alf_r, alf_p = R._alf_inputs(cs_ref, BD), T._alf_inputs(cs_port, BD)
    assert (alf_r is None) == (alf_p is None)
    if alf_r is not None:
        assert alf_r["any"] == alf_p["any"]
        for a, b in zip(alf_r["arrays"], alf_p["arrays"]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    planes = [np.zeros(s, np.int32) for s in _shapes(cs_ref)]
    key, arrays = R._frame_key_arrays(cs_ref, planes)
    key_p, arrays_p = T._frame_key_arrays(cs_port, _shapes(cs_port))
    assert key_p == key
    assert sorted(arrays_p) == sorted(arrays)
    for k, v in arrays.items():
        assert np.array_equal(arrays_p[k], v), k
    flat = R._flat_pack(key, arrays)
    assert np.array_equal(T._flat_pack(key, arrays_p), flat)
    unpacked = T._flat_unpack(key, to_torch(flat, "cpu"))
    for k, v in R._flat_unpack(key, _jax(flat)).items():
        assert np.array_equal(to_numpy(unpacked[k]), _np(v)), k
    assert key[12] == (name != "alf_ccalf")
    assert all(key[13:16]) == (name != "sao")


@pytest.mark.parametrize("name", ["sao", "alf_ccalf", "sao_alf"])
def test_chain_fn_full_key_matches(filter_frames, name):
    """_chain_fn(key) (deblock, SAO, ALF, CC-ALF, 10-bit pack) on
    identical (planes, flat): the reference's pre-filter recon and
    textured planes, with each stream's key (for sao_alf every stage
    on)."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    from vvdec_tpu.ops.frame_device import itx_residual_device
    from vvdec_tpu.ops.intra_device import (build_intra_descriptors,
                                            run_intra_scan, scan_key)
    rng = np.random.default_rng(len(name))
    cs_ref, _ = filter_frames[name]
    resi = itx_residual_device(cs_ref)
    desc, _ = build_intra_descriptors(cs_ref)
    rec = run_intra_scan(tuple(jnp.zeros_like(r) for r in resi), resi,
                         desc, scan_key(cs_ref))
    real = [np.asarray(rec[c])[:h, :w]
            for c, (h, w) in enumerate(_shapes(cs_ref))]
    key, arrays = R._frame_key_arrays(cs_ref, real)
    flat = R._flat_pack(key, arrays)
    textured = [_textured(rng, *p.shape) for p in real]
    for planes in (real, textured):
        want_p, want_b = _np(R._chain_fn(key)(_jax(tuple(planes)),
                                              _jax(flat)))
        got_p, got_b = to_numpy(T._chain_fn(key)(
            to_torch(tuple(planes), "cpu"), to_torch(flat, "cpu")))
        assert np.array_equal(got_b, want_b)
        for a, b in zip(got_p, want_p):
            assert np.array_equal(a, b)
        assert any(not np.array_equal(a, b) for a, b in zip(got_p, planes))


def test_reject_reasons_match_reference(filter_frames):
    """device_filter_reject_reason is the reference's: SAO, ALF and
    CC-ALF pictures are eligible."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    for cs_ref, cs_port in filter_frames.values():
        assert T.device_filter_reject_reason(cs_port) is None
        assert R.device_filter_reject_reason(cs_ref) is None


def test_expand_ctu_and_rep4_match():
    """_expand_ctu (crop of partial CTUs) and _rep4 as in the
    reference."""
    import vvdec_tpu.ops.device_pipeline as R
    import vvdec_tpu_torch.ops.device_pipeline as T
    rng = np.random.default_rng(3)
    vals = rng.integers(-9, 9, size=12).astype(np.int32)
    for args in ((8, 8, 20, 30, 4), (4, 2, 11, 7, 4), (16, 16, 48, 64, 4)):
        assert np.array_equal(
            to_numpy(T._expand_ctu(torch.from_numpy(vals), *args)),
            np.asarray(R._expand_ctu(jnp.asarray(vals), *args)))
    a = rng.integers(0, 9, size=(5, 6, 3)).astype(np.int32)
    assert np.array_equal(to_numpy(T._rep4(torch.from_numpy(a), 18, 21)),
                          np.asarray(R._rep4(jnp.asarray(a), 18, 21)))
