"""The port's inter-prediction stages against the JAX package's, on the CPU.

Tolerance: bit-equal.  Each test feeds the same numpy inputs, made from a
seed, to the JAX function and to its counterpart in vvdec_tpu_torch:
the MC core (luma and chroma, bit depths 8 and 10, the identity,
alternate half-pel and 4x4-affine coefficient rows, window starts past
both plane edges), the bi-prediction and explicit-WP combines, PROF, the
inter reconstruct scatter, the whole-picture MC driver on
tests/test_mc_device.py's streams, and the frame's MC + reconstruct
stage on decoded P and B pictures with GPM, affine + PROF, SbTMVP, CIIP,
BCW and weighted prediction.
"""

import numpy as np
import pytest
import torch

import tests.test_frame_device as tfd


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _mc_inputs(rng, comp, bd, w, h, n, table=None):
    """Padded reference planes and n fuzzed MC items: window origins
    drawn past both edges of the padded plane, fractions including 0 and
    the half-pel 8, alt-half-pel flags, intermediate / final flags."""
    from vvdec_tpu.ops.mc_device import mc_coeff_rows
    taps = 8 if comp == 0 else 4
    hp, wp = 40 + h + taps, 56 + w + taps
    refs = rng.integers(0, 1 << bd, (3, hp, wp)).astype(np.int32)
    y0 = rng.integers(-hp // 2, hp + hp // 2, n).astype(np.int32)
    x0 = rng.integers(-wp // 2, wp + wp // 2, n).astype(np.int32)
    ridx = rng.integers(-1, 4, n).astype(np.int32)
    nfrac = 16 if comp == 0 else 32
    fx = rng.integers(0, nfrac, n)
    fy = rng.integers(0, nfrac, n)
    fx[:4] = (0, 0, 8, nfrac // 2)
    fy[:4] = (0, 8, 0, nfrac // 2)
    alt = rng.random(n) < 0.5 if comp == 0 and table is None else None
    cfx = mc_coeff_rows(fx, comp, alt_hpel=alt, luma_table=table)
    cfy = mc_coeff_rows(fy, comp, alt_hpel=alt, luma_table=table)
    inter = rng.random(n) < 0.5
    return refs, y0, x0, ridx, cfy, cfx, inter


def _check_mc(comp, bd, w, h, seed, table=None):
    import jax.numpy as jnp
    from vvdec_tpu.ops.mc_device import mc_batch_core as ref_core
    from vvdec_tpu_torch.ops.mc_device import mc_batch_core
    rng = np.random.default_rng(seed)
    args = _mc_inputs(rng, comp, bd, w, h, 24, table)
    taps = 8 if comp == 0 else 4
    _, hp, wp = args[0].shape
    want = np.asarray(ref_core(w, h, taps, bd, hp, wp, 3)(
        *[jnp.asarray(a) for a in args]))
    got = mc_batch_core(w, h, taps, bd)(*[_t(a) for a in args])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(8, 8), (16, 4), (4, 16), (32, 8)])
def test_mc_batch_core_luma(bd, w, h):
    _check_mc(0, bd, w, h, seed=bd * 100 + w * 10 + h)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 4), (2, 8), (16, 16)])
def test_mc_batch_core_chroma(bd, w, h):
    _check_mc(1, bd, w, h, seed=7 + bd * 100 + w * 10 + h)


@pytest.mark.parametrize("bd", [8, 10])
def test_mc_batch_core_affine_rows(bd):
    """The 6-tap 4x4-affine luma filter in the 8-wide rows."""
    from vvdec_tpu.frame.inter_np import LUMA_IF_4X4
    _check_mc(0, bd, 4, 4, seed=31 + bd, table=LUMA_IF_4X4)


def test_mc_coeff_rows_match_reference():
    from vvdec_tpu.frame.inter_np import LUMA_IF_4X4
    from vvdec_tpu.ops.mc_device import mc_coeff_rows as ref
    from vvdec_tpu_torch.ops.mc_device import mc_coeff_rows
    rng = np.random.default_rng(5)
    f16, f32 = rng.integers(0, 16, 40), rng.integers(0, 32, 40)
    alt = rng.random(40) < 0.5
    np.testing.assert_array_equal(mc_coeff_rows(f16, 0, alt),
                                  ref(f16, 0, alt_hpel=alt))
    np.testing.assert_array_equal(mc_coeff_rows(f32, 1), ref(f32, 1))
    np.testing.assert_array_equal(
        mc_coeff_rows(f16, 0, luma_table=LUMA_IF_4X4),
        ref(f16, 0, luma_table=LUMA_IF_4X4))


def test_pad_ref_replicates_edges():
    import jax.numpy as jnp
    from vvdec_tpu.ops.mc_device import pad_ref as ref
    from vvdec_tpu_torch.ops.mc_device import pad_ref
    plane = np.random.default_rng(2).integers(0, 1024, (12, 20)).astype(
        np.int32)
    np.testing.assert_array_equal(pad_ref(_t(plane), 7).numpy(),
                                  np.asarray(ref(jnp.asarray(plane), 7)))


@pytest.mark.parametrize("bd", [8, 10])
def test_bi_combine_core_every_bcw_weight(bd):
    import jax.numpy as jnp
    from vvdec_tpu.frame.inter_np import BCW_WEIGHTS
    from vvdec_tpu.ops.mc_device import bi_combine_core as ref
    from vvdec_tpu_torch.ops.mc_device import bi_combine_core
    rng = np.random.default_rng(bd)
    n, h, w = 20, 8, 16
    a = rng.integers(-9000, 9000, (n, h, w)).astype(np.int32)
    b = rng.integers(-9000, 9000, (n, h, w)).astype(np.int32)
    w1 = np.array([BCW_WEIGHTS[i % 5] for i in range(n)], np.int32)
    want = np.asarray(ref(w, h, bd)(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(w1)))
    got = bi_combine_core(w, h, bd)(_t(a), _t(b), _t(w1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bd", [8, 10])
def test_wp_combine_core_uni_and_bi(bd):
    """Denominators 0-7, weights and offsets of both signs, uni and bi."""
    import jax.numpy as jnp
    from vvdec_tpu.ops.mc_device import wp_combine_core as ref
    from vvdec_tpu_torch.ops.mc_device import wp_combine_core
    rng = np.random.default_rng(40 + bd)
    n, h, w = 32, 4, 8
    a = rng.integers(-8192, 8192, (n, h, w)).astype(np.int32)
    b = rng.integers(-8192, 8192, (n, h, w)).astype(np.int32)
    denom = (np.arange(n) % 8).astype(np.int32)
    w0 = ((1 << denom) + rng.integers(-128, 128, n)).astype(np.int32)
    w1 = ((1 << denom) + rng.integers(-128, 128, n)).astype(np.int32)
    o0 = (rng.integers(-128, 128, n) << (bd - 8)).astype(np.int32)
    o1 = (rng.integers(-128, 128, n) << (bd - 8)).astype(np.int32)
    bi = (np.arange(n) // 8) % 2 == 1
    args = (a, b, w0, o0, w1, o1, denom, bi)
    want = np.asarray(ref(w, h, bd)(*[jnp.asarray(x) for x in args]))
    got = wp_combine_core(w, h, bd)(*[_t(x) for x in args])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (o0 < 0).any() and bi.any() and (~bi).any()


@pytest.mark.parametrize("bd", [8, 10])
def test_prof_core(bd):
    """PROF on and off, intermediate (bi / wp) and final output, 14-bit
    blocks, dMv grids at the clip limits, windows past the edges."""
    import jax.numpy as jnp
    from vvdec_tpu.ops.frame_device import _prof_core as ref
    from vvdec_tpu_torch.ops.frame_device import _prof_core
    rng = np.random.default_rng(60 + bd)
    n, hp, wp = 40, 30, 40
    refs = rng.integers(0, 1 << bd, (2, hp, wp)).astype(np.int32)
    yb = rng.integers(-8, hp + 4, n).astype(np.int32)
    xb = rng.integers(-8, wp + 4, n).astype(np.int32)
    ridx = rng.integers(0, 2, n).astype(np.int32)
    blk = rng.integers(-8192, 8192, (n, 4, 4)).astype(np.int32)
    dmvh = rng.integers(-2000, 2000, (n, 4, 4)).astype(np.int32)
    dmvv = rng.integers(-2000, 2000, (n, 4, 4)).astype(np.int32)
    prof = np.arange(n) % 2 == 0
    inter = (np.arange(n) // 2) % 2 == 0
    args = (refs, yb, xb, ridx, blk, dmvh, dmvv, prof, inter)
    want = np.asarray(ref(bd, hp, wp, 2)(*[jnp.asarray(x) for x in args]))
    got = _prof_core(bd)(*[_t(x) for x in args])
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_recon_fn():
    """recon[rect] = clip(pred + resi), starts clamped as
    lax.dynamic_update_slice clamps them."""
    import jax.numpy as jnp
    from vvdec_tpu.ops.frame_device import _scatter_recon_fn as ref
    from vvdec_tpu_torch.ops.frame_device import _scatter_recon_fn
    rng = np.random.default_rng(9)
    hp, wp, h, w, n, bd = 40, 48, 8, 4, 6, 10
    recon = rng.integers(0, 1024, (hp, wp)).astype(np.int32)
    resi = rng.integers(-600, 600, (hp, wp)).astype(np.int32)
    blocks = rng.integers(-100, 1200, (n, h, w)).astype(np.int32)
    ys = np.array([0, 8, 16, 36, -3, 24], np.int32)
    xs = np.array([0, 4, 44, 20, 30, 47], np.int32)
    want = np.asarray(ref(hp, wp, h, w, n, bd)(
        jnp.asarray(recon), jnp.asarray(resi), jnp.asarray(blocks),
        jnp.asarray(ys), jnp.asarray(xs)))
    got = _scatter_recon_fn(h, w, bd)(
        _t(recon.copy()), _t(resi), _t(blocks), _t(ys), _t(xs))
    np.testing.assert_array_equal(got.numpy(), want)


def _host_pictures(stream, monkeypatch):
    """The CodingStructures of the JAX package's host decode (native
    inter path off, so the CUs carry their motion), in decode order."""
    from vvdec_tpu.decoder import StreamDecoder
    monkeypatch.setenv("VVDEC_TPU_NO_NATIVE_INTER", "1")
    css = []
    orig = StreamDecoder._reconstruct_inner

    def spy(self, f):
        orig(self, f)
        css.append(f.cs)

    monkeypatch.setattr(StreamDecoder, "_reconstruct_inner", spy)
    dec = StreamDecoder()
    dec.push(stream)
    dec.flush()
    return [cs for cs in css if not cs.sh.is_intra]


def _mc_frame_stream():
    """tests/test_mc_device.py::TestMcFrame's stream: P and B pictures
    with AMVR and BCW, reordered."""
    from vvdec_tpu.bitstream.nal import NalUnitType
    from vvdec_tpu.hls.params import B_SLICE, P_SLICE
    from vvdec_tpu.testenc import encoder as E
    from vvdec_tpu.testenc.bitwriter import BitWriter
    from vvdec_tpu.testenc.encoder import RandomDecisions
    from vvdec_tpu.testenc.hls_writer import make_nal, write_pps, write_sps
    sps = E.make_sps(128, 96, ctu=64, num_reorder_pics=[2],
                     amvr_enabled=True, bcw_enabled=True)
    pps = E.make_pps(sps)
    w = BitWriter()
    write_sps(w, sps)
    stream = make_nal(NalUnitType.SPS, w.bytes())
    w = BitWriter()
    write_pps(w, pps, sps)
    stream += make_nal(NalUnitType.PPS, w.bytes())
    coding = [(0, True, None, ((), ()), None),
              (4, False, P_SLICE, ((4,), ()), None),
              (2, False, B_SLICE, ((2,), (-2,)), [1, 1])]
    for i, (poc, idr, st, deltas, active) in enumerate(coding):
        d = RandomDecisions(seed=100 + i, split_prob=0.4, inter_prob=0.85,
                            skip_prob=0.2, mv_range=48, bi_prob=0.6,
                            amvr_prob=0.3, bcw_prob=0.4)
        if idr:
            nal, _ = E.encode_frame(sps, pps, d, qp=32, poc=poc, idr=True)
        else:
            sh_kw = dict(num_ref_idx_active=active) if active else None
            nal, _ = E.encode_frame(sps, pps, d, qp=32, poc=poc, idr=False,
                                    slice_type=st, ref_deltas=deltas,
                                    sh_kw=sh_kw)
        stream += nal
    return stream


def _weighted_stream():
    """tests/test_mc_device.py::TestMcFrameWeighted's stream."""
    from tests.test_weighted_pred import _wp_stream
    return _wp_stream(3, 3, 0, {}, dict(weighted_bipred=True,
                                        weighted_pred=True),
                      dict(split_prob=0.4, inter_prob=0.85, skip_prob=0.2,
                           mv_range=32, bi_prob=0.5))


@pytest.mark.parametrize("name", ["mc_frame", "weighted"])
def test_mc_frame_device_matches_jax(name, monkeypatch):
    """Every eligible CU's prediction, port vs vvdec_tpu's
    mc_frame_device, on the same host-decoded pictures."""
    from vvdec_tpu.ops.mc_device import _cu_mc_eligible
    from vvdec_tpu.ops.mc_device import mc_frame_device as ref
    from vvdec_tpu_torch.ops.mc_device import mc_frame_device
    stream = _mc_frame_stream() if name == "mc_frame" else _weighted_stream()
    checked = bi = 0
    for cs in _host_pictures(stream, monkeypatch):
        want = ref(cs)
        got = mc_frame_device(cs, device="cpu")
        assert sorted(got) == sorted(want)
        for idx, planes in want.items():
            for c, p in enumerate(planes):
                np.testing.assert_array_equal(got[idx][c], np.asarray(p),
                                              err_msg=f"cu {idx} comp {c}")
            checked += 1
            bi += cs.cus[idx].inter_dir == 3
        assert all(_cu_mc_eligible(cs, cs.cus[i]) for i in got)
    assert checked >= 8 and bi >= 1, (checked, bi)


# the pictures of the MC + reconstruct stage test: a low-delay B stream
# with GPM, SbTMVP, affine + PROF, CIIP and BCW (tests/test_torch_inter.py
# builds it), the mixed-tool P stream and the weighted-prediction P stream
# of tests/test_frame_device.py::TestFrameDeviceInter
def _stage_streams():
    from tests.test_torch_inter import TOOL_STREAMS, ldb_stream
    return {"ldb": lambda: ldb_stream(3),
            "p_mixed": TOOL_STREAMS["mixed"],
            "p_weighted": TOOL_STREAMS["weighted_pred"]}


@pytest.mark.parametrize("name", ["ldb", "p_mixed", "p_weighted"])
def test_mc_reconstruct_device_matches_jax(name, monkeypatch):
    """The port's _mc_reconstruct_device against vvdec_tpu's on the
    pictures of a port decode (motion derived by the port's plan), with
    get_ref serving the same reference planes to both; the picture area
    of every plane is compared (the reference parks padded batch rows in
    the margin)."""
    import jax.numpy as jnp
    import vvdec_tpu_torch.ops.frame_device as fd
    from vvdec_tpu.ops.frame_device import _mc_reconstruct_device as ref
    from vvdec_tpu_torch.decoder import decode_annexb
    calls = []
    orig = fd._mc_reconstruct_device

    def spy(cs, recon, resi, get_ref):
        refs = {(lst, i): [get_ref(lst, i, c).numpy().copy()
                           for c in range(cs.num_comp)]
                for lst in (0, 1) for i in range(len(cs.ref_pocs[lst]))}
        before = [r.numpy().copy() for r in recon]
        out = orig(cs, recon, resi, get_ref)
        calls.append((cs, before, [r.numpy().copy() for r in resi], refs,
                      [r.numpy().copy() for r in out]))
        return out

    monkeypatch.setattr(fd, "_mc_reconstruct_device", spy)
    decode_annexb(_stage_streams()[name](), device="cpu")
    assert len(calls) >= 2
    tools = set()
    for cs, before, resi, refs, got in calls:
        want = ref(cs, [jnp.asarray(r) for r in before],
                   [jnp.asarray(r) for r in resi],
                   lambda lst, i, c, refs=refs: jnp.asarray(refs[lst, i][c]))
        for c in range(cs.num_comp):
            w_c, h_c = cs.comp_size[c]
            np.testing.assert_array_equal(got[c][:h_c, :w_c],
                                          np.asarray(want[c])[:h_c, :w_c])
        for cu in cs.cus:
            if cu.pred_mode != 1:
                tools |= {t for t, on in (
                    ("geo", cu.geo_flag), ("sbtmvp", cu.merge_type == 1),
                    ("affine", cu.affine_flag and cu.merge_type != 1),
                    ("ciip", cu.ciip_flag), ("bi", cu.inter_dir == 3))
                    if on}
    expect = {"ldb": {"geo", "sbtmvp", "affine", "ciip", "bi"},
              "p_mixed": {"affine", "ciip"}, "p_weighted": set()}[name]
    assert expect <= tools, tools
