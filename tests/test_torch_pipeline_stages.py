"""The port's ITX stage (vvdec_tpu_torch/ops/pipeline.py: itx_frame_torch
and _itx_fn) against vvdec_tpu/ops/pipeline.py, on the CPU.

Tolerance: bit-equal (integer arithmetic).  Both packages parse the same
stream; the reference runs its XLA path (on the CPU it never takes the
Pallas route).

- itx_frame_torch == itx_frame_jax on tests/test_pipeline_jax.py's
  streams (64x64 seeds 0-2, 128x96 seed 7), its LFNST stream, a
  scaling-list stream with MTS and transform skip, a TS / BDPCM stream;
  a spy holds the plain 2-D groups to one itx_batch_cuda call each.
- On the ISP stream (1-D transforms) the reference raises KeyError
  (tr_matrix(kind, 1)); with that lookup patched in the test it runs its
  1-D code, which the port equals, and the 1-D TUs equal the host
  golden's per-TU inverse transform.  _itx_fn's 1-D branch alone, too.
- Every entry point of the module raises without CUDA unless the CPU is
  asked for.  The cuda-marked test runs the ITX stage and
  reconstruct_frame_torch on the card against the CPU.
The streams come from the port's own test encoder, byte-equal to the
reference's (tests/test_torch_isolation.py), except the scaling-list
one, which is tests/test_scaling_list.py's own builder.
tests/test_torch_filter_stages.py holds the filters and
reconstruct_frame_torch against the reference.
"""

import functools

import numpy as np
import pytest
import torch

import vvdec_tpu_torch.ops.pipeline as TP

def _lfnst_stream():
    """tests/test_pipeline_jax.py::test_device_itx_lfnst_parity's."""
    import vvdec_tpu_torch.testenc.encoder as E

    class LfnstDec(E.RandomDecisions):
        def lfnst_idx(self, cu):
            return self.rnd.choice([1, 2])

    orig = E.RandomDecisions
    E.RandomDecisions = LfnstDec
    try:
        return E.generate_stream(
            width=96, height=64, ctu=32, n_frames=2, seed=1, qp=30,
            sps_kw=dict(lfnst_enabled=True),
            dec_kw=dict(split_prob=0.5, density=0.08, max_level=20))[0]
    finally:
        E.RandomDecisions = orig


def _sl_stream():
    """tests/test_scaling_list.py::test_with_mts_ts's: explicit scaling
    lists with MTS and transform skip."""
    from tests.test_scaling_list import _stream
    from vvdec_tpu.testenc.encoder import RandomDecisions

    class TsDec(RandomDecisions):
        def use_ts(self, tu, cu, comp):
            return self.rnd.random() < 0.4

    return _stream(2, 2, 2, dict(mts_enabled=True, explicit_mts_intra=True,
                                 transform_skip_enabled=True,
                                 log2_max_ts_size=4),
                   dict(split_prob=0.5), aps_seed=4, dec_cls=TsDec)


def _ts_bdpcm_stream():
    """tests/test_oracle.py's BDPCM / transform-skip / LFNST / MTS
    picture, seed 0 (dependent quantisation on)."""
    from vvdec_tpu_torch.streams import _headers
    from vvdec_tpu_torch.testenc import encoder as E

    class AllDec(E.RandomDecisions):
        def bdpcm_mode(self, cu, ch):
            return self.rnd.choice([0, 0, 1, 2])

        def use_ts(self, tu, cu, comp):
            return self.rnd.random() < 0.3

        def lfnst_idx(self, cu):
            return self.rnd.choice([0, 1, 2])

        def mts_idx(self, cu):
            return self.rnd.choice([0, 0, 2, 3, 4, 5])

    sps = E.make_sps(64, 64, transform_skip_enabled=True, bdpcm_enabled=True,
                     log2_max_ts_size=4, lfnst_enabled=True, mts_enabled=True,
                     explicit_mts_intra=True, dep_quant_enabled=True)
    pps = E.make_pps(sps)
    dec = AllDec(seed=0, split_prob=0.5, density=0.15, max_level=30)
    nal, _ = E.encode_frame(sps, pps, dec, qp=32,
                            sh_kw=dict(dep_quant_used=True))
    return _headers(sps, pps) + nal


def _isp_stream():
    """tests/test_torch_fallback.py's "isp" stream."""
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    return generate_stream(
        width=64, height=64, ctu=32, n_frames=2, seed=18, qp=30,
        sps_kw=dict(isp_enabled=True),
        dec_kw=dict(split_prob=0.4, density=0.3, isp_prob=0.8))[0]


def _pipeline_jax_stream(seed, wh):
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    if wh == (64, 64):
        return generate_stream(width=64, height=64, seed=seed,
                               dec_kw=dict(split_prob=0.5))[0]
    return generate_stream(width=128, height=96, ctu=64, seed=seed,
                           dec_kw=dict(split_prob=0.4))[0]


ITX_STREAMS = {
    "64x64-0": lambda: _pipeline_jax_stream(0, (64, 64)),
    "64x64-1": lambda: _pipeline_jax_stream(1, (64, 64)),
    "64x64-2": lambda: _pipeline_jax_stream(2, (64, 64)),
    "128x96-7": lambda: _pipeline_jax_stream(7, (128, 96)),
    "lfnst": _lfnst_stream,
    "scaling-list": _sl_stream,
    "ts-bdpcm": _ts_bdpcm_stream,
}


@functools.lru_cache(maxsize=None)
def _parsed(name):
    """(reference pictures, port pictures) of a stream, each package's
    own parse."""
    from vvdec_tpu.decoder import parse_annexb as parse_ref
    from vvdec_tpu_torch.decoder import parse_annexb
    stream = (ITX_STREAMS.get(name) or {"isp": _isp_stream}[name])()
    return parse_ref(stream), parse_annexb(stream)


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(ITX_STREAMS))
def test_itx_frame_matches_jax(name):
    from vvdec_tpu.ops.pipeline import itx_frame_jax
    ref, port = _parsed(name)
    for fr, fp in zip(ref, port):
        got = TP.itx_frame_torch(fp.cs, device="cpu")
        assert all(p.dtype == np.int32 for p in got)
        assert _equal(got, itx_frame_jax(fr.cs))


def test_itx_frame_routes_plain_groups_to_kernel_wrapper(monkeypatch):
    """Each plain 2-D group without a scaling list is one itx_batch_cuda
    call (its plain version on these CPU tensors); the others are not.
    The reference's own grouping counts them: one _itx_fn(use_sl=False)
    lookup per such group."""
    import vvdec_tpu.ops.pipeline as JP
    calls, want = [], []
    real, real_ref = TP.itx_batch_cuda, JP._itx_fn

    def spy(levels, *args, h, w, bit_depth):
        calls.append((h, w, levels.shape[0], levels.device.type))
        return real(levels, *args, h=h, w=w, bit_depth=bit_depth)

    def ref_spy(h, w, *args, use_sl=False):
        if not use_sl and h > 1 and w > 1:
            want.append((h, w))
        return real_ref(h, w, *args, use_sl=use_sl)

    monkeypatch.setattr(TP, "itx_batch_cuda", spy)
    monkeypatch.setattr(JP, "_itx_fn", ref_spy)
    for name in ("128x96-7", "scaling-list"):
        ref, port = _parsed(name)
        for fr, fp in zip(ref, port):
            calls.clear()
            want.clear()
            got = TP.itx_frame_torch(fp.cs, device="cpu")
            assert _equal(got, JP.itx_frame_jax(fr.cs))
            assert sorted(c[:2] for c in calls) == sorted(want)
            assert all(c[3] == "cpu" for c in calls)
        assert name != "128x96-7" or calls


def _tr_matrix_with_1():
    """The reference's tr_matrix, and a 1x1 matrix for a side of 1 (the
    1-D code never reads it)."""
    from vvdec_tpu.ops.tables import tr_matrix

    def patched(kind, n):
        return np.ones((1, 1), np.int32) if n == 1 else tr_matrix(kind, n)
    return patched


def test_itx_frame_isp_1d(monkeypatch):
    """ISP subpartitions of width or height 1 take the 1-D transforms.
    The reference builds both matrices and raises before its 1-D code;
    the port builds the one it uses.  With the lookup patched the
    reference runs its 1-D code and equals the port, and the port's 1-D
    TUs equal the host golden's per-TU dequant + inverse transform."""
    import vvdec_tpu.ops.pipeline as JP
    from vvdec_tpu.frame.recon_np import (
        dequant_block,
        get_tr_types,
        inverse_transform,
        tu_qp,
    )
    ref, port = _parsed("isp")
    with pytest.raises(KeyError):
        JP.itx_frame_jax(ref[0].cs)
    monkeypatch.setattr(JP, "tr_matrix", _tr_matrix_with_1())
    n_1d = 0
    for fr, fp in zip(ref, port):
        got = TP.itx_frame_torch(fp.cs, device="cpu")
        assert _equal(got, JP.itx_frame_jax(fr.cs))
        cs = fr.cs
        for tu in cs.tus:
            cu = cs.cus[tu.cu_idx]
            for comp in range(3):
                if tu.blocks[comp] is None or not tu.cbf[comp]:
                    continue
                x, y, w, h = tu.blocks[comp]
                if min(w, h) != 1:
                    continue
                deq = dequant_block(
                    cs.coef[comp][y:y + h, x:x + w], tu_qp(cs, tu, cu, comp),
                    w.bit_length() - 1, h.bit_length() - 1, cs.sps.bit_depth,
                    bool(cs.sh_of(cu).dep_quant_used), tu.max_scan_x[comp],
                    tu.max_scan_y[comp])
                hor, ver = get_tr_types(cs, tu, cu, comp)
                gold = inverse_transform(deq, hor, ver, cs.sps.bit_depth)
                assert np.array_equal(got[comp][y:y + h, x:x + w], gold)
                n_1d += 1
    assert n_1d > 0


@pytest.mark.parametrize("h,w,use_sl", [(1, 16, False), (32, 1, False),
                                        (1, 8, True), (16, 1, True)])
def test_itx_fn_1d_matches_jax(h, w, use_sl, monkeypatch):
    """_itx_fn's 1-D branch == the reference's, negative levels, both
    quantisers, the reference run with its matrix lookup patched."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.pipeline as JP
    from vvdec_tpu_torch.state import to_numpy, to_torch
    monkeypatch.setattr(JP, "tr_matrix", _tr_matrix_with_1())
    rng = np.random.default_rng(h * 100 + w)
    levels = rng.integers(-3000, 3000, size=(7, h, w)).astype(np.int32)
    levels[rng.random(levels.shape) < 0.3] = 0
    qp = rng.integers(0, 60, size=(7,)).astype(np.int32)
    smat = rng.integers(1, 64, size=(h, w)).astype(np.int32)
    extra = (smat,) if use_sl else ()
    for kind in ("DCT2", "DST7"):
        for dep_quant in (False, True):
            want = JP._itx_fn(h, w, kind, kind, 10, dep_quant, use_sl)(
                *(jnp.asarray(a) for a in (levels, qp) + extra))
            got = TP._itx_fn(h, w, kind, kind, 10, dep_quant, use_sl)(
                *to_torch((levels, qp) + extra, "cpu"))
            assert np.array_equal(to_numpy(got), np.asarray(want))


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA every entry point raises unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = _parsed("64x64-0")[1][0].cs
    planes = [np.zeros((h, w), np.int32) for (w, h) in cs.comp_size]
    for fn, args in ((TP.itx_frame_torch, (cs,)),
                     (TP.reconstruct_frame_torch, (cs,)),
                     (TP.deblock_frame_torch, (cs, planes)),
                     (TP.sao_frame_torch, (cs, planes)),
                     (TP.alf_frame_torch, (cs, planes))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["128x96-7", "lfnst", "ts-bdpcm", "isp"])
def test_itx_stage_on_card_matches_cpu(name):
    """On the card: itx_frame_torch (an itx_batch_cuda launch per plain
    group; LFNST, transform skip and the 1-D transforms in PyTorch) and
    reconstruct_frame_torch equal their CPU runs.  The streams come from
    the port's own encoder (no JAX there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.ops.cuda.itx import itx_batch_cuda
    for f in parse_annexb(({"isp": _isp_stream} | ITX_STREAMS)[name]()):
        itx_batch_cuda.launches = 0
        got = TP.itx_frame_torch(f.cs, device="cuda")
        assert itx_batch_cuda.launches > 0
        assert _equal(got, TP.itx_frame_torch(f.cs, device="cpu"))
        assert _equal(TP.reconstruct_frame_torch(f.cs, device="cuda"),
                      TP.reconstruct_frame_torch(f.cs, device="cpu"))
