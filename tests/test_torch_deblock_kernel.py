"""The dense deblock's kernel wrapper (vvdec_tpu_torch/ops/cuda/deblock.py)
and its plain version against the deblock of the JAX reference's filter
chain (vvdec_tpu/ops/device_pipeline.py::_chain_fn with SAO and ALF off
in its key), its constant pool, its errors, and the batched and sharded
chains' route to it.

Tolerance: bit-equal everywhere (integer arithmetic).  Both packages get
the same inputs, made with numpy from a seed: fuzzed grids (`random_inputs`: every bS, QP 0..127, filter lengths
{1, 2, 3, 5, 7} on neighbouring cells so that write windows overlap,
slice offsets past both ends of the tables) in 4:0:0, 4:2:0, 4:2:2 and
4:4:4, bit depths 8 and 10, two slices, a 56-row bottom CTU row and a
sharded chain's band height (tests/test_torch_deblock_kernel_streams.py
holds the stream pictures' grids).  On the CPU the wrapper runs its plain
version; the CUDA kernel itself runs only in the `cuda`-marked test, on
the card.  JAX is imported inside the tests that use it.
"""

import re

import numpy as np
import pytest
import torch

# name: (h, w, ctu, chroma format, bit depth, slices)
FUZZ = {
    "400 bd8": (32, 64, 32, 0, 8, 1),
    # 120 rows of CTU 64: a 56-row bottom CTU row, as 1080p has
    "420 bd10 2 slices 56-row bottom CTU row": (120, 64, 64, 1, 10, 2),
    # a band of the sharded chain: 32 rows and a CTU row of halo a side
    "422 bd10 sharded band": (96, 48, 32, 2, 10, 1),
    "444 bd8 2 slices": (32, 64, 32, 3, 8, 2),
}
STAGE_STREAMS = {
    # tests/test_torch_stages.py's stage streams
    "420": dict(n_frames=1, seed=5, qp=30,
                dec_kw=dict(split_prob=0.5, density=0.3)),
    "444": dict(n_frames=1, seed=11, qp=30, sps_kw=dict(chroma_format=3),
                dec_kw=dict(split_prob=0.4, density=0.3)),
}


def _fuzz(name, seed=0, frames=0):
    from vvdec_tpu_torch.ops.cuda.deblock import random_inputs
    h, w, ctu, cfmt, bd, n_sl = FUZZ[name]
    planes, grids, si, sltab, kw = random_inputs(
        seed + list(FUZZ).index(name), h, w, cfmt=cfmt, bd=bd, n_sl=n_sl,
        frames=frames)
    return planes, grids, si, sltab, dict(kw, ctu=ctu)


def _torch(planes, grids, si, sltab, device="cpu"):
    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)
    return [t(p) for p in planes], [t(g) for g in grids], t(si), t(sltab)


def _run(fn, case, device="cpu"):
    planes, grids, si, sltab, kw = case
    out = fn(*_torch(planes, grids, si, sltab, device), **kw)
    return [o.cpu().numpy() for o in out]


def _jax_deblock(case):
    """The reference chain's planes with deblocking alone on: its key and
    packed vector built from the case as _frame_key_arrays builds them."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.device_pipeline as R
    planes, grids, si, sltab, kw = case
    h, w = planes[0].shape
    num_comp = len(planes)
    hc, wc = planes[1].shape if num_comp > 1 else (1, 1)
    n_sl, bd, ctu = kw["n_sl"], kw["bd"], kw["ctu"]
    total = sum(p.size for p in planes)
    key = (h, w, hc, wc, bd, ctu, kw["sub_w"], kw["sub_h"], num_comp,
           -(-w // ctu), True, n_sl, False, False, False, False, 0, 0, 0,
           (-total) % 4 if bd > 8 else 0)
    arrays = dict(zip(("db_y", "db_cb", "db_cr"), grids), db_sltab=sltab)
    if n_sl > 1:
        arrays["db_si"] = si
    flat = R._flat_pack(key, arrays)
    out, _ = R._chain_fn(key)(tuple(jnp.asarray(p) for p in planes),
                              jnp.asarray(flat))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", list(FUZZ))
def test_fuzzed_grids_match_jax_chain(name):
    """Fuzzed grids with overlapping write windows: the wrapper on CPU
    tensors (its plain version) == the reference chain's deblock."""
    case = _fuzz(name)
    got = _run(_wrapper(), case)
    want = _jax_deblock(case)
    for c, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), (name, c)
    assert any(not np.array_equal(a, p) for a, p in zip(got, case[0]))


def _wrapper():
    from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_cuda
    return deblock_dense_cuda


def test_frame_axis_is_per_picture():
    """A leading frame axis: each picture as it is alone."""
    from vvdec_tpu_torch.ops.cuda.deblock import deblock_dense_ref
    planes, grids, si, sltab, kw = _fuzz(
        "420 bd10 2 slices 56-row bottom CTU row", frames=3)
    got = _run(_wrapper(), (planes, grids, si, sltab, kw))
    for i in range(3):
        one = _run(deblock_dense_ref, ([p[i] for p in planes],
                                       [g[i] for g in grids], si[i],
                                       sltab[i], kw))
        for a, b in zip(got, one):
            assert np.array_equal(a[i], b)


def test_const_pool_round_trips():
    """The pool holds ops/pipeline's tables at the offsets csrc/deblock.cu
    reads them from."""
    import os

    from vvdec_tpu_torch.ops.cuda._build import CSRC
    from vvdec_tpu_torch.ops.cuda.deblock import (CONST_LEN, CONST_TABLES,
                                                  deblock_consts)
    from vvdec_tpu_torch.ops.pipeline import _DB_BETA, _DB_DB, _DB_TC, _DB_TCC
    pool = deblock_consts("cpu")
    assert pool.dtype == torch.int32 and pool.shape == (CONST_LEN,)
    with open(os.path.join(CSRC, "deblock.cu")) as f:
        offsets = {m[0].lower(): int(m[1]) for m in re.findall(
            r"constexpr int k(Tc|Beta|Db|Tcc) = (\d+);", f.read())}
    tables = dict(tc=_DB_TC, beta=_DB_BETA, db=_DB_DB, tcc=_DB_TCC)
    off = 0
    for name, shape in CONST_TABLES:
        n = int(np.prod(shape))
        assert offsets[name] == off, name
        assert np.array_equal(pool[off:off + n].view(shape).numpy(),
                              tables[name]), name
        off += n
    assert off == CONST_LEN


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper's CUDA
    route, as far as it goes without one."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wrapper_raises(monkeypatch):
    """On CUDA-typed inputs with no build the wrapper raises KernelError
    and runs nothing in its place; an unsupported device, wrong dtypes
    (grids, si and sltab other than the host's packed int16) or shapes, a missing slice-index grid and vmap raise before any
    launch."""
    import vvdec_tpu_torch.ops.cuda._build as build
    from vvdec_tpu_torch.ops.cuda._build import KernelError
    from vvdec_tpu_torch.ops.cuda.deblock import (deblock_dense_cuda,
                                                  deblock_dense_ref)
    planes, grids, si, sltab, kw = _fuzz("444 bd8 2 slices")
    args = _torch(planes, grids, si, sltab)

    def no_build(name):
        raise KernelError(f"nvcc not found for csrc/{name}.cu")

    monkeypatch.setattr(build, "load_kernel", no_build)
    fake = ([p.as_subclass(_OnCuda) for p in args[0]],
            [g.as_subclass(_OnCuda) for g in args[1]],
            args[2].as_subclass(_OnCuda), args[3].as_subclass(_OnCuda))
    before = deblock_dense_cuda.launches
    with pytest.raises(KernelError, match="csrc/deblock.cu"):
        deblock_dense_cuda(*fake, **kw)
    assert deblock_dense_cuda.launches == before
    meta = [[t.to("meta") for t in args[0]], [t.to("meta") for t in args[1]],
            args[2].to("meta"), args[3].to("meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        deblock_dense_cuda(*meta, **kw)
    for fn in (deblock_dense_cuda, deblock_dense_ref):
        with pytest.raises(ValueError, match="plane 0 must be int32"):
            fn([args[0][0].to(torch.int64)] + args[0][1:], *args[1:], **kw)
        with pytest.raises(ValueError, match="grid 1 must be"):
            fn(args[0], [args[1][0], args[1][1][:, :-1], args[1][2]],
               *args[2:], **kw)
        # one format: the packed int16 of the host's upload
        with pytest.raises(ValueError, match="grid 0 must be int16"):
            fn(args[0], [args[1][0].to(torch.int32)] + args[1][1:],
               *args[2:], **kw)
        with pytest.raises(ValueError, match="sltab must be int16"):
            fn(*args[:3], args[3].to(torch.int32), **kw)
        with pytest.raises(ValueError, match="si must be int16"):
            fn(*args[:2], args[2].to(torch.int32), args[3], **kw)
        with pytest.raises(ValueError, match="need the slice-index grid"):
            fn(args[0], args[1], None, args[3], **kw)
        with pytest.raises(ValueError, match="1 or 3 planes"):
            fn(args[0][:2], args[1][:2], *args[2:], **kw)
    stacked = [t[None] for t in args[0]]
    with pytest.raises(RuntimeError, match="under torch.func.vmap"):
        torch.func.vmap(lambda *p: deblock_dense_cuda(
            list(p), args[1], args[2], args[3], **kw))(*stacked)


def test_batched_and_sharded_chains_take_the_kernel_route(monkeypatch):
    """filter_frames_device_batch deblocks its stacked pictures in one
    wrapper call (outside vmap) and equals the per-frame chain; the
    sharded chain deblocks each band through the wrapper and equals the
    whole-frame chain.  A stub counts the calls."""
    import vvdec_tpu_torch.ops.device_pipeline as dp
    import vvdec_tpu_torch.ops.sharded_chain as sc
    from vvdec_tpu_torch.parallel.dryrun import (capture_filter_inputs,
                                                 sharded_chain_parity)
    from vvdec_tpu_torch.parallel.sharding import Mesh
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    s, _ = generate_stream(
        width=96, height=64, ctu=32, n_frames=3, seed=5, qp=30,
        sps_kw=dict(sao_enabled=True),
        sh_kw=dict(sao_enabled_luma=True, sao_enabled_chroma=True),
        dec_kw=dict(split_prob=0.5, sao_prob=0.7))
    items = capture_filter_inputs(s, "cpu")
    want = [dp.filter_frame_device(cs, p).resolve() for cs, p in items]
    calls = []
    real = dp.deblock_dense_cuda

    def stub(planes, *a, **k):
        calls.append(tuple(planes[0].shape))
        return real(planes, *a, **k)

    monkeypatch.setattr(dp, "deblock_dense_cuda", stub)
    got = dp.filter_frames_device_batch(items)
    assert calls == [(3, 64, 96)]
    for g, w in zip(got, want):
        for a, b in zip(g.resolve(), w):
            assert np.array_equal(a, b)
    monkeypatch.setattr(dp, "deblock_dense_cuda", real)
    monkeypatch.setattr(sc, "deblock_dense_cuda", stub)
    calls.clear()
    sharded_chain_parity(items[:1], Mesh(np.array(["cpu"] * 2), ("row",)))
    # two bands of 32 rows, each with a CTU row of halo a side
    assert calls == [(96, 96)] * 2


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """On the card: deblock_dense_cuda (two launches a call) ==
    deblock_dense_ref on every fuzzed case, alone and with a frame axis,
    and on the stream pictures' grids under blocky planes, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.ops.cuda.deblock import (deblock_dense_cuda,
                                                  deblock_dense_ref,
                                                  random_inputs)
    from vvdec_tpu_torch.ops.device_pipeline import _deblock_grid_inputs
    from vvdec_tpu_torch.testenc.encoder import generate_stream
    cases = {name: _fuzz(name) for name in FUZZ}
    cases.update({f"{name} x3": _fuzz(name, frames=3) for name in FUZZ})
    for name, kw in STAGE_STREAMS.items():
        s, _ = generate_stream(width=128, height=96, ctu=32, **kw)
        cs = parse_annexb(s)[0].cs
        db = _deblock_grid_inputs(cs)
        planes = random_inputs(7, 96, 128, cfmt=cs.sps.chroma_format_idc,
                               bd=cs.sps.bit_depth)[0]
        cases[f"{name} stream"] = (
            planes, [db[k] for k in ("db_y", "db_cb", "db_cr")],
            db.get("db_si"), db["db_sltab"].astype(np.int16),
            dict(bd=cs.sps.bit_depth, ctu=cs.sps.ctu_size, sub_w=cs.sub_w,
                 sub_h=cs.sub_h, n_sl=len(cs.shs)))
    for name, case in cases.items():
        before = deblock_dense_cuda.launches
        got = _run(deblock_dense_cuda, case, "cuda")
        torch.cuda.synchronize()
        assert deblock_dense_cuda.launches == before + 2, name
        want = _run(deblock_dense_ref, case, "cuda")
        for c, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (name, c)
