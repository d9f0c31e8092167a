"""The SAO / ALF / CC-ALF kernels' wrapper (vvdec_tpu_torch/ops/cuda/
sao_alf.py) and its plain version against the SAO and ALF of the JAX
reference's filter chain (vvdec_tpu/ops/device_pipeline.py::_chain_fn
with the deblock off in its key), the wrapper's errors, the layout the
kernels read, and the per-picture and batched chains' route to it with
its stage-profiler counters.

Tolerance: bit-equal everywhere (integer arithmetic).  Both packages get
the same inputs, made with numpy from a seed (`random_inputs`): every SAO
type and off (255), offsets of +-31 and bands wrapping past 31 (EO and BO
CTUs on every picture border), several luma banks with a fixed set among
them, chroma alternatives, CC-ALF banks, bank and filter indices past
both ends, CTU 32, 64 and 128, partial bottom CTU rows and right CTU
columns, virtual-boundary rows, 4:0:0, 4:2:0, 4:2:2 and 4:4:4, bit depths
8 and 10, each stage alone and together.  On the CPU the wrapper runs its
plain version; the CUDA kernels run only in the `cuda`-marked tests, on
the card, against the plain version, which imports no JAX.  JAX is
imported inside the tests that use it.
"""

import os
import re

import numpy as np
import pytest
import torch

ALL = (True, True, True, True)
# name: (h, w, ctu, chroma format, bit depth, (sao, luma ALF, chroma ALF,
# CC-ALF))
FUZZ = {
    "400 bd8 ctu32": (64, 96, 32, 0, 8, ALL),
    # 120 rows and 136 columns of CTU 64: a 56-row bottom CTU row, an
    # 8-column right CTU column
    "420 bd10 ctu64 partial CTUs": (120, 136, 64, 1, 10, ALL),
    "422 bd10 ctu32": (96, 64, 32, 2, 10, ALL),
    "444 bd8 ctu32": (64, 64, 32, 3, 8, ALL),
    # the luma virtual boundary at row 124 and an 8-row bottom CTU row
    "420 bd10 ctu128 partial CTUs": (136, 144, 128, 1, 10, ALL),
    "420 bd10 SAO alone": (64, 64, 32, 1, 10, (True, False, False, False)),
    "420 bd10 chroma ALF and CC-ALF": (64, 96, 32, 1, 10,
                                       (False, False, True, True)),
    "420 bd8 luma ALF alone": (64, 64, 32, 1, 8, (False, True, False, False)),
    "422 bd10 SAO and CC-ALF": (64, 64, 32, 2, 10, (True, False, False, True)),
}
KERNEL_PICTURES = "filter: SAO/ALF kernel pictures"
PLAIN_PICTURES = "filter: SAO/ALF plain pictures"


def _fuzz(name, seed=0, frames=0):
    from vvdec_tpu_torch.ops.cuda.sao_alf import random_inputs
    h, w, ctu, cfmt, bd, stages = FUZZ[name]
    return random_inputs(seed + list(FUZZ).index(name), h, w, cfmt=cfmt,
                         bd=bd, ctu=ctu, stages=stages, frames=frames)


def _torch(case, device="cpu"):
    planes, flat, key = case
    return ([torch.from_numpy(p).to(device) for p in planes],
            torch.from_numpy(flat).to(device), key)


def _run(fn, case, device="cpu"):
    return [o.cpu().numpy() for o in fn(*_torch(case, device))]


def _launches(key) -> int:
    """The launches of one wrapper call: SAO, then ALF and CC-ALF."""
    return int(key[12]) + int(any(key[13:16]))


@pytest.mark.parametrize("name", list(FUZZ))
def test_fuzzed_match_jax_chain(name):
    """The wrapper on CPU tensors (its plain version) == the reference
    chain's planes; the port's chain, packed bytes included, == the
    reference's."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.device_pipeline as R
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda
    from vvdec_tpu_torch.ops.device_pipeline import _chain_fn
    case = _fuzz(name)
    planes, flat, key = case
    want_p, want_b = R._chain_fn(key)(tuple(jnp.asarray(p) for p in planes),
                                      jnp.asarray(flat))
    got = _run(sao_alf_cuda, case)
    for c, (a, b) in enumerate(zip(got, want_p)):
        assert np.array_equal(a, np.asarray(b)), (name, c)
    # each stage the key turns on changes its planes
    assert not np.array_equal(got[0], planes[0]) or not any(key[12:14])
    if len(planes) > 1 and any(key[14:16]):
        assert not np.array_equal(got[1], planes[1])
    chain_p, chain_b = _chain_fn(key)(*_torch(case)[:2])
    assert np.array_equal(chain_b.numpy(), np.asarray(want_b))
    for a, b in zip(chain_p, got):
        assert np.array_equal(a.numpy(), b)


def test_fuzz_covers_the_parameter_space():
    """What the module docstring promises of the fuzzed inputs."""
    from vvdec_tpu_torch.ops.cuda.sao_alf import layout
    seen_types, bands, sets, ccs = set(), set(), set(), set()
    for name in FUZZ:
        planes, flat, key = _fuzz(name)
        off, n = layout(key)
        n_ctu = key[9] * -(-key[0] // key[5])
        if key[12]:
            seen_types |= set(flat[off["sao_type"]:][:key[8] * n_ctu])
            vals = flat[off["sao_vals"]:][:key[8] * n_ctu * 6].reshape(-1, 6)
            bands |= set(vals[:, 0])
        if any(key[13:16]):
            sets |= set(flat[off["set_ctu"]:][:n_ctu])
            ccs |= set(flat[off["cc_ctu"]:][:2 * n_ctu])
    assert seen_types == {0, 1, 2, 3, 4, 255}
    assert max(bands) > 28                  # four bands wrap past 31
    assert -1 in sets and 3 in sets         # one past each end of 3 banks
    assert -1 in ccs and 3 in ccs


def test_layout_is_what_the_kernels_read():
    """The offsets the wrapper passes hold each field as _flat_unpack
    reads it, and FIELDS is csrc/sao_alf.cu's Field order."""
    from vvdec_tpu_torch.ops.cuda._build import CSRC
    from vvdec_tpu_torch.ops.cuda.sao_alf import FIELDS, layout
    from vvdec_tpu_torch.ops.device_pipeline import _flat_unpack
    with open(os.path.join(CSRC, "sao_alf.cu")) as f:
        enum = re.search(r"enum Field \{(.*?)\}", f.read(), re.S).group(1)
    names = [e.strip()[1:].lower() for e in enum.split(",")]
    assert names == [f.replace("_", "") for f in FIELDS] + ["fields"]
    planes, flat, key = _fuzz("420 bd10 ctu64 partial CTUs")
    off, n = layout(key)
    assert n == flat.size and set(off) == set(FIELDS)
    fields = _flat_unpack(key, torch.from_numpy(flat))
    for name in FIELDS:
        a = fields[name]
        assert np.array_equal(flat[off[name]:off[name] + a.numel()],
                              a.reshape(-1).numpy()), name


def test_frame_axis_is_per_picture():
    """A leading frame axis: each picture as it is alone."""
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda, sao_alf_ref
    planes, flat, key = _fuzz("422 bd10 ctu32", frames=3)
    got = _run(sao_alf_cuda, (planes, flat, key))
    for i in range(3):
        one = _run(sao_alf_ref, ([p[i] for p in planes], flat[i], key))
        for a, b in zip(got, one):
            assert np.array_equal(a[i], b)


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper's CUDA
    route, as far as it goes without one."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wrapper_raises(monkeypatch):
    """On CUDA-typed inputs with no build the wrapper raises KernelError
    and runs nothing in its place; an unsupported device, wrong dtypes or
    shapes, a missing field of the parameter vector, a key of another
    geometry and vmap raise before any launch."""
    import vvdec_tpu_torch.ops.cuda._build as build
    from vvdec_tpu_torch.ops.cuda._build import KernelError
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda, sao_alf_ref
    planes, flat, key = _torch(_fuzz("420 bd10 ctu64 partial CTUs"))

    def no_build(name):
        raise KernelError(f"nvcc not found for csrc/{name}.cu")

    monkeypatch.setattr(build, "load_kernel", no_build)
    before = sao_alf_cuda.launches
    with pytest.raises(KernelError, match="csrc/sao_alf.cu"):
        sao_alf_cuda([p.as_subclass(_OnCuda) for p in planes],
                     flat.as_subclass(_OnCuda), key)
    assert sao_alf_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        sao_alf_cuda([p.to("meta") for p in planes], flat.to("meta"), key)
    for fn in (sao_alf_cuda, sao_alf_ref):
        with pytest.raises(ValueError, match="plane 0 must be int32"):
            fn([planes[0].to(torch.int64)] + planes[1:], flat, key)
        with pytest.raises(ValueError, match="plane 2 must be"):
            fn(planes[:2] + [planes[2][:, :-1]], flat, key)
        with pytest.raises(ValueError, match="flat must be int16"):
            fn(planes, flat.to(torch.int32), key)
        with pytest.raises(ValueError, match="field cc_banks is missing"):
            fn(planes, flat[:-3], key)
        with pytest.raises(ValueError, match="flat must be contiguous"):
            fn(planes, torch.stack([flat, flat], -1)[:, 0], key)
        with pytest.raises(ValueError, match="3 components, the call 1"):
            fn(planes[:1], flat, key)
        with pytest.raises(ValueError, match="w_ctu"):
            fn(planes, flat, key[:9] + (key[9] + 1,) + key[10:])
    stacked = [p[None] for p in planes]
    with pytest.raises(RuntimeError, match="under torch.func.vmap"):
        torch.func.vmap(lambda *p: sao_alf_cuda(list(p), flat, key))(
            *stacked)


def test_chain_routes_through_the_wrapper_and_counts(monkeypatch):
    """The chain, with a leading frame axis of 3 pictures, calls the
    wrapper once on the stacked planes (outside any vmap), counts 3 plain
    pictures and equals the chain run a picture at a time, packed bytes
    included; a key with SAO and ALF off calls nothing and counts
    nothing."""
    import vvdec_tpu_torch.ops.device_pipeline as dp
    from vvdec_tpu_torch.utils.trace import profiler
    planes, flat, key = _torch(_fuzz("444 bd8 ctu32", frames=3))
    calls = []
    real = dp.sao_alf_cuda

    def stub(p, f, k):
        calls.append(tuple(p[0].shape))
        return real(p, f, k)

    monkeypatch.setattr(dp, "sao_alf_cuda", stub)
    profiler.reset()
    profiler.enabled = True
    try:
        got_p, got_b = dp._chain_fn(key)(planes, flat)
        counted = dict(profiler.counters)
        off = key[:12] + (False,) * 4 + (0, 0, 0) + key[19:]
        dp._chain_fn(off)(planes, torch.zeros((3, 1), dtype=torch.int16))
        after = dict(profiler.counters)
    finally:
        profiler.enabled = False
    assert calls == [(3, 64, 64)]
    assert counted.get(PLAIN_PICTURES) == 3 and KERNEL_PICTURES not in counted
    assert after == counted
    for i in range(3):
        one_p, one_b = dp._chain_fn(key)([p[i] for p in planes], flat[i])
        assert np.array_equal(got_b[i].numpy(), one_b.numpy())
        for a, b in zip(got_p, one_p):
            assert np.array_equal(a[i].numpy(), b.numpy())


def test_batched_chain_takes_one_call(monkeypatch):
    """filter_frames_device_batch over three SAO/ALF pictures calls the
    wrapper once on their stacked planes and equals the per-frame chain."""
    import vvdec_tpu_torch.ops.device_pipeline as dp
    from vvdec_tpu_torch.parallel.dryrun import capture_filter_inputs
    from vvdec_tpu_torch.streams import sao_alf_stream
    items = capture_filter_inputs(sao_alf_stream(w=128, h=96, n=3, seed=1),
                                  "cpu")
    want = [dp.filter_frame_device(cs, p).resolve() for cs, p in items]
    calls = []
    real = dp.sao_alf_cuda

    def stub(p, f, k):
        calls.append(tuple(p[0].shape))
        return real(p, f, k)

    monkeypatch.setattr(dp, "sao_alf_cuda", stub)
    got = dp.filter_frames_device_batch(items)
    assert calls == [(3, 96, 128)]
    for g, w in zip(got, want):
        for a, b in zip(g.resolve(), w):
            assert np.array_equal(a, b)


# ------------------------------------------------------------- the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _check_on_card(planes, flat, key, label):
    """One wrapper call on the card == the plain version, with its
    launches and its counted pictures."""
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda, sao_alf_ref
    from vvdec_tpu_torch.utils.trace import profiler
    n = planes[0].shape[0] if planes[0].dim() == 3 else 1
    before = sao_alf_cuda.launches
    profiler.reset()
    profiler.enabled = True
    try:
        got = sao_alf_cuda(planes, flat, key)
        counted = profiler.counters.get(KERNEL_PICTURES, 0)
    finally:
        profiler.enabled = False
    torch.cuda.synchronize()
    assert sao_alf_cuda.launches - before == _launches(key) <= 2, label
    assert counted == n, label
    want = sao_alf_ref(planes, flat, key)
    for c, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (label, c)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """On the card: sao_alf_cuda (at most two launches a call) ==
    sao_alf_ref on every fuzzed case, alone and with a frame axis of 4
    pictures, bit for bit."""
    _need_card()
    for name in FUZZ:
        for frames in (0, 4):
            _check_on_card(*_torch(_fuzz(name, frames=frames), "cuda"),
                           f"{name} x{frames}")


@pytest.mark.cuda
def test_kernel_on_the_bench_stream_pictures(monkeypatch):
    """On the card: the "SAO/ALF 8" bench stream (832x480, 8 pictures,
    every stage on) decoded through the chain makes two launches a
    picture; the kernels equal the plain version on every picture's
    post-deblock planes, and on 4 of them stacked on a frame axis."""
    _need_card()
    import vvdec_tpu_torch.ops.device_pipeline as dp
    from vvdec_tpu_torch.decoder import decode_annexb
    from vvdec_tpu_torch.ops.cuda.sao_alf import sao_alf_cuda
    from vvdec_tpu_torch.streams import STREAMS
    make, n_frames, _ = STREAMS["SAO/ALF 8"]
    recorded = []
    real = dp.sao_alf_cuda

    def recorder(p, f, k):
        recorded.append(([t.clone() for t in p], f.clone(), k))
        return real(p, f, k)

    monkeypatch.setattr(dp, "sao_alf_cuda", recorder)
    before = sao_alf_cuda.launches
    decode_annexb(make(), device="cuda")
    torch.cuda.synchronize()
    assert len(recorded) == n_frames
    assert sao_alf_cuda.launches - before == 2 * n_frames
    for i, (planes, flat, key) in enumerate(recorded):
        assert all(key[12:16]), i
        _check_on_card(planes, flat, key, f"picture {i}")
    # the first 4 pictures on a frame axis, their banks padded to one
    # key as the batched chain pads them
    per = [(k, {n: v.cpu().numpy() for n, v in
                dp._flat_unpack(k, f.cpu()).items()})
           for _, f, k in recorded[:4]]
    key = dp.batch_key(per, 16)
    flat = torch.stack([torch.from_numpy(dp._flat_pack(key, a))
                        for _, a in per]).cuda()
    planes = [torch.stack(ps) for ps in zip(*(r[0] for r in recorded[:4]))]
    _check_on_card(planes, flat, key, "4 pictures stacked")
