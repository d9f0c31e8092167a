"""The intra wavefront kernel's wrapper (vvdec_tpu_torch/ops/cuda/intra.py)
and its plain version against the JAX reference's _intra_wavefront_fn.

Tolerance: bit-equal everywhere (integer arithmetic).  Each case is one
picture made by the port's own test encoder (so the card test needs no
JAX): its real descriptor rows and step batches, with planes and
residuals of seeded noise, so every sample a unit reads shows in the
output.  The cases hold every mode class, CCLM in each chroma format
(4:2:0 also without vertically collocated chroma; 4:2:2 and 4:4:4
streams have no such flag and are collocated), the LMCS chroma scale,
CIIP from the inter-LDB tools stream (`inter_ldb_stream`), and units
against the planes' bottom and right edges.  The CUDA kernel itself runs only in the
`cuda`-marked test, on the card; JAX is imported inside the tests that
use it.
"""

import functools

import numpy as np
import pytest
import torch

BD = 10
K = 8
INTRA = dict(width=128, height=96, ctu=32, n_frames=1, qp=30)
CCLM_DEC = dict(split_prob=0.4, density=0.3)


def _intra(**kw):
    from vvdec_tpu_torch.streams import intra_stream
    return intra_stream(**dict(INTRA, **kw))


def _cclm(cfmt, collocated):
    sps = dict(cclm_enabled=True, chroma_format=cfmt)
    if not collocated:
        sps["chroma_ver_collocated"] = False
    return lambda: _intra(seed=51, sps_kw=sps, dec_kw=CCLM_DEC)


def _lmcs(seed, sps_kw, dec_kw):
    """One 128x96 IDR picture, CTU 32, LMCS with the chroma residual
    scale, the SPS tools `sps_kw`."""
    from vvdec_tpu_torch.streams import _headers
    from vvdec_tpu_torch.testenc import encoder as E
    sps = E.make_sps(128, 96, ctu=32, lmcs_enabled=True, **sps_kw)
    pps = E.make_pps(sps)
    _, aps_nal = E.make_lmcs_aps(seed)
    nal, _ = E.encode_frame(
        sps, pps, E.RandomDecisions(seed=seed * 100, **dec_kw), qp=32, poc=0,
        idr=True, ph_kw=dict(lmcs_enabled=True, lmcs_aps_id=0,
                             chroma_residual_scale=True))
    return _headers(sps, pps) + aps_nal + nal


def _ldb():
    from vvdec_tpu_torch.streams import INTER_LDB_STREAM_KW, inter_ldb_stream
    return inter_ldb_stream(**dict(INTER_LDB_STREAM_KW, w=128, h=96, n=3))


# name -> (stream maker, picture, planes padded by PB as the decoder
# pads them); the headline's decisions at 120x88, whose bottom and right
# CTUs are partial, put units against the padded planes' edges, and the
# same picture on unpadded planes has windows the clamp moves
CASES = {
    "angular": (lambda: _intra(width=120, height=88, seed=1, qp=32,
                               dec_kw=dict(split_prob=0.35, density=0.1)),
                0, True),
    "edges": (lambda: _intra(width=120, height=88, seed=1, qp=32,
                             dec_kw=dict(split_prob=0.35, density=0.1)),
              0, False),
    "mip": (lambda: _intra(seed=13, sps_kw=dict(mip_enabled=True),
                           dec_kw=dict(split_prob=0.4, density=0.3,
                                       mip_prob=0.9)), 0, True),
    "cclm 4:2:0": (_cclm(1, True), 0, True),
    "cclm 4:2:0 not collocated": (_cclm(1, False), 0, True),
    "cclm 4:2:2": (_cclm(2, True), 0, True),
    "cclm 4:4:4": (_cclm(3, True), 0, True),
    "lmcs": (lambda: _lmcs(33, {}, dict(split_prob=0.5, density=0.4)), 0,
             True),
    "lmcs mip cclm": (lambda: _lmcs(36, dict(mip_enabled=True,
                                             cclm_enabled=True),
                                    dict(split_prob=0.5, density=0.4,
                                         mip_prob=0.3)), 0, True),
    "ciip": (_ldb, 1, True),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(planes, resis, batches, key, lm, has_lmcs) of one case, numpy."""
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.frame.lmcs_np import Reshaper
    from vvdec_tpu_torch.ops.frame_device import _lmcs_on
    from vvdec_tpu_torch.ops.intra_device import (
        LM_LEN,
        PB,
        build_intra_descriptors,
        build_lmcs_params,
        build_wavefront_batches,
        compute_unit_levels,
        scan_key,
    )
    maker, pic, padded = CASES[name]
    cs = parse_annexb(maker())[pic].cs
    desc, reason = build_intra_descriptors(cs)
    assert reason is None, reason
    key = scan_key(cs)
    has_lmcs = _lmcs_on(cs)
    rng = np.random.default_rng(len(name) * 7 + pic)
    if has_lmcs:
        lm = build_lmcs_params(Reshaper(cs.lmcs_info, BD, bool(
            cs.ph.chroma_residual_scale)), cs)
    else:
        lm = rng.integers(0, 1 << 10, LM_LEN).astype(np.int32)
    pad = PB if padded else 0
    shapes = [(h + pad, w + pad) for w, h in cs.comp_size]
    planes = tuple(rng.integers(0, 1 << BD, size=s).astype(np.int32)
                   for s in shapes)
    resis = tuple(rng.integers(-600, 600, size=s).astype(np.int32)
                  for s in shapes)
    batches = build_wavefront_batches(
        desc, compute_unit_levels(desc, key[1]), K)
    return planes, resis, batches, key, lm, has_lmcs


def _stacked(planes, resis, device):
    """The wrapper's [3, hh, ww] planes and residuals, as _intra_wavefront_fn
    stacks them."""
    from vvdec_tpu_torch.ops.intra_device import RL
    hh = max(max(p.shape[0] for p in planes), RL)
    ww = max(max(p.shape[1] for p in planes), RL)
    out = []
    for arrs in (planes, resis):
        t = torch.zeros((3, hh, ww), dtype=torch.int32, device=device)
        for c, a in enumerate(arrs):
            t[c, :a.shape[0], :a.shape[1]] = torch.from_numpy(a)
        out.append(t)
    return out


def _run(fn, name, device):
    """fn (the wrapper or the plain version) on one case's inputs on
    `device`; returns the three planes cropped to their shapes, numpy."""
    from vvdec_tpu_torch.ops.cuda.intra import intra_consts
    planes, resis, batches, key, lm, has_lmcs = _inputs(name)
    buf, res = _stacked(planes, resis, device)
    bd, cfmt, collocated, ctu_log2 = key
    out = fn(buf, res, batches, intra_consts(device),
             torch.from_numpy(lm).to(device), bd=bd, cfmt=cfmt,
             collocated=collocated, ctu_log2=ctu_log2, K=K,
             has_lmcs=has_lmcs)
    assert out is buf
    return [buf[c, :p.shape[0], :p.shape[1]].cpu().numpy()
            for c, p in enumerate(planes)]


def _check_case(name):
    """The case holds what its name says."""
    from vvdec_tpu_torch.ops.intra_device import B, RL
    planes, _, batches, key, _, has_lmcs = _inputs(name)
    rows = batches.reshape(-1, batches.shape[-1])
    rows = rows[rows[:, 28] == 1]
    classes = set(rows[:, 7].tolist())
    want = {"angular": {0, 1, 2}, "mip": {3}, "lmcs mip cclm": {3, 4},
            "ciip": {5}}.get(name, {4} if name.startswith("cclm") else set())
    assert want <= classes, (name, classes)
    if name.startswith("cclm"):
        cfmt = {"4:2:0": 1, "4:2:2": 2, "4:4:4": 3}[name.split()[1]]
        assert key[1:3] == (cfmt, "not" not in name), key
    if name.startswith("lmcs"):
        assert has_lmcs and (rows[:, 29] & 1).any()
    if name == "angular":
        # units against the bottom and right edges of the picture
        assert ((rows[:, 0] == 0) & (rows[:, 2] + rows[:, 4] == 88)).any()
        assert ((rows[:, 0] == 0) & (rows[:, 1] + rows[:, 3] == 120)).any()
    if name == "edges":
        # windows whose start the clamp moves, at both edges
        hh = max(max(p.shape[0] for p in planes), RL)
        ww = max(max(p.shape[1] for p in planes), RL)
        assert (rows[:, 2] + B > hh).any() and (rows[:, 1] + B > ww).any()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_reference(name):
    """intra_wavefront_ref through the wrapper's argument list, and the
    wrapper on CPU tensors (which runs it without a launch), == the
    reference's _intra_wavefront_fn on identical inputs."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.intra_device as R
    from vvdec_tpu_torch.ops.cuda.intra import (intra_wavefront_cuda,
                                                intra_wavefront_ref)
    _check_case(name)
    planes, resis, batches, key, lm, has_lmcs = _inputs(name)
    want = R._intra_wavefront_fn(*key, K, has_lmcs)(
        tuple(map(jnp.asarray, planes)), tuple(map(jnp.asarray, resis)),
        jnp.asarray(batches), jnp.asarray(lm))
    got = _run(intra_wavefront_ref, name, "cpu")
    for c, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, np.asarray(b)), (name, c)
    before = intra_wavefront_cuda.launches
    again = _run(intra_wavefront_cuda, name, "cpu")
    assert intra_wavefront_cuda.launches == before
    for a, b in zip(again, got):
        assert np.array_equal(a, b)


def test_consts_round_trip():
    """intra_consts("cpu") holds the port's tables at CONST_TABLES'
    offsets, once per device."""
    from vvdec_tpu_torch.ops.cuda.intra import (CONST_LEN, CONST_TABLES,
                                                const_tables, intra_consts)
    from vvdec_tpu_torch.ops.intra_device import _CCLM_DIV
    from vvdec_tpu_torch.ops.tables import (CHROMA_FILTER, GAUSS_FILTER,
                                            MIP_4x4, MIP_8x8, MIP_16x16)
    consts = intra_consts("cpu")
    assert intra_consts("cpu") is consts
    assert consts.dtype == torch.int32 and consts.shape == (CONST_LEN,)
    tables = const_tables(consts)
    assert list(tables) == [n for n, _ in CONST_TABLES]
    for name, table in (("cubic", CHROMA_FILTER), ("gauss", GAUSS_FILTER),
                        ("mip4", MIP_4x4), ("mip8", MIP_8x8),
                        ("mip16", MIP_16x16), ("cclm_div", _CCLM_DIV)):
        assert np.array_equal(tables[name].numpy(), np.asarray(table)), name
    # the offsets csrc/intra_wavefront.cu reads them at
    offs = np.cumsum([0] + [int(np.prod(s)) for _, s in CONST_TABLES])
    assert offs.tolist() == [0, 128, 256, 1280, 2304, 4992, 5008]


def test_wrapper_raises():
    """An unsupported device, an unknown mode class, and buffers of the
    wrong shape or type raise before any launch."""
    from vvdec_tpu_torch.ops.cuda.intra import (intra_consts,
                                                intra_wavefront_cuda,
                                                intra_wavefront_ref)
    from vvdec_tpu_torch.ops.intra_device import D, RL
    kw = dict(bd=BD, cfmt=1, collocated=True, ctu_log2=5, K=K,
              has_lmcs=False)
    batches = np.zeros((2, K, D), np.int32)
    batches[:, 0, 28] = 1

    def args(device, b=batches, shape=(3, RL, RL)):
        buf = torch.zeros(shape, dtype=torch.int32, device=device)
        return (buf, torch.zeros_like(buf), b,
                intra_consts("cpu").to(device), None)

    with pytest.raises(ValueError, match="unsupported device"):
        intra_wavefront_cuda(*args("meta"), **kw)
    bad = batches.copy()
    bad[1, 0, 7] = 6
    for fn in (intra_wavefront_cuda, intra_wavefront_ref):
        with pytest.raises(NotImplementedError, match="mode class 6"):
            fn(*args("cpu", bad), **kw)
    with pytest.raises(ValueError, match="buf must be"):
        intra_wavefront_cuda(*args("cpu", shape=(3, RL - 1, RL)), **kw)
    with pytest.raises(ValueError, match="batches must be"):
        intra_wavefront_cuda(*args("cpu", batches[:, :4]), **kw)
    buf, res, b, consts, _ = args("cpu")
    with pytest.raises(TypeError, match="resi must be"):
        intra_wavefront_cuda(buf, res.to(torch.int64), b, consts, None, **kw)
    with pytest.raises(ValueError, match="lm must be"):
        intra_wavefront_cuda(buf, res, b, consts, None,
                             **dict(kw, has_lmcs=True))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """On the card: intra_wavefront_cuda (one launch a case) ==
    intra_wavefront_ref on every case, bit for bit; run_intra_scan on a
    CUDA device launches the kernel once and equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.ops.cuda.intra import (intra_wavefront_cuda,
                                                intra_wavefront_ref)
    from vvdec_tpu_torch.ops.intra_device import run_intra_scan
    for name in CASES:
        _check_case(name)
        before = intra_wavefront_cuda.launches
        got = _run(intra_wavefront_cuda, name, "cuda")
        torch.cuda.synchronize()
        assert intra_wavefront_cuda.launches == before + 1
        want = _run(intra_wavefront_ref, name, "cuda")
        for c, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (name, c)
    planes, resis, batches, key, lm, has_lmcs = _inputs("lmcs mip cclm")
    from vvdec_tpu_torch.decoder import parse_annexb
    from vvdec_tpu_torch.ops.intra_device import build_intra_descriptors
    desc, _ = build_intra_descriptors(
        parse_annexb(CASES["lmcs mip cclm"][0]())[0].cs)
    outs = []
    for dev in ("cuda", "cpu"):
        before = intra_wavefront_cuda.launches
        out = run_intra_scan(
            tuple(torch.from_numpy(p).to(dev) for p in planes),
            tuple(torch.from_numpy(r).to(dev) for r in resis), desc, key,
            torch.from_numpy(lm).to(dev))
        assert intra_wavefront_cuda.launches == before + (dev == "cuda")
        outs.append([o.cpu().numpy() for o in out])
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
