"""The intra wavefront kernel's wrapper (vvdec_tpu_torch/ops/cuda/intra.py)
and its plain version against the JAX reference's _intra_wavefront_fn,
the host helpers that cut the steps into phases (one a dependency level)
and pack them for the cluster kernel, and the level property the phases
rest on: no unit reads a sample another unit of its level writes.

Tolerance: bit-equal everywhere (integer arithmetic).  Each case is one
picture made by the port's own test encoder (so the card test needs no
JAX): its real descriptor rows and step batches, with planes and
residuals of seeded noise, so every sample a unit reads shows in the
output.  The cases hold every mode class, CCLM in each chroma format
(4:2:0 also without vertically collocated chroma; 4:2:2 and 4:4:4
streams have no such flag and are collocated), the LMCS chroma scale,
CIIP from the inter-LDB tools stream (`inter_ldb_stream`), and units
against the planes' bottom and right edges.  Two synthetic pictures
add a level whose units overlap (the later row must win) and a level of
165 4x4 units (wider than a cluster holds at once).  The CUDA kernel
itself runs only in the `cuda`-marked tests, on the card; JAX is
imported inside the tests that use it.
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
    _, pic, padded = CASES[name]
    cs = _picture(name)
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


def _run(fn, name, device, **kw):
    """fn (the wrapper or the plain version) on one case's inputs on
    `device`, with the keywords kw (levels, cluster); returns the three
    planes cropped to their shapes, numpy."""
    return _run_inputs(fn, _inputs(name), device, **kw)


def _run_inputs(fn, inputs, device, **kw):
    from vvdec_tpu_torch.ops.cuda.intra import intra_consts
    planes, resis, batches, key, lm, has_lmcs = inputs
    buf, res = _stacked(planes, resis, device)
    bd, cfmt, collocated, ctu_log2 = key
    out = fn(buf, res, batches, intra_consts(device),
             torch.from_numpy(lm).to(device), bd=bd, cfmt=cfmt,
             collocated=collocated, ctu_log2=ctu_log2, K=batches.shape[1],
             has_lmcs=has_lmcs, **kw)
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


def _reference(planes, resis, batches, key, lm, has_lmcs):
    """The reference's _intra_wavefront_fn on numpy inputs, its three
    planes as numpy."""
    import jax.numpy as jnp

    import vvdec_tpu.ops.intra_device as R
    out = R._intra_wavefront_fn(*key, batches.shape[1], has_lmcs)(
        tuple(map(jnp.asarray, planes)), tuple(map(jnp.asarray, resis)),
        jnp.asarray(batches), jnp.asarray(lm))
    return [np.asarray(o) for o in out]


@functools.lru_cache(maxsize=None)
def _want(name):
    """The reference's planes of one case."""
    return _reference(*_inputs(name))


def _step_levels(name):
    """The dependency level of each step of one case's batches."""
    from vvdec_tpu_torch.ops.intra_device import (build_intra_descriptors,
                                                  compute_unit_levels,
                                                  wavefront_step_levels)
    cs = _picture(name)
    desc, _ = build_intra_descriptors(cs)
    return wavefront_step_levels(
        desc, compute_unit_levels(desc, cs.sps.chroma_format_idc), K)


@functools.lru_cache(maxsize=None)
def _picture(name):
    from vvdec_tpu_torch.decoder import parse_annexb
    maker, pic, _ = CASES[name]
    return parse_annexb(maker())[pic].cs


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_reference(name):
    """intra_wavefront_ref through the wrapper's argument list, and the
    wrapper on CPU tensors (which runs it without a launch), == the
    reference's _intra_wavefront_fn on identical inputs."""
    from vvdec_tpu_torch.ops.cuda.intra import (intra_wavefront_cuda,
                                                intra_wavefront_ref)
    _check_case(name)
    want = _want(name)
    got = _run(intra_wavefront_ref, name, "cpu")
    for c, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), (name, c)
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


# ---------------------------------------------------------------- phases
@pytest.mark.parametrize("name", list(CASES))
def test_phased_plain_version_matches_reference(name):
    """With the step levels (one phase a level, every read of a phase
    before its writes) and without them (one phase a step), the plain
    version == the reference's step scan, bit for bit."""
    from vvdec_tpu_torch.ops.cuda.intra import intra_wavefront_ref
    levels = _step_levels(name)
    assert levels.shape == (_inputs(name)[2].shape[0],)
    want = _want(name)
    for lv in (levels, None):
        got = _run(intra_wavefront_ref, name, "cpu", levels=lv)
        for c, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (name, lv is None, c)


def _unit(comp, x, y, w, h, mc, **f):
    """One descriptor row with every reference available (the fill
    geometry _fill_params gives such a unit), PDPC on, the residual added;
    f sets other fields by index name: filtered, is_ver, angle, inv,
    kind."""
    from vvdec_tpu_torch.ops.intra_device import D
    d = np.zeros(D, np.int32)
    d[:11] = (comp, x, y, w, h, w.bit_length() - 1, h.bit_length() - 1, mc,
              f.get("filtered", 0), f.get("cbf", 1), 0)
    d[11:23] = (y - 1, y - 1, 0, x - 1, x - 1, x - 1 + 2 * w, x - 1, x - 1,
                0, y - 1, y - 1, y + 2 * h - 1)
    d[23:29] = (f.get("is_ver", 0), f.get("angle", 0), f.get("inv", 0),
                f.get("kind", 0), 1, 1)
    return d


def _synthetic(rows, seed):
    """(planes, resis, batches, key, lm, has_lmcs) of hand-made rows, all
    of level 1: 4:2:0 planes of a 128x96 picture padded by 64, seeded
    noise, K = 8 steps by mode class as build_wavefront_batches groups
    them; and the step levels."""
    from vvdec_tpu_torch.ops.intra_device import (LM_LEN,
                                                  build_wavefront_batches,
                                                  wavefront_step_levels)
    desc = np.stack(rows)
    lvl = np.ones(desc.shape[0], np.int32)
    rng = np.random.default_rng(seed)
    shapes = [(160, 192), (112, 128), (112, 128)]
    planes = tuple(rng.integers(0, 1 << BD, size=s).astype(np.int32)
                   for s in shapes)
    resis = tuple(rng.integers(-300, 300, size=s).astype(np.int32)
                  for s in shapes)
    lm = np.zeros(LM_LEN, np.int32)
    inputs = (planes, resis, build_wavefront_batches(desc, lvl, K),
              (BD, 1, True, 5), lm, False)
    return inputs, wavefront_step_levels(desc, lvl, K)


# angular modes of a 4x4 luma unit: (is_ver, angle, inv, kind)
ANGULAR = ((1, 0, 0, 0), (0, 0, 0, 0), (1, 32, 512, 0), (0, 32, 512, 0),
           (1, -32, 512, 0), (1, 18, 910, 1), (0, -12, 1365, 2),
           (1, 3, 5461, 1))


@functools.lru_cache(maxsize=None)
def _wide():
    """165 4x4 luma units of one level, 4 samples apart, so none reads
    another's block: planar (some smoothed), DC and 8 angular modes."""
    rows = []
    for j in range(11):
        for i in range(15):
            n = j * 15 + i
            kind = n % 10
            f = dict(cbf=n % 3 != 0)
            if kind >= 2:
                f.update(zip(("is_ver", "angle", "inv", "kind"),
                             ANGULAR[kind - 2]))
            elif kind == 0:
                f["filtered"] = n % 4 == 0
            rows.append(_unit(0, 4 + 8 * i, 4 + 8 * j, 4, 4, min(kind, 2),
                              **f))
    return _synthetic(rows, 5)


@functools.lru_cache(maxsize=None)
def _overlap():
    """A level whose units overlap: A (DC 8x8 at (8, 8)) and, two rows
    later in the same step, B (DC 4x4 at (8, 8)), whose references do not
    meet A's block; with planar and chroma units around them."""
    rows = [_unit(0, 8, 8, 8, 8, 1), _unit(0, 40, 8, 8, 8, 1),
            _unit(0, 8, 8, 4, 4, 1), _unit(0, 40, 40, 8, 8, 0),
            _unit(1, 24, 8, 4, 4, 0), _unit(1, 8, 8, 4, 4, 1)]
    return _synthetic(rows, 6)


def test_overlap_later_row_wins():
    """The phase helper starts a phase at the later of two overlapping
    units (per step, too, without levels); the plain version then equals
    the reference, whose fori_loop writes in row order, and the overlap
    holds the later unit's samples."""
    from vvdec_tpu_torch.ops.cuda.intra import (intra_wavefront_ref,
                                                wavefront_phases)
    inputs, levels = _overlap()
    batches = inputs[2]
    assert batches.shape[0] == 2 and (levels == 1).all()
    # step 0: the DC units (A, the luma DC at (40, 8), B, the chroma DC),
    # step 1 the planar units; B (flat row 2) starts a phase
    assert wavefront_phases(batches, levels, 160, 192).tolist() == [0, 2, 16]
    assert wavefront_phases(batches, None, 160, 192).tolist() == [
        0, 2, 8, 16]
    want = _reference(*inputs)
    for lv in (levels, None):
        got = _run_inputs(intra_wavefront_ref, inputs, "cpu", levels=lv)
        for c, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (lv is None, c)
    # B alone: its samples are the overlap's
    only_b = list(inputs)
    only_b[2] = batches[:1].copy()
    only_b[2][0, [0, 1, 3]] = 0
    alone = _run_inputs(intra_wavefront_ref, only_b, "cpu")
    assert np.array_equal(want[0][8:12, 8:12], alone[0][8:12, 8:12])
    assert not np.array_equal(want[0][8:12, 12:16], alone[0][8:12, 12:16])


def test_wide_level_matches_reference():
    """165 units of one level, one phase: the plain version == the
    reference; the cluster plan deals them over the blocks in chunks."""
    from vvdec_tpu_torch.ops.cuda.intra import (CHUNK_UNITS,
                                                intra_wavefront_ref,
                                                wavefront_phases,
                                                wavefront_plan)
    inputs, levels = _wide()
    batches = inputs[2]
    phases = wavefront_phases(batches, levels, 160, 192)
    assert phases.tolist() == [0, batches.shape[0] * K]
    want = _reference(*inputs)
    got = _run_inputs(intra_wavefront_ref, inputs, "cpu", levels=levels)
    for c, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), c
    for cluster in (1, 8, 16):
        recs = _records(wavefront_plan(batches, phases, cluster), cluster)
        counts = [r[2] for r in recs]
        assert sum(counts) == 165 and max(counts) <= CHUNK_UNITS
        assert len(recs) == sum(-(-len(range(b, 165, cluster))
                                  // CHUNK_UNITS)
                                for b in range(cluster))


# --------------------------------------------------------------- helpers
def test_step_levels_helper():
    """wavefront_step_levels == the level of every step of
    build_wavefront_batches, on seeded rows of mixed levels and mode
    classes and for several K; never decreasing."""
    from vvdec_tpu_torch.ops.intra_device import (D, build_wavefront_batches,
                                                  wavefront_step_levels)
    rng = np.random.default_rng(3)
    for n, k in ((1, 8), (40, 1), (97, 8), (97, 3), (300, 16)):
        desc = np.zeros((n, D), np.int32)
        desc[:, 7] = rng.integers(0, 6, n)
        desc[:, 1] = np.arange(n)          # tells the rows apart
        desc[:, 28] = 1
        lvl = rng.integers(1, 9, n).astype(np.int32)
        b = build_wavefront_batches(desc, lvl, k)
        got = wavefront_step_levels(desc, lvl, k)
        assert got.shape == (b.shape[0],) and got.dtype == np.int32
        assert (np.diff(got) >= 0).all()
        for s in range(b.shape[0]):
            units = b[s, b[s, :, 28] == 1, 1]
            assert (lvl[units] == got[s]).all(), (n, k, s)
    assert wavefront_step_levels(np.zeros((0, D), np.int32),
                                 np.zeros(0, np.int32), 8).shape == (0,)


def test_phase_helper():
    """wavefront_phases: one phase a step without levels, one a run of
    equal levels with them, boundaries at step starts; a cut where two
    units of one component write a sample in common, none where they
    are of two components or touch without sharing a sample."""
    from vvdec_tpu_torch.ops.cuda.intra import wavefront_phases
    rows = [_unit(0, 8 * i, 8, 8, 8, 0) for i in range(5)]
    b = np.stack([np.stack(rows[:2] + [np.zeros_like(rows[0])] * 2),
                  np.stack(rows[2:4] + [np.zeros_like(rows[0])] * 2),
                  np.stack([rows[4]] + [np.zeros_like(rows[0])] * 3)])
    assert wavefront_phases(b, None, 160, 192).tolist() == [0, 4, 8, 12]
    assert wavefront_phases(b, np.array([1, 1, 2]), 160, 192).tolist() == [
        0, 8, 12]
    assert wavefront_phases(b, np.array([3, 3, 3]), 160, 192).tolist() == [
        0, 12]
    # row 5 (step 1, slot 1) now overlaps row 0 by one column
    b2 = b.copy()
    b2[1, 1, 1] = 7
    assert wavefront_phases(b2, np.array([3, 3, 3]), 160, 192).tolist() == [
        0, 5, 12]
    # the same block in chroma: no cut; padding rows never cut
    b3 = b.copy()
    b3[1, 1, [0, 1]] = (1, 0)
    b3[2, 1] = b3[0, 0]
    b3[2, 1, 28] = 0
    assert wavefront_phases(b3, np.array([3, 3, 3]), 160, 192).tolist() == [
        0, 12]
    # a window the clamp moves (y = 120 starts its 64-row window at 96):
    # the phases are the steps, and the unit it overlaps in its step
    # still starts one
    b4 = b.copy()
    b4[0, :2, 1] = 0
    b4[0, :2, 2] = (120, 96)
    assert wavefront_phases(b4, np.array([3, 3, 3]), 160, 192).tolist() == [
        0, 1, 4, 8, 12]


def _records(plan, cluster):
    """The records of a wavefront_plan as (block, phase, count, rows), each
    row's pad ints checked zero; every block's records one after another,
    the plan ending in the room of one more record."""
    from vvdec_tpu_torch.ops.cuda.intra import (CHUNK_UNITS, PLAN_HEAD,
                                                PLAN_ROW)
    from vvdec_tpu_torch.ops.intra_device import D
    out = []
    assert plan[0] == 0
    assert plan.size == PLAN_HEAD + plan[cluster] + 4 + PLAN_ROW * CHUNK_UNITS
    for b in range(cluster):
        e = plan[b]
        while e < plan[b + 1]:
            r = plan[PLAN_HEAD + e:]
            n = int(r[1])
            body = r[4:4 + n * PLAN_ROW].reshape(n, PLAN_ROW)
            assert not body[:, D:].any() and not r[2:4].any()
            out.append((b, int(r[0]), n, body[:, :D]))
            e += 4 + n * PLAN_ROW
        assert e == plan[b + 1]
    return out


@pytest.mark.parametrize("cluster", [1, 4, 8, 16])
def test_plan_layout(cluster):
    """wavefront_plan on a real picture's phases: every valid row's
    slices (whole rows, at most SLICE_SAMPLES samples each) tile its
    block once, each in a record of the row's phase; each block's records
    in phase order; in every phase the blocks' sample counts differ by at
    most one slice; the masked plan the same with d[28] = 0.  The
    layout's constants match the kernel's."""
    import re

    from vvdec_tpu_torch.ops.cuda import _build
    from vvdec_tpu_torch.ops.cuda.intra import (CHUNK_UNITS, CLUSTER,
                                                CLUSTER_SIZES, PLAN_HEAD,
                                                PLAN_ROW, SLICE_SAMPLES,
                                                wavefront_phases)
    from vvdec_tpu_torch.ops.intra_device import D
    with open(f"{_build.CSRC}/intra_wavefront.cu") as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kU"]), int(consts["kRow"]), int(consts["kHead"]),
            int(consts["kD"]), int(consts["kMaxCluster"])) == (
        CHUNK_UNITS, PLAN_ROW, PLAN_HEAD, D, max(CLUSTER_SIZES))
    assert "kRec = 4 + kU * kRow" in src and CLUSTER in CLUSTER_SIZES
    batches = _inputs("lmcs mip cclm")[2]
    levels = _step_levels("lmcs mip cclm")
    phases = wavefront_phases(batches, levels, 160, 192)
    assert len(phases) - 1 == levels.max()
    for slice_samples in (SLICE_SAMPLES, 128):
        _check_plan(batches, phases, cluster, slice_samples)


def _check_plan(batches, phases, cluster, slice_samples):
    """test_plan_layout's checks of one plan."""
    import collections

    from vvdec_tpu_torch.ops.cuda.intra import CHUNK_UNITS, wavefront_plan
    from vvdec_tpu_torch.ops.intra_device import D
    rows = batches.reshape(-1, D)
    valid = np.flatnonzero(rows[:, 28] == 1)
    plan = wavefront_plan(batches, phases, cluster,
                          slice_samples=slice_samples)
    assert plan.dtype == np.int32
    recs = _records(plan, cluster)
    for b in range(cluster):
        mine = [r for r in recs if r[0] == b]
        assert [r[1] for r in mine] == sorted(r[1] for r in mine)
    slices = collections.defaultdict(list)
    load = collections.defaultdict(lambda: np.zeros(cluster, int))
    biggest = collections.defaultdict(int)
    for b, p, n, body in recs:
        assert 1 <= n <= CHUNK_UNITS
        for d in body:
            match = (np.delete(rows[valid], 32, 1) == np.delete(d, 32)).all(1)
            r = int(valid[match][0])
            assert phases[p] <= r < phases[p + 1]
            ys, ye = d[32] & 255, d[32] >> 8
            n_samples = (ye - ys) * min(d[3], 64)
            assert ys < ye and n_samples <= slice_samples
            slices[r].append((ys, ye))
            load[p][b] += n_samples
            biggest[p] = max(biggest[p], n_samples)
    assert sorted(slices) == valid.tolist()
    for r, parts in slices.items():
        parts.sort()
        assert parts[0][0] == 0 and parts[-1][1] == min(rows[r, 4], 64)
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert any(len(parts) > 1 for parts in slices.values()) \
        == (slice_samples < 32 * 32)
    for p, loads in load.items():
        assert loads.max() - loads.min() <= biggest[p], (p, loads)
    masked = _records(wavefront_plan(batches, phases, cluster, masked=True,
                                     slice_samples=slice_samples), cluster)
    assert [r[:3] for r in masked] == [r[:3] for r in recs]
    for m, r in zip(masked, recs):
        assert not m[3][:, 28].any()
        assert np.array_equal(np.delete(m[3], 28, 1), np.delete(r[3], 28, 1))
    # slicing off: one row a unit, its whole block
    whole = _records(wavefront_plan(batches, phases, cluster,
                                    slice_samples=64 * 64), cluster)
    assert sum(r[2] for r in whole) == valid.size


def test_every_row_class_and_levels_checked():
    """The wrapper and the plain version check the mode class of every
    valid row (a class-6 unit in row 3 raises; one in a padding row does
    not) and the step levels: one integer a step, never decreasing."""
    from vvdec_tpu_torch.ops.cuda.intra import (intra_consts,
                                                intra_wavefront_cuda,
                                                intra_wavefront_ref)
    from vvdec_tpu_torch.ops.intra_device import D, RL
    kw = dict(bd=BD, cfmt=1, collocated=True, ctu_log2=5, K=K,
              has_lmcs=False)
    batches = np.zeros((2, K, D), np.int32)
    batches[:, :4, 28] = 1
    buf = torch.zeros((3, RL, RL), dtype=torch.int32)
    args = (buf, torch.zeros_like(buf), intra_consts("cpu"), None)

    def call(fn, b, **extra):
        return fn(args[0], args[1], b, args[2], args[3], **kw, **extra)

    bad = batches.copy()
    bad[1, 3, 7] = 6
    for fn in (intra_wavefront_cuda, intra_wavefront_ref):
        with pytest.raises(NotImplementedError, match="mode class 6"):
            call(fn, bad)
    pad = batches.copy()
    pad[1, 5, 7] = 6
    call(intra_wavefront_ref, pad, levels=np.array([1, 2]))
    for lv, what in ((np.array([2, 1]), "must not decrease"),
                     (np.array([1]), "one integer a step"),
                     (np.array([1.0, 2.0]), "one integer a step")):
        for fn in (intra_wavefront_cuda, intra_wavefront_ref):
            with pytest.raises(ValueError, match=what):
                call(fn, batches, levels=lv)
    with pytest.raises(ValueError, match="unsupported device"):
        intra_wavefront_cuda(buf.to("meta"), buf.to("meta"), batches,
                             intra_consts("cpu").to("meta"), None,
                             levels=np.array([1, 2]), **kw)


# --------------------------------------------------------- level property
# CCLM's luma taps by chroma format (csrc/intra_wavefront.cu kT3, kT5,
# kT6): the nonzero coefficients' points
T3 = {1: (2, 1, 1), 2: (2, 1, 1), 3: (1, 0, 0)}
T5 = {1: (1, 4, 1, 1, 1), 2: (0, 2, 1, 1, 0), 3: (0, 1, 0, 0, 0)}
T6 = {1: (2, 1, 1, 2, 1, 1), 2: (2, 1, 1, 0, 0, 0), 3: (1, 0, 0, 0, 0, 0)}


def _ref_cells(d, hh, ww):
    """(rows, cols) of the samples unit d's reference runs read, with the
    kernel's window arithmetic (csrc/intra_wavefront.cu raw_top,
    raw_left)."""
    from vvdec_tpu_torch.ops.intra_device import RL
    if d[10] == 1:
        return np.zeros(0, int), np.zeros(0, int)
    j = np.arange(RL)

    def clampi(v, lo, hi):
        return np.minimum(np.maximum(v, lo), hi)

    rt0 = clampi(min(d[11], d[12]), 0, hh - 2)
    ct0 = clampi(d[15], 0, ww - RL)
    trow = np.where(j < d[13], rt0 + (d[11] != rt0), rt0 + (d[12] != rt0))
    jt = clampi(d[14] + j, d[15], d[16]) - ct0
    rl0 = clampi(d[21], 0, hh - RL)
    cl0 = clampi(min(d[17], d[18]), 0, ww - 2)
    lcol = np.where(j < d[19], cl0 + (d[17] != cl0), cl0 + (d[18] != cl0))
    jl = clampi(d[20] + j, d[21], d[22]) - rl0
    ok_t, ok_l = (jt >= 0) & (jt < RL), (jl >= 0) & (jl < RL)
    return (np.concatenate([trow[ok_t], rl0 + jl[ok_l]]),
            np.concatenate([ct0 + jt[ok_t], lcol[ok_l]]))


def _cclm_cells(d, key, hh, ww):
    """(rows, cols) of the luma samples a CCLM unit's template and
    prediction use: the points of every nonzero tap, of the template
    points its fit takes (csrc/intra_wavefront.cu cclm_setup, pred_cclm),
    normalised as the kernel normalises them."""
    from vvdec_tpu_torch.ops.intra_device import PB
    _, cfmt, collocated, ctu_log2 = key
    sub_w = 2 if cfmt in (1, 2) else 1
    sub_h = 2 if cfmt == 1 else 1
    stro = 0 if sub_w == 1 else 1
    lh, lw = hh - PB, ww - PB

    def nrow(r):
        r = np.minimum(np.where(r < 0, r + lh, r), lh - 1)
        return np.clip(np.where(r < 0, r + hh, r), 0, hh - 1)

    def ncol(x):
        x = np.minimum(np.where(x < 0, x + lw, x), lw - 1)
        return np.clip(np.where(x < 0, x + ww, x), 0, ww - 1)

    out = []

    def taps(coef, points):
        for k, (r, c) in zip(coef, points):
            if k:
                r, c = np.broadcast_arrays(r, c)
                out.append((nrow(r).ravel(), ncol(c).ravel()))

    lx, ly = d[1] * sub_w, d[2] * sub_h
    w, h = d[3], d[4]
    # the prediction
    y, x = np.mgrid[:h, :w]
    yy, xx = ly + sub_h * y, lx + sub_w * x
    no_left = (x == 0) & (d[23] != 1)
    if collocated:
        top_tap = np.where((y == 0) & (d[27] != 1), yy, yy - stro)
        taps(T5[cfmt], ((top_tap, xx), (yy, xx),
                        (yy, np.where(no_left, xx, xx - 1)), (yy, xx + 1),
                        (yy + stro, xx)))
    else:
        lx0 = np.where(no_left, xx, np.maximum(xx - 1, 0))
        xs1 = np.minimum(xx + 1, lw - 1)
        taps(T6[cfmt], ((yy, xx), (yy, lx0), (yy, xs1), (yy + stro, xx),
                        (yy + stro, lx0), (yy + stro, xs1)))
    # the template points the fit uses
    above, left = (d[26] & 1) == 1, (d[26] & 2) == 2
    a4, l4 = int(not left), int(not above)
    cnt_t = min(d[24], (1 + a4) << 1) if above else 0
    cnt_l = min(d[25], (1 + l4) << 1) if left else 0
    for q in range(cnt_t):
        i = (d[24] >> (2 + a4)) + q * max(d[24] >> (1 + a4), 1)
        xx = lx + sub_w * i
        lt = xx if (i == 0 and d[23] != 1) else xx - 1
        if (ly & ((1 << ctu_log2) - 1)) == 0:
            taps(T3[cfmt], ((ly - 1, xx), (ly - 1, lt), (ly - 1, xx + 1)))
        elif collocated:
            r = ly - sub_h
            taps(T5[cfmt], ((r - stro, xx), (r, xx), (r, lt), (r, xx + 1),
                            (r + stro, xx)))
        else:
            r = ly - sub_h
            taps(T6[cfmt], ((r, xx), (r, lt), (r, xx + 1), (r + stro, xx),
                            (r + stro, lt), (r + stro, xx + 1)))
    for q in range(cnt_l):
        jj = (d[25] >> (2 + l4)) + q * max(d[25] >> (1 + l4), 1)
        yy = ly + sub_h * jj
        base = lx - 2 - (sub_w - 1)
        if collocated:
            tt = yy if (jj == 0 and d[27] != 1) else yy - stro
            taps(T5[cfmt], ((tt, base + 1), (yy, base + 1), (yy, base),
                            (yy, base + 2), (yy + stro, base + 1)))
        else:
            taps(T6[cfmt], ((yy, base + 1), (yy, base), (yy, base + 2),
                            (yy + stro, base + 1), (yy + stro, base),
                            (yy + stro, base + 2)))
    return (np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]))


def _lmcs_cells(d, lm, ctu_log2, hh, ww):
    """(rows, cols) of the luma samples the LMCS chroma scale weighs."""
    num_nb = min(64, 1 << ctu_log2)
    xpos, ypos = int(d[30]), int(d[31])

    def start(s, size, dim):
        return min(max(s + dim if s < 0 else s, 0), dim - size)

    rows, cols = [], []
    if d[29] & 2:
        n = min(max(int(lm[67]) - ypos, 1), num_nb)
        rows.append(start(ypos, num_nb, hh) + np.arange(n))
        cols.append(np.full(n, start(max(xpos - 1, 0), 1, ww)))
    if d[29] & 4:
        n = min(max(int(lm[68]) - xpos, 1), num_nb)
        rows.append(np.full(n, start(max(ypos - 1, 0), 1, hh)))
        cols.append(start(xpos, num_nb, ww) + np.arange(n))
    if not rows:
        return np.zeros(0, int), np.zeros(0, int)
    return np.concatenate(rows), np.concatenate(cols)


def _level_conflicts(desc, lvl, key, lm, has_lmcs, hh, ww):
    """The (reader, writer) pairs of units of one level where the reader
    reads a sample the writer writes: reference runs, CCLM's luma and the
    LMCS VPDU neighbours, against each unit's written block in the
    stacked [3, hh, ww] planes."""
    from vvdec_tpu_torch.ops.cuda.intra import unit_blocks
    comp, y0, x0, h, w = unit_blocks(desc, hh, ww)
    owner = np.full((3, hh, ww), -1)
    for u in range(desc.shape[0]):
        owner[comp[u], y0[u]:y0[u] + h[u], x0[u]:x0[u] + w[u]] = u
    bad = set()
    for u, d in enumerate(desc):
        reads = [(comp[u], *_ref_cells(d, hh, ww))]
        if d[7] == 4:
            reads.append((0, *_cclm_cells(d, key, hh, ww)))
        if has_lmcs and d[29] & 1:
            reads.append((0, *_lmcs_cells(d, lm, key[3], hh, ww)))
        for c, r, x in reads:
            o = owner[c, r, x]
            o = np.unique(o[(o >= 0) & (o != u)])
            bad.update((u, int(v)) for v in o[lvl[o] == lvl[u]])
    return sorted(bad)


def _stream_picture(name):
    """The descriptor inputs of a stream's first picture (the CIIP
    stream's: its first with a CIIP unit), at full size."""
    from vvdec_tpu_torch import streams as S
    from vvdec_tpu_torch.decoder import parse_annexb
    if name == "headline":
        data, pic = S.intra_stream(**dict(S.HEADLINE_STREAM_KW,
                                          n_frames=1)), 0
    elif name == "tool-rich":
        data, pic = S.intra_stream(**dict(S.TOOL_RICH_STREAM_KW,
                                          n_frames=1)), 0
    elif name == "LMCS":
        data, pic = S.lmcs_stream(**dict(S.LMCS_STREAM_KW, n_frames=1)), 0
    else:
        data, pic = S.inter_ldb_stream(**dict(S.INTER_LDB_STREAM_KW,
                                              n=2)), 1
    return parse_annexb(data)[pic].cs


@pytest.mark.parametrize("name", list(CASES) + [
    "headline", "tool-rich", "LMCS", "CIIP"])
def test_level_property(name):
    """No unit reads a sample that another unit of its dependency level
    writes: the property one phase a level rests on.  On every case (its
    planes' size) and on the first picture of the headline, tool-rich,
    LMCS and CIIP (inter-LDB tools) streams (planes padded by PB)."""
    from vvdec_tpu_torch.frame.lmcs_np import Reshaper
    from vvdec_tpu_torch.ops.frame_device import _lmcs_on
    from vvdec_tpu_torch.ops.intra_device import (PB, RL,
                                                  build_intra_descriptors,
                                                  build_lmcs_params,
                                                  compute_unit_levels,
                                                  scan_key)
    if name in CASES:
        planes, _, _, key, lm, has_lmcs = _inputs(name)
        cs = _picture(name)
        hh = max(max(p.shape[0] for p in planes), RL)
        ww = max(max(p.shape[1] for p in planes), RL)
    else:
        cs = _stream_picture(name)
        key, has_lmcs = scan_key(cs), _lmcs_on(cs)
        lm = build_lmcs_params(Reshaper(cs.lmcs_info, BD, bool(
            cs.ph.chroma_residual_scale)), cs) if has_lmcs else None
        hh, ww = max(cs.h + PB, RL), max(cs.w + PB, RL)
    desc, reason = build_intra_descriptors(cs)
    assert reason is None and desc.shape[0], reason
    if name == "CIIP":
        assert (desc[:, 7] == 5).any()
    if name == "tool-rich":
        assert {3, 4} <= set(desc[:, 7].tolist())
    if name == "LMCS":
        assert has_lmcs and (desc[:, 29] & 1).any()
    lvl = compute_unit_levels(desc, key[1])
    conflicts = _level_conflicts(desc, lvl, key, lm, has_lmcs, hh, ww)
    if name != "edges":
        assert conflicts == []
        return
    # planes without the decoder's padding: windows the clamp moves write
    # where units of their level read, so the phases are the steps
    from vvdec_tpu_torch.ops.cuda.intra import (moved_windows, unit_blocks,
                                                wavefront_phases)
    _, y0, x0, _, _ = unit_blocks(desc, hh, ww)
    moved = (y0 != desc[:, 2]) | (x0 != desc[:, 1])
    assert conflicts and all(moved[w] for _, w in conflicts)
    batches = _inputs(name)[2]
    assert moved_windows(batches, hh, ww)
    steps = set(range(0, batches.shape[0] * K + 1, K))
    assert steps <= set(wavefront_phases(batches, _step_levels(name), hh,
                                         ww).tolist())


def test_level_property_finds_a_conflict():
    """The property check sees a reader of a same-level block: a unit
    whose top reference row lies inside another unit of its level."""
    rows = [_unit(0, 8, 8, 8, 8, 0), _unit(0, 8, 16, 8, 8, 0)]
    rows[1][11:13] = 15     # its top row is row 15 of the first unit
    desc = np.stack(rows)
    got = _level_conflicts(desc, np.array([1, 1]), (BD, 1, True, 5), None,
                           False, 160, 192)
    assert got == [(1, 0)]


def _launched(inputs, levels, cluster):
    """One case's planes after launch_plan over its plan for a cluster of
    `cluster` blocks, cropped, numpy (on the card)."""
    from vvdec_tpu_torch.ops.cuda.intra import (SLICE_SAMPLES, intra_consts,
                                                launch_plan, moved_windows,
                                                wavefront_phases,
                                                wavefront_plan)
    planes, resis, batches, key, lm, has_lmcs = inputs
    buf, res = _stacked(planes, resis, "cuda")
    hh, ww = buf.shape[1:]
    staged = moved_windows(batches, hh, ww)
    phases = wavefront_phases(batches, levels, hh, ww)
    plan = wavefront_plan(batches, phases, cluster,
                          slice_samples=64 * 64 if staged else SLICE_SAMPLES)
    err = launch_plan(buf, res, plan, len(phases) - 1, intra_consts("cuda"),
                      torch.from_numpy(lm).cuda(), bd=key[0], cfmt=key[1],
                      collocated=key[2], ctu_log2=key[3], has_lmcs=has_lmcs,
                      cluster=cluster, staged=staged)
    torch.cuda.synchronize()
    assert err == 0, err
    return [buf[c, :p.shape[0], :p.shape[1]].cpu().numpy()
            for c, p in enumerate(planes)]


@pytest.mark.cuda
def test_phased_kernel_matches_plain_version_on_card():
    """On the card: the cluster kernel with the step levels == the plain
    version with them on every case, the overlap picture (the later row
    wins) and the wide level, through the wrapper (one launch) and at
    every cluster size (a picture with a moved window only staged, on one
    block); an empty-phase plan (every unit masked) leaves the planes as
    they were."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vvdec_tpu_torch.ops.cuda.intra import (CLUSTER_SIZES, intra_consts,
                                                intra_wavefront_cuda,
                                                intra_wavefront_ref,
                                                launch_plan, moved_windows,
                                                wavefront_phases,
                                                wavefront_plan)
    cases = [(name, _inputs(name), _step_levels(name)) for name in CASES]
    cases += [("overlap", *_overlap()), ("wide", *_wide())]
    for name, inputs, levels in cases:
        want = _run_inputs(intra_wavefront_ref, inputs, "cuda",
                           levels=levels)
        before = intra_wavefront_cuda.launches
        got = _run_inputs(intra_wavefront_cuda, inputs, "cuda",
                          levels=levels)
        torch.cuda.synchronize()
        assert intra_wavefront_cuda.launches == before + 1
        for c, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (name, c)
        hh, ww = _stacked(inputs[0], inputs[1], "cpu")[0].shape[1:]
        moved = moved_windows(inputs[2], hh, ww)
        for cluster in (1,) if moved else CLUSTER_SIZES:
            got = _launched(inputs, levels, cluster)
            for c, (a, b) in enumerate(zip(got, want)):
                assert np.array_equal(a, b), (name, cluster, c)
    planes, resis, batches, key, lm, has_lmcs = _inputs("lmcs mip cclm")
    buf, res = _stacked(planes, resis, "cuda")
    before = buf.clone()
    phases = wavefront_phases(batches, _step_levels("lmcs mip cclm"),
                              buf.shape[1], buf.shape[2])
    err = launch_plan(buf, res, wavefront_plan(batches, phases, 8,
                                               masked=True),
                      len(phases) - 1, intra_consts("cuda"),
                      torch.from_numpy(lm).cuda(), bd=key[0], cfmt=key[1],
                      collocated=key[2], ctu_log2=key[3], has_lmcs=has_lmcs,
                      cluster=8)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(buf, before)
