"""The plan layer's C descriptor builder (csrc/plan_host.c, bound by
vvdec_tpu_torch/ops/plan_host.py) against its Python twin and the JAX
reference's builder, on the CPU.

Tolerance: bit-equal.  On every picture of every stream below, parsed by
the port's native syntax walk, the C builder gives the same (desc, reason)
as ops/intra_device.build_intra_descriptors_py: the same dtype, shape and
bytes, or the same first rejection reason.  The streams are each stream
of vvdec_tpu_torch/streams.STREAMS made by its own builder with its own
tools and decisions at a small picture size (the 1080p ones keep a
partial bottom CTU row, as 1080 rows do), small clips of the benchmark's
three traffic mixes at its CTU of 128, and tool streams: MIP, CCLM and
MDLM, dual tree (4:2:0 and 4:2:2), 4:4:4, 4:0:0, WPP, tiles with several
slices, CIIP, LMCS chroma scaling.  Rejections: ISP, MRL, BDPCM, IBC and
ACT from streams, and each reason no stream reaches (a CU or TU outside
the device set, the corner-only reference layout) from one record of a
parsed picture changed, which both builders then read.
"""

import functools
import os

import numpy as np
import pytest

from vvdec_tpu.decoder import parse_annexb as parse_ref
from vvdec_tpu.ops.intra_device import \
    build_intra_descriptors as build_ref
from vvdec_tpu_torch import streams as S
from vvdec_tpu_torch.decoder import parse_annexb
from vvdec_tpu_torch.frame.structure import MODE_INTRA
from vvdec_tpu_torch.ops import plan_host
from vvdec_tpu_torch.ops.intra_device import (
    _picture_gates,
    build_intra_descriptors_py,
    plan_intra_descriptors,
)
from vvdec_tpu_torch.testenc import encoder as E
from vvdec_tpu_torch.testenc.encoder import generate_stream
from vvdec_tpu_torch.utils.trace import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "decode_bench")

# each stream of streams.STREAMS: (builder, its keywords); made at SMALL
# (the 1080p ones at SMALL_1080) with at most FRAMES pictures, inter
# streams with three
STREAM_BUILDERS = {
    "headline": (S.intra_stream, S.HEADLINE_STREAM_KW),
    "tool-rich": (S.intra_stream, S.TOOL_RICH_STREAM_KW),
    "SAO/ALF": (S.sao_alf_stream, S.SAO_ALF_STREAM_KW),
    "LMCS": (S.lmcs_stream, S.LMCS_STREAM_KW),
    "inter-LD": (S.inter_ld_stream, S.INTER_LD_STREAM_KW),
    "inter-LDB tools": (S.inter_ldb_stream, S.INTER_LDB_STREAM_KW),
    "RA": (S.ra_stream, S.RA_STREAM_KW),
    "inter-LMCS": (S.lmcs_stream, S.LMCS_INTER_STREAM_KW),
    "dense q27": (S.intra_stream, S.DENSE_Q27_STREAM_KW),
    "max-density q22": (S.intra_stream, S.MAX_DENSITY_Q22_STREAM_KW),
    "tool-rich 8": (S.intra_stream, S.TOOL_RICH_8_STREAM_KW),
    "SAO/ALF 8": (S.sao_alf_stream, S.SAO_ALF_8_STREAM_KW),
    "SAO/ALF 1080p": (S.sao_alf_stream, S.SAO_ALF_1080P_STREAM_KW),
    "inter-LD 1080p": (S.inter_ld_stream, S.INTER_LD_1080P_STREAM_KW),
}
SMALL, SMALL_1080 = (256, 128), (320, 120)
FRAMES = 2


def _small(name):
    """STREAMS[name]'s stream at a small size and few pictures."""
    build, kw = STREAM_BUILDERS[name]
    kw = dict(kw)
    w, h = SMALL_1080 if name.endswith("1080p") else SMALL
    if "wh" in kw:
        kw["wh"] = (w, h)
    elif "width" in kw:
        kw.update(width=w, height=h)
    else:
        kw.update(w=w, h=h)
    inter = "inter" in name
    for key in ("n", "n_frames"):
        if key in kw:
            kw[key] = min(kw[key], 3 if inter else FRAMES)
    return build(**kw)


def _gen(**kw):
    kw.setdefault("width", 128)
    kw.setdefault("height", 96)
    kw.setdefault("ctu", 32)
    kw.setdefault("qp", 30)
    return generate_stream(**kw)[0]


DUAL = dict(dual_tree_intra=True, min_qt_size=[8, 8, 8],
            max_mtt_depth=[2, 2, 2], max_bt_size=[32, 32, 32],
            max_tt_size=[32, 32, 32])


def _tiles_slices():
    """Four rectangular slices, one a tile of a 2x2 grid, CTU 32."""
    return S.tiles_alf_stream(seed=2, wh=(128, 64), ctu=32, pps_kw=dict(
        no_pic_partition=False, num_exp_tile_cols=2, num_exp_tile_rows=2,
        tile_col_widths=[2, 2], tile_row_heights=[1, 1], rect_slice=True,
        single_slice_per_subpic=False, num_slices_in_pic=4,
        slice_top_left_tile_idx=[0, 1, 2, 3],
        slice_width_in_tiles=[1, 1, 1, 1],
        slice_height_in_tiles=[1, 1, 1, 1]))


def _bdpcm():
    class BdpcmDec(E.RandomDecisions):
        def bdpcm_mode(self, cu, ch):
            return self.rnd.choice([0, 0, 1, 2])

    sps = E.make_sps(64, 64, transform_skip_enabled=True,
                     bdpcm_enabled=True, log2_max_ts_size=4)
    pps = E.make_pps(sps)
    nal, _ = E.encode_frame(sps, pps, BdpcmDec(seed=0, split_prob=0.5),
                            qp=32)
    return S._headers(sps, pps) + nal


def _ibc():
    sps = E.make_sps(96, 64, ctu=32, ibc_enabled=True)
    pps = E.make_pps(sps)
    nal, _ = E.encode_frame(sps, pps, E.RandomDecisions(
        seed=900, split_prob=0.5, ibc_prob=0.7), qp=32, poc=0, idr=True)
    return S._headers(sps, pps) + nal


TOOL_STREAMS = {
    "mip": lambda: _gen(n_frames=2, seed=13, sps_kw=dict(mip_enabled=True),
                        dec_kw=dict(split_prob=0.4, density=0.3,
                                    mip_prob=0.9)),
    "mip_cclm_ctu128": lambda: _gen(
        width=256, height=128, ctu=128, n_frames=2, seed=17,
        sps_kw=dict(mip_enabled=True, cclm_enabled=True),
        dec_kw=dict(split_prob=0.3, density=0.3, mip_prob=0.3)),
    # non-square MDLM units whose above-right template runs past h / 2
    "cclm": lambda: _gen(n_frames=3, seed=52, sps_kw=dict(cclm_enabled=True),
                         dec_kw=dict(split_prob=0.6, density=0.3)),
    "dual_tree": lambda: _gen(n_frames=2, seed=9, sps_kw=dict(DUAL),
                              dec_kw=dict(split_prob=0.5, density=0.3)),
    "cclm_dual_tree_422": lambda: _gen(
        n_frames=2, seed=53,
        sps_kw=dict(DUAL, chroma_format=2, cclm_enabled=True),
        dec_kw=dict(split_prob=0.4, density=0.3)),
    "cclm_444": lambda: _gen(n_frames=2, seed=11,
                             sps_kw=dict(chroma_format=3, cclm_enabled=True),
                             dec_kw=dict(split_prob=0.4, density=0.3)),
    "mono_400": lambda: _gen(n_frames=2, seed=12,
                             sps_kw=dict(chroma_format=0),
                             dec_kw=dict(split_prob=0.4, density=0.3)),
    "wpp": lambda: _gen(n_frames=2, seed=10,
                        sps_kw=dict(entropy_coding_sync_enabled=True,
                                    entry_point_offsets_present=True),
                        dec_kw=dict(split_prob=0.4, density=0.3)),
    "tiles_slices": _tiles_slices,
    "lmcs_chroma_scale_ctu32": lambda: S.lmcs_stream(
        seed=33, n_frames=2, dec_kw=dict(split_prob=0.5, density=0.4),
        chroma_scale=True, ctu=32, wh=(128, 96)),
    # CTU 128: the scale's VPDU is 64x64, not the CTU
    "lmcs_chroma_scale_ctu128": lambda: S.lmcs_stream(
        seed=33, n_frames=2, dec_kw=dict(split_prob=0.5, density=0.4),
        chroma_scale=True, ctu=128, wh=(256, 128)),
}

# streams whose pictures the builders reject, and the reason
REJECTED = {
    "isp": (lambda: _gen(n_frames=1, seed=18, sps_kw=dict(isp_enabled=True),
                         dec_kw=dict(split_prob=0.4, density=0.3,
                                     isp_prob=0.8)), "isp"),
    "mrl": (lambda: _gen(n_frames=1, seed=19, sps_kw=dict(mrl_enabled=True),
                         dec_kw=dict(split_prob=0.5, mrl_prob=0.5)), "mrl"),
    "bdpcm": (_bdpcm, "bdpcm"),
    "ibc": (_ibc, "ibc"),
    "act": (lambda: _gen(n_frames=1, seed=20,
                         sps_kw=dict(chroma_format=3, act_enabled=True),
                         dec_kw=dict(split_prob=0.5, act_prob=0.7)), "act"),
}


def _load_clips():
    """{cell: clip stream}: a 2-picture clip of each of the benchmark's
    traffic mixes, made by the harness's own builder (decode_bench/
    clips.py) at the cell's CTU on a small picture."""
    import json
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.syspath_prepend(BENCH)
        import clips
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            manifest = json.load(f)
        configs = {c["name"]: c["file"] for c in manifest["configs"]}
        for cell in manifest["workloads"]:
            with open(os.path.join(ROOT, configs[cell["config"]])) as f:
                config = json.load(f)
            with open(os.path.join(BENCH, "traffic",
                                   cell["traffic"] + ".json")) as f:
                traffic = json.load(f)
            # one CTU row and a partial one at CTU 128, as 1080 rows end
            config.update(width=384, height=248)
            traffic.update(pictures_per_clip=2)
            out[cell["name"]] = clips.build_clip(
                traffic["kind"], config, traffic, 2 ** 31 + 977)[0]
    return out


@functools.lru_cache(maxsize=None)
def _stream(case):
    kind, name = case.split(":", 1)
    if kind == "streams":
        return _small(name)
    if kind == "tools":
        return TOOL_STREAMS[name]()
    if kind == "rejected":
        return REJECTED[name][0]()
    return _load_clips()[name]


def _parsed(case):
    return [f.cs for f in parse_annexb(_stream(case))]


def _compare(cs):
    """(reason, desc) of the C builder on cs, after checking them and the
    inter flag against the Python twin's."""
    reason, chroma_scale = _picture_gates(cs)
    assert reason is None
    got = plan_host.build_rows(cs, chroma_scale)
    assert got is not None, "the picture did not take the C builder"
    desc, why, inter = got
    want, why_py = build_intra_descriptors_py(cs)
    assert why == why_py
    if want is None:
        assert desc is None
    else:
        assert desc.dtype == want.dtype and desc.shape == want.shape
        assert desc.tobytes() == want.tobytes()
    assert inter == any(cu.pred_mode != MODE_INTRA for cu in cs.cus)
    return why, desc


CASES = ([f"streams:{n}" for n in STREAM_BUILDERS]
         + [f"tools:{n}" for n in TOOL_STREAMS]
         + ["clips:ai832_sao_alf_q32", "clips:ldp1080_mv32_q32",
            "clips:ai832_dense_q22"])


def test_every_stream_of_streams_py_is_covered():
    assert set(STREAM_BUILDERS) == set(S.STREAMS)


@pytest.mark.parametrize("case", CASES)
def test_c_builder_equals_python_twin(case):
    rows = 0
    for cs in _parsed(case):
        why, desc = _compare(cs)
        assert why is None
        rows += len(desc)
    assert rows > 0


def test_the_streams_reach_the_tools():
    """The rows of the tool streams hold what they are named for."""
    def classes(case):
        return {int(c) for cs in _parsed(case)
                for c in _compare(cs)[1][:, 7]}

    assert 3 in classes("tools:mip")                       # MIP
    from vvdec_tpu_torch.cabac.native_walk import CU_F
    assert 4 in classes("tools:cclm")
    chroma_modes = {int(m) for cs in _parsed("tools:cclm")
                    for m in cs._nw["cu_rec"][:len(cs.cus),
                                              CU_F["intra_dir1"]]}
    assert {67, 68, 69} <= chroma_modes                    # LM and MDLM
    assert 5 in classes("streams:inter-LDB tools")         # CIIP
    lmcs = [_compare(cs)[1] for cs in _parsed("tools:lmcs_chroma_scale_ctu32")]
    assert any((d[:, 29] & 1).any() for d in lmcs)         # chroma scale
    assert any(cs.sps.chroma_format_idc == 2 and cs.sps.dual_tree_intra
               for cs in _parsed("tools:cclm_dual_tree_422"))
    assert len(_parsed("tools:tiles_slices")[0].shs) == 4


@pytest.mark.parametrize("name", list(REJECTED))
def test_rejections_match(name):
    """A picture outside the device intra set: both builders name the
    same first reason (the per-TU ones through the C builder; ibc and act
    are picture-level gates both share)."""
    want = REJECTED[name][1]
    hit = False
    for cs in _parsed(f"rejected:{name}"):
        reason, chroma_scale = _picture_gates(cs)
        if reason is not None:
            assert (None, reason) == build_intra_descriptors_py(cs)
            assert plan_intra_descriptors(cs)[:2] == (None, reason)
        else:
            reason, _ = _compare(cs)
        hit |= reason == want
    assert hit


def _first_tu_with(cs, block, start=0):
    """(index, CU index) of the first TU from `start` on with a luma
    (block 0) or chroma (block 1) block in a CU that has that channel."""
    from vvdec_tpu_torch.cabac.native_walk import CU_F
    nw = cs._nw
    has = CU_F["has_chroma" if block else "has_luma"]
    for i in range(start, int(nw["counts"][1])):
        t = nw["tu_rec"][i]
        ci = int(t[plan_host.TU_F["cu_idx"]])
        if t[plan_host.TU_F[f"bw{block}"]] and nw["cu_rec"][ci, has]:
            return i, ci
    raise AssertionError("no such TU")


def _corner_only(cs):
    """Mark unavailable (another tile) every CU that covers the above or
    left reference samples of an intra luma TU whose top-left neighbour
    stays available: the corner-only layout."""
    from vvdec_tpu_torch.cabac.native_walk import CU_F
    nw = cs._nw
    cu_rec, tu_rec = nw["cu_rec"], nw["tu_rec"]
    TF = plan_host.TU_F
    for i in range(int(nw["counts"][1])):
        t = tu_rec[i]
        ci = int(t[TF["cu_idx"]])
        x, y, w, h = (int(t[TF[k]]) for k in ("bx0", "by0", "bw0", "bh0"))
        if not w or x < 4 or y < 4:
            continue
        cu = cu_rec[ci]
        if (x, y) != (cu[CU_F["x"]], cu[CU_F["y"]]):
            continue
        tl = cs.cu_map[(y - 1) >> 2, (x - 1) >> 2]
        if tl < 0 or tl >= ci:
            continue
        cover = set()
        for u in range(0, 2 * w, 4):
            if x + u < cs.w:
                cover.add(int(cs.cu_map[(y - 1) >> 2, (x + u) >> 2]))
        for u in range(0, 2 * h, 4):
            if y + u < cs.h:
                cover.add(int(cs.cu_map[(y + u) >> 2, (x - 1) >> 2]))
        cover.discard(-1)
        if tl in cover or ci in cover or not cover:
            continue
        for c in cover:
            cu_rec[c, CU_F["tile_idx"]] = 99
        return
    raise AssertionError("no TU with a corner-only layout to make")


MUTATIONS = {
    "ibc": lambda cs: _set_cu(cs, 3, "pred_mode", 2),
    "ciip_size": lambda cs: _set_cu(cs, 3, ("pred_mode", 0), ("ciip", 1),
                                    ("w", 128)),
    "isp": lambda cs: _set_cu(cs, 3, "isp", 1),
    "mrl": lambda cs: _set_cu(cs, 3, "multi_ref", 1),
    "bdpcm": lambda cs: _set_cu(cs, 3, "bdpcm_c", 1),
    "block_size": lambda cs: _set_tu(cs, _first_tu_with(cs, 0, 2)[0], "bw0",
                                     128),
    "chroma_mode": lambda cs: _set_cu(cs, _first_tu_with(cs, 1)[1],
                                      "intra_dir1", 75),
    "fill_corner_case": _corner_only,
}


def _set_cu(cs, idx, *pairs):
    from vvdec_tpu_torch.cabac.native_walk import CU_F
    if isinstance(pairs[0], str):
        pairs = (pairs,)
    for field, value in pairs:
        cs._nw["cu_rec"][idx, CU_F[field]] = value


def _set_tu(cs, idx, field, value):
    cs._nw["tu_rec"][idx, plan_host.TU_F[field]] = value


@pytest.mark.parametrize("reason", list(MUTATIONS))
def test_every_rejection_reason_in_parse_order(reason):
    """Every per-TU reason of the C builder, from one record changed in
    a parsed picture: both builders read the changed records and name
    the same first reason."""
    assert set(MUTATIONS) == set(plan_host.REASONS)
    cs = _parsed("tools:dual_tree")[0]
    MUTATIONS[reason](cs)
    assert _compare(cs)[0] == reason


def test_tu_record_layout_is_the_walks():
    """TU_FIELDS names the columns _materialize_tu reads, and CU_COLS
    are the walk's CU fields."""
    from vvdec_tpu_torch.cabac.native_walk import CU_F, _materialize_tu
    assert set(plan_host.CU_COLS) <= set(CU_F)
    rec = np.arange(1, len(plan_host.TU_FIELDS) + 1, dtype=np.int32)
    tu = _materialize_tu(None, {"tu_rec": rec[None]}, 0)
    F = {n: int(rec[i]) for i, n in enumerate(plan_host.TU_FIELDS)}
    assert tu.cu_idx == F["cu_idx"] and tu.part_idx == F["part_idx"]
    for c in range(3):
        assert tu.blocks[c] == tuple(F[f"b{k}{c}"] for k in "xywh")
        assert tu.cbf[c] and tu.mts_idx[c] == F[f"mts{c}"]
        assert tu.max_scan_x[c] == F[f"msx{c}"]
        assert tu.max_scan_y[c] == F[f"msy{c}"]
    assert tu.joint_cbcr == F["joint"] and tu.qp == F["qp"]
    assert tu.chroma_qp == [F["cqp0"], F["cqp1"]]


@pytest.mark.parametrize("case", ["tools:mip_cclm_ctu128",
                                  "tools:cclm_dual_tree_422",
                                  "tools:lmcs_chroma_scale_ctu32",
                                  "streams:inter-LDB tools",
                                  "tools:wpp"])
def test_c_builder_equals_the_reference_builder(case):
    """The JAX package's build_intra_descriptors on its own parse of the
    stream equals the port's C builder on the port's parse."""
    s = _stream(case)
    pairs = list(zip(parse_ref(s), parse_annexb(s)))
    assert pairs
    for f_ref, f_port in pairs:
        want, why_ref = build_ref(f_ref.cs)
        desc, why, _ = plan_host.build_rows(f_port.cs,
                                            _picture_gates(f_port.cs)[1])
        assert why == why_ref
        assert np.asarray(want).dtype == desc.dtype
        assert np.array_equal(np.asarray(want), desc)


def _counted(frames):
    """plan_intra_descriptors over the pictures with the span log on:
    (results, the log's plan counters)."""
    profiler.enabled = True
    try:
        out = [plan_intra_descriptors(cs) for cs in frames]
        counters = {k: v for k, v in profiler.counters.items()
                    if k.startswith("plan: ")}
    finally:
        profiler.enabled = False
    return out, counters


def test_counters_on_the_c_path():
    frames = _parsed("tools:cclm")
    out, counters = _counted(frames)
    assert counters == {"plan: TUs": sum(len(cs.tus) for cs in frames),
                        "plan: C pictures": len(frames)}
    for (desc, why, inter), cs in zip(out, frames):
        assert why is None and inter is False
        want, _ = build_intra_descriptors_py(cs)
        assert desc.tobytes() == want.tobytes()


def test_python_walk_takes_the_python_path(monkeypatch):
    monkeypatch.setenv("VVDEC_TPU_TORCH_PY_WALK", "1")
    frames = _parsed("tools:cclm")
    monkeypatch.delenv("VVDEC_TPU_TORCH_PY_WALK")
    assert all(getattr(cs, "_nw", None) is None for cs in frames)
    out, counters = _counted(frames)
    assert counters == {"plan: TUs": sum(len(cs.tus) for cs in frames),
                        "plan: Python pictures": len(frames)}
    native = _parsed("tools:cclm")
    for (desc, why, inter), cs in zip(out, native):
        assert why is None and inter is None
        assert desc.tobytes() == _compare(cs)[1].tobytes()


def test_no_library_takes_the_python_path(monkeypatch):
    monkeypatch.setattr(plan_host, "plan_function", lambda: None)
    frames = _parsed("tools:mip")
    out, counters = _counted(frames)
    assert counters["plan: Python pictures"] == len(frames)
    assert "plan: C pictures" not in counters
    for (desc, why, inter), cs in zip(out, _parsed("tools:mip")):
        want, _ = build_intra_descriptors_py(cs)
        assert inter is None and desc.tobytes() == want.tobytes()


def test_a_record_width_mismatch_falls_back(monkeypatch):
    """Records of another width than the layout the C builder is given
    are not read: a walk whose CU record grew a field plans in Python,
    and the C builder declines a record narrower than a column it
    reads."""
    frames = _parsed("tools:mip")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(plan_host, "CU_FIELDS", plan_host.CU_FIELDS + ("new",))
        assert all(plan_host.records_of(cs) is None for cs in frames)
        out, counters = _counted(frames)
    assert counters["plan: Python pictures"] == len(frames)
    for (desc, why, _), cs in zip(out, _parsed("tools:mip")):
        assert desc.tobytes() == _compare(cs)[1].tobytes()
    cs = _parsed("tools:mip")[0]
    cu_rec, tu_rec = plan_host.records_of(cs)
    narrow = np.ascontiguousarray(tu_rec[:, :plan_host.TU_F["joint"]])
    monkeypatch.setattr(plan_host, "records_of",
                        lambda cs: (cu_rec, narrow))
    assert plan_host.build_rows(cs, False) is None


def test_an_input_the_builder_does_not_model_goes_to_the_twin():
    """A TU naming a CU past the records: the C builder declines and the
    Python twin fails the same way as before."""
    cs = _parsed("tools:mip")[0]
    cs._nw["tu_rec"][5, plan_host.TU_F["cu_idx"]] = len(cs.cus)
    assert plan_host.build_rows(cs, False) is None
    with pytest.raises(IndexError):
        plan_intra_descriptors(cs)


def test_plan_native_pct_reads_the_counters():
    """decode_bench/metrics/plan_native_pct.py: the share of planned
    pictures the C builder took."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "plan_native_pct", os.path.join(BENCH, "metrics",
                                        "plan_native_pct.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Run:
        stage_pictures = 2

    _counted(_parsed("tools:mip"))
    assert mod.read(Run()) == 100.0
    with pytest.MonkeyPatch.context() as m:
        m.setattr(plan_host, "plan_function", lambda: None)
        _counted(_parsed("tools:mip"))
    assert mod.read(Run()) == 0.0
    Run.stage_pictures = 0
    assert mod.read(Run()) is None


def test_the_host_library_is_counted_apart_from_the_kernels():
    """The C builder's library is built and loaded by the kernels' route
    (build/kernels/, keyed by its source and flags) and counted under
    setup_counts' host_ keys, which kernel_setup_s does not read."""
    from vvdec_tpu_torch.ops.cuda import _build
    before = dict(_build.setup_counts)
    _build._loaded.pop("plan_host", None)
    assert plan_host.plan_function() is not None
    after = _build.setup_counts
    assert after["host_loads"] == before["host_loads"] + 1
    assert {k: after[k] for k in ("builds", "loads")} == \
        {k: before[k] for k in ("builds", "loads")}
    path = _build.library_path("plan_host")
    assert path.startswith(_build.BUILD_DIR) and os.path.exists(path)
