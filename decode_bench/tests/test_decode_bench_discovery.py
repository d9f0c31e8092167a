"""The harness finds configurations, mixes, builders and metrics by name,
so a new one is new files and new BENCHMARK.json entries."""

import json
import os
import re

import pytest

import clips as clipmod
import manifest
import run as runmod
import window as winmod

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["decode_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in M["end_to_end"]} == {
        "fps", "frame_p95_ms", "first_frame_ms", "peak_mem_mib", "setup_s"}
    for m in M["per_layer"]:
        assert m["moves"] == "fps" and m["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_loads(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    assert os.path.exists(os.path.join(BENCH, "gen",
                                       c.traffic["kind"] + ".py"))
    b = clipmod.load_builder(c.traffic["kind"])
    assert all(callable(getattr(b, f)) for f in ("pocs", "headers",
                                                  "picture"))
    assert {"width", "height", "ctu", "bit_depth"} <= set(c.config)
    cfg = next(x for x in M["configs"]
               if x["name"] == next(w["config"] for w in M["workloads"]
                                    if w["name"] == cell))
    with open(os.path.join(ROOT, cfg["file"])) as f:
        assert json.load(f)["reduced"] == cfg["reduced"]
    assert c.end_to_end and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end",
                                                         "per_layer")
                                    for m in M[k]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = manifest.load_reader(metric)
    empty = runmod.Run(cell=None, clips=[], window=winmod.Window())
    assert read(empty) is None or metric == "setup_s"


def test_a_new_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A manifest with a new cell, mix and metric: only new files."""
    m = json.loads(json.dumps(M))
    m["workloads"].append(dict(m["workloads"][0], name="new_cell"))
    m["per_layer"].append(dict(m["per_layer"][0], name="new_metric",
                               workloads=["new_cell"]))
    cell = manifest.load_cell("new_cell", root=ROOT, manifest=m)
    assert [x["name"] for x in cell.per_layer][-1] == "new_metric"
    assert "new_metric" not in [x["name"] for x in manifest.load_cell(
        m["workloads"][0]["name"], root=ROOT, manifest=m).per_layer]


def test_clip_seeds_are_fixed_by_the_run_seed():
    big = 2 ** 31 + 977
    assert clipmod.clip_seeds(big, 3) == clipmod.clip_seeds(big, 3)
    assert clipmod.clip_seeds(big, 3) != clipmod.clip_seeds(big + 1, 3)
    assert all(1 <= s < 10 ** 6 for s in clipmod.clip_seeds(big, 5))


def test_clips_are_cached_and_cut_into_access_units(tmp_path):
    config = dict(width=128, height=64, ctu=64, bit_depth=10)
    traffic = dict(kind="intra", clips=2, pictures_per_clip=2, qp=32,
                   decisions=dict(split_prob=0.35, density=0.1))
    a = clipmod.make_clips(config, traffic, 5, str(tmp_path), workers=2)
    b = clipmod.make_clips(config, traffic, 5, str(tmp_path))
    assert [c.stream for c in a] == [
        clipmod.build_clip("intra", config, traffic, c.seed)[0] for c in a]
    assert [c.stream for c in a] == [c.stream for c in b]
    assert len(os.listdir(tmp_path / "clips")) == 4
    for c in a:
        assert len(c.aus) == 2 and b"".join(c.aus) == c.stream


def test_pool_keeps_order_and_ends_its_workers():
    import pool
    assert pool.run_pool(("math", "sqrt"), [4, 9, 16, 25, 36], 2) == \
        [2, 3, 4, 5, 6]
    assert pool.run_pool(("math", "sqrt"), [49], 4) == [7]
    children = f"/proc/{os.getpid()}/task/{os.getpid()}/children"
    if os.path.exists(children):
        with open(children) as f:
            assert f.read().strip() == ""
