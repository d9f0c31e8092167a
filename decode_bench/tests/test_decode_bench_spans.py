"""The per-layer metrics that read the program's span log and counters,
from a traced run of a small cell on the CPU."""

import json

import pytest

import manifest
import run as runmod

NEW = ("unstaged_ms", "host_wait_ms", "gc_ms", "plan_us_per_unit",
       "kernel_setup_s")


def test_a_traced_cpu_run_reports_the_span_metrics(tmp_path):
    cell = manifest.load_cell("ai832_dense_q22")
    cell.config = dict(cell.config, width=128, height=64)
    cell.traffic = dict(cell.traffic, pictures_per_clip=2)
    res = runmod.run_cell(cell, 2 ** 31 + 11, 10.0, True, device="cpu",
                          cache=str(tmp_path), workers=1)
    json.dumps(res)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NEW:
        assert isinstance(got.get(name), float), name
        assert got[name] >= 0
    assert got["kernel_setup_s"] == 0       # nothing is built on the CPU
    assert got["plan_us_per_unit"] > 0 and got["unstaged_ms"] > 0
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    assert [units[n] for n in NEW] == ["ms", "ms", "ms", "us", "s"]
    # the log the readers read: the api spans' self time and their
    # children make up their inclusive time
    from vvdec_tpu_torch.utils.trace import profiler, self_times
    spans = profiler.spans()
    api = {i for i, sp in enumerate(spans) if sp.name.startswith("api: ")}
    own = self_times(spans)
    assert sum(own[i] for i in api) + sum(
        sp.t1 - sp.t0 for sp in spans if sp.parent in api) == pytest.approx(
        sum(spans[i].t1 - spans[i].t0 for i in api), abs=0)
