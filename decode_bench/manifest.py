"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration, whose `file`
holds its sizes, and a traffic mix, read from traffic/<mix>.json.  A
metric is computed by metrics/<name>.py's `read(run)`; the metrics of a
run are the manifest's `end_to_end` ones (`--trace 0`) or `per_layer`
ones (`--trace 1`) that list the cell under `workloads`, or that have no
such list.  Adding a configuration, a mix or a metric adds files and
manifest entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    """One cell of the manifest, with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, manifest: dict | None = None
              ) -> Cell:
    m = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[x for x in m["end_to_end"] if _applies(x, name)],
                per_layer=[x for x in m["per_layer"] if _applies(x, name)])


def load_reader(metric: str):
    """metrics/<metric>.py's `read(run) -> float | None`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "decode_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
