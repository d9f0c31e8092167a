"""A run's result line, and `correct` against a broken timed path.

The runs here skip the harness's look for a card and drive the rest of a
run on the CPU (the port's CPU path, the reference, the comparison) at a
small picture size; the faults are planted in the port's public surface
underneath the harness.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import control
import manifest
import reference as refmod
import run as runmod

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small(cell: str, pictures: int = 2):
    c = manifest.load_cell(cell)
    c.config = dict(c.config, width=128, height=64)
    c.traffic = dict(c.traffic, pictures_per_clip=pictures)
    return c


def run_small(cell: str, tmp_path, trace: bool = False, seconds=2.0,
              pictures: int = 2) -> dict:
    res = runmod.run_cell(small(cell, pictures), 2 ** 31 + 7, seconds,
                          trace, device="cpu", cache=str(tmp_path),
                          workers=1)
    json.dumps(res)
    return res


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(tmp_path, trace):
    res = run_small("ai832_dense_q22", tmp_path, trace=trace, seconds=3.0)
    want = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 2
    cell = manifest.load_cell("ai832_dense_q22")
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    if not trace:
        assert {"fps", "frame_p95_ms", "first_frame_ms", "setup_s"} <= \
            set(res["metrics"])
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["compared"] == {k: {"value": 0, "limit": lim}
                               for k, lim in refmod.LIMITS.items()}


def _patch_frames(monkeypatch, change):
    """api.Decoder hands out change(decoder, frames) in place of each
    list of frames that decode() or flush() returns."""
    from vvdec_tpu_torch import api
    decode, flush = api.Decoder.decode, api.Decoder.flush
    monkeypatch.setattr(api.Decoder, "decode",
                        lambda self, au: change(self, decode(self, au)))
    monkeypatch.setattr(api.Decoder, "flush",
                        lambda self: change(self, flush(self)))


def altered(dec, frames):
    for f in frames:
        f.planes = [p.copy() for p in f.planes]
        f.planes[1][3, 5] ^= 1
    return frames


def unchanged(dec, frames):
    for f in frames:
        prev = getattr(dec, "_prev_planes", None)
        dec._prev_planes = [p.copy() for p in f.planes]
        if prev is not None:
            f.planes = prev
    return frames


def half_left_out(dec, frames):
    kept = []
    for f in frames:
        dec._n = getattr(dec, "_n", 0) + 1
        if dec._n % 2:
            kept.append(f)
        else:
            dec.frame_unref(f)
    return kept


@pytest.mark.parametrize("fault,cell", [
    (altered, "ai832_dense_q22"),
    (unchanged, "ai832_sao_alf_q32"),
    (half_left_out, "ldp1080_mv32_q32"),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            cell):
    _patch_frames(monkeypatch, fault)
    res = run_small(cell, tmp_path, pictures=3)
    assert res["correct"] is False and res["failed"] > 0


def test_a_fault_after_the_first_cycle_is_not_correct(tmp_path,
                                                      monkeypatch):
    """A sample altered only from the second time a clip's pictures come
    out in the window (the first copy of each is sound): the window's
    comparison with its first copy catches it."""
    cell = small("ai832_dense_q22", 3)
    first = 2 * cell.traffic["clips"] * 3    # the warm-up and one cycle
    count = [0]

    def later(dec, frames):
        for f in frames:
            count[0] += 1
            if count[0] > first:
                f.planes = [p.copy() for p in f.planes]
                f.planes[0][2, 7] ^= 4
        return frames

    _patch_frames(monkeypatch, later)
    res = runmod.run_cell(cell, 2 ** 31 + 7, 4.0, False, device="cpu",
                          cache=str(tmp_path), workers=1)
    assert count[0] > first + 1, "the window decoded no second cycle"
    assert res["correct"] is False
    assert res["compared"]["max_abs_diff"]["value"] == 4
    assert 0 < res["failed"] <= count[0] - first


def test_the_control_is_not_correct(tmp_path):
    numbers = control.control_numbers(small("ai832_sao_alf_q32"), 11,
                                      str(tmp_path), 1)
    assert not refmod.is_correct(numbers)
    assert numbers["pictures_missing"] == 0
    assert numbers["max_abs_diff"] >= 1


def test_compare_counts_missing_and_extra():
    clips = [type("C", (), {"pocs": [0, 1, 2]})()]
    refs = [refmod.RefClip(md5={0: "a", 1: "b", 2: "c"})]
    assert refmod.compare([], [(0, 2)], clips, refs)["pictures_missing"] == 2


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = runmod.main(["--workload", "ai832_dense_q22", "--seed", "1",
                      "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with BENCHMARK.json and decode_bench/ but not the
    program exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "decode_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = subprocess.run([sys.executable, "decode_bench/run.py",
                        "--workload", "ai832_dense_q22", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "decode_bench/run.py",
                        "--workload", "ai832_dense_q22", "--seed",
                        "2147483659", "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
