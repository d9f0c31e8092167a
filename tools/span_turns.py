#!/usr/bin/env python3
"""The stage profiler's cost and yardstick, and the collector, in turns of
one decode_bench cell's loop in one process.

    python3 tools/span_turns.py <cell> [--seed N] [--seconds S]
        [--turns onshvpc] [--device cuda|cpu] [--small] [--out FILE]

from the root of a checkout.  The cell's clips are made (and cached under
decode_bench/.cache/) and decoded once, as decode_bench/run.py sets a run
up: torch on one CPU thread, the decoding thread pinned to one core, what
set-up left behind frozen out of the collector's passes.  Then each letter
of `--turns` is one turn of the loop for `--seconds`:

  o  the span log off
  n  the span log on: device stages timed by CUDA events, no waits
  s  the span log on, with a synchronise at each device stage's end (the
     stage profiler's yardstick before the span log)
  h  the span log on, device stages timed on the host alone (no events,
     no waits)
  v  the stage profiler as it was before the span log: inclusive host
     seconds by stage name and a synchronise at each device stage's end,
     no span log
  p  one clip under torch.profiler, as decode_bench's traced window takes
     its first clip (window.profiled_clip), instead of a timed turn
  c  one full collection (gc.collect()), instead of a timed turn

Each turn prints one JSON line: frames/s, the collector's pauses (ms in
the turn, by generation, timed by a gc callback of this script in every
turn), the objects the collector tracks after the turn, and for `n`, `s`,
`h` and `v` the per-layer readings of decode_bench/metrics/ over the turn's
stage totals and span log (for `v`, those that read the totals only),
with the span log's report for `n`, `s` and `h`.
Then a summary: frames/s with the log off and on, and the api spans'
identity (self time plus direct children against inclusive time) over the
last logged turn.  `--small` cuts the cell to 128x64 and two pictures a
clip, for a check on the CPU.  Compare numbers only within one run.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "decode_bench")
sys.path[:0] = [BENCH, ROOT]

# the decode_bench readers that read the stage profiler
READERS = ("plan_host_ms", "motion_host_ms", "mc_ms", "intra_ms", "itx_ms",
           "filter_ms", "parse_ms", "readback_ms", "unstaged_ms",
           "host_wait_ms", "gc_ms", "plan_us_per_unit")


@contextlib.contextmanager
def _summed(name: str):
    """A stage of the stage profiler before the span log: its host time
    added to `totals`."""
    from vvdec_tpu_torch.utils.trace import profiler
    t0 = time.perf_counter()
    try:
        yield
    finally:
        profiler.totals[name] += time.perf_counter() - t0
        profiler.counts[name] += 1


class _Synced:
    """A device stage's context that waits for the device at its end."""

    def __init__(self, ctx, device):
        self._ctx, self._device = ctx, device

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize(self._device)
        return self._ctx.__exit__(*exc)


def readings(cell, clips, w, pictures, names=READERS) -> dict:
    import manifest
    import run as runmod
    from vvdec_tpu_torch.utils.trace import profiler
    run = runmod.Run(cell=cell, clips=clips, window=w,
                     stages=dict(profiler.totals), stage_pictures=pictures)
    out = {}
    for name in names:
        try:
            out[name] = manifest.load_reader(name)(run)
        except Exception as e:      # a reader this checkout lacks
            out[name] = repr(e)
    return out


def identity(spans) -> dict:
    from vvdec_tpu_torch.utils.trace import self_times
    own = self_times(spans)
    api = {i for i, sp in enumerate(spans) if sp.name.startswith("api: ")}
    incl = sum(spans[i].t1 - spans[i].t0 for i in api)
    mine = sum(own[i] for i in api)
    kids = sum(sp.t1 - sp.t0 for sp in spans if sp.parent in api)
    return {"api_inclusive_ms": incl / 1e6, "api_self_ms": mine / 1e6,
            "children_ms": kids / 1e6,
            "error_pct": 100 * (mine + kids - incl) / incl if incl else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--turns", default="onno")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    import clips as clipmod
    import manifest
    import run as runmod
    import window as winmod
    cell = manifest.load_cell(a.cell)
    if a.small:
        cell.config = dict(cell.config, width=128, height=64)
        cell.traffic = dict(cell.traffic, pictures_per_clip=2)
    runmod.keep_caches_in_checkout()
    clips = clipmod.make_clips(cell.config, cell.traffic, a.seed,
                               runmod.CACHE, runmod.ref_workers())
    import torch

    import vvdec_tpu_torch.api as api
    from vvdec_tpu_torch.utils.trace import profiler
    on_card = a.device == "cuda"
    torch.set_num_threads(1)
    runmod.pin_main_thread()
    for ci, c in enumerate(clips):
        winmod.decode_clip(api, c, ci, a.device, None, winmod.Window())
    if on_card:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=a.device).add_(1)
            torch.cuda.synchronize()
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()

    pauses: dict = {}           # generation -> [collections, ns]
    t_gc = [0]

    def timer(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter_ns()
        else:
            p = pauses.setdefault(info["generation"], [0, 0])
            p[0] += 1
            p[1] += time.perf_counter_ns() - t_gc[0]

    gc.callbacks.append(timer)
    turns, start, spans = [], 0, []
    for kind in a.turns:
        pauses.clear()
        tracked0 = len(gc.get_objects())
        if kind in "pc":
            w = winmod.Window()
            t = time.perf_counter()
            if kind == "p":
                winmod.profiled_clip(api, clips, start, a.device, w)
                start += 1
            else:
                gc.collect()
            w.seconds = time.perf_counter() - t
        else:
            if kind in "nshv":
                profiler.reset()
                if kind in "sv":
                    profiler.device_span = _Synced
                elif kind == "h":
                    profiler.device_span = lambda ctx, device: ctx
                if kind == "v":         # no span log: _start is skipped
                    profiler.stage = _summed
                    profiler._on = True
                else:
                    profiler.enabled = True
            try:
                w, start = winmod.run_loop(api, clips, a.device, a.seconds,
                                           start=start)
            finally:
                if kind == "v":
                    profiler._on = False
                elif kind in "nsh":
                    profiler.enabled = False
                for attr in ("device_span", "stage"):
                    profiler.__dict__.pop(attr, None)
        n = len(w.handed)
        turn = {"turn": kind, "fps": n / w.seconds, "pictures": n,
                "seconds": w.seconds,
                "gc_ms": {g: v[1] / 1e6 for g, v in sorted(pauses.items())},
                "gc_calls": {g: v[0] for g, v in sorted(pauses.items())},
                "tracked_before": tracked0,
                "tracked_after": len(gc.get_objects()),
                "tracked_gen2_after": len(gc.get_objects(2))}
        if kind in "nsh":
            turn["metrics"] = readings(cell, clips, w, n)
            turn["report"] = profiler.report()
            spans = profiler.spans()
        elif kind == "v":
            turn["metrics"] = readings(cell, clips, w, n, READERS[:8])
        profiler.reset()
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    gc.callbacks.remove(timer)

    def fps(kinds):
        v = [t["fps"] for t in turns if t["turn"] in kinds]
        return statistics.mean(v) if v else None

    off, on = fps("o"), fps("n")
    out = {"cell": a.cell, "seed": a.seed, "turns": turns,
           "fps_off_mean": off, "fps_on_mean": on,
           "cost_pct": 100 * (1 - on / off) if off and on else None,
           "identity": identity(spans) if spans else None,
           "report": profiler.report() if spans else None,
           "card": runmod.card_line() if on_card else a.device}
    print(json.dumps({k: v for k, v in out.items() if k != "turns"},
                     indent=1))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
