#!/usr/bin/env python3
"""One run of one cell of the decode benchmark of vvdec_tpu_torch.

    python3 decode_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration and a traffic mix; the run:

1. makes the cell's clips from the seed (clips.py; outside the set-up
   time, printed apart);
2. sets the decoder up: imports the port, opens the card, builds or
   loads its kernels (build/kernels/ in the checkout) and decodes every
   clip once, so that nothing is built or first used in the window;
   `setup_s` runs from the process's start to the window, less step 1;
3. measures for `--seconds` (window.py): one client decodes the clips
   in turn through `vvdec_tpu_torch.api.Decoder` on the card.  With
   `--trace 1` a first clip is decoded under torch.profiler and the
   rest of the window with the program's stage profiler on;
4. frees the program's state, decodes every clip with the plain
   reference (reference.py, refdec) and compares every sample of every
   picture handed out in the window;
5. prints the compared numbers beside their limits as the last lines of
   standard error, and the result as the last line of standard output:
   the cell's end-to-end metrics (`--trace 0`) or its per-layer ones
   (`--trace 1`), each read by metrics/<name>.py.

It exits non-zero and prints no result when there is no CUDA card, when
the program cannot be imported, or when jax, jaxlib, flax or the JAX
package vvdec_tpu is loaded once the window has closed.  Clips and the
reference's per-picture digests are cached under decode_bench/.cache/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the harness's modules first, then the program's package
sys.path[:] = [HERE, ROOT] + [p for p in sys.path
                              if os.path.abspath(p or ".") not in (HERE, ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "vvdec_tpu")
CACHE = os.path.join(HERE, ".cache")


def log(text: str) -> None:
    print(f"[decode_bench] {text}", file=sys.stderr, flush=True)


@dataclass
class Run:
    """What the metric readers see of one run."""

    cell: object
    clips: list
    window: object
    refs: list = field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0
    trace: object = None            # devtrace.DeviceTrace (--trace 1)
    stages: dict = field(default_factory=dict)   # stage -> seconds
    stage_pictures: int = 0

    def stage_ms(self, names=(), prefix: str | None = None):
        """ms a picture of the stage profiler's stages `names` and those
        whose name starts with `prefix`, summed; None when the stage
        profiler saw no picture or none of these stages."""
        hit = [s for k, s in self.stages.items()
               if k in names or (prefix is not None and k.startswith(prefix))]
        if not self.stage_pictures or not hit:
            return None
        return sum(hit) / self.stage_pictures * 1e3

    def traced_work(self) -> list:
        """work.picture_work of every picture of the profiled clips."""
        return [self.refs[ci].work[poc] for ci, poc in self.trace.pictures
                if poc in self.refs[ci].work]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "?"
    except (OSError, subprocess.SubprocessError):
        return "? (nvidia-smi did not answer)"


def host_clocks(since: dict | None = None) -> dict:
    """Wall and process CPU seconds, or their growth `since` an earlier
    reading: a decode that is bound by one host thread uses about one
    CPU second a second."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    now = {"wall_s": time.perf_counter(), "process_user_s": r.ru_utime,
           "process_system_s": r.ru_stime}
    if since is None:
        return now
    return {k: v - since[k] for k, v in now.items()}


def ref_workers() -> int:
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:
        cores = os.cpu_count() or 1
    return max(1, min(6, cores - 2))


def pin_main_thread() -> set | None:
    """Keep the calling thread, which runs the decode's host work, on the
    last core it may use, so that it is not moved between cores in the
    window; returns its former cores, or None where they cannot be set."""
    try:
        cores = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {max(cores)})
        return cores
    except (AttributeError, OSError):
        return None


def keep_caches_in_checkout() -> None:
    """Kernel and build caches of torch, Triton and CUDA at fixed paths in
    the checkout (the port builds its own kernels into build/kernels/)."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cache: str | None = CACHE,
             workers: int | None = None, t_start: float = T_START) -> dict:
    """One run of `cell` (manifest.Cell); returns the result object.
    `device` other than "cuda" (the CPU, in tests) skips what reads the
    card: memory, the profiler."""
    import clips as clipmod
    import reference as refmod
    import window as winmod
    workers = workers or ref_workers()

    t = time.perf_counter()
    clips = clipmod.make_clips(cell.config, cell.traffic, seed, cache,
                               workers)
    clips_s = time.perf_counter() - t
    log(f"{cell.name}: {len(clips)} clips of {len(clips[0].aus)} pictures "
        f"({cell.traffic['kind']}, clip seeds "
        f"{[c.seed for c in clips]}, {sum(len(c.stream) for c in clips)} "
        f"bytes) made or read in {clips_s:.3f} s (not set-up)")

    marks = [("imports", time.perf_counter())]
    import torch
    on_card = device == "cuda"
    import vvdec_tpu_torch.api as api
    marks.append(("import torch and the port", time.perf_counter()))
    # one client, one host thread: torch's CPU ops on one thread, the
    # decoding thread on one core, from the warm-up to the window's end
    torch.set_num_threads(1)
    cores = pin_main_thread()
    if on_card:
        torch.ones(1, device=device)
        torch.cuda.synchronize()
        marks.append(("CUDA context", time.perf_counter()))
    for ci, clip in enumerate(clips):       # warm-up: every clip once
        winmod.decode_clip(api, clip, ci, device, None, winmod.Window())
        marks.append((f"warm-up clip {ci}", time.perf_counter()))
    if on_card and trace:
        # the profiler's first start loads CUPTI: not in the window
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
    set_up_peak = 0
    if on_card:
        torch.cuda.synchronize()
        set_up_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start - clips_s
    log(f"decoding thread on core {'any' if cores is None else max(cores)}"
        f" of {'?' if cores is None else len(cores)}, torch CPU threads "
        f"{torch.get_num_threads()}")
    log(f"set-up {setup_s:.3f} s: process start and imports "
        f"{marks[0][1] - t_start - clips_s:.3f} s, " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])))

    run = Run(cell=cell, clips=clips, window=None, setup_s=setup_s)
    # what set-up left behind stays out of the collector's full passes
    gc.collect()
    gc.freeze()
    host0 = host_clocks()
    launches0 = winmod.launch_counts()
    if trace:
        run.window, run.trace, run.stages, run.stage_pictures = \
            winmod.traced_window(api, clips, device, seconds)
    else:
        run.window, _ = winmod.run_loop(api, clips, device, seconds)
    launches = {k: v - launches0[k] for k, v in
                winmod.launch_counts().items()}
    if cores is not None:
        os.sched_setaffinity(0, cores)   # the reference's pool: every core
    if on_card:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    w = run.window
    log("host over the window: " + ", ".join(
        f"{k} {v:.3f}" for k, v in host_clocks(host0).items()))
    log(f"window {w.seconds:.3f} s: {len(w.handed)} pictures of "
        f"{len(w.fed)} clip decodes; kernel launches {launches}; "
        f"fallback census {dict(w.census)}; seconds a clip "
        f"{[round(t, 3) for t in w.clip_s]}")
    if run.trace is not None:
        tr = run.trace
        log(f"trace: {len(tr.pictures)} pictures, busy {tr.busy_s:.6f} s "
            f"of {tr.window_s:.6f} s; kernel events {tr.kernel_events} for "
            f"launches {tr.launches} (whole: {tr.whole}); stage profiler "
            f"over {run.stage_pictures} pictures")

    # the program's state goes before the reference runs
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.refs = refmod.reference(clips, cache, workers)
    numbers = refmod.compare([(h.clip, h.poc, h.planes) for h in w.handed],
                             w.fed, clips, run.refs, workers)
    log(f"reference and comparison {time.perf_counter() - t:.3f} s "
        f"({workers} workers)")
    correct = refmod.is_correct(numbers)

    import manifest
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else device,
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else device),
                   "count": cell.chips,
                   "memory_peak_bytes": max(set_up_peak, run.peak_bytes)}
    result = {"correct": correct, "attempted": w.attempted,
              "failed": numbers["pictures_missing"]
              + numbers["pictures_differing"],
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["compared"] = {k: {"value": v, "limit": refmod.LIMITS[k]}
                          for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import manifest
        cell = manifest.load_cell(args.workload)
        keep_caches_in_checkout()
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            log(f"no result: {cell.name} needs {cell.chips} CUDA card(s); "
                f"torch sees {torch.cuda.device_count()}")
            return 2
        import vvdec_tpu_torch.api  # noqa: F401  (the program, or no run)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
        log(f"card: {card_line()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    except Exception:
        traceback.print_exc()
        log("no result: the run failed")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process loaded {bad}")
        return 3
    for k, v in result["compared"].items():
        print(f"compare {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
