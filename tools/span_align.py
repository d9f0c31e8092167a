#!/usr/bin/env python3
"""The span log against a plain torch.profiler trace of one clip, on CUDA.

    python3 tools/span_align.py [cell] [--out FILE]

from the root of a checkout.  Decodes the first clip of a decode_bench
cell (default ai832_sao_alf_q32) once to warm up, then once with the span
log on under torch.profiler (no decode_bench annotation).  For each
"intra: kernel" span it prints whether the stage's record_function range
holds the launch of its intra_wavefront_kernel (by correlation id), and
the offsets, in us, of the span's event-derived device start and end from
the kernel's start and end in the trace, and of its host start and end
from the range's, after the span log's (perf_counter_ns, time_ns) anchor
places the span on the trace's unix-ns timeline.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "decode_bench"), ROOT]


def main():
    import clips as clipmod
    import manifest
    import window as winmod
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import vvdec_tpu_torch.api as api
    from vvdec_tpu_torch.utils.trace import profiler
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cell", nargs="?", default="ai832_sao_alf_q32")
    ap.add_argument("--out")
    a = ap.parse_args()
    name = a.cell
    cell = manifest.load_cell(name)
    cl = clipmod.make_clips(cell.config, cell.traffic, 2 ** 31 + 4242,
                            os.path.join(ROOT, "decode_bench", ".cache"),
                            6)[0]
    winmod.decode_clip(api, cl, 0, "cuda", None, winmod.Window())
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    profiler.enabled = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        winmod.decode_clip(api, cl, 0, "cuda", None, winmod.Window())
        torch.cuda.synchronize()
    profiler.enabled = False
    kev = prof.profiler.kineto_results.events()
    rf = sorted([(e.start_ns(), e.end_ns()) for e in kev
                 if e.name() == "intra: kernel"
                 and e.device_type() == DeviceType.CPU])
    kern = sorted([e for e in kev if e.device_type() == DeviceType.CUDA
                   and "intra_wavefront_kernel" in e.name()],
                  key=lambda e: e.start_ns())
    runtime = {e.correlation_id(): e for e in kev
               if e.device_type() == DeviceType.CPU
               and e.name().startswith("cuda")}
    spans = [sp for sp in profiler.spans() if sp.name == "intra: kernel"]
    p0, u0 = profiler.anchor

    def unix(ns):
        return u0 + (ns - p0)

    rows = []
    for (r0, r1), k, sp in zip(rf, kern, spans):
        ln = runtime.get(k.correlation_id())
        rows.append(dict(
            launch=None if ln is None else ln.name(),
            launch_in_range=ln is not None and r0 <= ln.start_ns()
            and ln.end_ns() <= r1,
            dev_end_minus_kernel_end_us=(unix(sp.dev1) - k.end_ns()) / 1e3,
            dev_start_minus_kernel_start_us=(unix(sp.dev0)
                                             - k.start_ns()) / 1e3,
            host_start_minus_range_start_us=(unix(sp.t0) - r0) / 1e3,
            host_end_minus_range_end_us=(unix(sp.t1) - r1) / 1e3,
            kernel_us=(k.end_ns() - k.start_ns()) / 1e3))
    out = {"cell": name, "ranges": len(rf), "kernels": len(kern),
           "spans": len(spans), "pictures": len(cl.aus), "rows": rows,
           "torch": torch.__version__}
    for key in ("dev_end_minus_kernel_end_us",
                "host_start_minus_range_start_us"):
        vals = [abs(r[key]) for r in rows]
        out["max_abs_" + key] = max(vals) if vals else None
    print(json.dumps(out, indent=1))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
