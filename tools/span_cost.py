#!/usr/bin/env python3
"""Host cost of one empty stage, and of one empty device stage
(device_pipeline.timed_stage), with the span log off and on, on CUDA.

    python3 tools/span_cost.py

from the root of a checkout; prints ns a stage over 20000 stages each,
and the ns of turning the log off.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    from vvdec_tpu_torch.ops.device_pipeline import timed_stage
    from vvdec_tpu_torch.utils.trace import profiler
    dev = torch.device("cuda")
    x = torch.ones(1, device=dev)
    n = 20000
    out = {}
    for on in (False, True):
        profiler.enabled = on
        for label, ctx in (("stage", lambda: profiler.stage("x")),
                           ("timed_stage", lambda: timed_stage("x", dev))):
            t = time.perf_counter_ns()
            for _ in range(n):
                with ctx():
                    pass
            out[f"{label} {'on' if on else 'off'} ns"] = \
                (time.perf_counter_ns() - t) / n
        t = time.perf_counter_ns()
        profiler.enabled = False
        out[f"turn off ns ({'on' if on else 'off'})"] = \
            time.perf_counter_ns() - t
        x.add_(1)
    print(out, flush=True)


if __name__ == "__main__":
    main()
