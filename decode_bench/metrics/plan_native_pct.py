"""plan_native_pct: the share of the pictures the plan layer planned that
its C descriptor builder took (csrc/plan_host.c, from the syntax walk's
records), from the stage profiler's counters "plan: C pictures" and
"plan: Python pictures" of the traced window; None where the program
keeps neither counter."""


def read(run):
    from vvdec_tpu_torch.utils import trace
    counters = getattr(trace.profiler, "counters", None)
    if counters is None or not run.stage_pictures:
        return None
    native = counters.get("plan: C pictures", 0)
    python = counters.get("plan: Python pictures", 0)
    if not native + python:
        return None
    return 100.0 * native / (native + python)
