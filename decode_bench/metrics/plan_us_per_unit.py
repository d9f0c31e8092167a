"""plan_us_per_unit: the "plan (host)" spans' time over the TUs the
intra descriptor builder walked (the profiler's counter "plan: TUs"),
us a TU.  Read from the stage profiler's span log and counters of the
traced window; None where the program keeps neither."""


def read(run):
    from vvdec_tpu_torch.utils import trace
    spans = getattr(trace.profiler, "spans", None)
    counters = getattr(trace.profiler, "counters", None)
    if spans is None or counters is None or not run.stage_pictures:
        return None
    units = counters.get("plan: TUs", 0)
    if not units:
        return None
    plan = sum(sp.t1 - sp.t0 for sp in spans()
               if sp.name == "plan (host)" and sp.t1 is not None)
    return plan / units / 1e3
