"""gc_ms: the program's "gc" spans (the collector's pauses) inside its
other spans, ms a picture.  Read from the stage profiler's span log of
the traced window; None where the program keeps no span log."""


def read(run):
    from vvdec_tpu_torch.utils import trace
    spans = getattr(trace.profiler, "spans", None)
    if spans is None or not run.stage_pictures:
        return None
    log = spans()
    if not log:
        return None
    pauses = sum(sp.t1 - sp.t0 for sp in log
                 if sp.name == "gc" and sp.parent >= 0)
    return pauses / run.stage_pictures / 1e6
