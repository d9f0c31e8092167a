"""host_wait_ms: the program's "wait: *" spans (the host blocked on the
card: readback and DMVR events, uploads from pageable memory), ms a
picture.  Read from the stage profiler's span log of the traced window;
None where the program keeps no span log."""


def read(run):
    from vvdec_tpu_torch.utils import trace
    spans = getattr(trace.profiler, "spans", None)
    if spans is None or not run.stage_pictures:
        return None
    log = spans()
    if not log:
        return None
    waits = sum(sp.t1 - sp.t0 for sp in log
                if sp.name.startswith("wait: ") and sp.t1 is not None)
    return waits / run.stage_pictures / 1e6
