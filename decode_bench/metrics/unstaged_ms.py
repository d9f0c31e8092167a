"""unstaged_ms: the self time of the program's "api: *" spans (its
api.Decoder open, decode, flush, frame_unref and close), ms a picture:
host time inside the decoder that no stage of it owns.  Read from the
stage profiler's span log of the traced window; None where the program
keeps no span log."""


def read(run):
    from vvdec_tpu_torch.utils import trace
    spans = getattr(trace.profiler, "spans", None)
    self_times = getattr(trace, "self_times", None)
    if spans is None or self_times is None or not run.stage_pictures:
        return None
    log = spans()
    own = [s for sp, s in zip(log, self_times(log))
           if sp.name.startswith("api: ")]
    if not own:
        return None
    return sum(own) / run.stage_pictures / 1e6
