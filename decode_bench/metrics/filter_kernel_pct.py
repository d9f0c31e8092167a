"""filter_kernel_pct: the share of the pictures whose SAO, ALF and CC-ALF
the filter layer ran that went through its hand-written kernels
(csrc/sao_alf.cu), from the stage profiler's counters "filter: SAO/ALF
kernel pictures" and "filter: SAO/ALF plain pictures" of the traced
window; None where the program keeps neither counter."""


def read(run):
    from vvdec_tpu_torch.utils import trace
    counters = getattr(trace.profiler, "counters", None)
    if counters is None or not run.stage_pictures:
        return None
    kernel = counters.get("filter: SAO/ALF kernel pictures", 0)
    plain = counters.get("filter: SAO/ALF plain pictures", 0)
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
