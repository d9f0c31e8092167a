"""kernel_setup_s: seconds the process spent building (nvcc) and loading
(ctypes) the program's hand-written kernels, from the counters of
vvdec_tpu_torch.ops.cuda._build; 0 where nothing was built or loaded,
None for a run without clips or a program without such counters."""


def read(run):
    if not run.clips:
        return None
    try:
        from vvdec_tpu_torch.ops.cuda import _build
    except ImportError:
        return None
    counts = getattr(_build, "setup_counts", None)
    if counts is None:
        return None
    return counts["build_s"] + counts["load_s"]
