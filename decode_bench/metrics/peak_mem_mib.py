"""peak_mem_mib: torch.cuda.max_memory_allocated over the window, whose
start reset the peak."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
