"""setup_s: process start to the window, less the making of the clips."""


def read(run):
    return run.setup_s
