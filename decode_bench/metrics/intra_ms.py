"""intra_ms: the stage "intra" (the intra scan with its host planning and
its kernel; synchronised at its end), ms a picture."""


def read(run):
    return run.stage_ms(("intra",))
