"""readback_ms: the stage "readback" (the wait for the packed planes and
their unpacking on the host), ms a picture."""


def read(run):
    return run.stage_ms(("readback",))
