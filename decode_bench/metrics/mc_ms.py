"""mc_ms: the MC stages ("mc: *") and "dmvr fixups", ms a picture."""


def read(run):
    return run.stage_ms(("dmvr fixups",), prefix="mc: ")
