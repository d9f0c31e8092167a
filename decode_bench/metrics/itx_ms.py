"""itx_ms: the stage "itx" (the residual's table and kernel), ms a picture."""


def read(run):
    return run.stage_ms(("itx",))
