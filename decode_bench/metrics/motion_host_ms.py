"""motion_host_ms: the stage "motion (host)" (motion derivation and the
DPB's motion fields), ms a picture; none in a clip without inter pictures."""


def read(run):
    return run.stage_ms(("motion (host)",))
