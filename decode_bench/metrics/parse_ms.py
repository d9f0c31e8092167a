"""parse_ms: the stage "parse" (NAL, slice headers, CABAC), ms a picture."""


def read(run):
    return run.stage_ms(("parse",))
