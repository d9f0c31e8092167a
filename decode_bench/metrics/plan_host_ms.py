"""plan_host_ms: the stage "plan (host)" (plan_frame_device and the intra
descriptors), ms a picture."""


def read(run):
    return run.stage_ms(("plan (host)",))
