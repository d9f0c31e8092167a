"""filter_ms: the filter chain: "deblock strengths (host)", "sao/alf
parameters (host)" and the "filter: *" stages, ms a picture."""


def read(run):
    return run.stage_ms(("deblock strengths (host)",
                         "sao/alf parameters (host)"), prefix="filter: ")
