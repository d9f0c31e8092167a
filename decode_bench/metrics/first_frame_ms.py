"""first_frame_ms: the mean, over every clip started in the window, of
the time from a new Decoder's first decode() to its first picture read."""


def read(run):
    t = run.window.first_frame_s
    return sum(t) / len(t) * 1e3 if t else None
