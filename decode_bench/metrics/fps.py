"""fps: pictures handed out and read in the window, over its length."""


def read(run):
    w = run.window
    return len(w.handed) / w.seconds if w.handed and w.seconds > 0 else None
