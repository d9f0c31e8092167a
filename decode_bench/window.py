"""The measured window: one client decoding the cell's clips in a loop.

The client is a player or a transcoder in a closed loop, as fast as the
decoder goes.  For each clip it opens a new `api.Decoder` on the card,
feeds the clip one access unit at a time with `decode(au)`, calls
`flush()`, reads every handed-out picture's planes on the host and calls
`frame_unref`.  The read is a copy the first time a clip's picture comes
out in a window, and after that a sample-by-sample comparison with that
copy; a picture that differs from it is copied too.  So every picture
handed out is judged after the window, and the window's host memory
stays at one copy of each distinct picture instead of growing with every
picture read.
The clips are taken in turn, over and over.  Once the window's time is
up the client feeds no further access unit: it flushes the clip it is
in, reads what comes out, and the window ends there.

Each picture's latency runs from the `decode()` call of its access unit
to its planes being copied; it includes the picture the decoder holds
until the next one begins.  A clip's first-frame delay runs from its
first `decode()` to its first picture copied.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Handed:
    """One picture handed out and read."""

    clip: int
    poc: int
    planes: list        # the window's copy of this clip's picture, or
    latency_s: float    # a copy of its own where it differed from that


@dataclass
class Window:
    """What a window (or a part of one) decoded, and how fast."""

    seconds: float = 0.0
    handed: list = field(default_factory=list)
    fed: list = field(default_factory=list)        # (clip, access units)
    first_frame_s: list = field(default_factory=list)
    census: Counter = field(default_factory=Counter)
    clip_s: list = field(default_factory=list)     # each clip decode's
    kept: dict = field(default_factory=dict)  # (clip, poc) -> first copy

    @property
    def attempted(self) -> int:
        return sum(k for _, k in self.fed)


def decode_clip(api, clip, ci: int, device, deadline, w: Window) -> None:
    """Decode `clip` (index ci) with a new Decoder into `w`, feeding no
    access unit after `deadline` (None: the whole clip)."""
    t0 = time.perf_counter()
    dec = api.Decoder(api.DecoderParams(device=device, threads=0))
    t_call: dict = {}
    first = []

    def take(frames):
        for f in frames:
            planes = w.kept.get((ci, f.poc))
            if planes is None or len(planes) != len(f.planes) or not all(
                    np.array_equal(a, p) for a, p in zip(planes, f.planes)):
                planes = [np.array(p, dtype=np.uint16) for p in f.planes]
                w.kept.setdefault((ci, f.poc), planes)
            t = time.perf_counter()
            dec.frame_unref(f)
            w.handed.append(Handed(ci, f.poc, planes, t - t_call[f.poc]))
            if not first:
                first.append(t - t_call[clip.pocs[0]])

    fed = 0
    for au, poc in zip(clip.aus, clip.pocs):
        t_call[poc] = time.perf_counter()
        take(dec.decode(au))
        fed += 1
        if deadline is not None and time.perf_counter() >= deadline:
            break
    take(dec.flush())
    w.fed.append((ci, fed))
    w.first_frame_s += first
    w.census.update(dec.get_fallback_census())
    dec.close()
    w.clip_s.append(time.perf_counter() - t0)


def run_loop(api, clips, device, seconds: float, start: int = 0,
             w: Window | None = None) -> tuple[Window, int]:
    """Clips from index `start` on, in turn, for `seconds`; returns the
    window and the index of the next clip."""
    w = w if w is not None else Window()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = start
    while time.perf_counter() < deadline:
        decode_clip(api, clips[i % len(clips)], i % len(clips), device,
                    deadline, w)
        i += 1
    w.seconds += time.perf_counter() - t0
    return w, i


def launch_counts() -> dict:
    """{kind: launches so far} of the hand-written kernels' wrappers."""
    import importlib

    from work import KERNELS
    out = {}
    for kind, (_, (module, names)) in KERNELS.items():
        mod = importlib.import_module("vvdec_tpu_torch." + module)
        out[kind] = sum(getattr(mod, n).launches for n in names)
    return out


def profiled_clip(api, clips, i: int, device, w: Window):
    """Clip i (mod the count) decoded under torch.profiler into `w`, the
    stage profiler off; returns its devtrace.DeviceTrace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from devtrace import CLIP_SPAN, annotated_stages, read_trace
    from vvdec_tpu_torch.utils.trace import profiler as stage_profiler
    from work import KERNELS
    ci = i % len(clips)
    before = launch_counts()
    n0 = len(w.handed)
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with annotated_stages(stage_profiler):
        with profile(activities=activities) as prof:
            with record_function(CLIP_SPAN):
                decode_clip(api, clips[ci], ci, device, None, w)
            if on_card:
                torch.cuda.synchronize()
    w.seconds += time.perf_counter() - t0
    after = launch_counts()
    tr = read_trace(prof, {k: v[0] for k, v in KERNELS.items()})
    tr.launches = {k: after[k] - before[k] for k in after}
    tr.pictures = [(h.clip, h.poc) for h in w.handed[n0:]]
    return tr


def traced_window(api, clips, device, seconds: float, tries: int = 3):
    """The traced run's window: a clip under torch.profiler (the next
    one again, up to `tries` clips, while the trace misses launches the
    wrappers counted), then the rest of the window with the stage
    profiler on.  Returns (window, trace, stage seconds, pictures the
    stage profiler saw)."""
    from vvdec_tpu_torch.utils.trace import profiler as stage_profiler
    t0 = time.perf_counter()
    w = Window()
    i = 0
    tr = None
    while i < tries and (tr is None or not tr.whole):
        tr = profiled_clip(api, clips, i, device, w)
        i += 1
    rest = seconds - (time.perf_counter() - t0)
    n0 = len(w.handed)
    stage_profiler.reset()
    stage_profiler.enabled = True
    try:
        if rest > 0:
            run_loop(api, clips, device, rest, start=i, w=w)
    finally:
        stage_profiler.enabled = False
    stages = dict(stage_profiler.totals)
    stage_profiler.reset()
    return w, tr, stages, len(w.handed) - n0
