"""The device trace of one clip's decode, and what is read from it.

torch.profiler traces the card's kernels and copies (CUPTI) and, on the
host, the spans this module adds around the program's own stages: while
a clip is profiled, the stage profiler of vvdec_tpu_torch.utils.trace
stays off (its stages would wait for the device at their ends) and each
of its stages opens a `record_function` span named "stage: <name>"
instead, so the card's idle time can be put down to the stages the
host was in meanwhile.  The clip itself is one span, "decode_bench: clip", whose
length is the traced window.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

CLIP_SPAN = "decode_bench: clip"
STAGE_PREFIX = "stage: "
OUTSIDE = "(no stage)"


@dataclass
class DeviceTrace:
    """What one profiled clip's trace holds."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)      # kind -> seconds
    kernel_events: dict = field(default_factory=dict)  # kind -> events
    launches: dict = field(default_factory=dict)      # kind -> counted
    device_ops: list = field(default_factory=list)    # [[name, s]] top 10
    idle_gaps: list = field(default_factory=list)     # [[stage, s]] top 10
    # (the card's idle time by the innermost host stage it fell in)
    pictures: list = field(default_factory=list)      # (clip, poc) traced

    @property
    def whole(self) -> bool:
        """Every launch the wrappers counted is in the trace."""
        return all(self.kernel_events.get(k, 0) >= n
                   for k, n in self.launches.items())


def busy_in(spans, a: float, b: float) -> float:
    """The union of the device intervals `spans` (sorted (start, end,
    name)) clipped to [a, b]."""
    busy = 0.0
    end = a
    for s0, s1, _ in spans:
        s0, s1 = max(s0, end), min(s1, b)
        if s1 > s0:
            busy += s1 - s0
            end = s1
    return busy


def idle_gaps(spans, a: float, b: float) -> list:
    """[(start, end)] of the stretches of [a, b] with no device span."""
    gaps = []
    end = a
    for s0, s1, _ in spans:
        if s0 > end and s0 > a:
            gaps.append((end, min(s0, b)))
        end = max(end, s1)
        if end >= b:
            break
    if end < b:
        gaps.append((end, b))
    return [(g0, g1) for g0, g1 in gaps if g1 > g0]


def innermost(stages, a: float, b: float) -> list:
    """[(start, end, name)] covering [a, b]: at each time the innermost
    of the stage spans (start, end, name) that hold it, OUTSIDE where
    none does; spans nest as one thread's do."""
    segs, stack, cur = [], [], a

    def emit(upto):
        nonlocal cur
        upto = min(max(upto, cur), b)
        if upto > cur:
            segs.append((cur, upto, stack[-1][1] if stack else OUTSIDE))
            cur = upto

    for s0, s1, name in sorted(stages):
        while stack and stack[-1][0] <= s0:
            emit(stack[-1][0])
            stack.pop()
        emit(s0)
        stack.append((s1, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(b)
    return segs


def idle_by_stage(gaps, segs) -> dict:
    """{stage: seconds of the gaps (start, end) in its segments}."""
    out: dict = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            ov = min(g1, s1) - max(g0, s0)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov
            k += 1
    return out


@contextlib.contextmanager
def annotated_stages(stage_profiler):
    """Make the program's stage profiler open a record_function span for
    each stage, without its timing or its waits for the device."""
    from torch.profiler import record_function

    @contextlib.contextmanager
    def stage(name):
        with record_function(STAGE_PREFIX + name):
            yield

    enabled = stage_profiler.enabled
    stage_profiler.enabled = False
    stage_profiler.stage = stage
    try:
        yield
    finally:
        del stage_profiler.stage
        stage_profiler.enabled = enabled


def read_trace(prof, kernel_names: dict) -> DeviceTrace:
    """DeviceTrace of a profile whose window is the CLIP_SPAN span;
    kernel_names: kind -> the substring of its device kernel's name."""
    from torch.autograd import DeviceType
    dev, stages, clip = [], [], None
    for e in prof.events():
        name = e.name
        annotation = (getattr(e, "is_user_annotation", False)
                      or name == CLIP_SPAN or name.startswith(STAGE_PREFIX))
        if e.device_type == DeviceType.CUDA:
            if not annotation:
                dev.append((e.time_range.start, e.time_range.end, name))
        elif name == CLIP_SPAN:
            clip = (e.time_range.start, e.time_range.end)
        elif name.startswith(STAGE_PREFIX):
            stages.append((e.time_range.start, e.time_range.end,
                           name[len(STAGE_PREFIX):]))
    if clip is None:
        raise RuntimeError("the trace holds no clip span")
    a, b = clip
    dev.sort()
    stages.sort()
    tr = DeviceTrace(window_s=(b - a) / 1e6,
                     busy_s=busy_in(dev, a, b) / 1e6)
    by_name: dict = {}
    for s0, s1, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0) / 1e6
    for kind, sub in kernel_names.items():
        hits = [(s1 - s0) / 1e6 for s0, s1, n in dev if sub in n]
        tr.kernel_s[kind] = sum(hits)
        tr.kernel_events[kind] = len(hits)
    tr.device_ops = [[n[:160], s] for n, s in
                     sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    by_stage = idle_by_stage(idle_gaps(dev, a, b), innermost(stages, a, b))
    tr.idle_gaps = [[n, s / 1e6] for n, s in
                    sorted(by_stage.items(), key=lambda kv: -kv[1])[:10]]
    return tr
