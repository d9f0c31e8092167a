"""Tracing, per-stage profiling, and logging (auxiliary subsystems).

The port's own file since it diverged from vvdec_tpu/utils/trace.py:
the stage profiler times device work on a CUDA card.

Reference analogs (SURVEY.md §5):
  - dtrace channel tracer with condition rules ("D_CABAC:poc==0"),
    CLI -tf/-tr and vvdec_set_tracing (dtrace.cpp, vvdec.h.in:712)
  - TimeProfiler scoped per-stage accounting (TimeProfiler.h), here with
    a span log: parents, pictures, device time from CUDA events, the
    collector's pauses, and record_function ranges under torch.profiler
  - msg(level, ...) logging with a redirectable callback
    (vvdec_set_logging_callback, vvdec.h.in:595)
"""

from __future__ import annotations

import gc
import itertools
import re
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

from torch._C._autograd import _profiler_enabled as _torch_profiling

# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------
SILENT, ERROR, WARNING, INFO, NOTICE, VERBOSE, DETAILS = range(7)

_log_callback = None
_log_level = WARNING


def set_logging_callback(fn) -> None:
    """Redirect log output (vvdec_set_logging_callback analog).
    fn(level, message)."""
    global _log_callback
    _log_callback = fn


def set_log_level(level: int) -> None:
    global _log_level
    _log_level = level


def msg(level: int, text: str) -> None:
    if level > _log_level:
        return
    if _log_callback is not None:
        _log_callback(level, text)
    else:
        print(text, file=sys.stderr)


# ---------------------------------------------------------------------------
# dtrace-style channel tracer
# ---------------------------------------------------------------------------
class Tracer:
    """Channel tracer with condition rules.

    Rules use the reference syntax: "D_CHANNEL:cond,cond;D_OTHER:cond"
    where cond is e.g. "poc==0" or "poc>=8" (dtrace.cpp rule parsing).
    """

    def __init__(self, path: str | None = None, rule: str = ""):
        self.file = open(path, "w") if path else None
        self.rules: dict[str, list[tuple[str, str, int]]] = {}
        if rule:
            for part in rule.split(";"):
                if ":" not in part:
                    continue
                chan, conds = part.split(":", 1)
                lst = []
                for c in conds.split(","):
                    m = re.match(r"(\w+)(==|>=|<=|>|<|!=)(\d+)", c.strip())
                    if m:
                        lst.append((m.group(1), m.group(2), int(m.group(3))))
                self.rules[chan.strip()] = lst

    def active(self, channel: str, **ctx) -> bool:
        if self.file is None or channel not in self.rules:
            return False
        ops = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b,
               ">": lambda a, b: a > b, "<": lambda a, b: a < b,
               ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b}
        for var, op, val in self.rules[channel]:
            if var not in ctx or not ops[op](ctx[var], val):
                return False
        return True

    def trace(self, channel: str, text: str, **ctx) -> None:
        if self.active(channel, **ctx):
            self.file.write(text)
            self.file.flush()

    def close(self) -> None:
        if self.file:
            self.file.close()
            self.file = None


_tracer = Tracer()


def set_tracing(path: str | None, rule: str = "") -> None:
    """vvdec_set_tracing analog (also CLI -tf/-tr)."""
    global _tracer
    _tracer.close()
    _tracer = Tracer(path, rule)


def trace(channel: str, text: str, **ctx) -> None:
    _tracer.trace(channel, text, **ctx)


# ---------------------------------------------------------------------------
# per-stage time profiler and span log
# ---------------------------------------------------------------------------

class _Null:
    """The shared context of a stage that nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Span(NamedTuple):
    """One span of the log, as `TimeProfiler.spans` gives it.

    `t0`, `t1`: host start and end (time.perf_counter_ns); `parent`: the
    index in the log of the span it ran inside on its thread, -1 for
    none; `picture`: (decoder serial, POC, type "IDR" / "I" / "P" / "B"
    or None) of the picture it works on, or None; `thread`: the thread's
    ident; `dev0`, `dev1`: for a device stage on CUDA, the start and end
    of the device work queued inside it, on the host clock (None
    otherwise); `gen`: a "gc" span's collector generation."""

    name: str
    t0: int
    t1: int
    parent: int = -1
    picture: tuple | None = None
    thread: int = 0
    dev0: int | None = None
    dev1: int | None = None
    gen: int | None = None

    @property
    def inclusive_ns(self) -> int:
        """t0 to the later of the host end and the device end."""
        return (self.t1 if self.dev1 is None else max(self.t1, self.dev1)) \
            - self.t0


class _Open:
    """A stage's context while the log is on: the span while it is open.
    Its exit appends the closed span to the log as a tuple of plain
    values, which the collector stops tracking, so that a long log does
    not lengthen the collections it records."""

    __slots__ = ("_prof", "name", "seq", "picture", "events", "_up", "_t0",
                 "_rf")

    def __init__(self, prof, name: str) -> None:
        self._prof = prof
        self.name = name
        self.events = None

    def __enter__(self):
        prof = self._prof
        tl = prof._thread
        stack = tl.stack
        self._up = stack[-1].seq if stack else -1
        self.seq = next(prof._seq)
        self.picture = tl.picture
        stack.append(self)
        if _torch_profiling():
            from torch.autograd.profiler import record_function
            self._rf = record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        prof = self._prof
        stack = prof._thread.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        prof._log.append((self.seq, self.name, self._t0, t1, self._up,
                          self.picture, threading.get_ident(), None))
        if self.events is not None:
            prof._pending.append((self.seq,) + self.events)
        return False


class _Picture:
    """While open, spans opened on this thread carry `pic`."""

    __slots__ = ("_tl", "_pic", "_prev")

    def __init__(self, tl, pic) -> None:
        self._tl, self._pic = tl, pic

    def __enter__(self):
        self._prev = self._tl.picture
        self._tl.picture = self._pic

    def __exit__(self, *exc):
        self._tl.picture = self._prev
        return False


class _DeviceTimed:
    """A stage's context whose span also times the CUDA work queued
    inside it: an event at entry and one at exit on the device's current
    stream."""

    __slots__ = ("_prof", "_ctx", "_device", "_span", "_ev0")

    def __init__(self, prof, ctx, device) -> None:
        self._prof, self._ctx, self._device = prof, ctx, device

    def __enter__(self):
        sp = self._ctx.__enter__()
        self._span = sp if isinstance(sp, _Open) else None
        if self._span is not None:
            self._ev0 = self._prof._event(self._device)
        return sp

    def __exit__(self, *exc):
        if self._span is not None and self._ev0 is not None:
            idx, e1 = self._prof._event(self._device)
            self._span.events = (idx, self._ev0[1], e1)
        return self._ctx.__exit__(*exc)


class _Thread(threading.local):
    """A thread's open spans, innermost last, and its current picture."""

    def __init__(self) -> None:
        self.stack: list = []
        self.picture = None
        self.gc_t0 = 0


def self_times(spans) -> list:
    """Each span's self time in ns: its host duration less the part of
    it that its children cover."""
    kids: list = [[] for _ in spans]
    for sp in spans:
        if sp.parent >= 0:
            kids[sp.parent].append(sp)
    out = []
    for sp, ch in zip(spans, kids):
        covered, end = 0, sp.t0
        for c in sorted(ch, key=lambda c: c.t0):
            a, b = max(c.t0, end), min(c.t1, sp.t1)
            if b > a:
                covered += b - a
                end = b
        out.append(sp.t1 - sp.t0 - covered)
    return out


class TimeProfiler:
    """Scoped per-stage time accounting (TimeProfiler.h analog) with a
    span log.

    While `enabled`, each `stage(name)` records a span; `spans()` reads
    the log of closed spans, which starts empty each time `enabled`
    turns on and stays readable after it turns off.  `totals`
    (inclusive seconds by name) and `counts` gain the log's spans when
    it turns off, until `reset()`; a device stage (`device_span`) counts
    to the later of its host end and its device end.  `counters` are
    the work counts (`count`) of the last log.  While a torch.profiler
    session is active, each stage also opens a `record_function` range
    of its name, whether or not the log is on.  Turning the log on
    where CUDA is available initialises and synchronises the current
    CUDA device once and records the anchor event that maps device
    events onto the host clock (a device stage on another device gets
    no device time); turning it off synchronises once, records an end
    anchor on the idle device and resolves the events.  No stage waits
    for the device.  `anchor` is (perf_counter_ns, time_ns) read when the log
    last turned on, which places a span on the unix-ns timeline of a
    torch.profiler trace.  A "gc" span records each collection, with its
    generation, under the span open on the collecting thread."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.anchor: tuple | None = None
        self._on = False
        self._log: list = []        # closed spans, as plain tuples
        self._pending: list = []    # (seq, device index, event, event)
        self._dev: dict = {}        # seq -> (device start, device end)
        self._seq = itertools.count()
        self._thread = _Thread()
        self._anchors: dict = {}    # CUDA device index -> (event, ns)

    @property
    def enabled(self) -> bool:
        return self._on

    @enabled.setter
    def enabled(self, on: bool) -> None:
        on = bool(on)
        if on and not self._on:
            self._start()
        elif self._on and not on:
            self._stop()

    def stage(self, name: str):
        """The context of the stage `name`: an open span while the log is
        on, else a record_function range while torch.profiler is active,
        else a shared no-op."""
        if self._on:
            return _Open(self, name)
        if _torch_profiling():
            from torch.autograd.profiler import record_function
            return record_function(name)
        return _NULL

    def device_span(self, ctx, device):
        """`ctx`, a stage's context, whose span also holds the time of
        the work queued inside it on the CUDA device `device` (a
        torch.device); called while the log is on.  Nothing waits for
        the device."""
        return _DeviceTimed(self, ctx, device)

    def picture(self, pic):
        """Context: spans opened inside it on this thread carry `pic`,
        (decoder serial, POC, type)."""
        if not self._on:
            return _NULL
        return _Picture(self._thread, pic)

    def tag(self, pic) -> None:
        """Give this thread's innermost open span the picture `pic` (a
        parse span, once the slice header names its picture)."""
        if self._on:
            stack = self._thread.stack
            if stack:
                stack[-1].picture = pic

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the work counter `name` while the log is on."""
        if self._on:
            self.counters[name] += n

    def spans(self) -> list:
        """The log's closed spans (Span), in the order they opened."""
        log = sorted(self._log)
        pos = {rec[0]: i for i, rec in enumerate(log)}
        dev = self._dev
        return [Span(name, t0, t1, pos.get(up, -1), pic, thread,
                     *dev.get(seq, (None, None)), gen)
                for seq, name, t0, t1, up, pic, thread, gen in log]

    def report(self) -> str:
        """Per stage of the span log: inclusive and self ms a picture,
        calls, and inclusive ms a picture by picture type."""
        spans = self.spans()
        own = self_times(spans)
        pics = {sp.picture[:2]: sp.picture[2] for sp in spans if sp.picture}
        n = max(1, len(pics))
        kinds: dict = defaultdict(int)
        for k in pics.values():
            kinds[k] += 1
        types = [k for k in ("IDR", "I", "P", "B") if kinds[k]]
        rows: dict = {}
        for sp, s in zip(spans, own):
            r = rows.setdefault(sp.name, [0, 0, 0, defaultdict(int)])
            r[0] += sp.inclusive_ns
            r[1] += s
            r[2] += 1
            if sp.picture and sp.picture[2] in kinds:
                r[3][sp.picture[2]] += sp.inclusive_ns
        lines = [f"{len(pics)} pictures (" + ", ".join(
            f"{kinds[k]} {k}" for k in types) + "); ms a picture, a device"
            " stage's inclusive time to the end of its device work",
            f"{'stage':<28}{'incl':>10}{'self':>10}{'calls':>7}"
            + "".join(f"{'incl ' + k:>10}" for k in types)]
        for name, (incl, s, calls, by) in sorted(rows.items(),
                                                 key=lambda kv: -kv[1][0]):
            lines.append(f"{name:<28}{incl / n / 1e6:>10.3f}"
                         f"{s / n / 1e6:>10.3f}{calls:>7}" + "".join(
                             f"{by[k] / kinds[k] / 1e6:>10.3f}"
                             for k in types))
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    # -- the log's start and end, device events, the collector ------------
    def _start(self) -> None:
        self._log = []
        self._pending = []
        self._dev = {}
        self.counters = defaultdict(int)
        self._anchors = {}
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        import torch
        if torch.cuda.is_available():       # initialises the device
            self._anchor(torch.cuda.current_device())
        gc.callbacks.append(self._gc)
        self._on = True

    def _stop(self) -> None:
        self._on = False
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        if self._anchors:
            import torch
            ends = {}
            for idx in self._anchors:
                torch.cuda.synchronize(idx)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(idx))
                ends[idx] = (ev, time.perf_counter_ns())
                ev.synchronize()        # recorded on an idle device
            self._resolve(ends)
        for sp in self.spans():
            self.totals[sp.name] += sp.inclusive_ns / 1e9
            self.counts[sp.name] += 1

    def _resolve(self, ends: dict) -> None:
        """Each device span's start and end on the host clock: its
        events' time after the device's anchor, scaled so that the
        anchor and the end anchor (`ends`: device index -> (event, host
        ns), recorded when the log turned off) land on their host
        readings, which takes out the drift of the device's timer
        against the host clock."""
        scale = {}
        for idx, (e1, n1) in ends.items():
            e0, n0 = self._anchors[idx]
            ms = e0.elapsed_time(e1)
            scale[idx] = (n1 - n0) / (ms * 1e6) if ms > 0 else 1.0
        for seq, idx, a, b in self._pending:
            e0, n0 = self._anchors[idx]
            self._dev[seq] = (
                n0 + round(e0.elapsed_time(a) * 1e6 * scale[idx]),
                n0 + round(e0.elapsed_time(b) * 1e6 * scale[idx]))
        self._pending = []
        self._anchors = {}

    def _anchor(self, idx: int) -> None:
        """The device's anchor event, recorded on an idle device, and the
        host clock right after recording it."""
        import torch
        torch.cuda.synchronize(idx)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(idx))
        self._anchors[idx] = (ev, time.perf_counter_ns())

    def _event(self, device) -> tuple | None:
        """(device index, a timing event recorded now on its current
        stream), or None for a device the log did not anchor when it
        turned on: nothing here waits for the device."""
        import torch
        idx = torch.cuda.current_device() if device.index is None \
            else device.index
        if idx not in self._anchors:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(idx))
        return idx, ev

    def _gc(self, phase: str, info: dict) -> None:
        tl = self._thread
        if phase == "start":
            tl.gc_t0 = time.perf_counter_ns()
            return
        if not tl.gc_t0:
            return
        stack = tl.stack
        self._log.append((next(self._seq), "gc", tl.gc_t0,
                          time.perf_counter_ns(),
                          stack[-1].seq if stack else -1, tl.picture,
                          threading.get_ident(), info.get("generation")))
        tl.gc_t0 = 0


profiler = TimeProfiler()
