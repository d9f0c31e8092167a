"""Tracing, per-stage profiling, and logging (auxiliary subsystems).

Reference analogs (SURVEY.md §5):
  - dtrace channel tracer with condition rules ("D_CABAC:poc==0"),
    CLI -tf/-tr and vvdec_set_tracing (dtrace.cpp, vvdec.h.in:712)
  - TimeProfiler scoped per-stage accounting (TimeProfiler.h)
  - msg(level, ...) logging with a redirectable callback
    (vvdec_set_logging_callback, vvdec.h.in:595)
"""

from __future__ import annotations

import re
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

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
# per-stage time profiler
# ---------------------------------------------------------------------------
class TimeProfiler:
    """Scoped per-stage wall-time accounting (TimeProfiler.h analog)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.enabled = False

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = [f"{'stage':<16}{'time[s]':>10}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<16}{t:>10.4f}{self.counts[name]:>8}"
                         f"{t / total:>7.1%}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


profiler = TimeProfiler()
