"""The port's stage profiler and its span log (vvdec_tpu_torch.utils.trace)
on the CPU: parents from per-thread stacks, self time, inclusive totals,
the log's lifetime, the disabled path, a decode's spans with picture
ids, and record_function ranges under torch.profiler.
"""

import gc
import os
import sys
import threading
import time

import numpy as np
import pytest

from vvdec_tpu_torch.utils import trace
from vvdec_tpu_torch.utils.trace import Span, TimeProfiler, self_times

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "decode_bench")

# the spans of one picture's reconstruction, by name or prefix
RECON = ("plan (host)", "motion (host)", "itx", "mc: ", "intra",
         "filter: ", "deblock strengths (host)", "sao/alf parameters (host)",
         "readback", "dmvr fixups", "wait: ")


def _by_name(spans):
    out = {}
    for i, sp in enumerate(spans):
        out.setdefault(sp.name, []).append(i)
    return out


def test_parents_follow_each_threads_own_stack():
    prof = TimeProfiler()
    opened, go_on = threading.Event(), threading.Event()

    def worker():
        with prof.stage("x"):
            with prof.stage("y"):
                opened.set()
                go_on.wait(10)

    prof.enabled = True
    try:
        with prof.stage("a"):
            t = threading.Thread(target=worker)
            t.start()
            assert opened.wait(10)
            with prof.stage("b"):
                go_on.set()
            t.join(10)
            assert not t.is_alive()
        with prof.stage("c"):
            pass
    finally:
        prof.enabled = False
    spans = prof.spans()
    n = _by_name(spans)
    a, b, c, x, y = (n[k][0] for k in "abcxy")
    assert spans[a].parent == -1 and spans[c].parent == -1
    assert spans[b].parent == a
    assert spans[x].parent == -1, "a second thread's span has no parent " \
        "on the first thread"
    assert spans[y].parent == x
    assert spans[x].thread != spans[a].thread
    assert spans[y].thread == spans[x].thread
    for sp in spans:
        assert sp.t0 <= sp.t1


def _span(t0, t1, parent, name="s"):
    return Span(name, t0, t1, parent)


def test_self_time_is_duration_less_what_children_cover():
    spans = [
        _span(0, 100, -1, "top"),
        _span(10, 30, 0, "child"),
        _span(15, 20, 1, "grandchild"),
        _span(40, 70, 0, "child"),
        _span(75, 80, 0, "gc"),
        _span(95, 120, 0, "overhang"),     # clipped to its parent's end
        _span(200, 210, -1, "other"),
    ]
    assert self_times(spans) == [100 - 20 - 30 - 5 - 5, 15, 5, 30, 5, 25, 10]


def test_totals_stay_inclusive_seconds_by_name():
    prof = TimeProfiler()
    spans = []
    for _ in range(2):          # totals add up over logs until reset()
        prof.enabled = True
        try:
            with prof.stage("outer"):
                for _ in range(3):
                    with prof.stage("inner"):
                        time.sleep(0.002)
                time.sleep(0.001)
        finally:
            prof.enabled = False
        spans += prof.spans()
    # what the old profiler summed: each call's start to its end
    for name in ("outer", "inner"):
        old = sum((sp.t1 - sp.t0) / 1e9 for sp in spans if sp.name == name)
        assert prof.totals[name] == pytest.approx(old, rel=1e-9)
    assert prof.counts == {"outer": 2, "inner": 6}
    assert prof.totals["outer"] > prof.totals["inner"] >= 6 * 0.002
    prof.reset()
    assert not prof.totals and not prof.counts


def test_log_restarts_when_turned_on_and_survives_reset():
    prof = TimeProfiler()
    prof.enabled = True
    with prof.stage("first"):
        prof.count("units", 3)
    prof.enabled = False
    assert [sp.name for sp in prof.spans()] == ["first"]
    prof.reset()
    assert [sp.name for sp in prof.spans()] == ["first"]
    assert prof.counters == {"units": 3}
    assert not prof.totals
    prof.enabled = True
    assert prof.spans() == [] and not prof.counters
    with prof.stage("second"):
        pass
    prof.enabled = False
    assert [sp.name for sp in prof.spans()] == ["second"]
    assert prof.anchor is not None and len(prof.anchor) == 2


def test_the_disabled_path_records_nothing(monkeypatch):
    made = []

    class Counted(trace._Open):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(trace, "_Open", Counted)
    prof = TimeProfiler()
    hooks = list(gc.callbacks)
    assert prof.stage("a") is prof.stage("b") is trace._NULL
    with prof.stage("a"):
        with prof.picture((1, 0, "IDR")):
            prof.tag((1, 0, "IDR"))
            prof.count("units", 5)
            gc.collect()
    assert prof.picture(None) is trace._NULL
    assert made == [] and prof.spans() == []
    assert not prof.totals and not prof.counters
    assert gc.callbacks == hooks
    prof.enabled = True
    with prof.stage("a"):
        pass
    prof.enabled = False
    assert [a[1] for a in made] == ["a"]
    assert gc.callbacks == hooks


def test_a_collection_is_a_gc_span_under_the_open_span():
    prof = TimeProfiler()
    prof.enabled = True
    try:
        with prof.picture((7, 3, "P")):
            with prof.stage("work"):
                gc.collect()
    finally:
        prof.enabled = False
    spans = prof.spans()
    n = _by_name(spans)
    g = spans[n["gc"][-1]]
    assert g.parent == n["work"][0] and g.gen == 2
    assert g.picture == (7, 3, "P")
    assert spans[n["work"][0]].t0 <= g.t0 <= g.t1 <= spans[n["work"][0]].t1
    assert prof._gc not in gc.callbacks


def _small_inter_stream():
    from vvdec_tpu_torch.streams import INTER_LD_STREAM_KW, inter_ld_stream
    return inter_ld_stream(w=128, h=64, n=3, seed=5,
                           dec_kw=INTER_LD_STREAM_KW["dec_kw"])


def _nal_chunks(stream):
    from vvdec_tpu_torch.bitstream.nal import split_annexb
    return [b"\x00\x00\x01" + stream[s:s + n] for s, n in split_annexb(stream)]


def _decode(chunks):
    """Decode chunk by chunk through api.Decoder on the CPU; returns the
    decoder and the POCs handed out."""
    import vvdec_tpu_torch.api as api
    dec = api.Decoder(api.DecoderParams(device="cpu"))
    pocs = []
    for c in chunks:
        for f in dec.decode(c):
            pocs.append(f.poc)
            dec.frame_unref(f)
    for f in dec.flush():
        pocs.append(f.poc)
        dec.frame_unref(f)
    return dec, pocs


@pytest.fixture(scope="module")
def stream():
    return _small_inter_stream()


def test_a_cpu_decode_gives_every_picture_span_its_picture(stream):
    from vvdec_tpu_torch.utils.trace import profiler
    chunks = _nal_chunks(stream)
    profiler.enabled = True
    try:
        dec, pocs = _decode(chunks)
        serial = dec._core.serial
        dec.close()
    finally:
        profiler.enabled = False
    spans = profiler.spans()
    assert sorted(pocs) == [0, 1, 2]
    # (a collection outside the decoder's calls is a top-level "gc")
    tops = {sp.name for sp in spans if sp.parent == -1 and sp.name != "gc"}
    assert tops <= {"api: open", "api: decode", "api: flush",
                    "api: frame_unref", "api: close"}
    assert {"api: open", "api: decode", "api: flush",
            "api: close"} <= tops
    recon = [sp for sp in spans if sp.name.startswith(RECON)]
    names = {sp.name for sp in recon}
    assert {"plan (host)", "motion (host)", "itx", "intra", "readback",
            "mc: plan (host)", "filter: params"} <= names
    for sp in recon:
        assert sp.picture is not None, sp.name
        s, poc, kind = sp.picture
        assert s == serial and poc in pocs
        assert kind == ("IDR" if poc == 0 else "P")
    parsed = {sp.picture for sp in spans if sp.name == "parse" and
              sp.picture is not None}
    assert parsed == {(serial, 0, "IDR"), (serial, 1, "P"), (serial, 2, "P")}
    assert {sp.picture[1] for sp in spans if sp.name == "readback"} \
        == {0, 1, 2}
    assert profiler.counters["plan: TUs"] > 0
    # the api spans' self time and their children's time make up their
    # inclusive time
    own = self_times(spans)
    api_i = [i for i, sp in enumerate(spans) if sp.name.startswith("api: ")]
    kids = sum(sp.t1 - sp.t0 for sp in spans if sp.parent in set(api_i))
    assert sum(own[i] for i in api_i) + kids == sum(
        spans[i].t1 - spans[i].t0 for i in api_i)
    report = profiler.report()
    assert "api: decode" in report and "incl" in report and " P" in report


def test_stages_are_record_function_ranges_under_torch_profiler(stream):
    from torch.profiler import ProfilerActivity, profile

    from vvdec_tpu_torch.utils.trace import profiler
    sys.path.insert(0, BENCH)
    try:
        from devtrace import STAGE_PREFIX, annotated_stages
    finally:
        sys.path.remove(BENCH)
    chunks = _nal_chunks(stream)
    assert not profiler.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(chunks)
    names = {e.name for e in prof.events()}
    assert {"api: open", "api: decode", "api: flush", "parse",
            "plan (host)", "itx", "intra", "mc: plan (host)",
            "readback"} <= names
    assert profiler.spans() == [] or not profiler.enabled
    with annotated_stages(profiler):
        assert "stage" in vars(profiler)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _decode(chunks)
    assert "stage" not in vars(profiler) and not profiler.enabled
    names = {e.name for e in prof.events()}
    assert {STAGE_PREFIX + "api: decode", STAGE_PREFIX + "parse",
            STAGE_PREFIX + "intra"} <= names
    assert "parse" not in names


def test_a_threaded_decode_keeps_the_parse_threads_spans_apart(stream):
    from vvdec_tpu_torch.utils.trace import profiler
    import vvdec_tpu_torch.api as api
    profiler.enabled = True
    try:
        dec = api.Decoder(api.DecoderParams(device="cpu", threads=2))
        frames = dec.decode(stream) + dec.flush()
        planes = [np.asarray(f.planes[0]).copy() for f in frames]
        dec.close()
    finally:
        profiler.enabled = False
    spans = profiler.spans()
    parse = [sp for sp in spans if sp.name == "parse"]
    main = spans[0].thread
    assert len(planes) == 3 and parse
    assert all(sp.thread != main and sp.parent == -1 for sp in parse)
    assert {sp.picture[1] for sp in parse if sp.picture} == {0, 1, 2}
    assert all(spans[sp.parent].thread == sp.thread
               for sp in spans if sp.parent >= 0)


class _Event:
    """A device timer reading, as torch.cuda.Event's elapsed_time sees
    it: `at` ns of the device's own clock."""

    def __init__(self, at):
        self.at = at

    def elapsed_time(self, other):
        return (other.at - self.at) / 1e6


def test_device_times_are_scaled_between_the_two_anchors():
    """A device timer 100 ppm slow against the host clock: each device
    span lands where the host clock saw it, not where the anchor and the
    device's own elapsed time alone would put it."""
    prof = TimeProfiler()
    prof._anchors = {0: (_Event(0), 5_000)}
    # host end first: the span's inclusive time runs to its device end
    prof._log = [(7, "kernel", 10_000, 900_000, -1, None, 1, None)]
    prof._pending = [(7, 0, _Event(1_000_000), _Event(1_500_000))]
    prof._resolve({0: (_Event(2_000_000), 5_000 + 2_000_200)})
    (sp,) = prof.spans()
    assert (sp.dev0, sp.dev1) == (5_000 + 1_000_100, 5_000 + 1_500_150)
    assert prof._pending == [] and prof._anchors == {}
    assert sp.inclusive_ns == 5_000 + 1_500_150 - 10_000


class _CudaMock:
    """torch.cuda as the span log uses it, on a card that is not there:
    counts the waits (synchronize, Event.synchronize) and the events."""

    def __init__(self):
        self.waits = []
        self.events = 0
        self.clock = 0
        mock = self

        class Event:
            def __init__(self, enable_timing=False):
                mock.events += 1

            def record(self, stream=None):
                mock.clock += 1_000
                self.at = mock.clock

            def synchronize(self):
                mock.waits.append("event")

            def elapsed_time(self, other):
                return (other.at - self.at) / 1e6

        self.Event = Event

    def install(self, monkeypatch):
        import torch
        for name, fn in (
                ("is_available", lambda: True),
                ("is_initialized", lambda: True),
                ("current_device", lambda: 0),
                ("current_stream", lambda idx=None: None),
                ("synchronize", lambda idx=None: self.waits.append("sync")),
                ("Event", self.Event)):
            monkeypatch.setattr(torch.cuda, name, fn)


def test_device_stages_never_wait_for_the_card(monkeypatch):
    """The log waits for the card once when it turns on and once when it
    turns off; a device stage only records two events, and one on a
    device the log did not anchor records none."""
    import torch

    from vvdec_tpu_torch.ops.device_pipeline import timed_stage
    cuda = _CudaMock()
    cuda.install(monkeypatch)
    prof = trace.profiler
    prof.reset()
    prof.enabled = True
    try:
        assert cuda.waits == ["sync"]
        cuda.waits.clear()
        for _ in range(5):
            with prof.stage("plan (host)"):
                with timed_stage("itx", torch.device("cuda")):
                    pass
        with timed_stage("itx", torch.device("cuda", 1)):
            pass
        assert cuda.waits == []
        assert cuda.events == 1 + 10
    finally:
        prof.enabled = False
    assert cuda.waits == ["sync", "event"]
    spans = prof.spans()
    itx = [sp for sp in spans if sp.name == "itx"]
    assert len(itx) == 6
    assert all(sp.dev0 is not None for sp in itx[:5])
    assert itx[5].dev0 is None and itx[5].dev1 is None
    assert prof.counts["itx"] == 6
    prof.reset()


def test_the_cli_profile_report_reads_the_log_and_the_kernel_counts(
        stream, tmp_path, capsys):
    import vvdec_tpu_torch.app as app
    path = tmp_path / "in.266"
    path.write_bytes(stream)
    assert app.main(["-b", str(path), "-t", "1", "--device", "cpu",
                     "--profile"]) == 0
    err = capsys.readouterr().err
    assert "3 pictures (1 IDR, 2 P)" in err
    assert "api: decode" in err and "incl P" in err
    from vvdec_tpu_torch.ops.cuda._build import setup_counts as k
    assert (f"kernel set-up: {k['builds']} builds ({k['build_s']:.3f} s), "
            f"{k['loads']} loads ({k['load_s']:.3f} s)") in err
