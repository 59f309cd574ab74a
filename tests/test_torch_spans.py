"""The serving loops' span and counter recorder (``utils.logging.
SpanRecorder``) and the CLI's ``--trace-spans``, on the CPU.

Bounds: with the recorder off no span, counter or file is kept, and with
no profiler running no profiler range is made (under one, the phases are
its ranges and nothing else is); a ``--trace-spans`` file of each loop
(the wideband mode with 4 stations, the one-station mode at its
defaults) holds the phases ``read_wait`` / ``submit`` / ``drain`` with
their inner spans under the right parent and segment id, one
``in_flight`` per segment from its fetch to the start of its drain, no
two phases of one thread overlapping, and the ``segments`` / ``groups``
and ``blocks`` counters equal to what was served; in both loops the
drains, one a segment or group, all run in one thread of their own (the
drain worker), the reads and submits in another, each ``in_flight`` ends
at its drain's start, and ``drain_backpressure`` counts the
``backpressure_wait`` spans; ``graph_captures`` counts each new graph;
under a torch.profiler session that records every thread every phase
lies within 0.25 ms of its own profiler range on the profiler's own
clock, the drains' in the worker's thread.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.utils import graphs, synth
from real_time_sdr_tpu_torch.utils import logging as span_log
from real_time_sdr_tpu_torch.utils.logging import SpanRecorder

CFG = mode_config(0)
OFFSETS = [-3_000_000, -1_000_000, 1_000_000, 3_000_000]
PHASES = ("read_wait", "submit", "drain")
TOL_US = 250.0


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A one-station capture (4 blocks) and a 4-station wideband capture
    at 9.6 MS/s (8 blocks)."""
    d = tmp_path_factory.mktemp("spans")
    iq, _ = synth.station_iq(CFG, 4, ps_name="SPANS   ", pi=0x5A5A)
    iq.tofile(d / "one.raw")
    st = [dict(offset_hz=o, ps_name=f"ST{k}     ", pi=0xA0A0 + k)
          for k, o in enumerate(OFFSETS)]
    iw, qw, _ = synth.wideband_iq(CFG, 4 * CFG.rf_fs, st, 8)
    x = np.empty(2 * len(iw))
    x[0::2], x[1::2] = iw, qw
    np.clip(np.round(128 + 127 * x), 0, 255).astype(np.uint8).tofile(
        d / "wide.raw")
    return d


def _argv(kind, d, extra=()):
    if kind == "one":
        return ["0", "r", "--cpu", "--stats", "--max-blocks", "3",
                "--input", str(d / "one.raw"), "--output",
                str(d / "one.pcm"), *extra]
    return ["0", "r", "--cpu", "--stats", "--pll-tier", "3",
            "--stations=" + ",".join(map(str, OFFSETS)), "--wide-fs",
            str(4 * CFG.rf_fs), "--output-dir", str(d / "wide_out"),
            "--segment", "2", "--pipeline", "2", "--warmup", "--input",
            str(d / "wide.raw"), *extra]


def _profile():
    """A CPU torch.profiler session that records every thread: a default
    one records only the thread that started it, not the drain worker."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _main(argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    assert rc == 0, err.getvalue()[-2000:]
    return err.getvalue().splitlines()


def _events(path):
    with open(path) as f:
        doc = json.load(f)
    return doc, doc["traceEvents"]


def _spans(events):
    """{span index: (name, kind, start us, end us, args)}."""
    out, opened = {}, {}
    for e in events:
        if e["ph"] == "X":
            out[e["args"]["span"]] = (e["name"], e["cat"], e["ts"],
                                      e["ts"] + e["dur"], e["args"])
        elif e["ph"] == "b":
            opened[e["id"]] = e
        elif e["ph"] == "e":
            b = opened.pop(e["id"])
            out[b["args"]["span"]] = (b["name"], b["cat"], b["ts"], e["ts"],
                                      b["args"])
    assert not opened
    return out


@pytest.mark.parametrize("profiled", [False, True])
def test_recorder_off_records_nothing(captures, monkeypatch, profiled):
    """Without ``--trace-spans`` the recorder keeps no span, counter or
    file. With no profiler running no span site opens anything or a
    profiler range; under a profiler the phases are its ranges
    (``read_wait``, ``submit``, ``drain``: the drain worker's too) and
    nothing else is made."""
    made, calls = [], []
    real_init, real_rf = SpanRecorder.__init__, span_log._enter_range

    def init(self):
        real_init(self)
        made.append(self)

    def refuse(*a, **k):
        raise AssertionError("a span site ran with the recorder off")
    monkeypatch.setattr(SpanRecorder, "__init__", init)
    monkeypatch.setattr(SpanRecorder, "write", refuse)
    if not profiled:
        monkeypatch.setattr(SpanRecorder, "_open", refuse)
    monkeypatch.setattr(span_log, "_enter_range",
                        lambda *a, **k: calls.append(a) or real_rf(*a, **k))
    with (_profile() if profiled else contextlib.nullcontext()) as prof:
        _main(_argv("wide", captures, ["--max-blocks", "4"]))
    (rec,) = made
    assert not rec.on and rec.spans == [] and rec.counters == {}
    assert rec.samples == []
    if not profiled:
        assert calls == []
    else:
        names = {e.key for e in prof.key_averages()}
        assert set(PHASES) <= names
        assert {a[0] for a in calls} == set(PHASES)
    rec.count("blocks", 3)
    assert rec.counters == {} and (rec.live and rec.phase("x")) is False


@pytest.mark.parametrize("kind", ["one", "wide"])
def test_trace_spans_file_of_each_loop(captures, kind, tmp_path):
    path = tmp_path / "spans.json"
    lines = _main(_argv(kind, captures, ["--trace-spans", str(path)]))
    doc, events = _events(path)
    spans = _spans(events)
    counters = doc["otherData"]["counters"]
    blocks = int(next(s for s in lines if s.startswith("total: "))
                 .split()[1])
    assert blocks == (3 if kind == "one" else 8)
    unit = "groups" if kind == "one" else "segments"
    assert counters["blocks"] == blocks
    submits = {a["id"]: (t0, t1) for n, _, t0, t1, a in spans.values()
               if n == "submit"}
    assert counters[unit] == len(submits) == (3 if kind == "one" else 4)
    assert sorted(submits) == list(range(len(submits)))
    drains = {a["id"]: (t0, t1) for n, _, t0, t1, a in spans.values()
              if n == "drain"}
    assert sorted(drains) == sorted(submits)
    # one drain a segment
    assert sum(s[0] == "drain" for s in spans.values()) == len(submits)
    # at most one framer feed a station and block
    assert counters.get("rds_feeds", 0) <= blocks * (
        1 if kind == "one" else len(OFFSETS))
    for k, (name, kind_, t0, t1, a) in spans.items():
        assert t1 >= t0 and a["profiled"] is False
        if kind_ == "phase":
            assert name in PHASES and a["parent"] is None
            continue
        parent = spans[a["parent"]]
        assert parent[4]["id"] == a["id"]
        want = {"upload": "submit", "dispatch": "submit", "fetch": "submit",
                "backpressure_wait": "submit", "drain_wait": "drain",
                "in_flight": "submit"}[name]
        assert parent[0] == want, (name, parent[0])
        if kind_ == "span":
            assert parent[2] <= t0 and t1 <= parent[3]
        else:       # from the fetch's end to the start of its drain
            assert kind_ == "flight" and name == "in_flight"
            fetch = [s for s in spans.values()
                     if s[0] == "fetch" and s[4]["parent"] == a["parent"]]
            # it shares the fetch's end stamp and the drain's start stamp
            # (the fetch's end is written as ts + dur: 1 ns for the
            # rounding)
            assert abs(t0 - fetch[0][3]) < 1e-3
            assert t1 == drains[a["id"]][0]
    assert sum(s[0] == "in_flight" for s in spans.values()) == len(submits)
    for a in (s[4] for s in spans.values() if s[0] == "drain"):
        assert a["write_ms"] >= 0 and a["rds_ms"] >= 0
    assert counters.get("drain_backpressure", 0) == sum(
        s[0] == "backpressure_wait" for s in spans.values())
    assert counters.get("drained_before_next_read", 0) <= len(submits)
    tid_of = {e["args"]["span"]: e["tid"] for e in events
              if e.get("cat") == "phase"}
    threads = {}
    for k, s in spans.items():
        if s[1] == "phase":
            threads.setdefault(s[0], set()).add(tid_of[k])
    # every drain in the worker's thread, the reads and submits in the
    # serving thread
    assert len(threads["drain"]) == 1
    assert threads["read_wait"] == threads["submit"]
    assert len(threads["submit"]) == 1
    assert threads["drain"] != threads["submit"]
    for tid in set().union(*threads.values()):
        phases = sorted((t0, t1) for k, (n, c, t0, t1, a) in spans.items()
                        if c == "phase" and tid_of[k] == tid)
        for (a0, a1), (b0, b1) in zip(phases, phases[1:]):
            assert a1 <= b0, "two phases of one thread overlap"


def test_graph_captures_are_counted(captures, monkeypatch, tmp_path):
    """Each graph built (``HostGraph`` standing in for the card's) counts
    once: the warm-up's, then the EOF partial segment's own shape."""
    real = graphs.GraphCache.__init__
    monkeypatch.setattr(graphs.GraphCache, "__init__",
                        lambda self, graph_cls=graphs.HostGraph:
                        real(self, graph_cls))
    path = tmp_path / "spans.json"
    _main(_argv("wide", captures, ["--max-blocks", "5", "--trace-spans",
                                   str(path)]))
    doc, events = _events(path)
    assert doc["otherData"]["counters"]["graph_captures"] == 2
    first_read = min(e["ts"] for e in events if e["name"] == "read_wait")
    when = [e["ts"] for e in events
            if e["ph"] == "C" and e["name"] == "graph_captures"]
    assert when[0] < first_read < when[1]
    rec = SpanRecorder()
    rec.start()
    cache = graphs.GraphCache(graphs.HostGraph)
    cache.spans = rec
    x = torch.ones(8)
    for _ in range(3):
        cache(torch.neg, ("neg",), x)
    cache(torch.neg, ("neg",), torch.ones(4))
    assert rec.counters == {"graph_captures": 2}


@pytest.mark.parametrize("kind", ["one", "wide", "wide-sync"])
def test_phases_on_the_profiler_clock(captures, kind, tmp_path):
    """Under a CPU torch.profiler session that records every thread: each
    phase's start and end in the file lie within 0.25 ms of its range in
    the profiler's Chrome trace (``ts`` plus ``baseTimeNanoseconds`` in
    both), in the phase's own thread. Each loop's drain worker opens one
    range a group or segment, in its own thread: the one-station loop at
    its default ``--pipeline 1``, the wideband loop at ``--pipeline 2``,
    where the worker and the serving thread run Python at once, and at
    ``--pipeline 0`` (``wide-sync``), where they take turns."""
    path = tmp_path / "spans.json"
    extra = ["--trace-spans", str(path)]
    if kind == "one":
        extra += ["--pll-tier", "3"]
    elif kind == "wide-sync":
        extra += ["--pipeline", "0"]
    with _profile() as prof:
        _main(_argv(kind.split("-")[0], captures, extra))
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    pdoc, pev = _events(tmp_path / "prof.json")
    doc, events = _events(path)
    shift = (doc["baseTimeNanoseconds"] - pdoc["baseTimeNanoseconds"]) / 1e3
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in pev
                    if e.get("cat") == "cpu_op" and e["name"] in PHASES)
    range_tid = {(e["ts"], e["name"]): e["tid"] for e in pev
                 if e.get("cat") == "cpu_op"}
    phases = sorted((t0 + shift, t1 + shift, n)
                    for n, c, t0, t1, a in _spans(events).values()
                    if c == "phase")
    assert all(a["profiled"] for *_, a in _spans(events).values())
    # every phase's midpoint lies in one range of its name; a range's
    # first phase starts, and its last ends, with it
    covered = []
    for r0, r1, name in ranges:
        inside = [(t0, t1) for t0, t1, n in phases
                  if n == name and r0 <= (t0 + t1) / 2 <= r1]
        assert inside, (name, r0)
        assert abs(min(inside)[0] - r0) < TOL_US, (name, min(inside)[0] - r0)
        assert abs(max(t1 for _, t1 in inside) - r1) < TOL_US, name
        assert len(inside) == 1
        covered += inside
    assert sorted(covered) == sorted((t0, t1) for t0, t1, _ in phases)
    tids = {name: {range_tid[(r0, name)] for r0, _, n in ranges if n == name}
            for name in PHASES}
    # one range a segment or group, in the worker's thread
    assert sum(n == "drain" for *_, n in ranges) == sum(
        n == "drain" for *_, n in phases)
    assert len(tids["drain"]) == 1 and tids["drain"] != tids["submit"]
