"""The wideband CLI's drain worker (``cli._DrainWorker`` in
``cli.run_wideband``), on the CPU.

Bounds: fed through a FIFO, a segment's PCM reaches every station's file
before the next segment is written (``--pipeline 2``: the loop does not
wait for later input to drain it); PCM files and ``ch<k>`` RDS lines
byte-identical at ``--pipeline`` 1, 2 and 4 to ``--pipeline 0`` with the
drain held back until an upload has waited on it (``drain_backpressure``
> 0 in the ``--trace-spans`` file); an exception in the drain raised
from ``main``; under a 1 us switch interval, the worker releases 2,000
items in order with never more than the bound pending, and a recorder's
counter counted from 8 threads at once loses no update. Each run has a
time limit of its own and fails, not hangs, past it.
"""

import contextlib
import io
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest

from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.logging import SpanRecorder

CFG = mode_config(0)
STATIONS = [dict(offset_hz=-2_000_000, ps_name="DRAIN-A ", pi=0xD0A0),
            dict(offset_hz=1_500_000, ps_name="DRAIN-B ", pi=0xD0B0)]
BLOCK_BYTES = 2 * CFG.block_size_iq * 4
PCM_BLOCK = CFG.audio_block * 2 * 2        # stereo int16 bytes a block
LIMIT_S = 60.0


def _argv(out, inp, extra=()):
    return ["0", "r", "--cpu", "--pll-tier", "3",
            "--stations=" + ",".join(str(s["offset_hz"]) for s in STATIONS),
            "--wide-fs", str(4 * CFG.rf_fs), "--output-dir", str(out),
            "--input", str(inp), *extra]


def _main_within(argv, seconds=LIMIT_S):
    """``cli.main(argv)`` in a thread of its own, its stderr taken:
    (return code, exception raised, stderr lines); fails once ``seconds``
    pass instead of hanging."""
    box: dict = {}
    err = io.StringIO()

    def run():
        try:
            with contextlib.redirect_stderr(err):
                box["rc"] = cli.main(argv)
        except BaseException as e:      # handed to the test
            box["exc"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"cli.main still running after {seconds} s"
    return box.get("rc"), box.get("exc"), err.getvalue().splitlines()


def _pcm(out):
    return [(out / f"station_{k}.pcm").read_bytes()
            for k in range(len(STATIONS))]


def _ch_lines(lines):
    return [ln for ln in lines if re.match(r"ch\d+ ", ln)]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """12 blocks of two stations at 9.6 MS/s."""
    d = tmp_path_factory.mktemp("drain")
    iw, qw, _ = synth.wideband_iq(CFG, 4 * CFG.rf_fs, STATIONS, 12)
    x = np.empty(2 * len(iw))
    x[0::2], x[1::2] = iw, qw
    u8 = np.clip(np.round(128 + 127 * x), 0, 255).astype(np.uint8)
    u8.tofile(d / "wide.raw")
    return d / "wide.raw", u8


@pytest.fixture(scope="module")
def synchronous(capture, tmp_path_factory):
    """The ``--pipeline 0`` run: (PCM per station, ch lines)."""
    out = tmp_path_factory.mktemp("sync")
    rc, exc, lines = _main_within(_argv(out, capture[0], [
        "--segment", "1", "--pipeline", "0"]))
    assert exc is None and rc == 0, lines[-20:]
    return _pcm(out), _ch_lines(lines)


def test_segment_drained_before_next_read(capture, tmp_path):
    """--pipeline 2, input through a FIFO: the first segment's PCM is in
    every station's file while the CLI still waits for the second (the
    read-driven loop would drain it only after two more segments)."""
    _, u8 = capture
    seg = 2 * BLOCK_BYTES
    fifo = tmp_path / "in.fifo"
    os.mkfifo(fifo)
    out = tmp_path / "out"
    seen: dict = {}

    def feed():
        with open(fifo, "wb") as f:
            f.write(u8[:seg].tobytes())
            f.flush()
            deadline = time.monotonic() + LIMIT_S / 2
            while time.monotonic() < deadline:
                try:
                    sizes = [os.path.getsize(out / f"station_{k}.pcm")
                             for k in range(len(STATIONS))]
                except OSError:
                    sizes = [0]
                if min(sizes) >= 2 * PCM_BLOCK:
                    seen["sizes"] = sizes
                    break
                time.sleep(0.005)
            f.write(u8[seg:2 * seg].tobytes())

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    rc, exc, lines = _main_within(_argv(out, fifo, [
        "--segment", "2", "--pipeline", "2"]))
    t.join(LIMIT_S)
    assert not t.is_alive()
    assert exc is None and rc == 0, lines[-20:]
    assert seen.get("sizes") == [2 * PCM_BLOCK] * len(STATIONS), seen
    assert [len(p) for p in _pcm(out)] == [4 * PCM_BLOCK] * len(STATIONS)


@pytest.mark.parametrize("pipeline", [1, 2, 4])
def test_pipeline_depths_byte_identical(capture, synchronous, tmp_path,
                                        monkeypatch, pipeline):
    """One block a segment; the drain's first framer feed waits until an
    upload has found the bound reached, and every feed takes a
    millisecond more: PCM and every ``ch<k>`` line as at --pipeline 0,
    with ``drain_backpressure`` above 0 and one drain a segment."""
    pressed = threading.Event()
    real_count, real_feed = SpanRecorder.count, RdsFramer.feed

    def count(self, name, n=1):
        if name == "drain_backpressure":
            pressed.set()
        real_count(self, name, n)

    def feed(self, bits):
        if not pressed.wait(LIMIT_S / 2):
            raise AssertionError("no upload waited on the drain")
        time.sleep(0.001)
        return real_feed(self, bits)
    monkeypatch.setattr(SpanRecorder, "count", count)
    monkeypatch.setattr(RdsFramer, "feed", feed)
    out, spans = tmp_path / "out", tmp_path / "spans.json"
    rc, exc, lines = _main_within(_argv(out, capture[0], [
        "--segment", "1", "--pipeline", str(pipeline), "--stats",
        "--trace-spans", str(spans)]))
    assert exc is None and rc == 0, lines[-20:]
    pcm, ch = synchronous
    assert _pcm(out) == pcm
    assert ch and _ch_lines(lines) == ch
    counters = json.loads(spans.read_text())["otherData"]["counters"]
    assert counters["drain_backpressure"] > 0
    assert counters["segments"] == counters["blocks"] == 12
    drains = [e for e in json.loads(spans.read_text())["traceEvents"]
              if e.get("cat") == "phase" and e["name"] == "drain"]
    assert sorted(e["args"]["id"] for e in drains) == list(range(12))
    # the --stats lines are whole lines among the drain's RDS lines
    assert sum(ln.startswith("block ") for ln in lines) == 12
    assert all(re.fullmatch(r"block \d+: [\d.]+ ms \([\d.]+x real time\)",
                            ln) for ln in lines if ln.startswith("block "))


@pytest.mark.parametrize("pipeline", [0, 2])
def test_drain_exception_reaches_main(capture, tmp_path, monkeypatch,
                                      pipeline):
    """A framer that raises in the drain thread: ``main`` raises the same
    exception within the time limit and leaves no drain thread behind."""
    def feed(self, bits):
        raise RuntimeError("framer broke")
    monkeypatch.setattr(RdsFramer, "feed", feed)
    rc, exc, lines = _main_within(_argv(tmp_path / "out", capture[0], [
        "--segment", "1", "--pipeline", str(pipeline)]))
    assert isinstance(exc, RuntimeError) and str(exc) == "framer broke", (
        rc, exc, lines[-20:])
    assert not [t for t in threading.enumerate()
                if t.name.startswith("drain")]


def test_worker_and_counters_under_switching():
    """The worker's bookkeeping and ``SpanRecorder.count`` shared between
    threads, with the interpreter switching threads every microsecond:
    items drain in order, the serving side never sees more than the bound
    pending and ends with all released, and 8 threads counting one name
    at once lose no update."""
    rec = SpanRecorder()
    rec.start()
    drained: list = []
    n, bound, threads, each = 2000, 3, 8, 2000

    def drain_one(item):
        drained.append(item)
        rec.count("drained")
        return 0

    def counter():
        for _ in range(each):
            rec.count("hits")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=counter, daemon=True)
                for _ in range(threads)]
        for t in pool:
            t.start()
        worker = cli._DrainWorker(drain_one)
        most = 0
        for k in range(n):
            worker.wait(bound - 1)
            worker.submit(k)
            most = max(most, worker.pending())
        worker.wait(0)
        worker.close()
        for t in pool:
            t.join(LIMIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    assert drained == list(range(n))
    assert worker.submitted == worker.released == n and most <= bound
    assert rec.counters == {"drained": n, "hits": threads * each}
