"""The one-station CLI's drain worker (``cli._DrainWorker`` in
``cli._serve``), on the CPU.

Bounds: fed through a FIFO at ``--pipeline 1``, a block's PCM reaches the
``--output`` file while the CLI still waits for the next block (the
read-driven loop drained it only after two later reads); an exception in
the drain (a framer that raises) raised from ``main``, with no drain
thread left behind; under a 1 us switch interval every stderr line is
whole, each RDS and ``--stats`` line written in one call (the drain
thread's lines and the serving thread's never splice), and the ``PI:`` /
``PTY:`` / ``Program Service:`` lines equal a ``--pipeline 0`` run's, in
order. Each run has a time limit
of its own and fails, not hangs, past it.
"""

import contextlib
import io
import os
import re
import sys
import threading
import time

import pytest

from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.utils import synth

CFG = mode_config(0)
N_BLOCKS = 24
BLOCK_BYTES = 2 * CFG.block_size_iq
PCM_BLOCK = CFG.audio_block * 2 * 2        # stereo int16 bytes a block
LIMIT_S = 60.0
EVENTS = ("PI:", "PTY:", "Program Service:")
# every line the one-station CLI writes to stderr in these runs, whole
WHOLE = re.compile("|".join((
    r"output: 48000 Hz s16le stereo  \(play with: aplay -r 48000 -f S16_LE "
    r"-c 2\)",
    r"block \d+: [\d.]+ ms \([\d.]+x real time\)",
    r"PI: [0-9a-f]+", r"PTY: [A-Za-z ]+", r"Program Service: .{8}",
    r"RDS summary: \d+ groups decoded, \d+ blocks burst-corrected",
    r"total: \d+ blocks, avg [\d.]+ ms/block, [\d.]+x real time",
    r"block latency \(ingest->PCM out\): p50 [\d.]+ ms, p99 [\d.]+ ms, "
    r"max [\d.]+ ms, steady-state p50 [\d.]+ ms vs [\d.]+ ms block "
    r"deadline \(dropped \d+\)")))


def _argv(out, inp, extra=()):
    return ["0", "r", "--cpu", "--pll-tier", "3", "--input", str(inp),
            "--output", str(out), *extra]


class _Writes(io.StringIO):
    """A stderr that keeps each ``write`` call's text."""

    def __init__(self):
        super().__init__()
        self.calls: list[str] = []

    def write(self, s: str) -> int:
        self.calls.append(s)
        return super().write(s)


def _main_within(argv, seconds=LIMIT_S, err=None):
    """``cli.main(argv)`` in a thread of its own, its stderr taken (into
    ``err`` when given): (return code, exception raised, stderr lines);
    fails once ``seconds`` pass instead of hanging."""
    box: dict = {}
    err = io.StringIO() if err is None else err

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


def _events(lines):
    return [ln for ln in lines if ln.startswith(EVENTS)]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """24 blocks of one station with RDS (its PS decodes by the last)."""
    path = tmp_path_factory.mktemp("serve") / "station.raw"
    iq, _ = synth.station_iq(CFG, N_BLOCKS, ps_name="SERVE-DR", pi=0x5D0E,
                             pty=3)
    iq.tofile(path)
    return path, iq


def test_block_drained_before_next_read(capture, tmp_path):
    """--pipeline 1, input through a FIFO: the first block's PCM is in the
    output file while the CLI still waits for the second block (the
    read-driven loop would drain it only after two more reads)."""
    _, iq = capture
    fifo = tmp_path / "in.fifo"
    os.mkfifo(fifo)
    out = tmp_path / "out.pcm"
    seen: dict = {}

    def feed():
        with open(fifo, "wb") as f:
            f.write(iq[:BLOCK_BYTES].tobytes())
            f.flush()
            deadline = time.monotonic() + LIMIT_S / 2
            while time.monotonic() < deadline:
                try:
                    size = os.path.getsize(out)
                except OSError:
                    size = 0
                if size >= PCM_BLOCK:
                    seen["size"] = size
                    break
                time.sleep(0.005)
            f.write(iq[BLOCK_BYTES:2 * BLOCK_BYTES].tobytes())

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    rc, exc, lines = _main_within(_argv(out, fifo, ["--pipeline", "1"]))
    t.join(LIMIT_S)
    assert not t.is_alive()
    assert exc is None and rc == 0, lines[-20:]
    assert seen.get("size") == PCM_BLOCK, seen
    assert out.stat().st_size == 2 * PCM_BLOCK


@pytest.mark.parametrize("pipeline", [0, 1])
def test_drain_exception_reaches_main(capture, tmp_path, monkeypatch,
                                      pipeline):
    """A framer that raises in the drain thread: ``main`` raises the same
    exception within the time limit and leaves no drain thread behind."""
    def feed(self, bits):
        raise RuntimeError("framer broke")
    monkeypatch.setattr(RdsFramer, "feed", feed)
    rc, exc, lines = _main_within(_argv(tmp_path / "out.pcm", capture[0], [
        "--pipeline", str(pipeline)]))
    assert isinstance(exc, RuntimeError) and str(exc) == "framer broke", (
        rc, exc, lines[-20:])
    assert not [t for t in threading.enumerate()
                if t.name.startswith("drain")]


def test_whole_lines_under_switching(capture, tmp_path):
    """With the interpreter switching threads every microsecond, the
    drain thread's RDS lines and the serving thread's ``--stats`` lines
    are each whole, each written in one call (two calls a line, as
    ``print`` makes, would let the other thread's line in between), and
    the RDS event lines are a ``--pipeline 0`` run's, in order."""
    rc, exc, sync = _main_within(_argv(tmp_path / "p0.pcm", capture[0], [
        "--pipeline", "0", "--stats"]))
    assert exc is None and rc == 0, sync[-20:]
    old = sys.getswitchinterval()
    err = _Writes()
    sys.setswitchinterval(1e-6)
    try:
        rc, exc, lines = _main_within(_argv(tmp_path / "p1.pcm", capture[0],
                                            ["--pipeline", "1", "--stats"]),
                                      err=err)
    finally:
        sys.setswitchinterval(old)
    assert exc is None and rc == 0, lines[-20:]
    split = [c for c in err.calls if re.match(r"(PI|PTY|Program Service"
                                              r"|block \d+):", c)
             and not c.endswith("\n")]
    assert split == []
    assert [ln for ln in lines if not WHOLE.fullmatch(ln)] == []
    assert [ln for ln in sync if not WHOLE.fullmatch(ln)] == []
    assert sum(ln.startswith("block ") and "x real time" in ln
               for ln in lines) == N_BLOCKS
    assert "Program Service: SERVE-DR" in _events(sync)
    assert _events(lines) == _events(sync)
    assert ((tmp_path / "p1.pcm").read_bytes()
            == (tmp_path / "p0.pcm").read_bytes())
