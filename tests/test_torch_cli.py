"""The port's pipe CLI (``python -m real_time_sdr_tpu_torch.cli``) on the CPU,
run in-process through ``main`` with ``--cpu --input --output``.

Bounds: PI/PTY/Program Service/RDS summary lines identical to the JAX
CLI's on the same capture; PCM byte counts exact; PCM byte-identical to
the in-process port receiver and across ``--staged``; PCM and RDS event
lines at ``--pipeline`` 1, 2 and 4 as at 0 with the drain thread held
back until an upload waits on it, and a ``--checkpoint`` pair at
``--pipeline 12``, its drains held until the end of each half, joining
to the single run; ``--segment 4`` within 1 LSB of per-block serving with an
identical RDS trail at tier 3 (measured 1 LSB; the JAX package holds 2 LSB
at tier 1, whose library-level segment equality tests/test_torch_modes.py
checks).

The wideband mode (``--stations``) on small captures (2-3 stations at 9.6
MS/s, 8-26 blocks): the ``wideband frontend``, ``ch<k> ps:``, ``retuned
station`` and ``channelized`` lines equal to the JAX CLI's, per-station PCM
> 60 dB against it (the chain gate; measured 108 dB, 1 LSB), exact PCM
lengths, ``--pipeline 4`` byte-identical, ``--segment 13`` within 8 LSB of
per-block serving (the JAX package's bound for its own CLI; measured 1), an
EOF partial segment at its exact length, and a checkpoint taken after
``--retune`` resuming onto the saved grid with the split run's PCM within 1
LSB of the single run's.
"""

import functools
import contextlib
import io
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.audio import stereo_pcm

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

CFG = mode_config(0)
RDS_PREFIXES = ("PI:", "PTY:", "Program Service:", "RadioText:",
                "RDS summary:")


@pytest.fixture
def jcli(monkeypatch, tmp_path):
    """The JAX CLI module. Importing it sets defaults for JAX's compilation
    cache variables; set them first (to this test's directory) so nothing
    is written outside it and the process environment is restored."""
    for var, val in (("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc")),
                     ("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1"),
                     ("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")):
        monkeypatch.setenv(var, val)
    from real_time_sdr_tpu import cli as module
    return module


@pytest.fixture(scope="module")
def station(tmp_path_factory):
    iq, _ = synth.station_iq(CFG, 24, ps_name="CLI-TEST", pi=0x6D0F, pty=3)
    path = tmp_path_factory.mktemp("iq") / "station.raw"
    iq.tofile(path)
    return path, iq


def _run(main, args, inp, out, capsys):
    rc = main(["--cpu", *args, "--input", str(inp), "--output", str(out)])
    err = capsys.readouterr().err
    return rc, err, out.read_bytes() if out.exists() else b""


def _rds_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith(RDS_PREFIXES)]


def test_cli_rds_lines_match_jax_cli(station, tmp_path, capsys, jcli):
    path, _ = station
    rc, err, pcm = _run(cli.main, ["0", "r", "--pll-tier", "3", "--stats"],
                        path, tmp_path / "port.pcm", capsys)
    assert rc == 0
    assert len(pcm) == 24 * CFG.audio_block * 2 * 2   # stereo int16
    jrc, jerr, jpcm = _run(jcli.main, ["0", "r", "--pll-tier", "3"], path,
                           tmp_path / "jax.pcm", capsys)
    assert jrc == 0 and len(jpcm) == len(pcm)
    lines = _rds_lines(err)
    assert lines == _rds_lines(jerr)
    assert "Program Service: CLI-TEST" in lines
    assert "PI: 6d0f" in lines and "PTY: Sports" in lines
    assert err.splitlines()[0] == jerr.splitlines()[0]   # output: ... line
    assert "x real time" in err and "block latency (ingest->PCM out)" in err


def test_cli_default_tier_equals_receiver(station, tmp_path, capsys):
    """`0 s` at the default tier 1, 3 blocks: the bytes of three per-block
    calls of the in-process receiver."""
    path, iq = station
    rc, _, pcm = _run(cli.main, ["0", "s", "--max-blocks", "3"], path,
                      tmp_path / "s.pcm", capsys)
    assert rc == 0
    rx = Receiver(0, stereo=True)
    assert rx.pll_tier == 1
    state, ref = rx.init_state(1), []
    blocks = torch.from_numpy(iq[:3 * 2 * CFG.block_size_iq]).reshape(3, -1)
    for b in range(3):
        state, out = rx.step(state, blocks[b][None])
        ref.append(stereo_pcm(out.left, out.right)[0].numpy())
    assert pcm == np.concatenate(ref).astype("<i2").tobytes()


def test_cli_no_positionals_is_mode0_mono(station, tmp_path, capsys):
    path, _ = station
    rc, err, pcm = _run(cli.main, ["--max-blocks", "2"], path,
                        tmp_path / "m.pcm", capsys)
    assert rc == 0
    assert len(pcm) == 2 * CFG.audio_block * 2
    assert err.startswith("output: 48000 Hz s16le mono")


RDS_EVENTS = ("PI:", "PTY:", "Program Service:", "RadioText:")
HOLD_S = 60.0


@pytest.fixture(scope="module")
def synchronous(station, tmp_path_factory):
    """The 24 blocks at tier 3 and ``--pipeline 0``: (PCM, RDS event
    lines)."""
    path, _ = station
    out = tmp_path_factory.mktemp("sync") / "p0.pcm"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--cpu", "0", "r", "--pll-tier", "3", "--pipeline",
                       "0", "--input", str(path), "--output", str(out)])
    assert rc == 0
    events = [ln for ln in err.getvalue().splitlines()
              if ln.startswith(RDS_EVENTS)]
    assert "Program Service: CLI-TEST" in events
    return out.read_bytes(), events


def _hold_feeds(monkeypatch, until: str) -> None:
    """Hold the drain thread's first framer feed until the serving thread
    reaches ``until``: ``"backpressure"``, an upload that found the bound
    reached, or ``"end"``, its wait for every drain at the end of the
    stream; every feed takes a millisecond more. A feed held past
    ``HOLD_S`` raises (the run fails, it does not hang)."""
    from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
    from real_time_sdr_tpu_torch.utils.logging import SpanRecorder
    reached = threading.Event()
    real_count, real_wait = SpanRecorder.count, cli._DrainWorker.wait
    real_feed = RdsFramer.feed

    def count(self, name, n=1):
        if name == "drain_backpressure":
            reached.set()
        real_count(self, name, n)

    def wait(self, n):
        if n == 0 and self._futs:
            reached.set()
        real_wait(self, n)

    def feed(self, bits):
        if not reached.wait(HOLD_S):
            raise AssertionError(f"the serving thread never reached {until}")
        time.sleep(0.001)
        return real_feed(self, bits)
    if until == "backpressure":
        monkeypatch.setattr(SpanRecorder, "count", count)
    else:
        monkeypatch.setattr(cli._DrainWorker, "wait", wait)
    monkeypatch.setattr(RdsFramer, "feed", feed)


@pytest.mark.parametrize("pipeline", [1, 2, 4])
def test_cli_pipeline_depth_identical(station, synchronous, tmp_path,
                                      capsys, monkeypatch, pipeline):
    """The drain held back until an upload has waited on it: PCM bytes and
    RDS event lines as at --pipeline 0, with ``drain_backpressure`` above
    0 and one group drained a block."""
    path, _ = station
    _hold_feeds(monkeypatch, "backpressure")
    spans = tmp_path / "spans.json"
    _, err, pcm = _run(cli.main, ["0", "r", "--pll-tier", "3", "--pipeline",
                                  str(pipeline), "--trace-spans",
                                  str(spans)],
                       path, tmp_path / "p.pcm", capsys)
    p0, events = synchronous
    assert pcm == p0 and len(p0) == 24 * CFG.audio_block * 2 * 2
    assert [ln for ln in err.splitlines()
            if ln.startswith(RDS_EVENTS)] == events
    counters = json.loads(spans.read_text())["otherData"]["counters"]
    assert counters["drain_backpressure"] > 0
    assert counters["groups"] == counters["blocks"] == 24


def test_cli_pipeline_checkpoint_after_last_drain(station, synchronous,
                                                  tmp_path, capsys,
                                                  monkeypatch):
    """--pipeline 12 over two halves of 12 blocks with ``--checkpoint``,
    every framer feed held until the serving thread waits for the last
    drain: the state and the framer are saved after it, so the halves'
    PCM and RDS event lines join to the single --pipeline 0 run's."""
    path, iq = station
    rest = tmp_path / "rest.raw"
    iq[12 * 2 * CFG.block_size_iq:].tofile(rest)
    ck = str(tmp_path / "ck.npz")
    args = ["0", "r", "--pll-tier", "3", "--pipeline", "12", "--checkpoint",
            ck]
    halves = []
    for k, inp in enumerate((path, rest)):
        with monkeypatch.context() as m:
            _hold_feeds(m, "end")
            rc, err, pcm = _run(cli.main, args + ["--max-blocks", "12"], inp,
                                tmp_path / f"h{k}.pcm", capsys)
        assert rc == 0 and f"saved state to {ck}" in err
        halves.append((pcm, [ln for ln in err.splitlines()
                             if ln.startswith(RDS_EVENTS)]))
    assert "resumed RDS framer from" in err
    p0, events = synchronous
    assert halves[0][0] + halves[1][0] == p0
    assert halves[0][1] + halves[1][1] == events



def test_cli_warns_when_drop_oldest_is_inactive(station, tmp_path, capsys,
                                                monkeypatch):
    """Without the native library the reader falls back to plain blocking
    reads, which drop nothing: ``--drop-oldest`` then prints one
    ``warning:`` line; the exit code and the PCM are those of the run
    without the option. With the native reader (when it loads here) there
    is no warning."""
    from real_time_sdr_tpu_torch.utils import native_io
    path, _ = station
    args = ["0", "r", "--pll-tier", "3", "--max-blocks", "3"]
    native = native_io.available()
    _, err_n, _ = _run(cli.main, args + ["--drop-oldest"], path,
                       tmp_path / "n.pcm", capsys)
    monkeypatch.setattr(native_io, "_load", lambda: None)
    rc, err, pcm = _run(cli.main, args + ["--drop-oldest"], path,
                        tmp_path / "d.pcm", capsys)
    rc0, err0, pcm0 = _run(cli.main, args, path, tmp_path / "p.pcm", capsys)
    warn = [ln for ln in err.splitlines() if ln.startswith("warning:")]
    assert warn == ["warning: --drop-oldest is inactive: the native I/O "
                    "library (native/librtsdr_io.so; make -C native builds "
                    "it) did not load, so input is read with plain blocking "
                    "reads and no block is dropped"]
    assert rc == rc0 == 0 and pcm == pcm0
    assert len(pcm) == 3 * CFG.audio_block * 2 * 2
    assert "warning:" not in err0
    if native:
        assert "warning:" not in err_n

def test_cli_staged_identical(station, tmp_path, capsys):
    path, _ = station
    args = ["0", "r", "--pll-tier", "3", "--max-blocks", "6", "--segment", "2"]
    _, _, a = _run(cli.main, args + ["--staged", "0"], path,
                   tmp_path / "a.pcm", capsys)
    _, _, b = _run(cli.main, args + ["--staged", "1"], path,
                   tmp_path / "b.pcm", capsys)
    assert a == b and len(a) == 6 * CFG.audio_block * 2 * 2


def test_cli_segment_and_partial_group(station, tmp_path, capsys):
    """14 blocks as groups of 4 (the last holds 2, dispatched at its exact
    shape) against per-block serving."""
    path, _ = station
    args = ["0", "r", "--pll-tier", "3", "--max-blocks", "14"]
    _, e1, p1 = _run(cli.main, args, path, tmp_path / "b1.pcm", capsys)
    _, eg, pg = _run(cli.main, args + ["--segment", "4"], path,
                     tmp_path / "b4.pcm", capsys)
    a = np.frombuffer(p1, "<i2").astype(np.int32)
    b = np.frombuffer(pg, "<i2").astype(np.int32)
    assert len(b) == 14 * CFG.audio_block * 2
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    assert _rds_lines(eg) == _rds_lines(e1) and _rds_lines(e1)


def test_cli_survives_noise(tmp_path, capsys):
    rng = np.random.default_rng(11)
    noise = tmp_path / "noise.raw"
    rng.integers(0, 256, size=6 * 2 * CFG.block_size_iq,
                 dtype=np.uint8).tofile(noise)
    rc, _, pcm = _run(cli.main, ["0", "r", "--pll-tier", "3"], noise,
                      tmp_path / "n.pcm", capsys)
    assert rc == 0 and len(pcm) == 6 * CFG.audio_block * 2 * 2


@pytest.mark.parametrize("args", [
    ["--io-depth", "0"], ["--pipeline", "-1"],
    ["--stations", "0,3e5"], ["--wide-fs", "9600000"],
    ["--output-dir", "out"], ["--retune", "0:0:100000"],
    ["--wb-fir", "bf16"]])
def test_cli_bad_arguments_exit_2(args, tmp_path, capsys):
    """Degenerate flags, an unparsable --stations, and the wideband-only
    flags without --stations."""
    rc = cli.main(["0", "r", "--cpu", *args, "--input",
                   str(tmp_path / "missing.raw")])
    assert rc == 2
    assert "error:" in capsys.readouterr().err


def test_cli_parser_matches_jax_surface(jcli):
    """Same positionals, flags, defaults and choices as the JAX CLI, and
    three flags of the port's own: ``--wb-fir``, the counterpart of the JAX
    package's RTSDR_WB_FIR / RTSDR_CHAN_FIR environment variables,
    ``--trace-spans`` (the serving loops' span recorder) and ``--tuners``
    (the multi-tuner loop)."""
    def surface(ap):
        return {a.dest: (tuple(a.option_strings), a.default,
                         None if a.choices is None else tuple(a.choices),
                         a.nargs) for a in ap._actions if a.dest != "help"}
    mine = surface(cli.make_parser())
    assert mine.pop("wb_fir") == (("--wb-fir",), None,
                                  ("f32", "bf16", "bf16x2"), None)
    assert mine.pop("trace_spans") == (("--trace-spans",), None, None, None)
    assert mine.pop("tuners") == (("--tuners",), None, None, None)
    assert mine == surface(jcli.make_parser())
    with pytest.raises(SystemExit) as e:
        cli.make_parser().parse_args(["7"])
    assert e.value.code == 2


def test_cli_without_card_and_without_cpu_fails(monkeypatch, capsys):
    """No --cpu and no card: an error, never a silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["0", "m", "--input", "/nonexistent"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


# -- the wideband (multi-station) mode ----------------------------------------

WIDE = ["--wide-fs", str(4 * CFG.rf_fs)]
STATIONS_AB = [dict(offset_hz=-2_000_000, ps_name="WIDE-A  ", pi=0xA0A0,
                    pty=5),
               dict(offset_hz=1_500_000, ps_name="WIDE-B  ", pi=0xB0B0,
                    pty=9)]
SKY = [dict(offset_hz=-600_000, tone_left=400.0, tone_right=400.0),
       dict(offset_hz=800_000, tone_left=900.0, tone_right=900.0),
       dict(offset_hz=1_200_000, tone_left=2500.0, tone_right=2500.0)]


def _wideband_file(path, stations, n_blocks):
    iw, qw, _ = synth.wideband_iq(CFG, 4 * CFG.rf_fs, stations, n_blocks)
    iq = np.empty(2 * len(iw))
    iq[0::2], iq[1::2] = iw, qw
    u8 = np.clip(np.round(128 + 127 * iq), 0, 255).astype(np.uint8)
    u8.tofile(path)
    return u8


def _wb(main, args, inp, outdir):
    """Run a CLI's wideband mode on the CPU: (rc, stderr lines, [pcm])."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--cpu", *args, "--output-dir", str(outdir), "--input",
                   str(inp)])
    pcm = [np.fromfile(f, "<i2").astype(np.int32)
           for f in sorted(outdir.glob("station_*.pcm"),
                           key=lambda f: int(f.stem.split("_")[1]))]
    return rc, err.getvalue().splitlines(), pcm


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _ch_lines(lines):
    return [ln for ln in lines if re.match(r"ch\d+ ", ln)
            and " group: " not in ln]


@pytest.fixture(scope="module")
def wide_ab(tmp_path_factory):
    """26 blocks of two stations at 9.6 MS/s, and the port's per-block
    (``--segment 1``) run of it at tier 3."""
    d = tmp_path_factory.mktemp("wide_ab")
    _wideband_file(d / "wb.raw", STATIONS_AB, 26)
    args = ["0", "r", "--pll-tier", "3", "--stations=-2000000,1500000",
            *WIDE]
    rc, lines, pcm = _wb(cli.main, args, d / "wb.raw", d / "base")
    assert rc == 0
    return d / "wb.raw", args, lines, pcm


def test_cli_wideband_multistation(wide_ab, tmp_path, jcli):
    """Twin of the JAX package's multistation case, and against the JAX CLI
    in-process on the same capture (``--segment 13``): the stderr lines
    that do not speak of compiling are equal, PCM > 60 dB."""
    path, args, lines, pcm = wide_ab
    assert "wideband frontend: fused one-matmul path" in lines
    assert "ch0 ps: WIDE-A  " in lines and "ch1 ps: WIDE-B  " in lines
    assert lines[-1] == "channelized 2 stations x 26 blocks"
    assert [len(p) for p in pcm] == [26 * CFG.audio_block * 2] * 2
    rc, tl, tp = _wb(cli.main, args + ["--segment", "13"], path,
                     tmp_path / "t")
    jrc, jl, jp = _wb(jcli.main, args + ["--segment", "13"], path,
                      tmp_path / "j")
    assert rc == 0 and jrc == 0
    assert tl == jl, (tl, jl)
    assert _ch_lines(tl) == _ch_lines(lines)
    for a, b in zip(tp, jp):
        assert a.shape == b.shape and _snr(b, a) > 60.0, _snr(b, a)


def test_cli_wideband_pipeline_identical(wide_ab, tmp_path):
    """Deferred fetches (--pipeline 4) and a pageable upload (--staged 0)
    must not change a byte."""
    path, args, lines, pcm = wide_ab
    for extra in (["--pipeline", "4"], ["--pipeline", "0", "--staged", "0"]):
        rc, l2, p2 = _wb(cli.main, args + extra, path,
                         tmp_path / "-".join(extra))
        assert rc == 0 and "ch0 ps: WIDE-A  " in l2
        for a, b in zip(pcm, p2):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seg", [13, 8])
def test_cli_wideband_segment_and_partial(wide_ab, tmp_path, seg):
    """--segment 13: two full segments; --segment 8: 26 % 8 != 0, the EOF
    partial segment runs at its exact shape. Exact PCM length, audio
    within int16 rounding of per-block serving, the same RDS text."""
    path, args, lines, pcm = wide_ab
    rc, l2, p2 = _wb(cli.main, args + ["--segment", str(seg), "--stats"],
                     path, tmp_path / "s")
    assert rc == 0
    assert _ch_lines(l2) == _ch_lines(lines)
    assert any(ln.startswith("total: 26 blocks") for ln in l2)
    assert sum(ln.startswith("block ") for ln in l2) == -(-26 // seg)
    for a, b in zip(pcm, p2):
        assert a.shape == b.shape and np.abs(a - b).max() <= 8


def test_cli_wideband_max_blocks_and_mono(wide_ab, tmp_path):
    """--max-blocks clamps inside a segment; type m writes mono PCM and no
    RDS text; the flags of the single-station I/O path only warn."""
    path, args, _, _ = wide_ab
    rc, lines, pcm = _wb(cli.main, ["0", "m", *args[4:], "--segment", "4",
                                    "--max-blocks", "6", "--io-depth", "2"],
                         path, tmp_path / "m")
    assert rc == 0
    assert [len(p) for p in pcm] == [6 * CFG.audio_block] * 2
    assert lines[0].startswith("warning: --io-depth/--drop-oldest/--monitor")
    assert lines[-1] == "channelized 2 stations x 6 blocks"
    assert not _ch_lines(lines)


def _tone(x):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.fft.rfftfreq(len(x), 1 / float(CFG.audio_fs))[sp.argmax()]


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    """8 blocks of three tone transmitters; also as two 4-block halves."""
    d = tmp_path_factory.mktemp("sky")
    u8 = _wideband_file(d / "sky.raw", SKY, 8)
    u8[:len(u8) // 2].tofile(d / "first.raw")
    u8[len(u8) // 2:].tofile(d / "second.raw")
    return d


def test_cli_wideband_retune_midstream(sky, tmp_path, jcli):
    """--retune SEG:STATION:HZ re-points one station mid-stream: station 1
    follows its old transmitter in the first segment and the new one after
    the retune point; station 0 never moves. Lines and PCM against the JAX
    CLI (whose retune line ends in " (no recompile)")."""
    args = ["0", "m", "--stations=-600000,800000", *WIDE, "--segment", "4",
            "--retune", "1:1:1200000"]
    rc, lines, pcm = _wb(cli.main, args, sky / "sky.raw", tmp_path / "t")
    assert rc == 0, lines[-5:]
    assert "retuned station 1 -> 1200000 Hz at segment 1" in lines
    p1 = pcm[1].astype(np.float64)
    half = len(p1) // 2
    assert abs(_tone(p1[half // 3:half]) - 900.0) < 20
    assert abs(_tone(p1[half + half // 3:]) - 2500.0) < 20
    p0 = pcm[0].astype(np.float64)
    assert abs(_tone(p0[len(p0) // 3:]) - 400.0) < 20
    jrc, jlines, jpcm = _wb(jcli.main, args, sky / "sky.raw", tmp_path / "j")
    assert jrc == 0
    assert lines == [ln.replace(" (no recompile)", "") for ln in jlines]
    for a, b in zip(pcm, jpcm):
        assert a.shape == b.shape and _snr(b, a) > 60.0, _snr(b, a)


def test_cli_wideband_corrupt_sidecar_starts_fresh(wide_ab, tmp_path):
    """A truncated .rds.json must rebuild ALL framers and still decode;
    --warmup runs a silent segment before the stream."""
    path, _, _, _ = wide_ab
    ck = tmp_path / "ck"
    args = ["0", "r", "--pll-tier", "3", "--stations=-2000000", *WIDE,
            "--checkpoint", str(ck), "--warmup", "--segment", "13"]
    rc, lines, _ = _wb(cli.main, args, path, tmp_path / "out")
    assert rc == 0
    assert any(ln.startswith("warmed up in ") for ln in lines)
    assert f"saved state to {ck}" in lines
    with open(str(ck) + ".rds.json") as f:
        side = json.load(f)
    assert side["kind"] == "wideband" and side["stations"] == [-2000000]
    assert len(side["framers"]) == 1
    (tmp_path / "ck.rds.json").write_text('{"kind": "wideband", "framers"')
    (tmp_path / "ck.npz").unlink()      # DSP state fresh too: clean restart
    rc, lines, _ = _wb(cli.main, args, path, tmp_path / "out")
    assert rc == 0
    assert any("could not resume RDS framer state" in ln
               and "starting fresh" in ln for ln in lines)
    assert "ch0 ps: WIDE-A  " in lines     # rebuilt framers still decode


def test_cli_wideband_checkpoint_after_retune(sky, tmp_path):
    """Checkpoint and --retune compose: the sidecar names the grid the state
    was saved on, and a resume with the ORIGINAL --stations retunes onto it
    before loading, so a split run equals the single run within 1 LSB."""
    base = ["0", "r", "--pll-tier", "3", "--stations=-600000,800000", *WIDE,
            "--segment", "2"]
    rc, _, single = _wb(cli.main, base + ["--retune", "1:1:1200000"],
                        sky / "sky.raw", tmp_path / "single")
    assert rc == 0
    ck = str(tmp_path / "ck")
    rc, l1, first = _wb(cli.main, base + ["--retune", "1:1:1200000",
                                          "--checkpoint", ck],
                        sky / "first.raw", tmp_path / "a")
    assert rc == 0 and f"saved state to {ck}" in l1
    with open(ck + ".rds.json") as f:
        side = json.load(f)
    assert side["stations"] == [-600000, 1200000]
    assert len(side["framers"]) == 2
    rc, l2, second = _wb(cli.main, base + ["--checkpoint", ck],
                         sky / "second.raw", tmp_path / "b")
    assert rc == 0
    assert "resumed onto the saved grid: station 1 -> 1200000 Hz" in l2
    assert f"resumed state from {ck}" in l2
    assert any(ln.startswith("resumed 2 RDS framers from ") for ln in l2)
    for k in range(2):
        joined = np.concatenate([first[k], second[k]])
        assert joined.shape == single[k].shape
        assert np.abs(joined - single[k]).max() <= 1
    with open(ck + ".rds.json") as f:      # the second run saved that grid
        assert json.load(f)["stations"] == [-600000, 1200000]


def test_cli_wideband_checkpoint_refuses_other_grids(sky, tmp_path):
    """Another station count loads nothing (a warning naming both); so does
    another grid on the two-stage frontend, whose grid cannot move. The
    sidecar is written without RDS too (``framers: []``)."""
    ck = str(tmp_path / "ck")
    mono = ["0", "m", *WIDE, "--max-blocks", "1", "--checkpoint", ck]
    rc, l1, _ = _wb(cli.main, mono + ["--stations=-600000,800000"],
                    sky / "sky.raw", tmp_path / "a")
    assert rc == 0 and f"saved state to {ck}" in l1
    with open(ck + ".rds.json") as f:
        assert json.load(f) == {"kind": "wideband",
                                "stations": [-600000, 800000], "framers": []}
    rc, l2, _ = _wb(cli.main, mono + ["--stations=-600000"],
                    sky / "sky.raw", tmp_path / "b")
    assert rc == 0
    warn = [ln for ln in l2 if ln.startswith("warning:")]
    assert len(warn) == 1 and "[-600000, 800000]" in warn[0]
    assert "--stations [-600000]" in warn[0] and "starting fresh" in warn[0]
    assert not any(ln.startswith("resumed") for ln in l2)
    # a 7 Hz offset has no short tone period: not eligible for the fused
    # frontend
    ck2 = str(tmp_path / "ck2")
    two = ["0", "m", *WIDE, "--max-blocks", "1", "--checkpoint", ck2]
    rc, l3, _ = _wb(cli.main, two + ["--stations=7,300000"],
                    sky / "sky.raw", tmp_path / "c")
    assert rc == 0 and "wideband frontend: two-stage uint8 path" in l3
    rc, l4, _ = _wb(cli.main, two + ["--stations=7,600000"],
                    sky / "sky.raw", tmp_path / "d")
    assert rc == 0
    assert any("cannot move; starting fresh" in ln for ln in l4)
    assert not any(ln.startswith("resumed") for ln in l4)
    rc, l5, _ = _wb(cli.main, two + ["--stations=7,600000"],
                    sky / "sky.raw", tmp_path / "e")
    assert rc == 0 and f"resumed state from {ck2}" in l5   # same grid now


@pytest.mark.parametrize("args, message", [
    (["--stations=1e6,2e6"], "comma-separated integer Hz"),
    (["--stations=0,300000", "--wide-fs", "9600001"],
     "integer multiple of the mode RF rate 2400000"),
    (["--stations=0,300000", "--retune", "0:2:300000"],
     "--retune takes SEG:STATION:HZ with STATION < 2"),
    (["--stations=0,300000", "--retune", "0:1"], "--retune takes"),
    (["--stations=7,300000", "--retune", "0:1:20000"],
     "requires the fused wideband frontend"),
    (["--stations=7,300000", "--wb-fir", "bf16x2"],
     "--wb-fir bf16x2 needs the fused wideband frontend"),
])
def test_cli_wideband_parse_errors_exit_2(args, message, tmp_path, capsys):
    rc = cli.main(["0", "r", "--cpu", *args, "--output-dir",
                   str(tmp_path / "o"), "--input",
                   str(tmp_path / "missing.raw")])
    err = capsys.readouterr().err
    assert rc == 2 and "error:" in err and message in err
    assert not (tmp_path / "o").exists()
