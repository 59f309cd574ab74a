"""The multi-tuner CLI (``cli.run_tuners``, ``--tuners``) and
``ChannelBank.run_segment_staged`` on the CPU, and the system against the
plain reference ``plainref/tuner_bank.py``.

Bounds:

- three tuners through ``--tuners`` at ``--segment`` 1 and 4 and
  ``--pipeline`` 0 and 2: each tuner's PCM file byte-identical to the
  one-station CLI's output on that tuner's stream alone at the same
  ``--segment``, and its ``ch<k>`` RDS lines, written as the one-station
  CLI writes events, identical to that CLI's event lines (tier 3: the
  loop's plumbing does not depend on the carrier tier, and the tier-1
  loop's plain version takes ~1 s a block here);
- the ``--trace-spans`` file of each such run: the phases, the spans
  inside them and the counters (``blocks`` = tuners x blocks a tuner =
  tuners x ``--segment`` x ``segments``);
- ``--tuners`` with ``--stations``, ``--checkpoint``, ``--staged 0``,
  ``--input`` or ``--output``: exit 2;
- ``ChannelBank.run_segment_staged`` bit-equal to
  ``run_segment`` on the embedded segments, on one device and split over
  two;
- two seeded captures through the bank at tier 1 (the configuration's)
  against the float64 reference: every block after the cold start's
  first within 1.5e-4 in ||program - reference|| / ||reference|| (a sound
  float32 chain reads ~5e-6 here; the bound is the benchmark cell's
  limit; the first block holds the pilot loop's acquisition from zero
  history, whose first samples turn on rounding at ~1e-17), and the
  reference rounded to bfloat16 outside that bound (~2.3e-3); the RDS
  bits of every decoded block equal;
- the reference against ``portbench/reference/chain.py``'s listener path,
  both float64: the demod within 1e-11 (two FFTs' rounding), every block
  after the first equal in PCM and within 1e-9 in audio (the first block's
  first ~20 samples are the cold loop's, as above); it imports neither JAX
  nor the port. The benchmark's tuner cell holds the program against
  ``chain.py``'s listener path itself (its reference imports NumPy alone).
"""

import ast
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from plainref.tuner_bank import TunerBank
from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank, gather
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.audio import stereo_pcm
from real_time_sdr_tpu_torch.utils.state import map_state

Receiver = functools.partial(_Receiver, device="cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = mode_config(0)
BLOCK = 2 * CFG.block_size_iq
PCM_BLOCK = 2 * CFG.audio_block
N_BLOCKS = 20
LIMIT_S = 120.0
with open(os.path.join(ROOT, "portbench", "configs",
                       "tuners32_mode0.json")) as _f:
    RX = json.load(_f)["receiver"]
TUNERS = [dict(ps_name="TUNER-A ", pi=0x7A01, tone_left=500.0),
          dict(ps_name="TUNER-B ", pi=0x7A02, tone_left=750.0),
          dict(ps_name="TUNER-C ", pi=0x7A03, tone_left=1000.0)]
EVENT = re.compile(r"(PI|PTY|Program Service|RadioText|Program Type Name|"
                   r"Clock Time|Alternative Frequencies): ")


def _main(argv):
    """``cli.main(argv)`` in a thread, its stderr taken: (rc, stderr
    lines); fails past ``LIMIT_S`` instead of hanging."""
    box: dict = {}
    err = io.StringIO()

    def run():
        with contextlib.redirect_stderr(err):
            box["rc"] = cli.main(argv)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    assert not t.is_alive(), f"cli.main still running after {LIMIT_S} s"
    return box.get("rc"), err.getvalue().splitlines()


def _as_events(ch_lines: list[str], k: int) -> list[str]:
    """Tuner k's ``ch<k> <kind>: <val>`` lines as the one-station CLI
    writes the same events (``cli._emit``)."""
    out = io.StringIO()
    with contextlib.redirect_stderr(out):
        for ln in ch_lines:
            head, _, val = ln.partition(": ")
            tag, kind = head.split(" ", 1)
            if tag != f"ch{k}":
                continue
            cli._emit(kind, ast.literal_eval(val)
                      if kind in ("group", "af") else val)
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("tuners")
    paths = []
    for k, kw in enumerate(TUNERS):
        iq, _ = synth.station_iq(CFG, N_BLOCKS, tone_right=1500.0, **kw)
        p = d / f"tuner_{k}.raw"
        iq.tofile(p)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def alone(streams, tmp_path_factory):
    """{segment: [(PCM bytes, event lines)] per tuner} of the one-station
    CLI on each stream alone, made on first use."""
    cache: dict = {}

    def get(segment: int):
        if segment not in cache:
            d = tmp_path_factory.mktemp(f"alone{segment}")
            runs = []
            for k, p in enumerate(streams):
                out = d / f"out_{k}.pcm"
                rc, lines = _main(["0", "r", "--cpu", "--pll-tier", "3",
                                   "--segment", str(segment), "--input", p,
                                   "--output", str(out)])
                assert rc == 0, lines[-20:]
                runs.append((out.read_bytes(),
                             [ln for ln in lines if EVENT.match(ln)]))
            cache[segment] = runs
        return cache[segment]
    return get


@pytest.mark.parametrize("segment,pipeline", [(1, 0), (1, 2), (4, 0),
                                              (4, 2)])
def test_each_tuner_as_the_one_station_cli(streams, alone, tmp_path,
                                           segment, pipeline):
    out, spans = tmp_path / "out", tmp_path / "spans.json"
    rc, lines = _main(["0", "r", "--cpu", "--pll-tier", "3", "--tuners",
                       ",".join(streams), "--output-dir", str(out),
                       "--segment", str(segment), "--pipeline",
                       str(pipeline), "--stats", "--trace-spans",
                       str(spans)])
    assert rc == 0, lines[-20:]
    ch = [ln for ln in lines if re.match(r"ch\d+ ", ln)]
    for k, (pcm, events) in enumerate(alone(segment)):
        mine = (out / f"station_{k}.pcm").read_bytes()
        assert len(mine) == N_BLOCKS * PCM_BLOCK * 2
        assert mine == pcm, k
        assert events and _as_events(ch, k) == events, k
    assert sum(ln.startswith("block ") for ln in lines) \
        == N_BLOCKS // segment
    assert f"decoded {len(streams)} tuners x {N_BLOCKS} blocks" in lines

    doc = json.loads(spans.read_text())
    counters = doc["otherData"]["counters"]
    n_t, segs = len(streams), N_BLOCKS // segment
    assert counters["tuners"] == n_t and counters["segments"] == segs
    assert counters["blocks"] == n_t * segment * segs
    assert counters["rds_feeds"] > 0
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_index = {e["args"]["span"]: e for e in ev}

    def named(name):
        return [e for e in ev if e["name"] == name]
    for phase in ("read_wait", "submit", "drain"):
        assert len(named(phase)) >= segs, phase
    for name, parent in (("skew_wait", "read_wait"), ("stage", "submit"),
                         ("upload", "submit"), ("dispatch", "submit"),
                         ("fetch", "submit"), ("drain_wait", "drain")):
        got = named(name)
        assert len(got) == segs, name
        for e in got:
            p = by_index[e["args"]["parent"]]
            assert p["name"] == parent and p["args"]["id"] == e["args"]["id"]
            assert p["ts"] <= e["ts"] + 1e-3
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    assert all("write_ms" in e["args"] and "rds_ms" in e["args"]
               for e in named("drain"))


@pytest.mark.parametrize("extra", [["--stations=0"],
                                   ["--checkpoint", "state.npz"],
                                   ["--staged", "0"], ["--input", "x.raw"],
                                   ["--output", "x.pcm"]])
def test_refused_flags_exit_2(extra, tmp_path):
    rc, lines = _main(["0", "r", "--cpu", "--tuners", "a.raw,b.raw",
                       "--output-dir", str(tmp_path), *extra])
    assert rc == 2
    assert lines[-1].startswith("error: --tuners does not take")


def _staged(rx, seg: np.ndarray) -> torch.Tensor:
    tail = np.full((seg.shape[0], rx.frontend.tail_len), 128, np.uint8)
    return torch.from_numpy(rx.frontend.stage_segment(tail, seg))


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_run_segment_staged_equals_run_segment(devices):
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 256, (4, 2 * BLOCK), dtype=np.uint8)
    bank = ChannelBank(rx, 4, devices=devices)
    s0 = bank.init_state()

    def leaves(state_out):
        flat = []
        for tree in state_out:
            map_state(gather(tree), lambda t: flat.append(t) or t)
        return flat
    want = leaves(bank.run_segment(s0, torch.from_numpy(seg)))
    got = leaves(bank.run_segment_staged(s0, _staged(rx, seg), seg.shape[1]))
    assert len(got) == len(want) > 10
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def _rel(p: np.ndarray, r: np.ndarray) -> float:
    p, r = p.astype(np.float64), r.astype(np.float64)
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1.0))


def test_bank_against_the_plain_reference():
    """Two seeded captures (content drawn from seeds 11 and 12) as two
    tuners of one bank, tier 1, two 4-block segments."""
    n_blocks, g = 8, 4
    caps = []
    for seed in (11, 12):
        rng = np.random.default_rng(seed)
        caps.append(synth.station_iq(
            CFG, n_blocks, ps_name="SEED-%03d" % seed,
            pi=int(rng.integers(0x1001, 0xFFFF)),
            tone_left=125.0 * int(rng.integers(2, 32)),
            tone_right=125.0 * int(rng.integers(2, 32)))[0])
    u8 = np.stack(caps)
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1)
    bank = ChannelBank(rx, 2)
    state = bank.init_state()
    tail = np.full((2, rx.frontend.tail_len), 128, np.uint8)
    pcm, bits = [], []
    for s in range(n_blocks // g):
        seg = u8[:, s * g * BLOCK:(s + 1) * g * BLOCK]
        xs = torch.from_numpy(rx.frontend.stage_segment(tail, seg))
        tail = seg[:, -rx.frontend.tail_len:].copy()
        state, out = bank.run_segment_staged(state, xs, seg.shape[1])
        pcm.append(stereo_pcm(out.left, out.right).numpy())
        bits.append([[out.rds_bits[k, j, :out.rds_nbits[k, j]].tolist()
                      for j in range(g)] for k in range(2)])
    pcm = np.concatenate(pcm, -1)
    ref_pcm, ref_bits = TunerBank(RX).decode(torch.from_numpy(u8))
    ctl_pcm, _ = TunerBank(RX, precision="bf16").decode(torch.from_numpy(u8))
    n = 2 * CFG.audio_block
    for k in range(2):
        for b in range(1, n_blocks):
            blk = slice(b * n, (b + 1) * n)
            r = ref_pcm[k, blk].numpy()
            assert _rel(pcm[k, blk], r) <= 1.5e-4, (k, b)
            assert _rel(ctl_pcm[k, blk].numpy(), r) > 1.5e-4, (k, b)
        mine = [bb for seg in bits for bb in seg[k]]
        assert sum(map(len, ref_bits[k])) > 60
        assert mine == ref_bits[k], k


def test_reference_against_chain_listener_path():
    from portbench.reference.chain import ReferenceChain
    iq, _ = synth.station_iq(CFG, 3, ps_name="CHAIN-64", pi=0x6464,
                             tone_left=625.0, tone_right=1875.0)
    u8 = iq[None]
    tb, ch = TunerBank(RX), ReferenceChain(RX)
    fm = tb.demod(torch.from_numpy(u8))
    fm_c = ch.listener_demod(u8)
    assert np.abs(fm.numpy() - fm_c).max() < 1e-11
    left, right = tb.stereo(fm)
    left_c, right_c = ch.stereo(fm_c)
    pcm, pcm_c = tb.pcm(left, right).numpy(), ch.pcm(left_c, right_c)
    a = CFG.audio_block
    assert np.abs(left.numpy()[:, a:] - left_c[:, a:]).max() < 1e-9
    assert np.abs(right.numpy()[:, a:] - right_c[:, a:]).max() < 1e-9
    assert np.array_equal(pcm[:, 2 * a:], pcm_c[:, 2 * a:])


def test_reference_imports_nothing_of_the_port():
    code = ("import sys, plainref.tuner_bank\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = set(ast.literal_eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "real_time_sdr_tpu",
                         "real_time_sdr_tpu_torch", "golden"}
