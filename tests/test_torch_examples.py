"""The walkthroughs of ``real_time_sdr_tpu_torch/examples/`` against the
JAX package on the same bytes.

The JAX scripts (``examples/*.py``) are not imported: at import they set
``XLA_FLAGS`` and ``jax_platforms``. Each test instead runs the port
module's ``run(device="cpu")`` and the few JAX package calls its script
makes, on the same synthesized capture (the port's ``utils.synth``, pinned
bit-equal to the JAX one by ``tests/test_torch_copies.py``), and holds
them against each other: audio above 60 dB (the chain-parity bound), the
decoded RDS events equal (they survive the cold start's carrier sign,
which rounding sets), raw bits only from a carried state. Each run also
holds its script's own check (``GateError`` otherwise) and launches the
kernel wrappers of its path (counted on their plain route here). Every
walkthrough runs at its script's own block counts.

Then each module's ``main(["--cpu", ...])`` prints its script's lines and
exits 0, and without a card and without ``--cpu`` it exits 2.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from real_time_sdr_tpu.models.rds_framing import RdsFramer as JRdsFramer
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.models.wideband_frontend import \
    make_wideband_frontend as jmake_wideband_frontend
from real_time_sdr_tpu.parallel.channel import ChannelBank as JBank
from real_time_sdr_tpu.parallel.time_shard import \
    time_sharded_run as jtime_sharded_run
from real_time_sdr_tpu.utils import state as jstate
from real_time_sdr_tpu_torch.examples import (EXAMPLES, GateError,
                                              checkpoint_resume, mono_to_wav,
                                              retune_station, snr_db,
                                              stereo_rds_events,
                                              time_sharded_offline,
                                              wideband_multistation)
from real_time_sdr_tpu_torch.models import receiver as port_receiver
from real_time_sdr_tpu_torch.ops.cuda import KERNELS
from real_time_sdr_tpu_torch.utils import graphs
from real_time_sdr_tpu_torch.utils.graphs import GraphCache, HostGraph

MODULES = dict(mono_to_wav=mono_to_wav, stereo_rds_events=stereo_rds_events,
               wideband_multistation=wideband_multistation,
               retune_station=retune_station,
               time_sharded_offline=time_sharded_offline,
               checkpoint_resume=checkpoint_resume)
# the kernels each walkthrough's path reaches (at mode 0 the mono path
# has no FIR bank: its audio resampler is fir_decimate; a fused wideband
# frontend replaces frontend_fused with its fold product)
PATH_KERNELS = dict(
    mono_to_wav={"frontend_fused", "fir_decimate"},
    stereo_rds_events={"frontend_fused", "fir_bank", "fir_decimate"},
    wideband_multistation={"fir_bank", "fir_decimate"},
    retune_station={"fir_bank", "fir_decimate"},
    time_sharded_offline={"frontend_fused", "fir_bank", "fir_decimate"},
    checkpoint_resume={"frontend_fused", "fir_bank", "fir_decimate"})


@pytest.fixture
def counting(monkeypatch):
    """Every kernel wrapper counts its calls on the plain route too; the
    counts start at 0. Yields a function that returns the kernels that
    launched."""
    for k in KERNELS:
        def call(self, *a, __orig=type(k).__call__, **kw):
            self.launches += 1
            return __orig(self, *a, **kw)
        monkeypatch.setattr(type(k), "__call__", call)
    saved = graphs.launch_counts()
    graphs.set_launch_counts(dict.fromkeys(saved, 0))
    yield lambda: {k.name for k in KERNELS if k.launches}
    graphs.set_launch_counts(saved)


@pytest.fixture(scope="module")
def stereo_capture():
    return stereo_rds_events.fixture()


@pytest.fixture(scope="module")
def wideband_rails():
    return wideband_multistation.fixture()


@pytest.fixture(scope="module")
def retune_rails():
    return retune_station.fixture()


def _events(ev) -> dict:
    """A framer's events (either package's dataclass) as a dict."""
    return dataclasses.asdict(ev)


def test_mono_to_wav_matches_jax(tmp_path, counting):
    iq = mono_to_wav.fixture()
    res = mono_to_wav.run(iq, str(tmp_path / "mono.wav"), device="cpu")
    assert counting() == PATH_KERNELS["mono_to_wav"]
    jrx = JReceiver(0, stereo=False, rds=False)
    _, out = jrx.run_segment(jrx.init_state(), jnp.asarray(iq))
    ref = np.asarray(out.mono).ravel()
    assert res.audio.shape == ref.shape == (24 * jrx.cfg.audio_block,)
    assert res.fs == jrx.cfg.audio_fs and res.n_blocks == 24
    assert snr_db(ref, res.audio) > 60.0


def test_mono_to_wav_gate_fails_on_a_short_wav(tmp_path, monkeypatch):
    """The script's check reads the WAV back: a writer that drops samples
    fails it."""
    write = mono_to_wav.write_wav
    monkeypatch.setattr(mono_to_wav, "write_wav",
                        lambda path, audio, fs, stereo=False: write(
                            path, audio[:-1], fs, stereo))
    with pytest.raises(GateError, match="frames"):
        mono_to_wav.run(mono_to_wav.fixture(), str(tmp_path / "m.wav"),
                        device="cpu")


def test_stereo_rds_events_matches_jax(stereo_capture, counting):
    iq, sent = stereo_capture
    res = stereo_rds_events.run(iq, sent=sent, device="cpu")
    assert counting() == PATH_KERNELS["stereo_rds_events"]
    ev = res.events
    assert (ev.ps_name, ev.pi, ev.radiotext.rstrip(), ev.clock_utc,
            ev.alt_freqs_mhz, ev.traffic_program) == (
        "EXAMPLE ", 0x3A5C, "TPU-NATIVE SDR EXAMPLE",
        "2026-08-18 12:00 UTC-4.0", (98.1, 101.5), False)
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    _, out = jrx.run_segment(jrx.init_state(), jnp.asarray(iq))
    jlog = []
    jfr = JRdsFramer(on_event=lambda kind, val: jlog.append((kind, val)))
    bits, nbits = np.asarray(out.rds_bits), np.asarray(out.rds_nbits)
    for b in range(bits.shape[0]):
        jfr.feed(bits[b, :nbits[b]])
    assert res.log == jlog
    assert _events(res.events) == _events(jfr.events)
    assert snr_db(np.asarray(out.left).ravel(), res.left) > 60.0
    assert snr_db(np.asarray(out.right).ravel(), res.right) > 60.0
    # the script's lines
    lines = stereo_rds_events.summary(res)
    assert lines[0].strip() == ("station summary: PI=0x3a5c PTY='Top 40' "
                                "PS='EXAMPLE '")


def test_stereo_rds_events_gate_holds_what_was_sent(stereo_capture):
    """A station that sends another PS than the one the check expects
    fails it."""
    iq, sent = stereo_capture
    with pytest.raises(GateError, match="ps_name"):
        stereo_rds_events.run(iq, sent=dict(sent, bits=[
            b for g in stereo_rds_events.synth.ps_groups(
                sent["pi"], sent["pty"], "OTHER PS") for b in
            stereo_rds_events.synth.group_to_bits(g)] * 40), device="cpu")


def _jax_wideband(fe, bank, rails, n_blocks, n_ch, weights=None):
    """The JAX scripts' block loop: per-channel framers and audio."""
    jrx = bank.rx
    cfg = jrx.cfg
    iw, qw = rails
    cstate, bstate = fe.init_state(), jrx.init_state(batch=(n_ch,))
    block_wide = cfg.block_size_iq * fe.decim
    framers = [JRdsFramer() for _ in range(n_ch)]
    left = []
    for b in range(n_blocks):
        sl = slice(b * block_wide, (b + 1) * block_wide)
        kw = {} if weights is None else dict(weights=weights)
        bstate, out, cstate = bank.run_wideband_jit(
            bstate, fe, jnp.asarray(iw[sl]), jnp.asarray(qw[sl]), cstate,
            **kw)
        bits, nbits = np.asarray(out.rds_bits), np.asarray(out.rds_nbits)
        for k, fr in enumerate(framers):
            fr.feed(bits[k, :nbits[k]])
        left.append(np.asarray(out.left))
    return framers, np.concatenate(left, -1)


def test_wideband_multistation_matches_jax(wideband_rails, counting):
    res = wideband_multistation.run(wideband_rails, device="cpu")
    assert counting() == PATH_KERNELS["wideband_multistation"]
    assert res.decoded == 4 and res.frontend == "FusedWidebandFrontend"
    st = wideband_multistation.STATIONS
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    fe = jmake_wideband_frontend(jrx.cfg, wideband_multistation.wide_fs(),
                                 [s["offset_hz"] for s in st])
    assert type(fe).__name__ == res.frontend
    framers, left = _jax_wideband(fe, JBank(jrx, n_channels=4),
                                  wideband_rails,
                                  wideband_multistation.BLOCKS, 4)
    for k in range(4):
        assert _events(res.events[k]) == _events(framers[k].events)
        assert framers[k].events.ps_name == st[k]["ps_name"]
        assert snr_db(left[k], res.left[k]) > 60.0


def test_retune_station_matches_jax(retune_rails, counting, monkeypatch):
    """Through the graph cache's bookkeeping (``HostGraph``, what the card
    runs with an eager re-run in place of the replay): the retune adds no
    graph, and station 0 equals the run with no retune tensor for tensor.
    JAX serves the script's ``weights=`` operands; both channels' audio
    and events agree before and after the retune."""
    monkeypatch.setattr(port_receiver, "GraphCache",
                        functools.partial(GraphCache, HostGraph))
    before = []
    res = retune_station.run(retune_rails, device="cpu",
                             on_retune=before.append)
    assert counting() == PATH_KERNELS["retune_station"]
    assert res.graphs_before == res.graphs_after == 2   # with and without
    assert res.station0_equal
    assert before == [res.before] and res.before == ("SVC-A   ", "SVC-B   ")
    assert res.after == ("SVC-A   ", "SVC-C   ")

    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    cfg, seg = jrx.cfg, retune_station.SEG
    wf = JFused(cfg, retune_station.wide_fs(), list(retune_station.GRID))
    bank = JBank(jrx, n_channels=2)
    n_seg = cfg.block_size_iq * wf.decim * seg
    bs, ws = bank.init_state(), wf.init_state()
    framers, left = [JRdsFramer(), JRdsFramer()], []
    iw, qw = retune_rails
    for s in range(retune_station.BLOCKS // seg):
        if s == retune_station.SEGMENTS_BEFORE:
            assert tuple(f.events.ps_name for f in framers) == res.before
            wf.retune(*retune_station.RETUNE)
            framers[1] = JRdsFramer()
        sl = slice(s * n_seg, (s + 1) * n_seg)
        bs, out, ws = bank.run_wideband_jit(
            bs, wf, jnp.asarray(iw[sl]), jnp.asarray(qw[sl]), ws,
            weights=wf.device_weights())
        nbits, bits = np.asarray(out.rds_nbits), np.asarray(out.rds_bits)
        for k in range(2):
            for bi in range(nbits.shape[1]):
                if nbits[k, bi] > 0:
                    framers[k].feed(bits[k, bi][:nbits[k, bi]])
        left.append(np.asarray(out.left))
    left = np.concatenate(left, -1)
    for k in range(2):
        assert _events(res.events[k]) == _events(framers[k].events)
        assert snr_db(left[k], res.left[k]) > 60.0


def test_retune_station_gate_fails_on_a_new_graph(retune_rails,
                                                   monkeypatch):
    """A bank that captures another graph once the station is retuned
    (as one whose graph held the weights by value would have to) fails
    the script's check."""
    monkeypatch.setattr(port_receiver, "GraphCache",
                        functools.partial(GraphCache, HostGraph))
    orig = retune_station.ChannelBank.run_wideband_jit
    retuned = []

    def keyed(self, state, fe, i, q, fs):
        if fe.offsets[1] == retune_station.RETUNE[1]:
            retuned.append(fe)
            return self._jit("retuned", lambda s, i_, q_, f: self
                             .run_wideband(s, fe, i_, q_, f), fe, state, i,
                             q, fs)
        return orig(self, state, fe, i, q, fs)
    monkeypatch.setattr(retune_station.ChannelBank, "run_wideband_jit",
                        keyed)
    with pytest.raises(GateError, match="added graphs"):
        retune_station.run(retune_rails, device="cpu")
    assert retuned


def test_time_sharded_offline_matches_jax(counting):
    """Exact time sharding as 8 batch rows against the port's sequential
    receiver (every block > 100 dB, bits equal: the script's check, held
    by run) and against JAX's ``time_sharded_run`` on its 8 CPU devices
    (> 60 dB, the same events from the bits)."""
    blocks = time_sharded_offline.fixture()
    res = time_sharded_offline.run(blocks, device="cpu")
    assert counting() == PATH_KERNELS["time_sharded_offline"]
    assert res.bits_equal and res.worst_block_db > 100.0
    assert res.sharded.left.shape == (16, 1470)
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    mesh = Mesh(np.array(jax.devices()[:8]), ("time",))
    jout = jtime_sharded_run(jrx, mesh, jnp.asarray(blocks), axis="time",
                             overlap=1)
    for rail in ("left", "right"):
        assert snr_db(np.asarray(getattr(jout, rail)),
                      getattr(res.sharded, rail)) > 60.0
    evs = []
    for bits, nbits in ((res.sharded.rds_bits, res.sharded.rds_nbits),
                        (np.asarray(jout.rds_bits),
                         np.asarray(jout.rds_nbits))):
        fr = JRdsFramer()
        for b in range(bits.shape[0]):
            fr.feed(bits[b, :nbits[b]])
        evs.append(_events(fr.events))
    # 16 blocks (0.49 s) end inside the first full PS cycle, in both
    # packages' sequential runs too: the name's last segment decodes
    assert evs[0] == evs[1] and evs[0]["pi"] == 0x3A5C
    assert evs[0]["ps_name"].endswith("D!")


def test_checkpoint_resume_matches_jax(tmp_path, counting):
    """The split run equals the uninterrupted one (the script's check,
    held by run); the port's ``.npz`` loads through JAX's ``load_state``
    and resumes there: > 60 dB against JAX's uninterrupted run, and the
    RDS bits equal the port's from the same carried state."""
    blocks = checkpoint_resume.fixture()
    path = str(tmp_path / "receiver.npz")
    res = checkpoint_resume.run(blocks, path, device="cpu")
    assert counting() == PATH_KERNELS["checkpoint_resume"]
    assert res.audio_equal and res.bits_equal and res.path == path
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    _, jref = jrx.jit_run_blocks(jrx.init_state(), jnp.asarray(blocks))
    assert snr_db(np.asarray(jref.left), res.ref_left) > 60.0
    split = checkpoint_resume.SPLIT
    st = jstate.load_state(path, jrx.init_state())
    _, jout = jrx.jit_run_blocks(st, jnp.asarray(blocks[split:]))
    assert snr_db(np.asarray(jref.left)[split:], np.asarray(jout.left)) \
        > 60.0
    assert snr_db(res.left[split:], np.asarray(jout.left)) > 60.0
    assert np.array_equal(np.asarray(jout.rds_bits), res.rds_bits[split:])


# -- the module entries --------------------------------------------------

MAIN_LINES = dict(
    mono_to_wav=["synthesized 24 blocks (440 Hz left / 1200 Hz right tones)",
                 "wrote mono.wav: 35280 samples at 48000 Hz (0.74 s)"],
    stereo_rds_events=["synthesized 96 blocks with PS+RadioText+CT+AF",
                       "  ps: EXAMPLE ",
                       "station summary: PI=0x3a5c PTY='Top 40' "
                       "PS='EXAMPLE '",
                       "  RadioText: 'TPU-NATIVE SDR EXAMPLE'",
                       "  AF:        (98.1, 101.5) MHz  TP=False"],
    wideband_multistation=["frontend: FusedWidebandFrontend",
                           "4/4 stations decoded from one capture"],
    retune_station=["before retune: ch0 PS='SVC-A   '  ch1 PS='SVC-B   '",
                    "after  retune: ch0 PS='SVC-A   '  ch1 PS='SVC-C   '",
                    "OK: station 0 uninterrupted, station 1 now decodes "
                    "SVC-C"],
    time_sharded_offline=["shards: 8 x 2 blocks as the rows of one batch "
                          "on 1 x cpu", "RDS bits identical: True"],
    checkpoint_resume=["run 2 resumed and decoded the remaining 6 blocks",
                       "split run == uninterrupted run: audio True, RDS "
                       "bits True"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_on_cpu(name, tmp_path, monkeypatch, capsys, stereo_capture,
                     wideband_rails, retune_rails):
    """``main(["--cpu"])`` prints the script's lines and exits 0 (the
    larger fixtures come from this file's synthesis, not again)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    mod = MODULES[name]
    cached = dict(stereo_rds_events=stereo_capture,
                  wideband_multistation=wideband_rails,
                  retune_station=retune_rails)
    if name in cached:
        monkeypatch.setattr(mod, "fixture",
                            lambda *_, x=cached[name]: x)
    assert mod.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    for line in MAIN_LINES[name]:
        assert line in out, (line, out[-2000:])
    if name == "checkpoint_resume":
        assert str(tmp_path) in out
    if name == "mono_to_wav":
        assert (tmp_path / "mono.wav").stat().st_size == 44 + 2 * 35280


def test_main_with_a_capture(tmp_path, capsys):
    """The positional capture path and the WAV path, as the scripts take
    them: a 4-block capture cut from a longer file to whole blocks."""
    iq = mono_to_wav.fixture()
    blk = iq.size // mono_to_wav.BLOCKS
    (iq[:4 * blk + 100]).tofile(tmp_path / "cap.raw")
    wav = tmp_path / "out.wav"
    assert mono_to_wav.main(["--cpu", str(tmp_path / "cap.raw"),
                             str(wav)]) == 0
    out = capsys.readouterr().out
    assert f"loaded {tmp_path / 'cap.raw'}: 4 blocks" in out
    assert f"wrote {wav}: 5880 samples at 48000 Hz" in out
    assert stereo_rds_events.main(["--cpu", str(tmp_path / "cap.raw")]) == 0
    out = capsys.readouterr().out
    assert "synthesized" not in out and "station summary:" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_a_card_exits_2(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert MODULES[name].main([]) == 2
    assert "pass --cpu" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
