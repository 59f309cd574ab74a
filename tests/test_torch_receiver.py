"""The port's mode-0 receiver slice against the JAX package's receiver.

Two synthetic stations run as one 2-channel batch through the port and one
at a time through JAX ``run_segment`` (tier 3). The JAX side runs its TPU
default frontend, the fused Pallas kernel, in interpret mode: like the
port's kernel it computes (x - 128) exactly. Its CPU (XLA) frontend instead
subtracts a folded -128 offset after the matmul, which leaves ~1e-8 noise
where the cold-start signal is exactly zero, and the 57 kHz RDS carrier's
sign (a 180-degree ambiguity) is decided by the angle of the first nonzero
sync-filter outputs, ~1e-31 in magnitude: the two JAX frontends themselves
decode the RDS carrier with opposite signs.

Bounds: audio > 60 dB (the chain gate), RDS bits equal, and PS/PI/PTY
exact through the port's own framer. Carried state crosses from JAX to the
port mid-stream. The port's jax-free copies (code constants, station
synthesis, framer) are held equal to the originals.
"""

import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu.models.rds_framing import RdsFramer as JRdsFramer
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.ops import rds_bits as jbits
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.models.rds_framing import PTY_NAMES, RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.ops import fir as tfir
from real_time_sdr_tpu_torch.ops import rds_codes
from real_time_sdr_tpu_torch.ops.cuda import fir_bank, frontend_fused
from real_time_sdr_tpu_torch.utils import synth as tsynth
from real_time_sdr_tpu_torch.utils.audio import mono_pcm, stereo_pcm
from real_time_sdr_tpu_torch.utils.state import (state_from_numpy,
                                                 state_to_numpy)

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

REPO = Path(__file__).resolve().parents[1]
N_BLOCKS = 30           # PS needs ~30 blocks to decode (tier 3, warm-up)
STATIONS = [dict(ps_name="TORCH-FM", pi=0x1357, pty=6),
            dict(ps_name="PORT 90 ", pi=0x2B9A, pty=11, tone_left=700.0,
                 tone_right=1500.0)]


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stack(trees):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)


def _decode(bits, n_bits):
    """Feed (nb, max_bits) bits with (nb,) counts through the port framer."""
    fr = RdsFramer()
    for b in range(bits.shape[0]):
        fr.feed(bits[b][:n_bits[b]])
    return fr.events


@pytest.fixture(scope="module")
def slice_run():
    """2-channel port run vs per-channel JAX runs over N_BLOCKS blocks."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    iq = np.stack([jsynth.station_iq(jrx.cfg, N_BLOCKS, **kw)[0]
                   for kw in STATIONS])
    run = jax.jit(jrx.run_segment)
    jouts = [run(jrx.init_state(), jnp.asarray(iq[c]))[1]
             for c in range(len(STATIONS))]
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    _, out = rx.run_segment(rx.init_state(len(STATIONS)),
                            torch.from_numpy(iq))
    return rx, out, jouts


def test_slice_audio_matches_jax(slice_run):
    rx, out, jouts = slice_run
    n_audio = N_BLOCKS * rx.cfg.audio_block
    assert out.left.shape == out.right.shape == (len(STATIONS), n_audio)
    for c, jo in enumerate(jouts):
        for port, ref in ((out.left[c], jo.left), (out.right[c], jo.right)):
            assert np.isfinite(port.numpy()).all()
            assert _snr(ref, port) > 60.0, _snr(ref, port)


def test_slice_rds_bits_equal_and_decoded(slice_run):
    rx, out, jouts = slice_run
    for c, (jo, kw) in enumerate(zip(jouts, STATIONS)):
        np.testing.assert_array_equal(out.rds_nbits[c].numpy(),
                                      np.asarray(jo.rds_nbits))
        np.testing.assert_array_equal(out.rds_bits[c].numpy(),
                                      np.asarray(jo.rds_bits))
        ev = _decode(out.rds_bits[c].numpy(), out.rds_nbits[c].numpy())
        assert ev.ps_name == kw["ps_name"]
        assert ev.pi == kw["pi"]
        assert ev.pty == PTY_NAMES[kw["pty"]]


def test_mono_receiver_matches_jax():
    jrx = JReceiver(0)
    rng = np.random.default_rng(4)
    n = jrx.cfg.block_size_iq * 4
    tone = np.sin(2 * np.pi * 1000.0 * np.arange(n) / jrx.cfg.rf_fs)
    iq = np.stack([jsynth.fm_iq(jrx.cfg.rf_fs, n, mono=tone),
                   jsynth.fm_iq(jrx.cfg.rf_fs, n, mono=tone, noise_std=0.05,
                                noise_seed=int(rng.integers(9)))])
    rx = Receiver(0)
    _, out = rx.run_segment(rx.init_state(2), torch.from_numpy(iq))
    assert out.left is None and out.rds_bits is None
    for c in range(2):
        _, jo = jrx.run_segment(jrx.init_state(), jnp.asarray(iq[c]))
        assert _snr(jo.mono, out.mono[c]) > 60.0
    pcm = mono_pcm(out.mono)
    assert pcm.dtype == torch.int16 and pcm.shape == out.mono.shape


def test_state_carried_over_from_jax():
    """JAX runs blocks 0-5; its state converts; the port runs blocks 6-11
    and matches JAX's own blocks 6-11. The port's state round-trips."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    cfg = jrx.cfg
    half = 6 * 2 * cfg.block_size_iq
    iq = np.stack([jsynth.station_iq(cfg, 12, **kw)[0] for kw in STATIONS])
    run = jax.jit(jrx.run_segment)
    mids, refs = [], []
    for c in range(len(STATIONS)):
        st, _ = run(jrx.init_state(), jnp.asarray(iq[c, :half]))
        mids.append(_np_tree(st))
        refs.append(run(st, jnp.asarray(iq[c, half:]))[1])
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    state = state_from_numpy(_stack(mids), "cpu")
    assert int(state.rds.block_count[0]) == 6
    assert state.rds.bits.first.dtype == torch.bool
    assert state.frontend.iq_tail.dtype == torch.uint8
    new_state, out = rx.run_segment(state, torch.from_numpy(iq[:, half:]))
    for c, ref in enumerate(refs):
        assert _snr(ref.left, out.left[c]) > 60.0
        assert _snr(ref.right, out.right[c]) > 60.0
        np.testing.assert_array_equal(out.rds_bits[c].numpy(),
                                      np.asarray(ref.rds_bits))
        np.testing.assert_array_equal(out.rds_nbits[c].numpy(),
                                      np.asarray(ref.rds_nbits))
    back = state_to_numpy(new_state)
    again = state_from_numpy(back, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(new_state),
                    jax.tree_util.tree_leaves(again)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert type(back).__name__ == "ReceiverState"
    pcm = stereo_pcm(out.left, out.right)
    assert pcm.shape == (2, 2 * out.left.shape[-1])
    np.testing.assert_array_equal(
        pcm[:, 0::2].numpy(),
        np.clip(16384 * out.left.numpy(), -32768, 32767).astype(np.int16))


def test_receiver_flags_match_jax():
    """``stereo`` and ``rds`` are plain bools on the receiver, as on the JAX
    one (its CLI reads ``rx.rds``); ``rds_path`` stays the module."""
    for kw in (dict(), dict(stereo=True), dict(stereo=True, rds=True)):
        jrx, rx = JReceiver(0, **kw), Receiver(0, **kw)
        assert isinstance(rx.rds, bool) and rx.rds == jrx.rds
        assert rx.stereo == jrx.stereo
        assert (rx.rds_path is not None) == rx.rds


# channel -> circular shift (I/Q pairs) of the 36-block capture, as the card
# check tiles one station into 32 channels; 13 and 17 are the two channels
# on which PS does not decode there
SHIFTS = {0: 0, 3: 1352467, 13: 1332597, 17: 1672988}


def test_shifted_channels_ps_matches_jax():
    """PS decodes on 30 of the card check's 32 shifted channels. The two
    that miss it are no fault of the port: the JAX receiver misses PS on
    the same two shifts and decodes it on the others, with the same partial
    name. A 36-block capture (1.1 s, 9-10 RDS groups) holds each PS segment
    two or three times; rolled by these shifts, the wrap point and the
    warm-up together cost every copy of segment 0. The capture's length is
    what shows it, so the test runs all 36 blocks (three 12-block
    segments)."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    iq, _ = jsynth.station_iq(jrx.cfg, 36, ps_name="H100 FM ", pi=0x3A5C,
                              pty=5)
    pairs = iq.reshape(-1, 2)
    tiled = np.stack([np.roll(pairs, -s, axis=0).reshape(-1)
                      for s in SHIFTS.values()])
    seg = 12 * 2 * rx.cfg.block_size_iq
    run = jax.jit(jrx.run_segment)
    st = rx.init_state(len(SHIFTS))
    jst = [jrx.init_state() for _ in SHIFTS]
    fr = [RdsFramer() for _ in SHIFTS]
    jfr = [JRdsFramer() for _ in SHIFTS]
    for k in range(3):
        x = np.ascontiguousarray(tiled[:, k * seg:(k + 1) * seg])
        st, out = rx.run_segment(st, torch.from_numpy(x))
        for c in range(len(SHIFTS)):
            jst[c], jo = run(jst[c], jnp.asarray(x[c]))
            jb, jn = np.asarray(jo.rds_bits), np.asarray(jo.rds_nbits)
            tb, tn = out.rds_bits[c].numpy(), out.rds_nbits[c].numpy()
            for b in range(12):
                fr[c].feed(tb[b][:tn[b]])
                jfr[c].feed(jb[b][:jn[b]])
    names = [f.events.ps_name for f in fr]
    assert names == [f.events.ps_name for f in jfr]
    assert [f.events.groups_decoded for f in fr] == [
        f.events.groups_decoded for f in jfr]
    assert names[:2] == ["H100 FM "] * 2
    assert names[2:] == ["\x00\x0000 FM "] * 2


def test_rds_code_constants_equal():
    assert rds_codes.OFFSET_WORDS == jbits.OFFSET_WORDS
    assert rds_codes.OFFSET_SYNDROMES == jbits.OFFSET_SYNDROMES
    np.testing.assert_array_equal(rds_codes.parity_matrix_np(),
                                  jbits.parity_matrix_np())
    for v in (0, 1, 0x3A5C, 0xFFFF, 0x2B9A):
        assert rds_codes._crc_remainder(v, 16) == jbits._crc_remainder(v, 16)


def test_station_iq_copy_identical():
    cfg = JReceiver(0).cfg
    kw = dict(ps_name="COPYTEST", pi=0x1111, pty=3, radiotext="HELLO PORT",
              ptyn="PTYNAME", clock=(2026, 10, 16, 9, 30), af_mhz=(98.1,))
    a, ta = jsynth.station_iq(cfg, 2, **kw)
    b, tb = tsynth.station_iq(Receiver(0).cfg, 2, **kw)
    np.testing.assert_array_equal(a, b)
    assert ta["bits"] == tb["bits"]


def test_framer_copy_events_identical(slice_run):
    """Same bit stream (with a few flipped bits) -> identical events."""
    rx, out, jouts = slice_run
    bits = out.rds_bits[0].numpy()
    n = out.rds_nbits[0].numpy()
    stream = np.concatenate([bits[b][:n[b]] for b in range(len(n))])
    stream[[40, 300, 301, 555]] ^= 1
    seen_j, seen_t = [], []
    fj = JRdsFramer(on_event=lambda k, v: seen_j.append((k, v)))
    ft = RdsFramer(on_event=lambda k, v: seen_t.append((k, v)))
    for chunk in np.array_split(stream, 7):
        fj.feed(chunk)
        ft.feed(chunk)
    assert seen_t == seen_j and len(seen_t) > 0
    assert vars(ft.events) == vars(fj.events)
    assert ft.state_dict() == fj.state_dict()


def test_port_runs_without_jax():
    """Importing the port and running a CPU run_segment, a 2-shard
    time-sharded run, one tier-1 block, one wideband segment through both
    wideband frontends, the channel bank and the sharded wideband classes,
    the CLI on one block and the wideband CLI on one block of two stations
    with a checkpoint, loads no jax, no module of the JAX package
    ``real_time_sdr_tpu`` and no ``golden`` (a subprocess: this test
    process already imported all three)."""
    code = textwrap.dedent("""
        import os
        import sys
        import tempfile
        import torch
        from real_time_sdr_tpu_torch import cli
        from real_time_sdr_tpu_torch.ops import pll, sync
        from real_time_sdr_tpu_torch.ops.cuda import pll_scan
        from real_time_sdr_tpu_torch.models.receiver import Receiver
        from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
        from real_time_sdr_tpu_torch.models.channelizer import Channelizer
        from real_time_sdr_tpu_torch.models.wideband_frontend import (
            make_wideband_frontend)
        from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
        from real_time_sdr_tpu_torch.parallel import (distributed,
                                                      time_shard, wideband)
        from real_time_sdr_tpu_torch.utils import state, synth, audio
        rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cpu")
        iq, _ = synth.station_iq(rx.cfg, 2)
        st, out = rx.run_segment(rx.init_state(1),
                                 torch.from_numpy(iq)[None])
        assert out.left.shape == (1, 2 * rx.cfg.audio_block)
        sharded = time_shard.time_sharded_run(
            rx, torch.from_numpy(iq).reshape(2, -1), 2, devices=["cpu"])
        assert sharded.left.shape == (2, rx.cfg.audio_block)
        assert distributed.host_channel_slice(4) == slice(0, 4)
        rx1 = Receiver(0, stereo=True, rds=True,      # tier 1, the default
                       device="cpu")
        assert isinstance(rx1.audio.sync, sync.PllLoop)
        st1, out1 = rx1.step(rx1.init_state(1),
                             torch.from_numpy(iq[:iq.shape[0] // 2])[None])
        assert torch.isfinite(out1.left).all()
        assert isinstance(st1.rds.pll, pll.PllCarry)
        assert pll_scan.pll_scan_kernel.launches == 0     # CPU: plain
        with tempfile.TemporaryDirectory() as d:
            raw, pcm = os.path.join(d, "in.raw"), os.path.join(d, "out.pcm")
            iq[:iq.shape[0] // 2].tofile(raw)
            assert cli.main(["0", "m", "--cpu", "--input", raw,
                             "--output", pcm]) == 0
            assert os.path.getsize(pcm) == 2 * rx.cfg.audio_block
        wide_fs, offs = 4 * rx.cfg.rf_fs, [-300_000, 600_000]
        iw, qw, _ = synth.wideband_iq(rx.cfg, wide_fs, [
            dict(offset_hz=f) for f in offs], 1)
        raw = torch.from_numpy(synth.fm_iq(wide_fs, len(iw)))
        bank = ChannelBank(rx, 2)
        for fe in (make_wideband_frontend(rx.cfg, wide_fs, offs,
                                          device="cpu"),
                   Channelizer(rx.cfg, wide_fs, offs)):
            _, out, fst = bank.run_wideband(
                bank.init_state(), fe, torch.from_numpy(iw),
                torch.from_numpy(qw), fe.init_state())
            assert out.left.shape == (2, rx.cfg.audio_block)
            _, out, _ = bank.run_wideband_u8(bank.init_state(), fe, raw,
                                             fst)
            assert out.left.shape == (2, rx.cfg.audio_block)
            state.state_from_numpy(state.state_to_numpy(fst), "cpu")
            cls = (wideband.ShardedWideband if isinstance(fe, Channelizer)
                   else wideband.ShardedFusedWideband)
            sw = cls(fe, rx, devices=["cpu", "cpu"])
            _, _, outs = sw.step(*sw.init_state(), iw, qw)
            assert outs[1].left.shape == (1, rx.cfg.audio_block)
        with tempfile.TemporaryDirectory() as d:
            wide = os.path.join(d, "wide.raw")
            raw.numpy().tofile(wide)
            assert cli.main(["0", "r", "--cpu", "--pll-tier", "3",
                             "--stations=-300000,600000", "--wide-fs",
                             str(wide_fs), "--output-dir", d, "--input",
                             wide, "--checkpoint",
                             os.path.join(d, "ck")]) == 0
            for k in range(2):
                assert os.path.getsize(os.path.join(
                    d, f"station_{k}.pcm")) == 4 * rx.cfg.audio_block
            assert os.path.exists(os.path.join(d, "ck.npz"))
        foreign = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "real_time_sdr_tpu",
                                   "golden"))
        assert not foreign, foreign
        print("ok")
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_meta_tensors_raise():
    """A tensor on any device but CPU or CUDA takes no route."""
    fe = Frontend(Receiver(0).cfg).to("meta")
    xx = torch.empty((1, fe.tail_len + 2940), dtype=torch.uint8,
                     device="meta")
    z = torch.empty((1,), device="meta")
    with pytest.raises(ValueError):
        frontend_fused(xx, fe.rf_fir, z, z)
    bank = tfir.make_bank([tfir.PolyFIR(np.hanning(11))]).to("meta")
    with pytest.raises(ValueError):
        fir_bank(torch.empty((2, 40), device="meta"), bank.taps, bank.w,
                 bank.geometry)
    with pytest.raises(ValueError):
        Receiver(0, device="meta")
