"""The port's ``parallel/`` package against the JAX package's, on the CPU.

Inputs come from the port's seeded synthesizer (``utils.synth``); the same
bytes go through the JAX functions, as ``tests/test_parallel.py`` and
``tests/test_distributed.py`` run them on the virtual CPU devices, and
through the port with ``device="cpu"``, where the kernels' plain versions
run. Mode 0 at full widths, few blocks.

Bounds:

- ``RdsPath.emit_bits = False``: ``rds_clean`` and every FIR / carrier
  state leaf bit-equal to ``emit_bits = True``; bits and counts zeros of
  JAX's shapes, the decoder's state held, ``block_count`` advancing.
- ``run_segment_tiled`` against the port's one-pass ``run_segment``: audio
  > 110 dB, RDS bits equal; against JAX's ``run_segment_tiled`` > 60 dB.
- Exact time sharding (tier 3) against the port's sequential
  ``run_blocks``: audio > 100 dB on EVERY block (each shard's first block
  too), ``rds_bits`` / ``rds_nbits`` equal, at four geometries and both
  RDS timings; against JAX's ``time_sharded_run``: audio > 60 dB,
  ``rds_clean`` > 60 dB up to one global sign and the decoded bit stream
  equal from its second bit on (a cold start's 57 kHz carrier sign is set
  by ~1e-31 filter outputs, so two implementations may differ by a global
  sign, which differential decoding absorbs after one bit).
- Approximate mode (tier 1): every shard's blocks after its first > 25 dB
  against sequential; shard 0's first block equal to it.
- Device lists ``[cpu, cpu]`` (two replicas): the channel bank bit-equal
  to the receiver on its rows and > 120 dB (decisions equal) to the
  one-device bank; the sharded wideband classes > 70 dB and RDS
  bits equal against the unsharded port; against JAX's classes on a
  2-device mesh the fused path > 60 dB; the two-stage path's u8 station
  streams within 1 LSB on < 1 % of bytes and its audio > 60 dB, from the
  port's own u8 as from JAX's, save the first block of a cold segment
  (the discriminator of the filter ramp's zero signal: > 40 dB with it).
- Against JAX also: the approximate mode (> 40 dB, a shard's first block
  > 25 dB), the joint form on a (2, 4) mesh, the tracked timing, and the
  two-replica bank from a carried state, each as the exact case.
- Two gloo processes: each rank's audio > 100 dB (bank step: > 80 dB) and
  bits equal against a local sequential run.
"""

import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import mk_channelizer
from jax.sharding import Mesh

from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.parallel import distributed as jdist
from real_time_sdr_tpu.parallel.channel import ChannelBank as JChannelBank
from real_time_sdr_tpu.parallel import time_shard as jts
from real_time_sdr_tpu.parallel import wideband as jwb
from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend
from real_time_sdr_tpu_torch.parallel import distributed as tdist
from real_time_sdr_tpu_torch.parallel import time_shard as tts
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank, gather
from real_time_sdr_tpu_torch.parallel.wideband import (ShardedFusedWideband,
                                                       ShardedWideband)
from real_time_sdr_tpu_torch.utils import state as tstate
from real_time_sdr_tpu_torch.utils import synth

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

REPO = Path(__file__).resolve().parents[1]
CPU2 = ["cpu", "cpu"]
RASTER4 = [-450_000, -150_000, 150_000, 450_000]


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _leaves(tree):
    return tstate._leaves(tree)


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _assert_trees_close(a, b, db):
    """Float leaves within ``db`` dB (a matmul over fewer rows may sum in
    another order), every other leaf equal."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype.is_floating_point:
            assert torch.equal(x, y) or _snr(y, x) > db, _snr(y, x)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def _stream(bits, n_bits):
    """(B, max_bits), (B,) -> the decoded bits in order."""
    bits, n_bits = np.asarray(bits), np.asarray(n_bits)
    return np.concatenate([bits[b][:n_bits[b]] for b in range(len(n_bits))])


def _blocks(rx, n_blocks, **kw):
    iq, _ = synth.station_iq(rx.cfg, n_blocks, **kw)
    return iq.reshape(n_blocks, -1)


@pytest.fixture(scope="module")
def rx3():
    return Receiver(0, stereo=True, rds=True, pll_tier=3)


@pytest.fixture(scope="module")
def jrx3():
    return JReceiver(0, stereo=True, rds=True, pll_tier=3)


# -- the card is the default ------------------------------------------------

def test_receiver_default_device_is_the_card():
    """No ``device``: the card, so it raises where there is none (as every
    multi-device entry point's ``devices=None``); ``device="cpu"`` runs.
    Where there is a card, the same calls land on it."""
    rx = _Receiver(0, device="cpu")
    assert rx.device == torch.device("cpu")
    assert rx.replica("cpu") is rx
    with pytest.raises(TypeError):
        tstate.state_from_numpy(tstate.state_to_numpy(rx.init_state(1)))
    if torch.cuda.is_available():
        assert _Receiver(0).device.type == "cuda"
        assert all(d.type == "cuda" for d in tdist.channel_devices())
        return
    with pytest.raises(RuntimeError, match="cuda"):
        _Receiver(0)
    iq = torch.from_numpy(_blocks(rx, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        tts.time_sharded_run(rx, iq, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedFusedWideband(
            FusedWidebandFrontend(rx.cfg, 4 * rx.cfg.rf_fs, RASTER4), rx)
    with pytest.raises(RuntimeError, match="cuda"):
        tdist.channel_devices()


# -- RdsPath.emit_bits ------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 3])
def test_emit_bits_off_keeps_the_dsp(rx3, n_blocks):
    iq = _blocks(rx3, 8)
    x = torch.from_numpy(iq.reshape(1, -1))
    cut = (8 - n_blocks) * iq.shape[1]        # the last block(s) are warm
    st, _ = rx3.run_segment(rx3.init_state(1), x[:, :cut])
    seg = x[:, cut:]
    on_state, on = rx3.run_segment(st, seg)
    rx3.rds_path.emit_bits = False
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    jrx.rds_path.emit_bits = False
    try:
        off_state, off = rx3.run_segment(st, seg)
    finally:
        rx3.rds_path.emit_bits = True
    assert int(on.rds_nbits.sum()) > 0
    torch.testing.assert_close(off.rds_clean, on.rds_clean, rtol=0, atol=0)
    torch.testing.assert_close(off.left, on.left, rtol=0, atol=0)
    assert not off.rds_bits.any() and not off.rds_nbits.any()
    # JAX's shapes and dtypes for the constant outputs (no channel axis)
    _, jo = jrx.run_segment(jrx.init_state(), jnp.asarray(seg[0].numpy()))
    assert tuple(off.rds_bits.shape[1:]) == jo.rds_bits.shape
    assert tuple(off.rds_nbits.shape[1:]) == jo.rds_nbits.shape
    assert not np.asarray(jo.rds_bits).any()
    assert off.rds_bits.dtype == torch.int32 == off.rds_nbits.dtype
    # DSP state equal, the decoder's held, the count advancing
    for f in ("band_tail", "pilot_tail", "delay_tail", "baseband_tail",
              "rrc_tail", "pll", "block_count"):
        _assert_trees_equal(getattr(off_state.rds, f),
                            getattr(on_state.rds, f))
    _assert_trees_equal(off_state.rds.bits, st.rds.bits)
    _assert_trees_equal(off_state.audio, on_state.audio)


# -- Receiver.run_segment_tiled ---------------------------------------------

def test_run_segment_tiled(rx3, jrx3):
    iq = _blocks(rx3, 8, ps_name="TILED-FM")
    x = torch.from_numpy(iq.reshape(1, -1))
    s1, one = rx3.run_segment(rx3.init_state(1), x)
    s2, tiled = rx3.run_segment_tiled(rx3.init_state(1), x, tile_blocks=2)
    for f in ("left", "right", "rds_bits", "rds_nbits", "rds_clean"):
        assert getattr(tiled, f).shape == getattr(one, f).shape, f
    assert _snr(one.left, tiled.left) > 110.0
    assert _snr(one.right, tiled.right) > 110.0
    assert int(one.rds_nbits.sum()) > 0
    torch.testing.assert_close(tiled.rds_bits, one.rds_bits, rtol=0, atol=0)
    torch.testing.assert_close(tiled.rds_nbits, one.rds_nbits, rtol=0, atol=0)
    assert int(s2.rds.block_count) == 8
    _, jt = jax.jit(functools.partial(jrx3.run_segment_tiled, tile_blocks=2))(
        jrx3.init_state(), jnp.asarray(iq.reshape(-1)))
    assert _snr(jt.left, tiled.left[0]) > 60.0
    assert _snr(jt.right, tiled.right[0]) > 60.0
    assert jt.rds_bits.shape == tuple(tiled.rds_bits.shape[1:])
    assert jt.rds_nbits.shape == tuple(tiled.rds_nbits.shape[1:])
    # the one-pass shortcut and the refusal, as JAX
    _, short = rx3.run_segment_tiled(rx3.init_state(1), x, tile_blocks=8)
    _assert_trees_equal(short, one)
    with pytest.raises(ValueError, match="not divisible"):
        rx3.run_segment_tiled(rx3.init_state(1), x, tile_blocks=3)
    with pytest.raises(ValueError, match="not divisible"):
        jrx3.run_segment_tiled(jrx3.init_state(), jnp.asarray(iq.reshape(-1)),
                               tile_blocks=3)


# -- exact time sharding ----------------------------------------------------

def _check_exact(out, seq, n_blocks):
    """out (B, ...) sharded against seq (1, B, ...) sequential."""
    for name in ("left", "right"):
        got, ref = getattr(out, name), getattr(seq, name)[0]
        assert got.shape == ref.shape
        for b in range(n_blocks):       # every block: each shard's first too
            assert _snr(ref[b], got[b]) > 100.0, (name, b)
    torch.testing.assert_close(out.rds_nbits, seq.rds_nbits[0], rtol=0,
                               atol=0)
    torch.testing.assert_close(out.rds_bits, seq.rds_bits[0], rtol=0, atol=0)


@pytest.mark.parametrize("t,n_blocks,overlap,devices,timing", [
    (4, 8, 1, ["cpu"], "comb"), (2, 6, 1, CPU2, "comb"),
    (4, 8, 2, ["cpu"], "comb"), (4, 8, 1, ["cpu"], "tracked"),
    (8, 32, 1, CPU2, "comb")])
def test_time_sharding_exact(t, n_blocks, overlap, devices, timing):
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, rds_timing=timing)
    blocks = torch.from_numpy(_blocks(rx, n_blocks, ps_name="SHARD-FM"))
    out = tts.time_sharded_run(rx, blocks, t, overlap=overlap,
                               devices=devices)
    assert rx.rds_path.emit_bits
    _, seq = rx.run_blocks(rx.init_state(1), blocks[None])
    _check_exact(out, seq, n_blocks)
    if n_blocks > 6:
        assert int(out.rds_nbits.sum()) > 0
    if n_blocks == 32:
        fr = RdsFramer()
        for b in range(n_blocks):
            fr.feed(out.rds_bits[b, :out.rds_nbits[b]].numpy())
        assert fr.events.ps_name == "SHARD-FM"


def _check_against_jax(jout, out):
    """One station's sharded outputs (B, ...): audio and ``rds_clean`` > 60
    dB (the latter up to one global carrier sign), counts equal and the bit
    stream equal from its second bit on."""
    assert _snr(jout.left, out.left) > 60.0
    assert _snr(jout.right, out.right) > 60.0
    jclean, clean = np.asarray(jout.rds_clean), out.rds_clean.numpy()
    assert jclean.shape == clean.shape
    sign = np.sign(np.sum(jclean * clean))
    assert _snr(jclean, sign * clean) > 60.0
    np.testing.assert_array_equal(np.asarray(jout.rds_nbits),
                                  out.rds_nbits.numpy())
    js = _stream(jout.rds_bits, jout.rds_nbits)
    ts = _stream(out.rds_bits.numpy(), out.rds_nbits.numpy())
    assert len(ts) > 40
    np.testing.assert_array_equal(js[1:], ts[1:])


def test_time_sharding_tracked_matches_jax():
    """The exact mode with the tracked symbol timing against JAX's."""
    kw = dict(stereo=True, rds=True, pll_tier=3, rds_timing="tracked")
    rx, jrx = Receiver(0, **kw), JReceiver(0, **kw)
    blocks = _blocks(rx, 8)
    out = tts.time_sharded_run(rx, torch.from_numpy(blocks), 4,
                               devices=["cpu"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("ch", "time"))
    jout = jts.time_sharded_run(jrx, mesh, jnp.asarray(blocks), overlap=1)
    _check_against_jax(jout, out)


def test_time_sharding_exact_matches_jax(rx3, jrx3):
    blocks = _blocks(rx3, 8)
    out = tts.time_sharded_run(rx3, torch.from_numpy(blocks), 4,
                               devices=["cpu"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("ch", "time"))
    jout = jts.time_sharded_run(jrx3, mesh, jnp.asarray(blocks), overlap=1)
    _check_against_jax(jout, out)


def test_all_feedforward_and_refusals(rx3, jrx3):
    rx1 = Receiver(0, stereo=True, rds=True, pll_tier=1)
    mono = Receiver(0)
    for port, ref in ((rx3, jrx3),
                      (rx1, JReceiver(0, stereo=True, rds=True, pll_tier=1)),
                      (mono, JReceiver(0))):
        assert tts._all_feedforward(port) == jts._all_feedforward(ref)
    assert tts._all_feedforward(rx3) and tts._all_feedforward(mono)
    assert not tts._all_feedforward(rx1)
    blocks = torch.from_numpy(_blocks(rx3, 6))
    cpu = dict(devices=["cpu"])
    with pytest.raises(ValueError, match="requires every carrier"):
        tts.time_sharded_run(rx1, blocks, 2, exact=True, **cpu)
    with pytest.raises(ValueError, match="not divisible by time shards"):
        tts.time_sharded_run(rx3, blocks, 4, **cpu)          # JAX: assert
    with pytest.raises(ValueError, match="not divisible by time shards"):
        tts.time_sharded_run_bank(rx3, blocks[None], 4, **cpu)
    with pytest.raises(ValueError, match="do not tile"):     # JAX: assert
        tts.time_sharded_run_bank(rx3, blocks[None].repeat(3, 1, 1), 2,
                                  devices=CPU2)
    with pytest.raises(ValueError, match="exact-mode only"):
        tts.time_sharded_run_bank(rx1, blocks[None], 2, **cpu)
    with pytest.raises(ValueError, match="overlap"):
        tts.time_sharded_run(rx3, blocks, 2, overlap=4, **cpu)
    with pytest.raises(ValueError, match="time shards do not tile"):
        tts.time_sharded_run(rx3, blocks, 3, devices=CPU2)
    # one shard is the sequential receiver itself
    out = tts.time_sharded_run(rx3, blocks, 1, **cpu)
    _, seq = rx3.run_blocks(rx3.init_state(1), blocks[None])
    _assert_trees_equal(out, tstate.map_state(seq, lambda x: x[0]))
    # a mono receiver has no carrier stage: sharded by history alone
    mb = torch.from_numpy(_blocks(mono, 4))
    out = tts.time_sharded_run(mono, mb, 2, **cpu)
    _, seq = mono.run_blocks(mono.init_state(1), mb[None])
    assert out.left is None and out.rds_bits is None
    assert _snr(seq.mono[0], out.mono) > 100.0


# -- approximate mode (tier 1) ----------------------------------------------

@pytest.fixture(scope="module")
def tier1_run():
    rx = Receiver(0, stereo=True, pll_tier=1)
    blocks = torch.from_numpy(_blocks(rx, 8))
    _, seq = rx.run_blocks(rx.init_state(1), blocks[None])
    return rx, blocks, seq


@pytest.mark.parametrize("overlap", [1, 2])
def test_time_sharding_approx_tier1(tier1_run, overlap):
    rx, blocks, seq = tier1_run
    out = tts.time_sharded_run(rx, blocks, 4, overlap=overlap,
                               devices=["cpu"])
    assert out.left.shape == seq.left[0].shape
    for shard in range(4):
        for j in range(1, 2):
            b = shard * 2 + j
            assert _snr(seq.left[0, b], out.left[b]) > 25.0, (shard, b)
    # shard 0 is the true head of the stream: no warm-up, no time jump
    torch.testing.assert_close(out.left[0], seq.left[0, 0], rtol=0, atol=0)


def test_time_sharding_approx_matches_jax(tier1_run):
    """The approximate mode against JAX's ``_approx_run`` on a 4-device
    time mesh: both warm each shard on its halo and keep shard 0 at the
    initial state, so every block agrees to what two f32 PLL recurrences
    leave (> 40 dB; each shard's first block, where the loop re-acquires,
    > 25 dB)."""
    rx, blocks, _ = tier1_run
    out = tts.time_sharded_run(rx, blocks, 4, devices=["cpu"])
    jrx = JReceiver(0, stereo=True, pll_tier=1)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("ch", "time"))
    jout = jts.time_sharded_run(jrx, mesh, jnp.asarray(blocks.numpy()),
                                exact=False)
    assert jout.left.shape == tuple(out.left.shape)
    for name in ("left", "right"):
        jref, got = np.asarray(getattr(jout, name)), getattr(out, name)
        for b in range(8):
            assert _snr(jref[b], got[b]) > (40.0 if b % 2 else 25.0), (name,
                                                                       b)


# -- joint channel x time ---------------------------------------------------

@pytest.mark.parametrize("devices", [["cpu"], CPU2, [CPU2, CPU2]],
                         ids=["one", "channels", "grid"])
def test_time_sharding_bank(rx3, devices):
    n_blocks = 8
    a = _blocks(rx3, n_blocks, ps_name="JOINT-A ", tone_left=440.0,
                tone_right=900.0)
    b = _blocks(rx3, n_blocks, ps_name="JOINT-B ", tone_left=600.0,
                tone_right=1500.0)
    blocks = torch.from_numpy(np.stack([a, b]))
    out = tts.time_sharded_run_bank(rx3, blocks, 4, devices=devices)
    assert out.left.shape == (2, n_blocks, rx3.cfg.audio_block)
    assert out.rds_nbits.shape == (2, n_blocks)
    for c in range(2):
        _, seq = rx3.run_blocks(rx3.init_state(1), blocks[c:c + 1])
        _check_exact(tstate.map_state(out, lambda x: x[c]), seq, n_blocks)
    assert int(out.rds_nbits.sum()) > 0


def test_time_sharding_bank_matches_jax(rx3, jrx3):
    """2 channels x 4 time shards against JAX's joint form on a (2, 4)
    mesh, per channel as the one-station case."""
    blocks = np.stack([
        _blocks(rx3, 8, ps_name="JOINT-A ", tone_left=440.0),
        _blocks(rx3, 8, ps_name="JOINT-B ", tone_left=600.0)])
    out = tts.time_sharded_run_bank(rx3, torch.from_numpy(blocks), 4,
                                    devices=["cpu"])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("ch", "time"))
    jout = jts.time_sharded_run_bank(jrx3, mesh, jnp.asarray(blocks))
    for c in range(2):
        _check_against_jax(jax.tree_util.tree_map(lambda x: x[c], jout),
                           tstate.map_state(out, lambda x: x[c]))


# -- ChannelBank over devices -----------------------------------------------

def test_channel_bank_over_devices(rx3, tmp_path):
    rows = np.stack([np.roll(_blocks(rx3, 2), 2 * 997 * c, axis=-1)
                     for c in range(4)])                     # (4, 2, blk)
    one, two = ChannelBank(rx3, 4), ChannelBank(rx3, 4, devices=CPU2)
    assert isinstance(one.init_state(), type(rx3.init_state(1)))
    st2 = two.init_state()
    assert type(st2) is tuple and len(st2) == 2
    assert st2[0].frontend.iq_tail.shape[0] == 2
    placed = two.place(rows[:, 0])
    assert type(placed) is tuple and placed[1].shape[0] == 2
    torch.testing.assert_close(placed[1], torch.from_numpy(rows[2:, 0]))
    placed3 = two.place(rows.transpose(1, 0, 2))             # (B, C, n)
    assert placed3[0].shape[:2] == (2, 2)
    # step, run, run_segment against the one-device bank: decisions equal,
    # floats to summation order
    s1, o1 = one.step(one.init_state(), one.place(rows[:, 0]))
    s2, o2 = two.step(st2, placed)
    _assert_trees_close(gather(o2), o1, 120.0)
    _assert_trees_close(gather(s2), s1, 120.0)
    s1, o1 = one.run(s1, one.place(rows.transpose(1, 0, 2)))
    s2, o2 = two.run(s2, rows.transpose(1, 0, 2))            # placed inside
    _assert_trees_close(gather(o2, axis=1), o1, 120.0)
    seg = rows.reshape(4, -1)
    s1, o1 = one.run_segment(s1, one.place(seg))
    s2, o2 = two.run_segment(s2, two.place(seg))
    _assert_trees_close(gather(o2), o1, 120.0)
    _assert_trees_close(gather(s2), s1, 120.0)
    # each replica alone is the receiver on its rows, bit for bit
    _, half = rx3.run_segment(rx3.init_state(2), torch.from_numpy(seg[2:]))
    _, o3 = two.run_segment(two.init_state(), two.place(seg))
    _assert_trees_equal(o3[1], half)
    assert gather(o1) is not None
    # the tuple state is a checkpoint as it is
    path = str(tmp_path / "bank")
    tstate.save_state(path, s2)
    back = tstate.load_state(path, two.init_state())
    assert type(back) is tuple
    _assert_trees_equal(back, s2)
    with pytest.raises(ValueError, match="do not tile"):
        ChannelBank(rx3, 3, devices=CPU2)
    with pytest.raises(ValueError, match="channel rows"):
        two.step(s2, rows[:3, 0])
    with pytest.raises(ValueError, match="several devices"):
        two.run_channelized(s2, None, None, None, None)


def test_channel_bank_over_devices_matches_jax(rx3, jrx3):
    """Two replicas against JAX's bank sharded over a 2-device mesh: a
    warm-up segment, then a segment from the carried state, per channel as
    the time-sharded case (audio and ``rds_clean`` > 60 dB, the decoded
    stream equal from its second bit on)."""
    rows = np.stack([np.roll(_blocks(rx3, 8), 2 * 997 * c, axis=-1)
                     for c in range(4)]).reshape(4, 2, -1)   # 2 x 4 blocks
    two = ChannelBank(rx3, 4, devices=CPU2)
    jbank = JChannelBank(jrx3, 4, Mesh(np.array(jax.devices()[:2]), ("ch",)))
    st, jst = two.init_state(), jbank.init_state()
    for k in range(2):
        st, out = two.run_segment(st, two.place(rows[:, k]))
        jst, jout = jbank.run_segment(jst, jbank.place(rows[:, k]))
    got = gather(out)
    assert int(got.rds_nbits.sum()) > 100
    for c in range(4):
        _check_against_jax(jax.tree_util.tree_map(lambda x: x[c], jout),
                           tstate.map_state(got, lambda x: x[c]))


# -- sharded wideband -------------------------------------------------------

@pytest.fixture(scope="module")
def wide(rx3):
    cfg = rx3.cfg
    wide_fs = 4 * cfg.rf_fs
    scene = [dict(offset_hz=o, ps_name=f"SHARD-{k}  "[:8], pi=0x5B00 + k,
                  pty=k + 1, tone_left=500.0 + 100 * k, tone_right=1300.0)
             for k, o in enumerate(RASTER4)]
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, 8)
    return wide_fs, iw, qw


def _halves(a):
    return a[:len(a) // 2], a[len(a) // 2:]


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "mix"])
def test_sharded_wideband_two_stage(rx3, jrx3, wide, fold):
    wide_fs, iw, qw = wide
    ch = Channelizer(rx3.cfg, wide_fs, RASTER4, fold=fold)
    sw = ShardedWideband(ch, rx3, devices=CPU2)
    assert [s.offsets for s in sw.shards] == [RASTER4[:2], RASTER4[2:]]
    assert sw.offsets == RASTER4
    bank = ChannelBank(rx3, 4)
    cs, bs = sw.init_state()
    cs_u, bs_u = ch.init_state(), bank.init_state()
    jch = mk_channelizer(jrx3.cfg, wide_fs, RASTER4, fold)
    mesh = Mesh(np.array(jax.devices()[:2]), ("ch",))
    jsw = jwb.ShardedWideband(jch, jrx3, mesh)
    jcs, jbs = jsw.init_state()
    # the port's two replicas fed JAX's own u8 station streams
    fed = ChannelBank(rx3, 4, devices=CPU2)
    fed_s, jcs_u = fed.init_state(), jch.init_state()
    for seg_no, (i_seg, q_seg) in enumerate(zip(_halves(iw), _halves(qw))):
        cs, bs, out = sw.step(cs, bs, i_seg, q_seg)       # numpy rails
        bs_u, out_u, cs_u = bank.run_channelized(
            bs_u, ch, torch.from_numpy(i_seg), torch.from_numpy(q_seg), cs_u)
        assert type(out) is tuple and out[0].left.shape[0] == 2
        got = gather(out)
        assert _snr(out_u.left, got.left) > 70.0
        assert _snr(out_u.right, got.right) > 70.0
        torch.testing.assert_close(got.rds_bits, out_u.rds_bits, rtol=0,
                                   atol=0)
        torch.testing.assert_close(got.rds_nbits, out_u.rds_nbits, rtol=0,
                                   atol=0)
        jcs, jbs, jout = jsw.step(jcs, jbs, i_seg, q_seg)
        ju8, jcs_u = jch.call_u8(jnp.asarray(i_seg), jnp.asarray(q_seg),
                                 jcs_u)
        fed_s, fed_out = fed.run_segment(fed_s, fed.place(np.array(ju8)))
        fed_out = gather(fed_out)
        # a cold segment opens on the channelizer's filter ramp, where the
        # discriminator sees a zero signal and two implementations give
        # different noise: past that first block, and from a carried
        # state, the port gives JAX's audio to 60 dB, from its own u8
        # station streams as from JAX's
        skip = rx3.cfg.audio_block if seg_no == 0 else 0
        for o in (got, fed_out):
            for name in ("left", "right"):
                jref, mine = np.asarray(getattr(jout, name)), getattr(o, name)
                assert _snr(jref, mine) > 40.0
                assert _snr(jref[:, skip:], mine[:, skip:]) > 60.0, (
                    seg_no, name)
    assert int(got.rds_nbits.sum()) > 0
    ju8, _ = jch.call_u8(jnp.asarray(i_seg), jnp.asarray(q_seg),
                         jch.init_state())
    u8 = torch.cat([sh.call_u8(torch.from_numpy(i_seg),
                               torch.from_numpy(q_seg), sh.init_state())[0]
                    for sh in sw.shards])
    diff = np.abs(np.asarray(ju8).astype(np.int32) - u8.numpy().astype(
        np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    _assert_trees_close(gather(bs), bs_u, 70.0)
    assert int(cs[0].pos) == int(cs[1].pos) == int(cs_u.pos)
    with pytest.raises(ValueError, match="do not tile"):    # JAX: assert
        ShardedWideband(Channelizer(rx3.cfg, wide_fs, RASTER4[:3]), rx3,
                        devices=CPU2)
    with pytest.raises(TypeError):
        ShardedWideband(rx3, rx3, devices=CPU2)


def test_sharded_fused_wideband_and_retune(rx3, jrx3, wide):
    wide_fs, iw, qw = wide
    cfg = rx3.cfg
    wf = FusedWidebandFrontend(cfg, wide_fs, RASTER4)
    sf = ShardedFusedWideband(wf, rx3, devices=CPU2)
    bank = ChannelBank(rx3, 4)
    ws, bs = sf.init_state()
    ws_u, bs_u = wf.init_state(), bank.init_state()
    assert ws[1].prev_i.shape == (2,)
    assert ws[1].i_tail.shape == ws_u.i_tail.shape
    jwf = JFused(jrx3.cfg, wide_fs, RASTER4, compute_dtype="f32")
    jsf = jwb.ShardedFusedWideband(
        jwf, jrx3, Mesh(np.array(jax.devices()[:2]), ("ch",)))
    jws, jbs = jsf.init_state()
    (i0, i1), (q0, q1) = _halves(iw), _halves(qw)
    ws, bs, out = sf.step(ws, bs, torch.from_numpy(i0), torch.from_numpy(q0))
    bs_u, out_u, ws_u = bank.run_channelized_fused(
        bs_u, wf, torch.from_numpy(i0), torch.from_numpy(q0), ws_u)
    got = gather(out)
    assert _snr(out_u.left, got.left) > 70.0
    jws, jbs, jout = jsf.step(jws, jbs, i0, q0)
    assert _snr(jout.left, got.left) > 60.0
    assert _snr(jout.right, got.right) > 60.0
    # retune station 2 (the second shard's first column) onto station 3's
    # transmitter: only that shard's weights change
    before = [s.w.clone() for s in sf.shards]
    twin = ShardedFusedWideband(wf, rx3, devices=CPU2)     # never retuned
    sf.retune(2, RASTER4[3])
    wf.retune(2, RASTER4[3])
    assert torch.equal(sf.shards[0].w, before[0])
    assert not torch.equal(sf.shards[1].w, before[1])
    assert sf.offsets == wf.offsets == RASTER4[:2] + [RASTER4[3]] * 2
    assert twin.offsets == RASTER4
    _, _, out_t = twin.step(ws, bs, i1, q1)
    ws, bs, out = sf.step(ws, bs, i1, q1)
    bs_u, out_u, ws_u = bank.run_channelized_fused(
        bs_u, wf, torch.from_numpy(i1), torch.from_numpy(q1), ws_u)
    got, got_t = gather(out), gather(out_t)
    for st in (0, 1, 3):                       # no other station moved
        torch.testing.assert_close(got.left[st], got_t.left[st], rtol=0,
                                   atol=0)
        torch.testing.assert_close(got.rds_bits[st], got_t.rds_bits[st],
                                   rtol=0, atol=0)
    assert _snr(got_t.left[2], got.left[2]) < 20.0
    assert _snr(out_u.left, got.left) > 70.0   # = the unsharded retune
    assert _snr(out_u.right, got.right) > 70.0
    torch.testing.assert_close(got.rds_bits, out_u.rds_bits, rtol=0, atol=0)
    torch.testing.assert_close(got.rds_nbits, out_u.rds_nbits, rtol=0, atol=0)
    assert int(got.rds_nbits.sum()) > 0
    with pytest.raises(ValueError, match="out of range"):
        sf.retune(4, 0)
    with pytest.raises(ValueError, match="do not tile"):    # JAX: assert
        ShardedFusedWideband(
            FusedWidebandFrontend(cfg, wide_fs, RASTER4[:3]), rx3,
            devices=CPU2)


# -- torch.distributed helpers ----------------------------------------------

def test_distributed_helpers_single_process():
    tdist.initialize()                          # one process: nothing to join
    tdist.initialize("127.0.0.1:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    jdist.initialize()
    assert tdist.host_channel_slice(6) == jdist.host_channel_slice(6)
    assert tdist.channel_devices(CPU2) == [torch.device("cpu")] * 2
    grid = tdist.channel_time_grid(2, ["cpu"] * 4)
    assert len(grid) == 2 and all(len(row) == 2 for row in grid)
    with pytest.raises(ValueError, match="do not split"):   # JAX: assert
        tdist.channel_time_grid(3, ["cpu"] * 4)
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize(num_processes=2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(code: str, n: int = 2, timeout: float = 240.0):
    """``n`` ranks of ``code`` (argv: port, rank) on localhost; every worker
    is killed when one fails or the time is up."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(port), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
        for rank in range(n)]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode(), err.decode()))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {rank} rc={rc}\n{err[-3000:]}"
        assert f"WORKER_OK {rank}" in out
    assert len(outs) == n


_WORKER_HEAD = textwrap.dedent("""
    import sys
    port, rank = sys.argv[1], int(sys.argv[2])
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from real_time_sdr_tpu_torch.models.receiver import Receiver
    from real_time_sdr_tpu_torch.parallel import distributed as D
    from real_time_sdr_tpu_torch.parallel import time_shard as T
    from real_time_sdr_tpu_torch.parallel.channel import ChannelBank, gather
    from real_time_sdr_tpu_torch.utils import synth

    def snr(ref, y):
        ref = ref.double()
        err = (y.double() - ref).pow(2).sum().item()
        return 10 * np.log10(ref.pow(2).sum().item() / max(err, 1e-300))

    D.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                 device="cpu", timeout_s=120)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cpu")
""")

_WORKER = _WORKER_HEAD + textwrap.dedent("""
    # channel bank: each rank feeds and decodes only its own rows
    C = 4
    iq, _ = synth.station_iq(rx.cfg, 1)          # the same on both ranks
    rows = torch.from_numpy(np.stack([np.roll(iq, 2 * 997 * c)
                                      for c in range(C)]))
    sl = D.host_channel_slice(C)
    assert sl == slice(2 * rank, 2 * rank + 2), sl
    try:
        D.host_channel_slice(3)
        raise SystemExit("an uneven split was accepted")
    except ValueError:
        pass
    bank = ChannelBank(rx, 2, devices=D.channel_devices(["cpu"]))
    _, out = bank.step(bank.init_state(), bank.place(rows[sl]))
    for j, c in enumerate(range(sl.start, sl.stop)):
        _, ref = rx.step(rx.init_state(1), rows[c:c + 1])
        assert snr(ref.left[0], out.left[j]) > 80, c

    # exact time sharding: each rank holds half of the timeline, the halo
    # crosses the process boundary
    B = 16
    iq, _ = synth.station_iq(rx.cfg, B, ps_name="2PROC-TS")
    blocks = torch.from_numpy(iq.reshape(B, -1))
    mine = D.host_channel_slice(B)
    out = T.time_sharded_run(rx, blocks[mine], shards=4, overlap=1,
                             devices=["cpu"], group=dist.group.WORLD)
    _, seq = rx.run_blocks(rx.init_state(1), blocks[None])
    assert out.left.shape[0] == B // 2
    for j, b in enumerate(range(mine.start, mine.stop)):
        assert snr(seq.left[0, b], out.left[j]) > 100, b
        assert snr(seq.right[0, b], out.right[j]) > 100, b
    assert torch.equal(out.rds_bits, seq.rds_bits[0, mine])
    assert torch.equal(out.rds_nbits, seq.rds_nbits[0, mine])
    assert int(seq.rds_nbits.sum()) > 0
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)
""")


def test_two_process_bank_and_time_sharding():
    """gloo, two ranks: ``initialize``, ``host_channel_slice``, a bank step
    on each rank's rows, and exact time sharding with the halo crossing the
    process boundary."""
    _run_workers(_WORKER)


_WORKER_JOINT = _WORKER_HEAD + textwrap.dedent("""
    B = 8
    rows = torch.from_numpy(np.stack([
        synth.station_iq(rx.cfg, B, ps_name=ps, tone_left=tl)[0].reshape(
            B, -1) for ps, tl in (("JOINT2PA", 440.0), ("JOINT2PB", 700.0))]))
    mine = D.host_channel_slice(B)
    out = T.time_sharded_run_bank(rx, rows[:, mine], shards=4,
                                  devices=[["cpu", "cpu"]],
                                  group=dist.group.WORLD)
    for c in range(2):
        _, seq = rx.run_blocks(rx.init_state(1), rows[c:c + 1])
        for j, b in enumerate(range(mine.start, mine.stop)):
            assert snr(seq.left[0, b], out.left[c, j]) > 100, (c, b)
        assert torch.equal(out.rds_bits[c], seq.rds_bits[0, mine])
        assert torch.equal(out.rds_nbits[c], seq.rds_nbits[0, mine])
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)
""")


@pytest.mark.slow
def test_two_process_joint_time_sharding():
    """The joint form over two ranks, each with a 1 x 2 device grid."""
    _run_workers(_WORKER_JOINT)


_WORKER_WIDE = _WORKER_HEAD + textwrap.dedent("""
    from real_time_sdr_tpu_torch.models.wideband_frontend import (
        FusedWidebandFrontend)
    from real_time_sdr_tpu_torch.parallel.wideband import ShardedFusedWideband
    cfg, wide_fs = rx.cfg, 4 * rx.cfg.rf_fs
    offs = [-450_000, -150_000, 150_000, 450_000]
    rng = np.random.default_rng(17)              # the same capture on both
    n = cfg.block_size_iq * 4
    iw, qw = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                               * 0.2) for _ in range(2))
    # stations split over processes: each rank builds its stations' shard
    sl = D.host_channel_slice(len(offs))
    wf = FusedWidebandFrontend(cfg, wide_fs, offs)
    sf = ShardedFusedWideband(wf.station_subset(sl), rx, devices=["cpu"])
    ws, bs = sf.init_state()
    _, _, out = sf.step(ws, bs, iw, qw)
    demod, _ = wf(iw, qw, wf.init_state())
    _, ref = rx.run_segment_demod(rx.init_state(len(offs)), demod)
    got = gather(out)
    assert snr(ref.left[sl], got.left) > 70
    assert torch.equal(got.rds_bits, ref.rds_bits[sl])
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_OK {rank}", flush=True)
""")


@pytest.mark.slow
def test_two_process_sharded_wideband():
    """Stations split over two ranks on one replicated capture."""
    _run_workers(_WORKER_WIDE)
