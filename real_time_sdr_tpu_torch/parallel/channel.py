"""Channel bank: many FM stations decoded at once, on one card or several.

Port of ``real_time_sdr_tpu/parallel/channel.py``. The receiver already
batches channels natively (every tensor has a leading channel axis), so the
bank is a thin layer that ties the receiver to the wideband frontends:

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    bank = ChannelBank(rx, 64)
    fe = make_wideband_frontend(cfg, wide_fs, offsets)
    state, fstate = bank.init_state(), fe.init_state()
    state, out, fstate = bank.run_wideband_u8(state, fe, raw_u8, fstate)

Where JAX shards the channel axis of one global array over a device mesh,
the port takes a list of devices: the channel axis is split in contiguous,
equal groups, one replica of the receiver per device, and the host loop
over the devices only enqueues work (nothing on the device path waits for
the host), so the cards run side by side. No collective is needed: channels
never interact.

    bank = ChannelBank(rx, 64, devices=["cuda:0", "cuda:1"])
    state = bank.init_state()                 # (ReceiverState, ReceiverState)
    state, out = bank.run_segment(state, bank.place(segments))
    left = gather(out).left                   # (64, n_audio) on the CPU

With several devices every state, input and output is a plain tuple with
one tree per device (``utils.state`` walks tuples, so ``save_state`` /
``load_state`` / ``map_state`` take it as it is); with one device everything
is the bare tree, as before. A device may be listed twice (two replicas on
one card).

The bank's own entries (``step``, ``run``, ``run_segment``,
``run_segment_demod``), the ``*_jit`` entries and ``run_segment_grouped``
are compiled in the JAX package: on the card each is one captured CUDA
graph per input shape (kept in the receiver's ``graphs``, one cache per
replica), replayed once per call and device, whose outputs are fresh
tensors; on the CPU they run their eager functions. ``_step``, ``_run``
and ``_run_segment_demod`` are the eager forms. ``run_segment_staged``
serves a bank of independent tuners from host-staged rows (the CLI's
``--tuners``); it has no counterpart in the JAX package.
"""

from __future__ import annotations

import functools

import torch

from real_time_sdr_tpu_torch.device import on_device, resolve_devices
from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.receiver import (Receiver,
                                                     ReceiverOutput,
                                                     ReceiverState)
from real_time_sdr_tpu_torch.models.wideband_frontend import (
    FusedWidebandFrontend, u8_to_rails)
from real_time_sdr_tpu_torch.utils.state import map_state

__all__ = ["ChannelBank", "split_rows", "gather", "grouped_step"]


def split_rows(n: int, devices: list, what: str = "channels") -> int:
    """Rows per device when ``n`` rows tile ``devices`` evenly; raises
    ``ValueError`` otherwise (the remainder rows would run nowhere)."""
    if n < 1 or n % len(devices):
        raise ValueError(f"{n} {what} do not tile {len(devices)} devices")
    return n // len(devices)


def gather(trees, device: str | torch.device = "cpu", axis: int = 0):
    """What ``ChannelBank.place`` split, joined again: per-device trees (a
    tuple, one tree per device) -> one tree on ``device`` with the leaves
    concatenated on ``axis``, the channel axis: 0 for states and segment
    outputs, 1 for the (B, C, ...) outputs of ``ChannelBank.run``. A bare
    tree is only moved."""
    if not isinstance(trees, tuple) or hasattr(trees, "_fields"):
        return map_state(trees, lambda t: t.to(device))
    return map_state(trees[0], lambda *leaves: torch.cat(
        [t.to(device) for t in leaves], dim=axis), *trees[1:])


class ChannelBank:
    """A bank of ``n_channels`` independent receivers.

    ``devices=None`` keeps the bank on the receiver's own device (the card,
    unless the receiver was built with ``device="cpu"``). A list of devices
    splits the channels over them in contiguous, equal groups; it raises
    ``ValueError`` when ``n_channels`` does not tile the list."""

    def __init__(self, rx: Receiver, n_channels: int, devices=None):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        self.rx = rx
        self.n = int(n_channels)
        self.devices = ([rx.device] if devices is None
                        else resolve_devices(devices))
        self.per = split_rows(self.n, self.devices)
        self.replicas = [rx.replica(d) for d in self.devices]
        self.sharded = len(self.devices) > 1

    def init_state(self):
        """A ``ReceiverState`` of n channels, or with several devices a
        tuple of them, ``n / len(devices)`` channels each."""
        if not self.sharded:
            return self.rx.init_state(self.n)
        return tuple(r.init_state(self.per) for r in self.replicas)

    def place(self, arr):
        """A (C, ...) or (B, C, ...) channel-major array as a tensor on the
        bank's device; with several devices a tuple of tensors, the channel
        axis (the second of an array of 3 or more axes) split by rows."""
        t = torch.as_tensor(arr)
        if not self.sharded:
            return t.to(self.devices[0])
        axis = 1 if t.ndim >= 3 else 0
        if t.shape[axis] != self.n:
            raise ValueError(f"array of shape {tuple(t.shape)} has no "
                             f"{self.n}-channel axis {axis}")
        return tuple(t.narrow(axis, k * self.per, self.per).to(
            d, non_blocking=True) for k, d in enumerate(self.devices))

    def _each(self, call, state, x):
        """``call(replica, state, rows)`` for every device on its state and
        its rows: the loop only enqueues, so the devices overlap."""
        if not self.sharded:
            return call(self.rx, state, x)
        if not isinstance(x, tuple):
            x = self.place(x)
        if len(state) != len(self.devices) or len(x) != len(self.devices):
            raise ValueError(f"expected one state and one input per device "
                             f"({len(self.devices)}), got {len(state)} and "
                             f"{len(x)}")
        res = []
        for r, d, st, xk in zip(self.replicas, self.devices, state, x):
            with on_device(d):
                res.append(call(r, st, xk))
        return tuple(s for s, _ in res), tuple(o for _, o in res)

    def step(self, state, blocks):
        """blocks: (C, 2*block_size_iq) uint8, one block per channel (with
        several devices: ``place``'s tuple, or the whole array). Each
        replica's ``jit_step``."""
        self._rows(blocks, "blocks")
        return self._each(Receiver.jit_step, state, blocks)

    def _step(self, state, x):
        """The eager form of ``step`` and ``run_segment``."""
        self._rows(x, "rows")
        return self._each(Receiver.step, state, x)

    def run(self, state, blocks):
        """blocks: (B, C, 2*block_size_iq) uint8: one ``step`` per block, in
        order, the whole loop one graph per device. Returns (final_state,
        ReceiverOutput) with every output stacked on a leading block axis,
        e.g. left (B, C, audio_block), rds_nbits (B, C)."""
        return self._each(
            lambda rx, st, x: rx.graphs(functools.partial(self._run_one, rx),
                                        ("bank_run",), st, x),
            state, blocks)

    def _run(self, state, blocks):
        """The eager form of ``run``."""
        return self._each(self._run_one, state, blocks)

    @staticmethod
    def _run_one(rx: Receiver, state: ReceiverState, blocks: torch.Tensor):
        if blocks.ndim != 3 or blocks.shape[0] == 0:
            raise ValueError(f"blocks must be (B, C, n) with B >= 1, got "
                             f"{tuple(blocks.shape)}")
        outs = []
        for b in range(blocks.shape[0]):
            state, out = rx.step(state, blocks[b])
            outs.append(out)
        stacked = ReceiverOutput(*(
            None if leaves[0] is None else torch.stack(leaves, dim=0)
            for leaves in zip(*outs)))
        return state, stacked

    def _rows(self, x, what: str) -> None:
        rows = (sum(t.shape[0] for t in x) if isinstance(x, tuple)
                else x.shape[0])
        ndim = x[0].ndim if isinstance(x, tuple) else x.ndim
        if ndim != 2 or rows != self.n:
            raise ValueError(f"{what} must have {self.n} channel rows of one "
                             f"axis each, got {rows} rows of {ndim - 1} axes")

    def run_segment(self, state, segments):
        """segments: (C, B*2*block_size_iq) uint8, one pass per segment (see
        ``Receiver.run_segment``): each replica's ``jit_step``."""
        self._rows(segments, "segments")
        return self._each(Receiver.jit_step, state, segments)

    def run_segment_staged(self, state, staged, n2: int):
        """staged: (C, rx.frontend.staged_len(n2)) uint8, each row ``[tail
        | segment]`` as ``Frontend.stage_segment`` writes it for an
        ``n2``-byte segment (with several devices: ``place``'s tuple, or
        the whole array): each replica's ``jit_run_segment_staged``.
        Equal to ``run_segment`` on the embedded segments."""
        self._rows(staged, "staged rows")
        return self._each(
            lambda rx, st, x: rx.jit_run_segment_staged(st, x, n2),
            state, staged)

    def run_segment_grouped(self, state, segments, group: int = 32):
        """``run_segment`` as sequential sub-batches of ``group`` channels
        (per device), all in one graph on the card: each sub-batch's
        working set stays at ``group`` rows. Equal to ``run_segment``: the
        channels never interact. A ``group`` of at least the rows is one
        ``jit_step``; one that does not divide them raises ``ValueError``."""
        self._rows(segments, "segments")
        group = int(group)
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        if group < self.per and self.per % group:
            raise ValueError(f"group {group} does not divide the {self.per} "
                             "channels of each device")

        def call(rx: Receiver, st, seg):
            if group >= seg.shape[0]:
                return rx.jit_step(st, seg)
            return rx.graphs(functools.partial(grouped_step, rx, group),
                             ("run_segment_grouped", group), st, seg)
        return self._each(call, state, segments)

    def run_segment_demod(self, state, demod):
        """demod: (C, B*if_block) float32 from an external frontend, one
        graph per device."""
        self._rows(demod, "demod")
        return self._each(
            lambda rx, st, d: rx.graphs(rx.run_segment_demod,
                                        ("run_segment_demod",), st, d),
            state, demod)

    def _run_segment_demod(self, state, demod):
        """The eager form of ``run_segment_demod``."""
        self._rows(demod, "demod")
        return self._each(Receiver.run_segment_demod, state, demod)

    def _one_device(self, what: str) -> None:
        if self.sharded:
            raise ValueError(
                f"{what} feeds one frontend on one device; over several "
                "devices use parallel.wideband.ShardedWideband / "
                "ShardedFusedWideband, which split the frontend too")

    def run_channelized(self, state, ch: Channelizer, i_wide, q_wide,
                        cstate):
        """Wideband segment through the two-stage path: the channelizer's
        u8 station streams (``call_u8``, ending in the ``chan_epilogue``
        kernel on the card) feed ``run_segment``. Returns
        ``(state, out, cstate)``; ``run_channelized_jit`` is its graph."""
        self._one_device("run_channelized")
        u8, cstate = ch.call_u8(i_wide, q_wide, cstate)
        state, out = self._step(state, u8)
        return state, out, cstate

    def run_channelized_fused(self, state, wf: FusedWidebandFrontend,
                              i_wide, q_wide, wstate):
        """Wideband segment through the fused frontend: one wide-rate matmul
        emits every station's IF demod, which feeds ``run_segment_demod``.
        The frontend reads its own weight buffers, which ``retune`` updates
        in stream order; ``run_channelized_fused_jit`` is its graph."""
        self._one_device("run_channelized_fused")
        demod, wstate = wf(i_wide, q_wide, wstate)
        state, out = self._run_segment_demod(state, demod)
        return state, out, wstate

    def run_wideband(self, state, fe, i_wide, q_wide, festate):
        """Either wideband frontend on f32 rails, dispatching on the object
        ``make_wideband_frontend`` built; ``run_wideband_jit`` is its
        graph."""
        if isinstance(fe, FusedWidebandFrontend):
            return self.run_channelized_fused(state, fe, i_wide, q_wide,
                                              festate)
        if not isinstance(fe, Channelizer):
            raise TypeError(f"not a wideband frontend: {type(fe).__name__}")
        return self.run_channelized(state, fe, i_wide, q_wide, festate)

    def run_wideband_u8(self, state, fe, raw_u8: torch.Tensor, festate):
        """Live-ingest entry: the interleaved raw uint8 capture (2N,) goes to
        the device as bytes and is split into rails there
        (``u8_to_rails``), then as ``run_wideband``;
        ``run_wideband_u8_jit`` is its graph."""
        i_wide, q_wide = u8_to_rails(raw_u8)
        return self.run_wideband(state, fe, i_wide, q_wide, festate)

    # -- the serving entries: one graph per frontend and input shape --------
    # The frontend is part of the key and the graph reads its buffers where
    # they are, so a FusedWidebandFrontend.retune, which rewrites them in
    # place, takes effect at the next replay.

    def _jit(self, name: str, fn, fe, *args):
        self._one_device(name)
        return self.rx.graphs(fn, (name, id(fe)), *args)

    def run_channelized_jit(self, state, ch: Channelizer, i_wide, q_wide,
                            cstate):
        """``run_channelized`` as one graph replay per call on the card."""
        return self._jit(
            "run_channelized_jit",
            lambda s, i, q, c: self.run_channelized(s, ch, i, q, c),
            ch, state, i_wide, q_wide, cstate)

    def run_channelized_fused_jit(self, state, wf: FusedWidebandFrontend,
                                  i_wide, q_wide, wstate):
        """``run_channelized_fused`` as one graph replay per call on the
        card."""
        return self._jit(
            "run_channelized_fused_jit",
            lambda s, i, q, w: self.run_channelized_fused(s, wf, i, q, w),
            wf, state, i_wide, q_wide, wstate)

    def run_wideband_jit(self, state, fe, i_wide, q_wide, festate):
        """``run_wideband`` as one graph replay per call on the card."""
        return self._jit(
            "run_wideband_jit",
            lambda s, i, q, f: self.run_wideband(s, fe, i, q, f),
            fe, state, i_wide, q_wide, festate)

    def run_wideband_u8_jit(self, state, fe, raw_u8: torch.Tensor, festate):
        """``run_wideband_u8`` as one graph replay per call on the card:
        the deinterleave, the frontend and the bank in one graph."""
        return self._jit(
            "run_wideband_u8_jit",
            lambda s, raw, f: self.run_wideband_u8(s, fe, raw, f),
            fe, state, raw_u8, festate)


def grouped_step(rx: Receiver, group: int, state: ReceiverState,
                 segments: torch.Tensor):
    """The eager form of ``ChannelBank.run_segment_grouped`` on one
    device: ``rx.step`` over consecutive ``group``-row sub-batches, the
    states and outputs joined again on the channel axis."""
    parts = [rx.step(map_state(state, lambda t: t[k:k + group]),
                     segments[k:k + group])
             for k in range(0, segments.shape[0], group)]
    return map_state(parts[0], lambda *leaves: torch.cat(leaves),
                     *parts[1:])
