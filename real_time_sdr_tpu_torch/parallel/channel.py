"""Channel bank: many FM stations decoded at once.

Port of ``real_time_sdr_tpu/parallel/channel.py`` without a device mesh.
The receiver already batches channels natively (every tensor has a leading
channel axis), so the bank is a thin layer that ties the receiver to the
wideband frontends:

    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cuda")
    bank = ChannelBank(rx, 64)
    fe = make_wideband_frontend(cfg, wide_fs, offsets).to("cuda")
    state, fstate = bank.init_state(), fe.init_state()
    state, out, fstate = bank.run_wideband_u8(state, fe, raw_u8, fstate)
"""

from __future__ import annotations

import torch

from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.receiver import (Receiver,
                                                     ReceiverOutput,
                                                     ReceiverState)
from real_time_sdr_tpu_torch.models.wideband_frontend import (
    FusedWidebandFrontend, u8_to_rails)

__all__ = ["ChannelBank"]


class ChannelBank:
    """A bank of ``n_channels`` independent receivers on one device."""

    def __init__(self, rx: Receiver, n_channels: int):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        self.rx = rx
        self.n = int(n_channels)

    def init_state(self) -> ReceiverState:
        return self.rx.init_state(self.n)

    def place(self, arr) -> torch.Tensor:
        """A (C, ...) or (B, C, ...) channel-major array as a tensor on the
        receiver's device (one device: nothing to shard)."""
        return torch.as_tensor(arr).to(self.rx.device)

    def step(self, state: ReceiverState, blocks: torch.Tensor):
        """blocks: (C, 2*block_size_iq) uint8, one block per channel."""
        self._rows(blocks, "blocks")
        return self.rx.step(state, blocks)

    def run(self, state: ReceiverState, blocks: torch.Tensor):
        """blocks: (B, C, 2*block_size_iq) uint8: one ``step`` per block, in
        order. Returns (final_state, ReceiverOutput) with every output
        stacked on a leading block axis, e.g. left (B, C, audio_block),
        rds_nbits (B, C)."""
        if blocks.ndim != 3 or blocks.shape[0] == 0:
            raise ValueError(f"blocks must be (B, C, n) with B >= 1, got "
                             f"{tuple(blocks.shape)}")
        outs = []
        for b in range(blocks.shape[0]):
            state, out = self.step(state, blocks[b])
            outs.append(out)
        stacked = ReceiverOutput(*(
            None if leaves[0] is None else torch.stack(leaves, dim=0)
            for leaves in zip(*outs)))
        return state, stacked

    def _rows(self, x: torch.Tensor, what: str) -> None:
        if x.ndim != 2 or x.shape[0] != self.n:
            raise ValueError(f"{what} must have {self.n} channel rows, got "
                             f"{tuple(x.shape)}")

    def run_segment(self, state: ReceiverState, segments: torch.Tensor):
        """segments: (C, B*2*block_size_iq) uint8, one pass per segment (see
        ``Receiver.run_segment``)."""
        self._rows(segments, "segments")
        return self.rx.run_segment(state, segments)

    def run_segment_demod(self, state: ReceiverState, demod: torch.Tensor):
        """demod: (C, B*if_block) float32 from an external frontend."""
        self._rows(demod, "demod")
        return self.rx.run_segment_demod(state, demod)

    def run_channelized(self, state, ch: Channelizer, i_wide, q_wide,
                        cstate):
        """Wideband segment through the two-stage path: the channelizer's
        u8 station streams (``call_u8``, ending in the ``chan_epilogue``
        kernel on the card) feed ``run_segment``. Returns
        ``(state, out, cstate)``. The JAX counterpart is
        ``run_channelized_jit``."""
        u8, cstate = ch.call_u8(i_wide, q_wide, cstate)
        state, out = self.run_segment(state, u8)
        return state, out, cstate

    def run_channelized_fused(self, state, wf: FusedWidebandFrontend,
                              i_wide, q_wide, wstate):
        """Wideband segment through the fused frontend: one wide-rate matmul
        emits every station's IF demod, which feeds ``run_segment_demod``.
        The frontend reads its own weight buffers, which ``retune`` updates
        in stream order. The JAX counterpart is
        ``run_channelized_fused_jit``."""
        demod, wstate = wf(i_wide, q_wide, wstate)
        state, out = self.run_segment_demod(state, demod)
        return state, out, wstate

    def run_wideband(self, state, fe, i_wide, q_wide, festate):
        """Serving entry for either wideband frontend on f32 rails,
        dispatching on the object ``make_wideband_frontend`` built. The JAX
        counterpart is ``run_wideband_jit``."""
        if isinstance(fe, FusedWidebandFrontend):
            return self.run_channelized_fused(state, fe, i_wide, q_wide,
                                              festate)
        if not isinstance(fe, Channelizer):
            raise TypeError(f"not a wideband frontend: {type(fe).__name__}")
        return self.run_channelized(state, fe, i_wide, q_wide, festate)

    def run_wideband_u8(self, state, fe, raw_u8: torch.Tensor, festate):
        """Live-ingest entry: the interleaved raw uint8 capture (2N,) goes to
        the device as bytes and is split into rails there
        (``u8_to_rails``), then as ``run_wideband``. The JAX counterpart is
        ``run_wideband_u8_jit``."""
        i_wide, q_wide = u8_to_rails(raw_u8)
        return self.run_wideband(state, fe, i_wide, q_wide, festate)
