"""RF front end: u8 IQ rows -> FM-demodulated IF rows.

Port of ``real_time_sdr_tpu/models/frontend.py`` with the same state
contract: a raw u8 interleaved tail of 2K-2 bytes (byte 128 is the
zero-signal byte) plus the carried discriminator samples (prev_i, prev_q).
On the card the whole stage is one fused kernel launch
(ops/cuda/frontend_fused.py); on the CPU it runs DualPhaseFIR + fm_demod.

Host-staged ingest: ``stage_segment`` writes ``[tail | segment]`` on the
host (into a pinned buffer, for one asynchronous upload), and
``call_staged`` hands that operand to the kernel as it is, so the device
runs no ``torch.cat`` of the tail and the segment. The staged operand is
byte for byte the one ``forward`` builds, so staged and unstaged calls give
identical results and interleave freely.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from real_time_sdr_tpu_torch.config import ReceiverConfig
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import frontend_fused
from real_time_sdr_tpu_torch.ops.fir import DualPhaseFIR

__all__ = ["FrontendState", "Frontend"]


class FrontendState(NamedTuple):
    iq_tail: torch.Tensor  # (C, 2K-2) u8 interleaved overlap-save tail
    prev_i: torch.Tensor   # (C,) f32 carried discriminator samples
    prev_q: torch.Tensor


class Frontend(nn.Module):
    """Per call: normalize, LPF + decimate I/Q, discriminate."""

    def __init__(self, cfg: ReceiverConfig):
        super().__init__()
        self.cfg = cfg
        h_rf = filters.design_lpf(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps)
        self.rf_fir = DualPhaseFIR(h_rf, down=cfg.rf_decim)

    @property
    def tail_len(self) -> int:
        return self.rf_fir.tail_len

    def cost(self, n2: int) -> dict:
        """Work of the fused stage on an n2-byte interleaved u8 block of one
        row: the u8 bytes and their tail read once, the f32 demod written
        once, K multiply-adds per output for I and for Q, and the taps once
        per launch (``ops/fir.py`` has the dict's keys)."""
        fir = self.rf_fir
        n_out = fir.n_out(n2)
        w_bytes = 4 * fir.num_taps
        return {"kind": "fused_u8",
                "flops": fir.cost(n2)["flops"],
                "bytes": self.tail_len + n2 + 4 * n_out + w_bytes,
                "w_bytes": w_bytes, "dims": (n_out, fir.num_taps, 2)}

    def staged_len(self, n2: int) -> int:
        """Length of the host-staged operand of an n2-byte segment:
        [tail (2K-2) | segment (n2)]."""
        return self.tail_len + n2

    def stage_segment(self, prev_tail_u8, seg_u8, out=None) -> np.ndarray:
        """HOST staging (numpy, leading batch dims allowed): write
        ``[prev_tail | segment]`` into ``out`` when given (e.g. the numpy
        view of a pinned torch buffer, so the upload is one asynchronous
        copy), else into a new array. Returns the staged operand."""
        prev_tail_u8 = np.asarray(prev_tail_u8)
        seg_u8 = np.asarray(seg_u8)
        if prev_tail_u8.dtype != np.uint8 or seg_u8.dtype != np.uint8:
            raise TypeError(f"stage_segment takes uint8 bytes, got "
                            f"{prev_tail_u8.dtype} and {seg_u8.dtype}")
        tl = self.tail_len
        lead = seg_u8.shape[:-1]
        if prev_tail_u8.shape != lead + (tl,):
            raise ValueError(f"the tail must be {lead + (tl,)} bytes, got "
                             f"{prev_tail_u8.shape}")
        shape = lead + (self.staged_len(seg_u8.shape[-1]),)
        if out is None:
            out = np.empty(shape, dtype=np.uint8)
        elif out.shape != shape or out.dtype != np.uint8:
            raise ValueError(f"out must be {shape} uint8, got {out.dtype} "
                             f"{out.shape}")
        out[..., :tl] = prev_tail_u8
        out[..., tl:] = seg_u8
        return out

    def call_staged(self, xp_u8: torch.Tensor, n2: int,
                    state: FrontendState):
        """Staged twin of ``forward``: ``xp_u8`` (C, staged_len(n2)) u8 on
        the device already holds the tail, so it goes to the kernel as it
        is. ``state.iq_tail`` is ignored on entry (the operand embeds the
        tail); the returned state is ``forward``'s, so staged and unstaged
        calls interleave freely. Returns (demod, new_state)."""
        if not isinstance(xp_u8, torch.Tensor):
            raise TypeError(f"call_staged takes one (C, staged_len) uint8 "
                            f"tensor, got {type(xp_u8).__name__} (the "
                            "rows/boundary/tail forms are not ported)")
        if xp_u8.dtype != torch.uint8 or xp_u8.ndim != 2:
            raise TypeError(f"the staged operand must be (C, L) uint8, got "
                            f"{xp_u8.dtype} {tuple(xp_u8.shape)}")
        if xp_u8.shape[-1] != self.staged_len(n2):
            raise ValueError(f"the staged operand of an n2={n2}-byte segment "
                             f"is {self.staged_len(n2)} bytes long, got "
                             f"{xp_u8.shape[-1]}")
        return self._run(xp_u8, state)

    def init_state(self, batch: int) -> FrontendState:
        dev = self.rf_fir.taps.device
        z = torch.full((batch, self.tail_len), 128, dtype=torch.uint8,
                       device=dev)
        s = torch.zeros((batch,), dtype=torch.float32, device=dev)
        return FrontendState(z, s, s.clone())

    def forward(self, iq_u8: torch.Tensor, state: FrontendState):
        """iq_u8: (C, 2*nb*block_size_iq) u8 interleaved I,Q.

        Returns (demod (C, nb*if_block) f32, new_state)."""
        return self._run(torch.cat([state.iq_tail, iq_u8], dim=-1), state)

    def _run(self, xx: torch.Tensor, state: FrontendState):
        """The kernel on the tail-prefixed rows ``xx``."""
        demod, prev_i, prev_q = frontend_fused(xx, self.rf_fir, state.prev_i,
                                               state.prev_q)
        # a copy: a staged operand is the caller's buffer, which it may
        # reuse while the state lives on
        iq_tail = xx[:, xx.shape[-1] - self.tail_len:].clone(
            memory_format=torch.contiguous_format)
        return demod, FrontendState(iq_tail, prev_i, prev_q)
