"""RF front end: u8 IQ rows -> FM-demodulated IF rows.

Port of ``real_time_sdr_tpu/models/frontend.py`` with the same state
contract: a raw u8 interleaved tail of 2K-2 bytes (byte 128 is the
zero-signal byte) plus the carried discriminator samples (prev_i, prev_q).
On the card the whole stage is one fused kernel launch
(ops/cuda/frontend_fused.py); on the CPU it runs DualPhaseFIR + fm_demod.
"""

from __future__ import annotations

from typing import NamedTuple

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

    def init_state(self, batch: int) -> FrontendState:
        dev = self.rf_fir.taps.device
        z = torch.full((batch, self.tail_len), 128, dtype=torch.uint8,
                       device=dev)
        s = torch.zeros((batch,), dtype=torch.float32, device=dev)
        return FrontendState(z, s, s.clone())

    def forward(self, iq_u8: torch.Tensor, state: FrontendState):
        """iq_u8: (C, 2*nb*block_size_iq) u8 interleaved I,Q.

        Returns (demod (C, nb*if_block) f32, new_state)."""
        xx = torch.cat([state.iq_tail, iq_u8], dim=-1)
        demod, prev_i, prev_q = frontend_fused(xx, self.rf_fir, state.prev_i,
                                               state.prev_q)
        iq_tail = xx[:, xx.shape[-1] - self.tail_len:].contiguous()
        return demod, FrontendState(iq_tail, prev_i, prev_q)
