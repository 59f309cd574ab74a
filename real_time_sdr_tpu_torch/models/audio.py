"""Audio chains: mono extraction and stereo pilot-carrier matrixing.

Port of ``real_time_sdr_tpu/models/audio.py``. The stereo chain: pilot BPF
18.5-19.5 kHz -> carrier loop (tier 1 exact PLL, tier 2 its Newton twin,
tier 3 feedforward sync) -> 38 kHz carrier;
stereo BPF 22-54 kHz -> x carrier x2 -> baseband L-R; mono through an
all-pass delay for group-delay alignment; both rails resampled to the audio
rate in ONE kernel launch (the rails stacked as batch rows); L = M+S,
R = M-S.

The audio resampler is the direct-form decimating FIR where the mode does
not upsample (``cfg.audio_up == 1``: modes 0 and 1) and the polyphase FIR
bank otherwise (modes 2-3); the configuration alone decides, once, in
``_audio_resampler``. Both have the same call contract and carry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from real_time_sdr_tpu_torch import config as C
from real_time_sdr_tpu_torch.config import ReceiverConfig
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.ops.fir import (DecimatingFIR, PolyFIR,
                                             make_bank, state_len)
from real_time_sdr_tpu_torch.ops.pll import PllCarry, PllParams
from real_time_sdr_tpu_torch.ops.sync import FFSyncCarry, carrier_sync

__all__ = ["MonoState", "MonoPath", "StereoState", "StereoPath"]


def _audio_fir(cfg: ReceiverConfig) -> PolyFIR:
    """Polyphase audio LPF: designed at if_fs*up with taps*up and gain up."""
    up = cfg.audio_up
    h = filters.design_lpf(cfg.if_fs * up, cfg.audio_fc, cfg.rf_taps * up,
                           gain=up)
    return PolyFIR(h, up=up, down=cfg.audio_down)


def _audio_resampler(fir: PolyFIR) -> nn.Module:
    """The kernel site behind an audio FIR: ``(x, tail) -> ([y], tail)``."""
    return DecimatingFIR(fir) if fir.up == 1 else make_bank([fir])


def _zeros(batch: int, n: int, device) -> torch.Tensor:
    return torch.zeros((batch, n), dtype=torch.float32, device=device)


class MonoState(NamedTuple):
    audio_tail: torch.Tensor


class MonoPath(nn.Module):
    """fm_demod -> audio-rate mono samples (float; int16 in utils.audio)."""

    def __init__(self, cfg: ReceiverConfig):
        super().__init__()
        self.cfg = cfg
        self.audio_fir = _audio_fir(cfg)
        self.audio_bank = _audio_resampler(self.audio_fir)

    def init_state(self, batch: int) -> MonoState:
        return MonoState(_zeros(batch, self.audio_fir.tail_len,
                                self.audio_bank.taps.device))

    def forward(self, demod: torch.Tensor, state: MonoState):
        (audio,), tail = self.audio_bank(demod, state.audio_tail)
        return audio, MonoState(tail)


class StereoState(NamedTuple):
    # one tail serves both the pilot and stereo band BPFs (shared input)
    pilot_tail: torch.Tensor
    delay_tail: torch.Tensor
    mono_tail: torch.Tensor
    stereo_tail: torch.Tensor
    pll: FFSyncCarry | PllCarry   # tier 3 | tiers 1-2


class StereoPath(nn.Module):
    """fm_demod -> (left, right) audio via the 19 kHz pilot + DSB-SC mix."""

    def __init__(self, cfg: ReceiverConfig, pll_tier: int = 1):
        super().__init__()
        self.cfg = cfg
        fs_if = cfg.rf_fs // cfg.rf_decim
        self.pilot_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.PILOT_BAND, cfg.rf_taps))
        self.band_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.STEREO_BAND, cfg.rf_taps))
        self.delay_fir = PolyFIR(filters.design_apf(cfg.rf_taps))
        self.mono_fir = _audio_fir(cfg)   # serves both rails
        self.pb_bank = make_bank([self.pilot_fir, self.band_fir])
        self.resamp_bank = _audio_resampler(self.mono_fir)
        self.pll_params = PllParams(freq=int(C.PILOT_FREQ), fs=fs_if,
                                    nco_scale=2.0, norm_bw=C.PLL_BW_STEREO)
        self.sync = carrier_sync(self.pll_params, pll_tier)

    def init_state(self, batch: int) -> StereoState:
        dev = self.pb_bank.taps.device
        k = state_len(self.cfg.rf_taps)
        return StereoState(
            pilot_tail=_zeros(batch, k, dev), delay_tail=_zeros(batch, k, dev),
            mono_tail=_zeros(batch, self.mono_fir.tail_len, dev),
            stereo_tail=_zeros(batch, self.mono_fir.tail_len, dev),
            pll=self.sync.init(batch))

    def forward(self, demod: torch.Tensor, state: StereoState, shared=None):
        """shared: optional (pilot, band, new_tail) from the receiver's IF
        band bank, which the stereo and RDS band filters share."""
        if shared is not None:
            pilot, band, pilot_tail = shared
        else:
            (pilot, band), pilot_tail = self.pb_bank(demod, state.pilot_tail)
        carrier, pll = self.sync(pilot, state.pll)
        stereo_dc = 2.0 * band * carrier
        mono_delay, delay_tail = self.delay_fir(demod, state.delay_tail)
        rails = torch.stack([mono_delay, stereo_dc], dim=-2)    # (C, 2, n)
        tails = torch.stack([state.mono_tail, state.stereo_tail], dim=-2)
        (ys,), new_tails = self.resamp_bank(rails, tails)
        mono, sub = ys[..., 0, :], ys[..., 1, :]
        new_state = StereoState(pilot_tail, delay_tail,
                                new_tails[..., 0, :].contiguous(),
                                new_tails[..., 1, :].contiguous(), pll)
        return (mono + sub, mono - sub), new_state
