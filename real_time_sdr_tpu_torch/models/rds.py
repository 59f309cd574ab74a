"""RDS chain: 57 kHz BPSK subcarrier -> RRC-clean samples -> decoded bits.

Port of ``real_time_sdr_tpu/models/rds.py`` (tier 3, comb timing):

  BPF 54-60 kHz -> square -> BPF 113.5-114.5 kHz -> feedforward sync
  (114 kHz, nco_scale 0.5) -> 57 kHz carrier -> APF delay-match -> x2 mix
  -> resample to sps*2375 S/s -> RRC -> comb CDR + slice + Manchester +
  differential decode (ops.rds_bits)

In segment mode the wideband stages run over the whole segment, while the
narrowband tail keeps exact per-block semantics: block b's FIR tail is a
slice of block b-1's data, so every (channel, block) becomes one batch row
of the 247/640 and RRC banks, and the slicer decodes all blocks at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from real_time_sdr_tpu import config as C
from real_time_sdr_tpu.config import ReceiverConfig
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank, state_len
from real_time_sdr_tpu_torch.ops.pll import PllParams
from real_time_sdr_tpu_torch.ops.rds_bits import (BitSyncState, bit_sync_init,
                                                  decode_block_bits,
                                                  decode_segment_bits)
from real_time_sdr_tpu_torch.ops.sync import FeedforwardSync, FFSyncCarry

__all__ = ["RdsState", "RdsPath"]

WARM_AFTER = 5  # the decoder starts once block_count > 5 (reference gate)


class RdsState(NamedTuple):
    band_tail: torch.Tensor
    pilot_tail: torch.Tensor
    delay_tail: torch.Tensor
    baseband_tail: torch.Tensor
    rrc_tail: torch.Tensor
    pll: FFSyncCarry
    bits: BitSyncState
    block_count: torch.Tensor  # (C,) int32
    track: None = None         # tracking-CDR carry (not ported)


class RdsPath(nn.Module):
    """fm_demod -> (bits, n_bits, rds_clean)."""

    def __init__(self, cfg: ReceiverConfig, pll_tier: int = 3):
        super().__init__()
        if pll_tier != 3:
            raise NotImplementedError(
                f"pll_tier={pll_tier}: only tier 3 (feedforward sync) is "
                "ported")
        self.cfg = cfg
        fs_if = cfg.if_fs
        up, down = cfg.rds_resample
        self.band_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.RDS_BAND, cfg.rf_taps))
        self.pilot_fir = PolyFIR(
            filters.design_bpf(fs_if, *C.RDS_SQUARED_BAND, cfg.rf_taps))
        self.delay_fir = PolyFIR(filters.design_apf(cfg.rf_taps))
        self.baseband_fir = PolyFIR(
            filters.design_lpf(fs_if * up, 3_000.0, cfg.rf_taps * up,
                               gain=up),
            up=up, down=down)
        self.rrc_fir = PolyFIR(
            filters.design_rrc(cfg.rds_fs, cfg.rf_taps,
                               symbol_rate=C.RDS_SYMBOL_RATE,
                               beta=C.RDS_RRC_BETA))
        self.band_bank = make_bank([self.band_fir])
        self.pilot_bank = make_bank([self.pilot_fir])
        self.baseband_bank = make_bank([self.baseband_fir])
        self.rrc_bank = make_bank([self.rrc_fir])
        self.pll_params = PllParams(freq=int(C.RDS_PILOT_FREQ), fs=fs_if,
                                    nco_scale=0.5)
        # narrower smoothing matches the RDS loop's 10x narrower bandwidth
        self.sync = FeedforwardSync(self.pll_params, smooth_taps=129)

    def init_state(self, batch: int) -> RdsState:
        dev = self.band_bank.taps.device
        t = lambda n: torch.zeros((batch, n), dtype=torch.float32,
                                  device=dev)
        k = state_len(self.cfg.rf_taps)
        return RdsState(
            band_tail=t(k), pilot_tail=t(k), delay_tail=t(k),
            baseband_tail=t(self.baseband_fir.tail_len),
            rrc_tail=t(self.rrc_fir.tail_len),
            pll=self.sync.init(batch),
            bits=bit_sync_init(batch, device=dev),
            block_count=torch.zeros((batch,), dtype=torch.int32, device=dev))

    def forward(self, demod: torch.Tensor, state: RdsState, band_pre=None):
        """demod: (C, nb*if_block). band_pre: optional (band, new_tail) from
        the receiver's IF band bank.

        Returns ((bits, n_bits, clean), state): (C, max_bits), (C,),
        (C, rds_block) for one block; with a block axis after C for nb > 1.
        """
        cfg = self.cfg
        n_ch = demod.shape[0]
        nb = demod.shape[-1] // cfg.if_block
        if band_pre is not None:
            band, band_tail = band_pre
        else:
            (band,), band_tail = self.band_bank(demod, state.band_tail)
        squared = band * band
        (pilot,), pilot_tail = self.pilot_bank(squared, state.pilot_tail)
        carrier, pll = self.sync(pilot, state.pll)
        delayed, delay_tail = self.delay_fir(band, state.delay_tail)
        mixed = 2.0 * delayed * carrier

        if nb == 1:
            (filt,), baseband_tail = self.baseband_bank(mixed,
                                                        state.baseband_tail)
            (clean,), rrc_tail = self.rrc_bank(filt, state.rrc_tail)
            bits, n_bits, new_bits = decode_block_bits(
                clean, state.bits, cfg.sps, cfg.max_symbols, cfg.max_bits)
            warm = state.block_count > WARM_AFTER
            n_bits = torch.where(warm, n_bits, 0)
            bit_state = BitSyncState(*(torch.where(warm, new, old)
                                       for new, old in zip(new_bits,
                                                           state.bits)))
            new_state = RdsState(band_tail, pilot_tail, delay_tail,
                                 baseband_tail, rrc_tail, pll, bit_state,
                                 state.block_count + 1)
            return (bits, n_bits, clean), new_state

        tl_bb = self.baseband_fir.tail_len
        tl_rrc = self.rrc_fir.tail_len
        mixed_blocks = mixed.reshape(n_ch, nb, cfg.if_block)
        bb_tails = torch.cat([state.baseband_tail[:, None],
                              mixed_blocks[:, :-1, cfg.if_block - tl_bb:]],
                             dim=1)
        (filt,), _ = self.baseband_bank(mixed_blocks, bb_tails)
        n_filt = filt.shape[-1]
        rrc_tails = torch.cat([state.rrc_tail[:, None],
                               filt[:, :-1, n_filt - tl_rrc:]], dim=1)
        (clean,), _ = self.rrc_bank(filt, rrc_tails)
        bits, n_bits, bit_state = decode_segment_bits(
            clean, state.bits, state.block_count, cfg.sps, cfg.max_symbols,
            cfg.max_bits, warm_after=WARM_AFTER)
        new_state = RdsState(
            band_tail, pilot_tail, delay_tail,
            mixed_blocks[:, -1, cfg.if_block - tl_bb:].contiguous(),
            filt[:, -1, n_filt - tl_rrc:].contiguous(), pll, bit_state,
            state.block_count + nb)
        return (bits, n_bits, clean), new_state
