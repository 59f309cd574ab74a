"""RDS chain: 57 kHz BPSK subcarrier -> RRC-clean samples -> decoded bits.

Port of ``real_time_sdr_tpu/models/rds.py``:

  BPF 54-60 kHz -> square -> BPF 113.5-114.5 kHz -> carrier loop (114 kHz,
  nco_scale 0.5; tier 1 exact PLL, tier 2 Newton, tier 3 feedforward sync)
  -> 57 kHz carrier -> APF delay-match -> x2 mix -> resample to
  sps*2375 S/s -> RRC -> CDR + slice + Manchester + differential decode
  (ops.rds_bits)

The CDR is the reference's per-block comb (``timing="comb"``) or the
drift-following interpolating CDR (``timing="tracked"``). In segment mode
the wideband stages run over the whole segment, while the narrowband tail
keeps exact per-block semantics: block b's FIR tail is a slice of block
b-1's data, so every (channel, block) becomes one batch row of the
resampler and RRC banks. The comb slicer decodes all blocks at once; the
tracked CDR runs block by block, as the JAX package's scan does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from real_time_sdr_tpu_torch import config as C
from real_time_sdr_tpu_torch.config import ReceiverConfig
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank, state_len
from real_time_sdr_tpu_torch.ops.pll import PllCarry, PllParams
from real_time_sdr_tpu_torch.ops.rds_bits import (BitSyncState, TimingTrack,
                                                  bit_sync_init,
                                                  decode_block_bits,
                                                  decode_block_bits_tracked,
                                                  decode_segment_bits,
                                                  timing_init)
from real_time_sdr_tpu_torch.ops.sync import FFSyncCarry, carrier_sync

__all__ = ["RdsState", "RdsPath"]

WARM_AFTER = 5  # the decoder starts once block_count > 5 (reference gate)


class RdsState(NamedTuple):
    band_tail: torch.Tensor
    pilot_tail: torch.Tensor
    delay_tail: torch.Tensor
    baseband_tail: torch.Tensor
    rrc_tail: torch.Tensor
    pll: FFSyncCarry | PllCarry    # tier 3 | tiers 1-2
    bits: BitSyncState
    block_count: torch.Tensor      # (C,) int32
    track: TimingTrack | None = None  # tracking-CDR carry (timing tracked)


class RdsPath(nn.Module):
    """fm_demod -> (bits, n_bits, rds_clean)."""

    def __init__(self, cfg: ReceiverConfig, pll_tier: int = 1,
                 timing: str = "comb"):
        super().__init__()
        if timing not in ("comb", "tracked"):
            raise ValueError(f"timing must be 'comb' or 'tracked', got "
                             f"{timing!r}")
        self.timing = timing
        # False: the DSP half runs and ``rds_clean`` comes out, but the
        # slicer is skipped (bits and n_bits are zeros, the decoder's state
        # and ``track`` hold, ``block_count`` still advances). Time sharding
        # decodes the gathered ``rds_clean`` stream once instead.
        self.emit_bits = True
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
                                    nco_scale=0.5, norm_bw=C.PLL_BW_RDS)
        # narrower smoothing matches the RDS loop's 10x narrower bandwidth
        self.sync = carrier_sync(self.pll_params, pll_tier, smooth_taps=129)

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
            block_count=torch.zeros((batch,), dtype=torch.int32, device=dev),
            track=(timing_init(batch, device=dev)
                   if self.timing == "tracked" else None))

    def _decode_one(self, clean: torch.Tensor, bit_state: BitSyncState,
                    track, block_count: torch.Tensor):
        """One block per channel, clean (C, rds_block), with the
        reference's 5-block warm-up gate: before warm-up the decoder's
        state holds. The tracked timing loop is not gated (it locks during
        warm-up)."""
        cfg = self.cfg
        if not self.emit_bits:
            return (*self._no_bits(clean.shape[:-1], clean.device),
                    bit_state, track)
        if self.timing == "tracked":
            bits, n_bits, new_bits, track = decode_block_bits_tracked(
                clean, bit_state, track, cfg.sps, cfg.max_symbols,
                cfg.max_bits)
        else:
            bits, n_bits, new_bits = decode_block_bits(
                clean, bit_state, cfg.sps, cfg.max_symbols, cfg.max_bits)
        warm = block_count > WARM_AFTER
        n_bits = torch.where(warm, n_bits, 0)
        new_bits = BitSyncState(*(torch.where(warm, new, old)
                                  for new, old in zip(new_bits, bit_state)))
        return bits, n_bits, new_bits, track

    def _no_bits(self, lead, device):
        """Constant (bits, n_bits) of the usual shapes behind ``lead``."""
        return (torch.zeros((*lead, self.cfg.max_bits), dtype=torch.int32,
                            device=device),
                torch.zeros(tuple(lead), dtype=torch.int32, device=device))

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
            bits, n_bits, bit_state, track = self._decode_one(
                clean, state.bits, state.track, state.block_count)
            new_state = RdsState(band_tail, pilot_tail, delay_tail,
                                 baseband_tail, rrc_tail, pll, bit_state,
                                 state.block_count + 1, track)
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
        track = state.track
        if not self.emit_bits:
            bits, n_bits = self._no_bits((n_ch, nb), clean.device)
            bit_state = state.bits
        elif self.timing == "comb":
            bits, n_bits, bit_state = decode_segment_bits(
                clean, state.bits, state.block_count, cfg.sps,
                cfg.max_symbols, cfg.max_bits, warm_after=WARM_AFTER)
        else:
            bit_state, out = state.bits, []
            for b in range(nb):
                bits_b, n_b, bit_state, track = self._decode_one(
                    clean[:, b], bit_state, track, state.block_count + b)
                out.append((bits_b, n_b))
            bits = torch.stack([o[0] for o in out], dim=1)
            n_bits = torch.stack([o[1] for o in out], dim=1)
        new_state = RdsState(
            band_tail, pilot_tail, delay_tail,
            mixed_blocks[:, -1, cfg.if_block - tl_bb:].contiguous(),
            filt[:, -1, n_filt - tl_rrc:].contiguous(), pll, bit_state,
            state.block_count + nb, track)
        return (bits, n_bits, clean), new_state
