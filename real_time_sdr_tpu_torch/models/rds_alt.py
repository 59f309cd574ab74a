"""Alternative RDS architecture: non-coherent complex baseband + M&M + Costas.

Port of ``real_time_sdr_tpu/models/rds_alt.py``, the twin of the
reference's second, independent RDS receiver (model/pySDRRDS.py), which
shares nothing with the production chain (``models/rds.py``):

1. the FM discriminator output (``Frontend``, kernel ``frontend_fused``)
   is shifted by -57 kHz into a complex baseband by an exact-rational mixer
   (pySDRRDS.py:18-23);
2. one polyphase stage low-pass filters and resamples it to 19 kHz = 16
   samples per bit, the (re, im) rails stacked as the rows of a one-filter
   ``FIRBank`` (kernel ``fir_bank``, pySDRRDS.py:25-34);
3. AGC to unit RMS, a comb-energy timing seed, then Mueller–Muller timing
   recovery (``ops.symbol_timing.mm_timing``, kernel ``mm_timing``;
   pySDRRDS.py:36-55);
4. a coarse FFT frequency seed, then a decision-directed Costas loop
   (``ops.costas.costas_scan``, kernel ``costas_scan``; pySDRRDS.py:60-84);
5. slice Re > 0 and decode differentially (pySDRRDS.py:88-90), then
6. frame on the host with the sync-by-offset decoder
   (``models.rds_framing.SyncByOffsetDecoder``).

The carrier is only frequency-locked (a 180-degree ambiguity); the
differential code makes the bits polarity-immune. This is an offline,
diagnostic receiver: ``decode(iq_u8)`` takes a whole capture, and only the
final fetch crosses to the host. The streaming path remains ``Receiver``.

JAX compiles ``_device_chain``; on the card the frontend and the chain are
one captured CUDA graph per capture length (``utils.graphs``, in the
receiver's ``graphs``), replayed once per decode between the capture's
upload and the fetch of its results; on the CPU they run eagerly.
``_decode(iq_u8, self._device_half)`` is the eager decode.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from real_time_sdr_tpu_torch.config import ReceiverConfig, mode_config
from real_time_sdr_tpu_torch.device import resolve_device
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.models.rds_framing import SyncByOffsetDecoder
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.ops.costas import (CostasCarry, coarse_freq_bpsk,
                                                costas_scan)
from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank
from real_time_sdr_tpu_torch.ops.symbol_timing import comb_acquire, mm_timing
from real_time_sdr_tpu_torch.utils.graphs import GraphCache

__all__ = ["AltRdsReceiver", "AltRdsDiag"]

RDS_CARRIER = 57_000.0
BIT_RATE = 1187.5
BB_FS = 19_000          # 16 samples per 1187.5 Hz bit (pySDRRDS.py:33-38)
SPS = 16


class AltRdsDiag(NamedTuple):
    """Diagnostics mirroring what the reference model plots (numpy)."""
    baseband: np.ndarray   # complex64 at 19 kHz (post-LPF, unit RMS)
    symbols: np.ndarray    # complex64 at 1187.5 Hz (post-M&M, pre-Costas)
    derotated: np.ndarray  # complex64 post-Costas (constellation)
    freq_log: np.ndarray   # Costas frequency estimate, Hz
    bits: np.ndarray       # differential-decoded bits


class AltRdsReceiver(nn.Module):
    """One-shot capture decoder via the pySDRRDS architecture. It runs on
    the card unless the caller names a device: ``device=None`` is
    ``"cuda"`` and raises ``RuntimeError`` without one; ``device="cpu"``
    runs the kernels' plain versions."""

    def __init__(self, cfg: ReceiverConfig | int = 0, *,
                 mm_gain: float = 0.01, costas_alpha: float = 0.02,
                 costas_beta: float = 1e-4,
                 device: str | torch.device | None = None):
        super().__init__()
        if isinstance(cfg, int):
            cfg = mode_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.frontend = Frontend(cfg)
        r = Fraction(BB_FS, cfg.if_fs)
        self.up, self.down = r.numerator, r.denominator
        # anti-alias LPF for the 19 kHz output band, designed at the
        # upsampled rate with gain=up (the polyphase convention of
        # models/rds); 7.5 kHz cutoff == firwin(101, 7.5e3) at
        # pySDRRDS.py:26. One filter over the stacked (re, im) rows.
        self.bb_bank = make_bank([PolyFIR(
            filters.design_lpf(cfg.if_fs * self.up, 7_500.0,
                               cfg.rf_taps * self.up, gain=self.up),
            up=self.up, down=self.down)])
        # the mixer's exact rational phase: 57000/if_fs = num/den
        g = math.gcd(int(RDS_CARRIER), cfg.if_fs)
        self.mix_num, self.mix_den = int(RDS_CARRIER) // g, cfg.if_fs // g
        self.mm_gain = mm_gain
        self.costas_alpha = costas_alpha
        self.costas_beta = costas_beta
        self.graphs = GraphCache()
        self.to(self.device)

    # -- device half -------------------------------------------------------

    def _mix(self, demod: torch.Tensor) -> torch.Tensor:
        """demod (n,) -> (2, n): x * (cos, sin)(-2 pi 57k t). The phase is
        the integer (num*k) mod den, which never leaves [0, den): an f32
        absolute phase 2 pi 57000 t would lose ~0.25 rad of precision by
        t = 10 s, and this model takes captures of minutes."""
        n, den = demod.shape[-1], self.mix_den
        k = torch.arange(n, dtype=torch.int64, device=demod.device) % den
        frac = (self.mix_num * k) % den
        ang = float(np.float32(-2.0 * np.pi / den)) * frac.to(torch.float32)
        return torch.stack([demod * torch.cos(ang), demod * torch.sin(ang)])

    def baseband(self, demod: torch.Tensor) -> torch.Tensor:
        """demod (n,) f32 -> the unit-RMS complex64 baseband at 19 kHz:
        the mixer, then the LPF + resampler (one ``fir_bank`` launch over
        the (re, im) rows from a zero tail), then AGC to unit RMS, so the
        M&M rails and the Costas gains do not depend on the capture's
        amplitude (ops/costas.py)."""
        mixed = self._mix(demod)
        tail = mixed.new_zeros((2, self.bb_bank.tail_len))
        (bb_ri,), _ = self.bb_bank(mixed, tail)
        bb = torch.complex(bb_ri[0], bb_ri[1])
        rms = torch.sqrt((bb.abs() ** 2).mean() + 1e-12)
        return bb / rms

    def _device_chain(self, demod: torch.Tensor):
        bb = self.baseband(demod)
        mu0 = comb_acquire(bb, SPS)
        syms, n_valid = mm_timing(bb, float(SPS), gain=self.mm_gain, mu0=mu0)
        # the buffer is zero beyond n_valid; the mask is for the bits
        mask = torch.arange(syms.shape[-1], device=syms.device) < n_valid
        # the coarse FFT estimate seeds the loop's frequency; the loop runs
        # over the whole buffer, zeros included, as the JAX package's does
        f0 = coarse_freq_bpsk(syms)
        derot, freq_log, _ = costas_scan(
            syms, CostasCarry(torch.zeros_like(f0), f0),
            alpha=self.costas_alpha, beta=self.costas_beta)
        hard = (derot.real > 0).to(torch.int32)
        bits = torch.where(mask[1:], torch.remainder(hard[1:] - hard[:-1], 2),
                           0)
        return bb, syms, derot, freq_log, bits, n_valid

    @torch.no_grad()
    def _device_half(self, iq: torch.Tensor):
        """iq (1, n) uint8 on the device -> ``_device_chain``'s outputs: the
        frontend from its initial state, then the chain."""
        demod, _ = self.frontend(iq, self.frontend.init_state(1))
        return self._device_chain(demod[0])

    # -- host half ---------------------------------------------------------

    @torch.no_grad()
    def decode(self, iq_u8: np.ndarray):
        """iq_u8: raw interleaved uint8 capture (whole blocks are used).

        Returns (SyncByOffsetDecoder with events populated, AltRdsDiag)."""
        return self._decode(iq_u8, lambda iq: self.graphs(
            self._device_half, ("decode",), iq))

    def _decode(self, iq_u8: np.ndarray, device_half):
        """``decode`` with ``device_half`` (iq (1, n) -> the chain's
        outputs) as its device half."""
        blk = 2 * self.cfg.block_size_iq
        n_blocks = len(iq_u8) // blk
        if n_blocks == 0:
            raise ValueError(f"capture of {len(iq_u8)} bytes holds no whole "
                             f"{blk}-byte block")
        iq = torch.from_numpy(np.ascontiguousarray(
            iq_u8[:n_blocks * blk], dtype=np.uint8)).to(self.device)
        bb, syms, derot, freq_log, bits, n_valid = device_half(iq[None])
        nv = int(n_valid)
        bits_np = bits.cpu().numpy()[:max(0, nv - 1)]
        dec = SyncByOffsetDecoder()
        dec.feed(bits_np)
        diag = AltRdsDiag(
            baseband=bb.cpu().numpy(),
            symbols=syms[:nv].cpu().numpy(),
            derotated=derot[:nv].cpu().numpy(),
            freq_log=freq_log[:nv].cpu().numpy() * (BIT_RATE / (2 * np.pi)),
            bits=bits_np)
        return dec, diag
