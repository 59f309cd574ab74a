"""Tier-3 carrier synchronizer: feedforward analytic-phase estimation.

Port of ``real_time_sdr_tpu/ops/sync.py`` ``FeedforwardSync`` (its default
"rot" table mode). No recurrence at all:

    pilot -> [ONE complex FIR: Hilbert pair (*) ramp-modulated smoother]
          -> rotate by the exact nominal carrier ramp (integer phase)
          -> residual phase = atan2(Im, Re); unwrap = torch.cumsum
          -> carrier = cos(scale * (nominal ramp + residual) + adjust)

The complex FIR is one two-filter bank (one FIR-bank kernel launch on the
card). The nominal ramp's cos/sin/angle come from period-length host tables
(numpy float64 -> float32, the JAX package's exact values) rotated by one
per-channel scalar phase. The stereo double-angle carrier (nco_scale 2)
needs no unwrap; the RDS half-angle carrier (nco_scale 0.5) takes the full
unwrap, whose 2*pi parity sets the carrier's sign.

``PllLoop`` puts tiers 1-2 (``ops/pll.py``) behind the same interface, and
``carrier_sync`` picks the tier.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from real_time_sdr_tpu_torch.ops.cuda.pll_scan import (PLL_CHAIN_OPS,
                                                       pll_scan_kernel)
from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank
from real_time_sdr_tpu_torch.ops.pll import (FOUR_PI, PllCarry, PllParams,
                                             pll_init, pll_newton)

__all__ = ["FeedforwardSync", "FFSyncCarry", "PllLoop", "carrier_sync"]

_TWO_PI = 2.0 * math.pi
HILBERT_TAPS = 63


def _hilbert_taps(taps: int) -> np.ndarray:
    """Type-III FIR Hilbert transformer, Hann-windowed (odd length)."""
    m = (taps - 1) // 2
    k = np.arange(taps) - m
    h = np.zeros(taps)
    odd = (k % 2) != 0
    h[odd] = 2.0 / (np.pi * k[odd])
    i = np.arange(taps, dtype=np.float64)
    w = np.sin(i * np.pi / taps) ** 2
    return h * w


class FFSyncCarry(NamedTuple):
    in_tail: torch.Tensor   # (C, T-1) f32 input tail of the complex FIR
    trig: torch.Tensor      # (C,) int32 global sample counter mod period
    resid: torch.Tensor     # (C,) f32 unwrapped residual phase, mod 4*pi


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.round(x / _TWO_PI)


class FeedforwardSync(nn.Module):
    """``sync(pilot (C, n), carry) -> (carrier (C, n), carry)``."""

    def __init__(self, p: PllParams, smooth_taps: int = 65):
        super().__init__()
        self.p = p
        h_h = _hilbert_taps(HILBERT_TAPS)
        m = (HILBERT_TAPS - 1) // 2
        delay = np.zeros(HILBERT_TAPS)
        delay[m] = 1.0
        i = np.arange(smooth_taps, dtype=np.float64)
        w = np.sin(i * np.pi / smooth_taps) ** 2
        w = w / w.sum()
        # [analytic pair] -> [rotate by the ramp] -> [smooth] collapses into
        # ONE complex FIR c = (delta + j h) * w~, w~[m] = w[m] e^{+j w0 m},
        # followed by the rotation (exact for the integer ramp)
        w0 = 2.0 * np.pi * p.freq / p.fs
        wm = w * np.exp(1j * w0 * np.arange(smooth_taps))
        c = np.convolve(delay + 1j * h_h, wm)
        self.cr_fir = PolyFIR(c.real)
        self.ci_fir = PolyFIR(c.imag)
        self.bank = make_bank([self.cr_fir, self.ci_fir])
        # the estimate at FIR output k describes input k-m (Hilbert pair);
        # the smoother's extra delay applies to the slow residual only
        self.hilbert_delay = m
        # the delay as a device scalar: a per-call torch.tensor would be a
        # host-to-device copy, which a captured graph cannot hold
        self.register_buffer("_hilbert_delay_t", torch.tensor(m),
                             persistent=False)
        self.group_delay = m + (smooth_taps - 1) // 2
        fr, fsr = p._ratio
        k = np.arange(p.period, dtype=np.int64)
        frac = (fr * k) % (2 * fsr)
        ang = ((2.0 * np.pi / fsr)
               * frac.astype(np.float32)).astype(np.float64)
        self.register_buffer("ramp_cos",
                             torch.as_tensor(np.cos(ang).astype(np.float32)))
        self.register_buffer("ramp_sin",
                             torch.as_tensor(np.sin(ang).astype(np.float32)))
        self.register_buffer("ramp_angle",
                             torch.as_tensor(ang.astype(np.float32)))

    def init(self, batch: int) -> FFSyncCarry:
        dev = self.ramp_cos.device
        return FFSyncCarry(
            in_tail=torch.zeros((batch, self.cr_fir.tail_len),
                                dtype=torch.float32, device=dev),
            trig=torch.zeros((batch,), dtype=torch.int32, device=dev),
            resid=torch.zeros((batch,), dtype=torch.float32, device=dev))

    def _tiled(self, table: torch.Tensor, n: int) -> torch.Tensor:
        """table tiled from index 0 to length n (the ramp at 0..n-1)."""
        return table.repeat(-(-n // table.shape[0]))[:n]

    def _ramp_cos_sin(self, start: torch.Tensor, n: int):
        """cos/sin of the nominal ramp at start..start+n-1: one rotation of
        the tiled tables by the angle of ``start`` (angle-sum identity)."""
        th = self.p.trig_angle(start % self.p.period)
        cs, sn = torch.cos(th)[..., None], torch.sin(th)[..., None]
        ct = self._tiled(self.ramp_cos, n)
        st = self._tiled(self.ramp_sin, n)
        return cs * ct - sn * st, sn * ct + cs * st

    def _ramp_angle(self, start: torch.Tensor, n: int) -> torch.Tensor:
        """Canonical ramp angle in [0, 4*pi) at start..start+n-1: both
        addends are canonical, so one conditional 4*pi subtraction
        reproduces the canonical branch."""
        th = self.p.trig_angle(start % self.p.period)[..., None]
        s = th + self._tiled(self.ramp_angle, n)
        return s - torch.where(s >= FOUR_PI, FOUR_PI, 0.0)

    def forward(self, x: torch.Tensor, carry: FFSyncCarry):
        p = self.p
        n = x.shape[-1]
        (c_re, c_im), in_tail = self.bank(x, carry.in_tail)
        d_total = self.group_delay
        ce, se = self._ramp_cos_sin(carry.trig + 1 - self.hilbert_delay, n)
        zr = c_re * ce + c_im * se
        zi = c_im * ce - c_re * se

        resid_w = torch.atan2(zi, zr)
        prev = torch.cat([_wrap_pi(carry.resid)[..., None],
                          resid_w[..., :-1]], dim=-1)
        d = _wrap_pi(resid_w - prev)
        # residual slope from the block's second half (a cold start
        # corrupts the first ~FIR-length deltas)
        mu = torch.mean(d[..., n // 2:], dim=-1, keepdim=True)

        if p.nco_scale == 2.0 and p.phase_adjust == 0.0:
            # double angle: cos(2*(ramp + resid + D*mu)) is invariant under
            # the 2*pi unwrap shift, so the residual enters only through
            # cos/sin(2*resid_w) — algebra on the unit vector, no unwrap
            r2 = zr * zr + zi * zi
            pos = r2 > 0.0
            safe = torch.where(pos, r2, 1.0)
            cos2r = torch.where(pos, (zr * zr - zi * zi) / safe, 1.0)
            sin2r = torch.where(pos, 2.0 * zr * zi / safe, 0.0)
            two_mu = 2.0 * d_total * mu
            cm, sm_ = torch.cos(two_mu), torch.sin(two_mu)
            cb = cos2r * cm - sin2r * sm_            # cos 2(resid + D*mu)
            sb = sin2r * cm + cos2r * sm_
            # cos/sin(2*ramp) at trig+1 from (ce, se) at trig+1-hilbert:
            # double-angle identity + the constant offset rotation
            delta = p.trig_angle(self._hilbert_delay_t)
            cph, sph = torch.cos(2.0 * delta), torch.sin(2.0 * delta)
            cos2e = ce * ce - se * se
            sin2e = 2.0 * ce * se
            c2 = cos2e * cph - sin2e * sph
            s2 = sin2e * cph + cos2e * sph
            carrier = c2 * cb - s2 * sb
            resid_last = carry.resid + torch.sum(d, dim=-1)
        else:
            # general path (the RDS half-angle carrier): full unwrap
            resid_u = carry.resid[..., None] + torch.cumsum(d, dim=-1)
            ramp_out = self._ramp_angle(carry.trig + 1, n)
            phase = ramp_out + resid_u + d_total * mu
            carrier = torch.cos(p.nco_scale * phase + p.phase_adjust)
            resid_last = resid_u[..., -1]

        new = FFSyncCarry(in_tail=in_tail,
                          trig=(carry.trig + n) % p.period,
                          resid=torch.remainder(resid_last, FOUR_PI))
        return carrier, new


class PllLoop(nn.Module):
    """Tier 1 (the ``pll_scan`` kernel's wrapper) or tier 2 (``pll_newton``)
    behind the tier-3 synchronizer's interface: ``loop.init(batch)`` and
    ``loop(x, carry) -> (carrier, carry)``."""

    def __init__(self, p: PllParams, pll_tier: int):
        super().__init__()
        if pll_tier not in (1, 2):
            raise ValueError(f"PllLoop runs tier 1 or 2, got {pll_tier!r}")
        self.p = p
        self.tier = pll_tier
        # empty buffer: follows .to(device), so init() knows the device
        self.register_buffer("_anchor", torch.zeros(0), persistent=False)

    def init(self, batch: int) -> PllCarry:
        return pll_init(batch, self._anchor.device)

    def cost(self, n: int) -> dict:
        """Work of the tier-1 loop on an n-sample block of one row: the
        pilot read and the carrier written once, the carry (six 4-byte
        leaves) read and written once, about 20 f32 operations per sample.
        The loop is bound by latency, not by bytes or operations:
        ``chain_ops`` dependent operations run in sequence per row. Tier
        2's Newton solve is plain elementwise torch and has no cost row."""
        if self.tier != 1:
            raise ValueError("only the tier-1 loop has a cost row; tier 2 is "
                             "elementwise torch work")
        return {"kind": "pll_scan", "flops": 20 * n, "bytes": 8 * n + 48,
                "w_bytes": 0, "dims": (n, PLL_CHAIN_OPS, 1),
                "chain_ops": PLL_CHAIN_OPS * n}

    def forward(self, x: torch.Tensor, carry: PllCarry):
        fn = pll_scan_kernel if self.tier == 1 else pll_newton
        return fn(x, carry, self.p)


def carrier_sync(p: PllParams, pll_tier: int,
                 smooth_taps: int = 65) -> nn.Module:
    """The carrier synchronizer of a tier: 1 the exact loop, 2 its Newton
    twin (``PllLoop``), 3 ``FeedforwardSync``. Each has ``init(batch)`` and
    is called as ``sync(x, carry) -> (carrier, carry)``."""
    if pll_tier == 3:
        return FeedforwardSync(p, smooth_taps=smooth_taps)
    if pll_tier in (1, 2):
        return PllLoop(p, pll_tier)
    raise ValueError(f"pll_tier must be 1 (exact loop), 2 (Newton) or 3 "
                     f"(feedforward); got {pll_tier!r}")
