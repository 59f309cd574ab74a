"""Carrier-loop parameters shared by the carrier synchronizers.

Port of ``PllParams`` from ``real_time_sdr_tpu/ops/pll.py``: the nominal
oscillator ramp 2*pi*(f/Fs)*trig comes from an integer counter wrapped
modulo period = 2*Fs/gcd(f, Fs), so float32 never evaluates trig of a large
argument. Only tier 3 (``ops.sync.FeedforwardSync``) is ported; the
sequential loop (tier 1) and its Newton solve (tier 2) are not.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["PllParams"]


class PllParams(NamedTuple):
    """Static loop configuration (python ints/floats)."""
    freq: int             # oscillator nominal frequency, Hz (integer)
    fs: int               # sample rate, Hz (integer)
    nco_scale: float = 1.0
    phase_adjust: float = 0.0

    @property
    def _ratio(self):
        g = math.gcd(self.freq, self.fs)
        return self.freq // g, self.fs // g

    @property
    def period(self) -> int:
        """Integer counter period: trig and trig+period give oscillator
        angles differing by a multiple of 4*pi."""
        return 2 * self._ratio[1]

    def trig_angle(self, trig: torch.Tensor) -> torch.Tensor:
        """Exact wrapped 2*pi*(f/Fs)*trig in [0, 4*pi), float32 (integer
        phase arithmetic in int64)."""
        fr, fsr = self._ratio
        frac = (fr * trig.to(torch.int64)) % (2 * fsr)
        return (2.0 * math.pi / fsr) * frac.to(torch.float32)
