"""FIR filter design (host-side, float64 NumPy).

The port's own copy of ``real_time_sdr_tpu/ops/filters.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_copies.py`` pins
each design function bit-equal to the original's on the receiver's
arguments. Design runs once on the host in float64 (reference:
src/filter.cpp:13-102, model/fmSupportLib.py:35-74, model/fmRRC.py:13-53);
the taps become float32 buffers of the modules that use them.

All windows are Hann realized as sin^2(pi*i/N) exactly as the reference
does, so taps agree with the C++/Python models to float64 round-off.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "design_lpf",
    "design_bpf",
    "design_apf",
    "design_rrc",
]


def _hann(taps: int) -> np.ndarray:
    i = np.arange(taps, dtype=np.float64)
    w = np.sin(i * np.pi / taps)
    return w * w


def design_lpf(fs: float, fc: float, taps: int, gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc low-pass.

    ``gain`` > 1 pre-scales for polyphase upsampling banks (the reference's
    ``impulseResponseLPF`` overload with ``u``, src/filter.cpp:33-50).
    """
    nc = fc / (fs / 2.0)  # normalized cutoff
    i = np.arange(taps, dtype=np.float64)
    m = (taps - 1) / 2.0
    x = nc * (i - m)
    h = gain * nc * np.sinc(x)  # sinc(x) = sin(pi x)/(pi x); handles x=0
    return h * _hann(taps)


def design_bpf(fs: float, f_low: float, f_high: float, taps: int) -> np.ndarray:
    """Windowed-sinc band-pass via cosine modulation
    (reference: src/filter.cpp:55-71)."""
    center = ((f_high + f_low) / 2.0) / (fs / 2.0)
    width = (f_high - f_low) / (fs / 2.0)
    i = np.arange(taps, dtype=np.float64)
    m = (taps - 1) // 2  # integer, as in the C++ (taps is odd so == (taps-1)/2)
    x = (width / 2.0) * (i - m)
    h = width * np.sinc(x)
    h = h * np.cos(i * np.pi * center)
    return h * _hann(taps)


def design_apf(taps: int, gain: float = 1.0) -> np.ndarray:
    """All-pass group-delay aligner: a centered impulse of (taps-1)/2 delay
    (reference: src/filter.cpp:73-78)."""
    h = np.zeros(taps, dtype=np.float64)
    h[(taps - 1) // 2] = gain
    return h


def design_rrc(fs: float, taps: int, symbol_rate: float = 2375.0,
               beta: float = 0.90) -> np.ndarray:
    """Root-raised-cosine matched filter for the RDS BPSK symbols
    (reference: src/filter.cpp:80-102, model/fmRRC.py:13-53).

    Time axis is centered at taps/2 (not (taps-1)/2), matching the models.
    The removable singularities use the standard textbook limits; with the
    reference's odd tap counts neither singular point ever lands on the
    sample grid, so the two implementations agree exactly in practice.
    """
    T = 1.0 / symbol_rate
    i = np.arange(taps, dtype=np.float64)
    t = (i - taps / 2.0) / fs

    with np.errstate(divide="ignore", invalid="ignore"):
        num = (np.sin(np.pi * t * (1 - beta) / T)
               + 4.0 * beta * (t / T) * np.cos(np.pi * t * (1 + beta) / T))
        den = np.pi * t * (1.0 - (4.0 * beta * t / T) ** 2) / T
        h = num / den

    h = np.where(t == 0.0, 1.0 + beta * (4.0 / np.pi - 1.0), h)
    sing = np.isclose(np.abs(t), T / (4.0 * beta))
    h_sing = (beta / np.sqrt(2.0)) * (
        (1 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
        + (1 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
    return np.where(sing, h_sing, h)
