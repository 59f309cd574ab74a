"""FIR designs of the receiver, float64 NumPy: a frozen copy.

Windowed-sinc low-pass and band-pass with the Hann window realized as
sin^2(pi*i/N), and the centred-impulse delay, as the FM receiver this
benchmark serves designs them (the designs of the reference C++ project,
src/filter.cpp:13-78). The benchmark's reference chain works every tap
out again from these; it takes none from the program under test.
"""

from __future__ import annotations

import numpy as np


def _hann(taps: int) -> np.ndarray:
    i = np.arange(taps, dtype=np.float64)
    w = np.sin(i * np.pi / taps)
    return w * w


def design_lpf(fs: float, fc: float, taps: int,
               gain: float = 1.0) -> np.ndarray:
    """Windowed-sinc low-pass; ``gain`` pre-scales a polyphase bank."""
    nc = fc / (fs / 2.0)
    i = np.arange(taps, dtype=np.float64)
    m = (taps - 1) / 2.0
    h = gain * nc * np.sinc(nc * (i - m))
    return h * _hann(taps)


def design_bpf(fs: float, f_low: float, f_high: float,
               taps: int) -> np.ndarray:
    """Windowed-sinc band-pass by cosine modulation."""
    center = ((f_high + f_low) / 2.0) / (fs / 2.0)
    width = (f_high - f_low) / (fs / 2.0)
    i = np.arange(taps, dtype=np.float64)
    m = (taps - 1) // 2
    h = width * np.sinc((width / 2.0) * (i - m))
    h = h * np.cos(i * np.pi * center)
    return h * _hann(taps)


def design_rrc(fs: float, taps: int, symbol_rate: float = 2375.0,
               beta: float = 0.90) -> np.ndarray:
    """Root-raised-cosine pulse for the RDS symbols, its time axis centred
    at taps/2, the removable singularities by their textbook limits."""
    T = 1.0 / symbol_rate
    t = (np.arange(taps, dtype=np.float64) - taps / 2.0) / fs
    with np.errstate(divide="ignore", invalid="ignore"):
        num = (np.sin(np.pi * t * (1 - beta) / T)
               + 4.0 * beta * (t / T) * np.cos(np.pi * t * (1 + beta) / T))
        h = num / (np.pi * t * (1.0 - (4.0 * beta * t / T) ** 2) / T)
    h = np.where(t == 0.0, 1.0 + beta * (4.0 / np.pi - 1.0), h)
    sing = np.isclose(np.abs(t), T / (4.0 * beta))
    h_sing = (beta / np.sqrt(2.0)) * (
        (1 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
        + (1 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta)))
    return np.where(sing, h_sing, h)
