"""Decision-directed carrier recovery for BPSK: 2nd-order Costas loop.

Port of ``real_time_sdr_tpu/ops/costas.py``: per sample, derotate by the
estimated phase, form the BPSK error Re(out)*Im(out), and advance a PI loop

    freq  = freq + beta*err
    phase = mod((phase + freq) + alpha*err, 2*pi)     (floor semantics)

at the ~1187.5 Hz post-timing-recovery rate. The input is AGC-normalized to
unit RMS first, so the default gains (alpha=0.02, beta=1e-4) do not depend
on the capture's amplitude.

- ``costas_scan`` routes by device: a CPU tensor takes ``costas_scan_plain``
  (a per-sample loop over the rows in PyTorch), a CUDA tensor launches the
  kernel ``csrc/costas_scan.cu`` (``ops.cuda.costas_scan``), or raises.
- ``coarse_freq_bpsk`` seeds the loop's frequency: squaring removes the
  BPSK modulation and one FFT finds the tone at twice the residual carrier.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["CostasCarry", "costas_init", "costas_scan", "costas_scan_plain",
           "coarse_freq_bpsk", "check_costas_args", "TWO_PI"]

TWO_PI = 2.0 * math.pi


class CostasCarry(NamedTuple):
    phase: torch.Tensor  # f32 rad, in [0, 2*pi)
    freq: torch.Tensor   # f32 rad/sample


def costas_init(batch: tuple = (), device=None) -> CostasCarry:
    z = torch.zeros(batch, dtype=torch.float32, device=device)
    return CostasCarry(z, z.clone())


def coarse_freq_bpsk(z: torch.Tensor, nfft: int = 4096) -> torch.Tensor:
    """Coarse carrier estimate for BPSK over the first ``nfft`` squared
    symbols, zero-padded: the FFT's peak bin (ties to the lowest index, as
    ``jnp.argmax``), mapped to a signed frequency and halved. Returns a 0-d
    f32 tensor, rad/sample, accurate to half a bin. ``z`` is 1-D (one
    channel)."""
    if z.ndim != 1:
        raise ValueError(f"coarse_freq_bpsk takes a 1-D stream, got shape "
                         f"{tuple(z.shape)}")
    n = z.shape[-1]
    sq = torch.zeros(nfft, dtype=torch.complex64, device=z.device)
    sq[:min(n, nfft)] = (z * z)[:nfft]
    spec = torch.fft.fft(sq).abs()
    k = torch.argmax(spec)
    f2 = torch.where(k > nfft // 2, k - nfft, k).to(torch.float32) / nfft
    return math.pi * f2    # == 0.5 * 2*pi*f2, pi rounded to f32 once


def check_costas_args(z: torch.Tensor, carry: CostasCarry) -> None:
    """What both versions take: z (..., N) complex64 and f32 carry leaves
    of z's batch shape, on z's device."""
    if z.ndim < 1 or z.dtype != torch.complex64:
        raise ValueError(f"costas_scan takes (..., N) complex64, got "
                         f"{z.dtype} {tuple(z.shape)}")
    for name, t in zip(carry._fields, carry):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(z.shape[:-1]):
            raise ValueError(f"carry.{name} must be f32 of shape "
                             f"{tuple(z.shape[:-1])}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def costas_scan_plain(z: torch.Tensor, carry: CostasCarry,
                      alpha: float = 0.02, beta: float = 1e-4):
    """The loop in PyTorch over the last axis, all rows at once; each
    operation rounds to f32 separately. Returns (derotated (..., N)
    complex64, freq_log (..., N) f32 rad/sample, new carry)."""
    check_costas_args(z, carry)
    n = z.shape[-1]
    zr, zi = z.real, z.imag
    out_r = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    out_i = torch.empty_like(out_r)
    freq_log = torch.empty_like(out_r)
    phase, freq = carry
    for k in range(n):
        ang = -phase
        c, s = torch.cos(ang), torch.sin(ang)     # exp(-j*phase)
        a, b = zr[..., k], zi[..., k]
        o_r = a * c - b * s
        o_i = a * s + b * c
        err = o_r * o_i
        freq = freq + beta * err
        phase = torch.remainder((phase + freq) + alpha * err, TWO_PI)
        out_r[..., k], out_i[..., k], freq_log[..., k] = o_r, o_i, freq
    return (torch.complex(out_r, out_i), freq_log,
            CostasCarry(phase.clone(), freq.clone()))


def costas_scan(z: torch.Tensor, carry: CostasCarry, alpha: float = 0.02,
                beta: float = 1e-4):
    """z: (..., N) complex64 at ~symbol rate, unit-RMS. Returns
    (derotated (..., N) complex64, freq_log (..., N) f32 rad/sample,
    new_carry)."""
    from real_time_sdr_tpu_torch.ops.cuda.costas_scan import costas_kernel
    return costas_kernel(z, carry, float(alpha), float(beta))
