"""Fourier transforms: the reference's transform ladder in PyTorch.

Port of ``real_time_sdr_tpu/ops/fourier.py``. The reference carries a
ladder of hand transforms (DFT O(N^2), recursive, precomputed-twiddle and
iterative FFTs, src/fourier.cpp:14-215) asserted pairwise equivalent by its
unit tests. Here:

- ``dft`` / ``idft`` / ``fft`` / ``magnitude`` — ``torch.fft``, the
  production transforms;
- ``dft_matmul`` — the O(N^2) transform as two or four products against
  cached (Re, Im) twiddle matrices, exact f32 (the package keeps TF32 off);
- ``fft_stockham`` — radix-2 Stockham autosort FFT: log2(N) butterfly
  stages of split, twiddle-multiply and concatenate, no bit-reversal;
- ``dft_naive`` — the numpy float64 oracle the equivalence tests chain to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["dft", "idft", "fft", "magnitude", "dft_naive", "dft_matmul",
           "fft_stockham"]


def dft(x: torch.Tensor) -> torch.Tensor:
    """Forward DFT, reference sign convention (src/fourier.cpp:14-22)."""
    return torch.fft.fft(x)


def idft(x: torch.Tensor) -> torch.Tensor:
    """Inverse DFT with 1/N normalization (src/fourier.cpp:96-105)."""
    return torch.fft.ifft(x)


def fft(x: torch.Tensor) -> torch.Tensor:
    """Alias of dft: the reference's FFT ladder (src/fourier.cpp:136-215)
    exists to be equivalent to its DFT, which this is by construction."""
    return torch.fft.fft(x)


def magnitude(spectrum: torch.Tensor) -> torch.Tensor:
    """|X_k| (``computeVectorMagnitude``, src/fourier.cpp:25-32)."""
    return spectrum.abs()


_TWIDDLE_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _twiddle_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(Re, Im) of the n-point DFT matrix, f32 (src/fourier.cpp:129-134
    precomputes the same values as a vector)."""
    if n not in _TWIDDLE_CACHE:
        k = np.arange(n)
        ang = -2.0 * np.pi * np.outer(k, k) / n
        _TWIDDLE_CACHE[n] = (np.cos(ang).astype(np.float32),
                             np.sin(ang).astype(np.float32))
    return _TWIDDLE_CACHE[n]


def dft_matmul(x: torch.Tensor) -> torch.Tensor:
    """O(N^2) DFT as products against the twiddle matrices over the last
    axis; real or complex input -> complex64."""
    wr, wi = (torch.from_numpy(w).to(x.device)
              for w in _twiddle_mats(x.shape[-1]))
    if x.is_complex():
        xr, xi = x.real.float(), x.imag.float()
        re = xr @ wr - xi @ wi
        im = xr @ wi + xi @ wr
    else:
        xr = x.float()
        re, im = xr @ wr, xr @ wi
    return torch.complex(re, im)


def fft_stockham(x: torch.Tensor) -> torch.Tensor:
    """Radix-2 Stockham autosort FFT over the last axis (power-of-2 N):
    each stage splits the (l, m) walk in half, adds the halves and spins
    their difference by the stage's twiddles (src/fourier.cpp:193-215's
    iterative FFT without its bit-reversal permutation)."""
    n = x.shape[-1]
    if not n or n & (n - 1):
        raise ValueError(f"power-of-2 length required, got {n}")
    X = x.to(torch.complex64)[..., None]        # (..., l=n, m=1)
    l = n
    while l > 1:
        hl = l // 2
        a, b = X[..., :hl, :], X[..., hl:, :]
        ang = -2.0 * math.pi * np.arange(hl, dtype=np.float64) / l
        tw = torch.from_numpy(np.exp(1j * ang).astype(np.complex64)).to(
            x.device)[:, None]
        X = torch.cat([a + b, (a - b) * tw], dim=-1)   # (..., hl, 2m)
        l = hl
    return X[..., 0, :]


def dft_naive(x: np.ndarray) -> np.ndarray:
    """Host-side O(N^2) direct DFT in float64: the independent oracle the
    equivalence tests compare against (src/fourier.cpp:14-22)."""
    x = np.asarray(x, dtype=np.complex128)
    n = len(x)
    k = np.arange(n)
    twiddle = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return twiddle @ x
