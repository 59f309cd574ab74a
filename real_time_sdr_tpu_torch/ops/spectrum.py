"""Spectral observability: Bartlett-averaged PSD estimate.

Port of ``real_time_sdr_tpu/ops/spectrum.py``, the reference's
``estimatePSD`` (src/fourier.cpp:36-92, model/fmSupportLib.py:214-289):
non-overlapping segments of length NFFT, Hann-windowed (sin^2),
magnitude-squared DFT per segment, scaled, converted to dB per segment and
averaged. For debugging and the figure sheet, not the audio path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NFFT", "estimate_psd", "freq_response"]

NFFT = 512  # reference: include/dy4.h:18


def estimate_psd(samples: torch.Tensor, fs: float, nfft: int = NFFT,
                 method: str = "matmul"):
    """Returns (freqs (nfft/2,) numpy, psd_db (..., nfft/2) tensor on the
    samples' device).

    Segments of length nfft, Hann window, per-segment |X_k|^2 *
    2/(Fs*nfft/2) over the first half of the bins, 10*log10 per segment,
    then the mean of those dB values (the reference averages per-segment dB,
    not linear power). ``method`` picks the transform of ``ops.fourier``:
    "matmul" (default, the DFT as twiddle-matrix products), "fft"
    (``torch.fft``) or "stockham"."""
    from real_time_sdr_tpu_torch.ops import fourier
    if method not in ("matmul", "fft", "stockham"):
        raise ValueError(f"method must be 'matmul', 'fft' or 'stockham', "
                         f"got {method!r}")
    n = samples.shape[-1]
    n_seg = n // nfft
    segs = samples[..., :n_seg * nfft].reshape(
        samples.shape[:-1] + (n_seg, nfft))
    i = np.arange(nfft)
    window = np.sin(i * np.pi / nfft) ** 2     # Hann via sin^2
    windowed = segs * torch.as_tensor(window, dtype=samples.dtype,
                                      device=samples.device)
    if method == "matmul":
        spec = fourier.dft_matmul(windowed)
    elif method == "stockham":
        spec = fourier.fft_stockham(windowed)
    else:
        spec = torch.fft.fft(windowed, dim=-1)
    half = spec[..., :nfft // 2]
    psd = (half.abs() ** 2) * (2.0 / (fs * nfft / 2.0))
    psd_db_seg = 10.0 * torch.log10(torch.clamp(psd, min=1e-30))
    psd_db = psd_db_seg.mean(dim=-2)
    freqs = np.arange(nfft // 2) * fs / nfft
    return freqs, psd_db


def freq_response(h: np.ndarray, fs: float, n: int = 4096):
    """|H(f)| on a dense grid (the reference's freqzPlot,
    model/fmSupportLib.py:185-208)."""
    resp = np.abs(np.fft.rfft(np.asarray(h), n))
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    return freqs, resp
