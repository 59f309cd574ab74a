"""PCM formatting: float audio -> int16 samples.

Port of ``real_time_sdr_tpu/utils/audio.py``: scale by 16384, clip, then
truncate toward zero into int16; stereo interleaves left (even) and right
(odd).
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import AUDIO_SCALE

__all__ = ["mono_pcm", "stereo_pcm", "write_pcm"]


def _to_i16(x: torch.Tensor) -> torch.Tensor:
    # clip before the cast: float->int16 overflow is undefined behaviour,
    # and loud transients must saturate, not wrap
    return torch.clamp(x, -32768.0, 32767.0).to(torch.int16)


def mono_pcm(audio: torch.Tensor) -> torch.Tensor:
    """(..., N) float -> (..., N) int16, truncation toward zero."""
    return _to_i16(AUDIO_SCALE * audio)


def stereo_pcm(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(..., N) x2 float -> (..., 2N) int16 interleaved L,R."""
    scaled = _to_i16(AUDIO_SCALE * torch.stack([left, right], dim=-1))
    return scaled.reshape(scaled.shape[:-2] + (-1,))


def write_pcm(fileobj, pcm) -> None:
    """Write int16 samples little-endian to an open binary file (a tensor
    on the card is fetched to the host first)."""
    if isinstance(pcm, torch.Tensor):
        pcm = pcm.cpu().numpy()
    np.asarray(pcm).astype("<i2").tofile(fileobj)
