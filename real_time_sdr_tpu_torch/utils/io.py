"""Binary file I/O: raw IQ captures, float32 tensor dumps, WAV export.

The port's own copy of ``real_time_sdr_tpu/utils/io.py`` (numpy only; the
files it writes are byte-identical to the JAX package's): the reference's
iofunc layer (src/iofunc.cpp:31-60 readBinData / writeBinData float32 files
used for C++-vs-model cross-validation) plus the recorded-IQ workflow
(rtl_sdr captures, model/fmMonoBasic.py:30-42). Torch tensors are written
from the host: pass ``t.cpu()``.
"""

from __future__ import annotations

import wave

import numpy as np


def read_iq_u8(path: str, max_pairs: int | None = None) -> np.ndarray:
    """Raw interleaved uint8 IQ capture -> (2*n_pairs,) uint8."""
    count = -1 if max_pairs is None else 2 * max_pairs
    return np.fromfile(path, dtype=np.uint8, count=count)


def write_iq_u8(path: str, iq: np.ndarray) -> None:
    np.asarray(iq, dtype=np.uint8).tofile(path)


def read_bin_f32(path: str) -> np.ndarray:
    """float32 tensor dump (readBinData twin, src/iofunc.cpp:31-48)."""
    return np.fromfile(path, dtype="<f4")


def write_bin_f32(path: str, data) -> None:
    """float32 tensor dump (writeBinData twin, src/iofunc.cpp:50-60)."""
    np.asarray(data, dtype="<f4").tofile(path)


def write_wav(path: str, audio, fs: int, stereo: bool = False) -> None:
    """int16 PCM WAV (the models' listen-test artifact,
    model/fmMonoBlock.py:157-159)."""
    pcm = np.asarray(audio)
    if pcm.dtype != np.int16:
        pcm = (16384 * pcm).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2 if stereo else 1)
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes(pcm.tobytes())


def print_real_vector(x, max_items: int = 10) -> str:
    """Console dump (printRealVector twin, src/iofunc.cpp:14-20)."""
    x = np.asarray(x).ravel()
    shown = ", ".join(f"{v:.6g}" for v in x[:max_items])
    tail = "" if len(x) <= max_items else f", ... ({len(x)} total)"
    s = f"[{shown}{tail}]"
    print(s)
    return s


def print_complex_vector(x, max_items: int = 10) -> str:
    """Console dump (printComplexVector twin, src/iofunc.cpp:22-28)."""
    x = np.asarray(x).ravel()
    shown = ", ".join(f"{v.real:.6g}{v.imag:+.6g}j" for v in x[:max_items])
    tail = "" if len(x) <= max_items else f", ... ({len(x)} total)"
    s = f"[{shown}{tail}]"
    print(s)
    return s
