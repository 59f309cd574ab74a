"""RBDS code constants (host, numpy): CRC remainder, parity matrix, offset
words and their syndromes.

A jax-free copy of the constants in ``real_time_sdr_tpu/ops/rds_bits.py``
(which imports jax), so the framer and the synthetic station fixture of the
port import no jax. ``tests/test_torch_receiver.py`` holds the copies equal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_crc_remainder", "parity_matrix_np", "OFFSET_WORDS",
           "OFFSET_SYNDROMES"]

_RDS_POLY = 0x5B9


def _crc_remainder(value: int, nbits: int) -> int:
    """Remainder of value * x^10 mod g(x) over GF(2) (host, design time)."""
    reg = 0
    for i in range(nbits, 0, -1):
        reg = (reg << 1) | ((value >> (i - 1)) & 1)
        if reg & (1 << 10):
            reg ^= _RDS_POLY
    for _ in range(10):
        reg <<= 1
        if reg & (1 << 10):
            reg ^= _RDS_POLY
    return reg & 0x3FF


def parity_matrix_np() -> np.ndarray:
    """(26, 10) RBDS parity-check matrix H; syndrome = bits @ H mod 2."""
    h = np.zeros((26, 10), dtype=np.int32)
    for i in range(26):
        rem = _crc_remainder(1 << (25 - i), 26)
        for c in range(10):
            h[i, c] = (rem >> (9 - c)) & 1
    return h


# RBDS offset words in block order (A, B, C, C', D).
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}

OFFSET_SYNDROMES = {k: _crc_remainder(w, 26) for k, w in OFFSET_WORDS.items()}
