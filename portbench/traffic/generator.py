"""The benchmark's one traffic generator: synthetic FM broadcast captures
made from ``--seed``, on the device, in a few large tensor operations.

A frozen, tensor-level rewrite of the FM multiplex synthesis the port's
tests use (``utils/synth.py``): mono + 19 kHz pilot + DSB-SC stereo
difference + 57 kHz RDS BPSK carrying real RBDS groups (PS 0A and
RadioText 2A with CRC and offset words, differential code, Manchester
symbols, root-raised-cosine pulses), FM-modulated at 75 kHz deviation.
Each station is synthesized straight at the capture's rate (its tones
and subcarriers from exact integer phases, the RDS baseband at 39 samples
a symbol and linearly interpolated, the FM phase summed in float64) and
shifted to its offset; the sum is scaled to ``iq_level`` RMS and
quantized to interleaved uint8 I/Q as an RTL-SDR delivers it.

A capture is one period of an endless broadcast: it holds a whole number
of RDS groups (``groups``, even: the group list is a half repeated, so
the differential code closes on itself), every tone a multiple of 125 Hz
and every offset a multiple of 150 kHz completes whole cycles in it, and
the modulation sums to zero over it, so the FM phase closes too. Played
in a loop it has no seam: every RDS group is whole and valid.

Everything that varies with the seed is content (tones, PI, PS, text,
phases): every seed gives the same sizes, the same station grid and the
same rates, so the work a cell does is the same on every seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.filters import design_rrc

RDS_SYMBOL_RATE = 2375          # Manchester symbols a second (1187.5 bit/s)
GROUP_BITS = 104
TONE_STEP_HZ = 125              # tones complete whole cycles in a capture
RDS_SPS = 39                    # baseband samples a symbol before resampling
DEVIATION_HZ = 75_000.0
AMPS = dict(mono=0.45, pilot=0.10, stereo=0.45, rds=0.06)
PS_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
RT_ALPHABET = PS_ALPHABET + " "

_RDS_POLY = 0x5B9
_OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "D": 0x1B4}


def _crc10(value: int) -> int:
    """Remainder of value * x^10 mod g(x) over GF(2), 16 data bits."""
    reg = 0
    for i in range(16, 0, -1):
        reg = (reg << 1) | ((value >> (i - 1)) & 1)
        if reg & (1 << 10):
            reg ^= _RDS_POLY
    for _ in range(10):
        reg <<= 1
        if reg & (1 << 10):
            reg ^= _RDS_POLY
    return reg & 0x3FF


def group_bits(words: list[int]) -> list[int]:
    """Four 16-bit words of a version-A group -> its 104 bits."""
    bits = []
    for word, off in zip(words, "ABCD"):
        block = (word << 10) | (_crc10(word) ^ _OFFSET_WORDS[off])
        bits.extend((block >> (25 - i)) & 1 for i in range(26))
    return bits


def station_groups(pi: int, pty: int, ps: str, rt: str) -> list[list[int]]:
    """PS as four 0A groups, then the RadioText as 2A groups."""
    groups = []
    for seg in range(4):
        b = (0 << 12) | (pty << 5) | seg
        groups.append([pi, b, 0, (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])])
    for seg in range(len(rt) // 4):
        c = rt[4 * seg:4 * seg + 4]
        b = (2 << 12) | (pty << 5) | seg
        groups.append([pi, b, (ord(c[0]) << 8) | ord(c[1]),
                       (ord(c[2]) << 8) | ord(c[3])])
    return groups


def draw_stations(seed: int, n: int, rt_chars: int) -> list[dict]:
    """Per-station content from the seed: PI, PTY, PS, RadioText, the two
    audio tones (integer Hz) and the carrier's starting phase."""
    rng = np.random.default_rng(int(seed))
    pis = rng.choice(np.arange(0x1001, 0xFFFF), size=n, replace=False)
    out = []
    for k in range(n):
        out.append(dict(
            pi=int(pis[k]), pty=int(rng.integers(1, 32)),
            ps="".join(rng.choice(list(PS_ALPHABET), 8)),
            rt="".join(rng.choice(list(RT_ALPHABET), rt_chars)),
            tone_left=TONE_STEP_HZ * int(rng.integers(2, 32)),
            tone_right=TONE_STEP_HZ * int(rng.integers(2, 32)),
            phase0=float(rng.uniform(0.0, 2.0 * math.pi))))
    return out


def cycle_samples(fs: int, groups: int) -> int:
    """Samples at ``fs`` of a capture holding ``groups`` RDS groups."""
    num = groups * GROUP_BITS * 2 * int(fs)
    n = num // RDS_SYMBOL_RATE
    if (groups % 2 or num % RDS_SYMBOL_RATE
            or (TONE_STEP_HZ * n) % fs or (19_000 * n) % fs):
        raise ValueError(f"{groups} groups at {fs} S/s is no whole capture")
    return n


def rds_symbols(st: dict, groups: int) -> np.ndarray:
    """The station's group sequence over ``groups`` groups (its first half
    twice, so the differential code's parity is even and the code closes
    on itself), differentially coded and Manchester-split into +-1
    symbols."""
    seq = station_groups(st["pi"], st["pty"], st["ps"], st["rt"])
    half = [seq[i % len(seq)] for i in range(groups // 2)]
    bits = np.array([b for g in half + half for b in group_bits(g)],
                    np.int64)
    diff = np.bitwise_xor.accumulate(bits)
    syms = np.empty(2 * diff.shape[0])
    syms[0::2] = np.where(diff == 1, 1.0, -1.0)
    syms[1::2] = -syms[0::2]
    return syms


def _cos_int(freq_hz: int, n: torch.Tensor, fs: int) -> torch.Tensor:
    """cos(2 pi f n / fs) from the exact integer phase (f n) mod fs."""
    return torch.cos((2.0 * math.pi / fs) * ((freq_hz * n) % fs).double())


def _sin_int(freq_hz: int, n: torch.Tensor, fs: int) -> torch.Tensor:
    return torch.sin((2.0 * math.pi / fs) * ((freq_hz * n) % fs).double())


def station_phase(st: dict, fs: int, groups: int,
                  device) -> torch.Tensor:
    """The FM carrier phase of one station at ``fs`` over one capture of
    ``groups`` RDS groups (float64 radians, before its offset)."""
    n_samples = cycle_samples(fs, groups)
    n = torch.arange(n_samples, dtype=torch.int64, device=device)
    left = _sin_int(st["tone_left"], n, fs)
    right = _sin_int(st["tone_right"], n, fs)
    m = AMPS["mono"] * 0.5 * (left + right)
    m += AMPS["pilot"] * _cos_int(19_000, n, fs)
    m += AMPS["stereo"] * 0.5 * (left - right) * _cos_int(38_000, n, fs)
    del left, right
    # RDS baseband at 39 samples a symbol (the pulses wrapped around the
    # capture), linearly interpolated to fs
    fs_b = RDS_SYMBOL_RATE * RDS_SPS
    syms = torch.from_numpy(rds_symbols(st, groups)).to(device)
    up = torch.zeros(syms.shape[0] * RDS_SPS, dtype=torch.float64,
                     device=device)
    up[::RDS_SPS] = syms
    h = torch.from_numpy(design_rrc(fs_b, 16 * RDS_SPS + 1)).to(device)
    k = h.shape[0] // 2
    shaped = torch.nn.functional.conv1d(
        torch.nn.functional.pad(up[None, None], (k, k), mode="circular"),
        h.flip(0)[None, None])[0, 0]
    pos = n.double() * (fs_b / fs)
    i0 = pos.floor().long()
    frac = pos - i0.double()
    i0 %= shaped.shape[0]
    bb = shaped[i0] * (1.0 - frac) + shaped[(i0 + 1) % shaped.shape[0]] * frac
    del pos, i0, frac, shaped
    m += AMPS["rds"] * bb * _cos_int(57_000, n, fs)
    del bb
    m -= m.mean()                  # the FM phase closes over the capture
    return st["phase0"] + (2.0 * math.pi * DEVIATION_HZ / fs) * torch.cumsum(
        m, 0)


def capture(stations: list[dict], offsets_hz: list[int], fs: int,
            groups: int, iq_level: float, device) -> np.ndarray:
    """One period of the broadcast as interleaved uint8 I/Q on the host:
    the stations at their offsets (multiples of 150 kHz), summed, scaled
    to ``iq_level`` RMS of |z| (a lone station's constant envelope at
    ``iq_level``) and quantized."""
    n_samples = cycle_samples(fs, groups)
    n = torch.arange(n_samples, dtype=torch.int64, device=device)
    i_acc = torch.zeros(n_samples, dtype=torch.float64, device=device)
    q_acc = torch.zeros_like(i_acc)
    for st, f in zip(stations, offsets_hz):
        if (int(f) * n_samples) % fs:
            raise ValueError(f"offset {f} Hz does not close over the capture")
        ph = station_phase(st, fs, groups, device)
        ph += (2.0 * math.pi / fs) * (((int(f) % fs) * n) % fs).double()
        i_acc += torch.cos(ph)
        q_acc += torch.sin(ph)
        del ph
    g = 127.0 * iq_level / math.sqrt(len(stations))
    iq = torch.stack([i_acc, q_acc], dim=-1).reshape(-1)
    del i_acc, q_acc
    u8 = torch.clamp(torch.round(128.0 + g * iq), 0, 255).to(torch.uint8)
    return u8.cpu().numpy()


def band_offsets(n_stations: int, raster_hz: int) -> list[int]:
    """A raster centred on DC: offset k = (k - (n-1)/2) * raster, truncated
    to integer Hz."""
    return [int((k - (n_stations - 1) / 2) * raster_hz)
            for k in range(n_stations)]
