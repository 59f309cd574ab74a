"""Synthetic FM broadcast stations (test fixture and benchmark input).

A jax-free copy of the ``station_iq`` and ``wideband_iq`` paths of
``real_time_sdr_tpu/utils/synth.py``: mono + 19 kHz pilot + DSB-SC stereo
difference + 57 kHz RDS BPSK with real RBDS framing, FM modulated into
uint8 interleaved IQ as an RTL-SDR delivers it. The transmit chain is the
inverse of the receive chain: groups -> CRC+offset checkwords ->
differential encode -> Manchester symbols -> RRC pulse shaping at
sps*2375 S/s -> resample to the RF rate -> mix to 57 kHz. For the same
arguments it returns the same bytes as the JAX package's copy
(``tests/test_torch_receiver.py``, ``tests/test_torch_wideband.py``).
``wideband_iq`` upsamples and frequency-shifts several stations into one
wideband capture for the channelizer. The channel impairments
(``impair_iq``), the offline resampler between RF rates (``rate_change``)
and the simple tone and noise fixtures are copies too, pinned bit-equal in
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
from scipy import signal as sp_signal

from real_time_sdr_tpu_torch.config import (PILOT_FREQ, RDS_SYMBOL_RATE,
                                      ReceiverConfig)
from real_time_sdr_tpu_torch.ops.filters import design_rrc
from real_time_sdr_tpu_torch.ops.rds_codes import OFFSET_WORDS as _OFFSET_WORDS
from real_time_sdr_tpu_torch.ops.rds_codes import _crc_remainder

__all__ = ["encode_group", "group_to_bits", "ps_groups", "radiotext_groups",
           "radiotext_2b_groups", "ptyn_groups", "date_to_mjd",
           "clocktime_group", "differential_encode", "manchester_symbols",
           "rds_baseband", "fm_iq", "station_iq", "impair_iq",
           "generate_sin", "add_sin", "random_samples", "rate_change",
           "wideband_iq"]

# ---------------------------------------------------------------------------
# RBDS transmit-side encoding
# ---------------------------------------------------------------------------

def encode_group(pi: int, group_type: int, pty: int, placement: int,
                 data_c: int, data_d: int,
                 version_b: bool = False) -> list[int]:
    """Four 16-bit data words of one group (version A, or B via flag)."""
    b = ((group_type << 12) | (int(version_b) << 11) | (pty << 5)
         | placement)
    return [pi, b, data_c, data_d]


def group_to_bits(words: list[int]) -> list[int]:
    """Data words -> 104 transmitted bits (CRC + offset word per block).

    Version-B groups (bit 11 of block B) transmit block 3 under the C'
    offset word, as the standard requires.
    """
    offsets = ("A", "B", "Cp" if (words[1] >> 11) & 1 else "C", "D")
    bits = []
    for word, offset in zip(words, offsets):
        check = _crc_remainder(word, 16) ^ _OFFSET_WORDS[offset]
        block = (word << 10) | check
        bits.extend((block >> (25 - i)) & 1 for i in range(26))
    return bits


def ps_groups(pi: int, pty: int, ps_name: str, *,
              af_mhz: tuple[float, ...] = (), tp: bool = False,
              ta: bool = False, music: bool = False,
              di: int = 0) -> list[list[int]]:
    """Group-type-0A sequence carrying an 8-char Program Service name,
    optionally with an AF list (block C), TP/TA/MS flags and DI bits."""
    assert len(ps_name) == 8
    af_codes = [int(round((f - 87.5) * 10)) for f in af_mhz]
    assert all(1 <= code <= 204 for code in af_codes), af_mhz
    if len(af_codes) % 2:
        af_codes.append(205)  # filler code
    out = []
    for placement in range(4):
        c0, c1 = ps_name[2 * placement], ps_name[2 * placement + 1]
        cword = 0x0000
        if 2 * placement < len(af_codes):
            cword = (af_codes[2 * placement] << 8) | af_codes[2 * placement + 1]
        g = encode_group(pi, 0, pty, placement, cword,
                         (ord(c0) << 8) | ord(c1))
        g[1] |= ((int(tp) << 10) | (int(ta) << 4) | (int(music) << 3)
                 | (((di >> (3 - placement)) & 1) << 2))
        out.append(g)
    return out


def radiotext_groups(pi: int, pty: int, text: str,
                     ab_flag: int = 0) -> list[list[int]]:
    """Group-type-2A sequence carrying up to 64 chars of RadioText.

    ab_flag is the text A/B flag (block B bit 4): toggling it between
    messages tells receivers to clear the previous text."""
    assert len(text) <= 64, "2A RadioText is capped at 64 chars (4-bit seg)"
    text = text.ljust(4 * ((len(text) + 3) // 4))
    out = []
    for seg in range(len(text) // 4):
        chunk = text[4 * seg: 4 * seg + 4]
        c = (ord(chunk[0]) << 8) | ord(chunk[1])
        d = (ord(chunk[2]) << 8) | ord(chunk[3])
        g = encode_group(pi, 2, pty, seg, c, d)
        g[1] |= (ab_flag & 1) << 4
        out.append(g)
    return out


def radiotext_2b_groups(pi: int, pty: int, text: str) -> list[list[int]]:
    """Group-type-2B sequence: 2 chars per group in block D, PI in block C."""
    text = text.ljust(2 * ((len(text) + 1) // 2))
    assert len(text) <= 32
    out = []
    for seg in range(len(text) // 2):
        chunk = text[2 * seg: 2 * seg + 2]
        d = (ord(chunk[0]) << 8) | ord(chunk[1])
        out.append(encode_group(pi, 2, pty, seg, pi, d, version_b=True))
    return out


def ptyn_groups(pi: int, pty: int, name: str,
                ab_flag: int = 0) -> list[list[int]]:
    """Group-type-10A pair carrying the 8-char Program Type Name
    (4 chars per segment from blocks C+D; block B bit 0 = segment,
    bit 4 = A/B flag)."""
    assert len(name) <= 8
    name = name.ljust(8)
    out = []
    for seg in range(2):
        chunk = name[4 * seg: 4 * seg + 4]
        c = (ord(chunk[0]) << 8) | ord(chunk[1])
        d = (ord(chunk[2]) << 8) | ord(chunk[3])
        g = encode_group(pi, 10, pty, seg, c, d)
        g[1] = (g[1] & ~0x1F) | ((ab_flag & 1) << 4) | seg
        out.append(g)
    return out


def date_to_mjd(year: int, month: int, day: int) -> int:
    """(year, month, day) -> Modified Julian Date, per the RDS spec annex."""
    lflag = 1 if month in (1, 2) else 0
    return (14956 + day + int((year - 1900 - lflag) * 365.25)
            + int((month + 1 + 12 * lflag) * 30.6001))


def clocktime_group(pi: int, pty: int, year: int, month: int, day: int,
                    hour: int, minute: int,
                    offset_half_hours: int = 0) -> list[int]:
    """One group-type-4A (clock-time/date) group for the given UTC time."""
    mjd = date_to_mjd(year, month, day)
    b_low = (mjd >> 15) & 0x3
    c = ((mjd & 0x7FFF) << 1) | ((hour >> 4) & 1)
    d = (((hour & 0xF) << 12) | ((minute & 0x3F) << 6)
         | (0x20 if offset_half_hours < 0 else 0)
         | (abs(offset_half_hours) & 0x1F))
    return encode_group(pi, 4, pty, b_low, c, d)


def differential_encode(bits, prev: int = 0) -> list[int]:
    out = []
    for b in bits:
        prev = int(b) ^ prev
        out.append(prev)
    return out


def manchester_symbols(bits) -> np.ndarray:
    """bit b -> symbol pair (b, 1-b) in {+1,-1} amplitude."""
    syms = np.empty(2 * len(bits), dtype=np.float64)
    for i, b in enumerate(bits):
        syms[2 * i] = 1.0 if b else -1.0
        syms[2 * i + 1] = -1.0 if b else 1.0
    return syms


def rds_baseband(symbols: np.ndarray, rf_fs: int, n_samples: int,
                 sps: int = 39, clock_ppm: float = 0.0) -> np.ndarray:
    """RRC-shaped BPSK baseband at rf_fs (tiled to n_samples).

    clock_ppm: transmitter symbol-clock error — symbols run at
    2375*(1 + ppm*1e-6) baud (the impairment a tracking CDR must follow;
    the per-block argmax CDR slips a symbol each time the accumulated
    drift wraps one comb phase)."""
    fs = int(RDS_SYMBOL_RATE * sps)
    x = np.zeros(len(symbols) * sps)
    x[::sps] = symbols
    h = design_rrc(fs, 16 * sps + 1)
    shaped = np.convolve(x, h, mode="same")
    if clock_ppm == 0.0:
        ratio = Fraction(rf_fs, fs)
        up, down = ratio.numerator, ratio.denominator
        resampled = sp_signal.resample_poly(shaped, up, down)
        reps = int(np.ceil(n_samples / len(resampled)))
        return np.tile(resampled, reps)[:n_samples]
    # scaled-clock path: shaped is ~39x oversampled (band edge ~2.4% of
    # fs), so linear interpolation onto the scaled rf grid is essentially
    # exact and handles irrational-looking ratios directly
    scale = 1.0 + clock_ppm * 1e-6
    pos = np.arange(n_samples) * (fs * scale / rf_fs)
    pos = np.mod(pos, len(shaped) - 1.0)
    return np.interp(pos, np.arange(len(shaped), dtype=np.float64), shaped)


# ---------------------------------------------------------------------------
# FM multiplex synthesis
# ---------------------------------------------------------------------------

def fm_iq(rf_fs: int, n_samples: int, *,
          mono: np.ndarray | None = None,
          stereo_diff: np.ndarray | None = None,
          rds_symbols: np.ndarray | None = None,
          mono_amp: float = 0.45, pilot_amp: float = 0.10,
          stereo_amp: float = 0.45, rds_amp: float = 0.06,
          deviation: float = 75_000.0, phase0: float = 0.0,
          rds_sps: int = 39, rds_clock_ppm: float = 0.0,
          noise_std: float = 0.0, noise_seed: int = 0,
          pilot_freq: float = PILOT_FREQ) -> np.ndarray:
    """Synthesize uint8 interleaved IQ for one FM station.

    mono / stereo_diff: per-sample (L+R)/2 and (L-R)/2 waveforms at rf_fs
    (unit amplitude). Returns (2*n_samples,) uint8.
    """
    t = np.arange(n_samples) / rf_fs
    theta_p = 2 * np.pi * pilot_freq * t  # off-nominal models tuner ppm error
    m = np.zeros(n_samples)
    if mono is not None:
        m += mono_amp * mono[:n_samples]
    m += pilot_amp * np.cos(theta_p)
    if stereo_diff is not None:
        m += stereo_amp * stereo_diff[:n_samples] * np.cos(2 * theta_p)
    if rds_symbols is not None:
        bb = rds_baseband(rds_symbols, rf_fs, n_samples, rds_sps,
                          clock_ppm=rds_clock_ppm)
        m += rds_amp * bb * np.cos(3 * theta_p)

    phase = phase0 + 2 * np.pi * deviation * np.cumsum(m) / rf_fs
    i = np.cos(phase)
    q = np.sin(phase)
    if noise_std > 0:
        rng = np.random.default_rng(noise_seed)
        i = i + noise_std * rng.standard_normal(n_samples)
        q = q + noise_std * rng.standard_normal(n_samples)
    iq = np.empty(2 * n_samples)
    iq[0::2] = i
    iq[1::2] = q
    return np.clip(np.round(128.0 + 127.0 * iq), 0, 255).astype(np.uint8)


def station_iq(cfg: ReceiverConfig, n_blocks: int, *,
               ps_name: str = "TPU-FM  ", pi: int = 0x3A5C, pty: int = 5,
               radiotext: str | None = None,
               ptyn: str | None = None,
               clock: tuple[int, ...] | None = None,
               af_mhz: tuple[float, ...] = (),
               tone_left: float = 440.0, tone_right: float = 1200.0,
               **kw) -> tuple[np.ndarray, dict]:
    """Convenience: a full station with stereo tones + RDS PS (and optionally
    RadioText and a 4A clock-time group, as
    ``clock=(year, month, day, hour, minute[, offset_half_hours])``).
    Returns (uint8 IQ of n_blocks blocks, ground-truth dict)."""
    n = cfg.block_size_iq * n_blocks
    t = np.arange(n) / cfg.rf_fs
    left = np.sin(2 * np.pi * tone_left * t)
    right = np.sin(2 * np.pi * tone_right * t)
    groups = ps_groups(pi, pty, ps_name, af_mhz=af_mhz)
    if radiotext is not None:
        groups = groups + radiotext_groups(pi, pty, radiotext)
    if ptyn is not None:
        groups = groups + ptyn_groups(pi, pty, ptyn)
    if clock is not None:
        groups = groups + [clocktime_group(pi, pty, *clock)]
    bits = [b for g in groups for b in group_to_bits(g)]
    # repeat groups so warm-up blocks and sync hunting have margin
    secs = n / cfg.rf_fs
    reps = max(2, int(np.ceil(secs * RDS_SYMBOL_RATE / len(bits))) + 1)
    diff = differential_encode(bits * reps)
    syms = manchester_symbols(diff)
    iq = fm_iq(cfg.rf_fs, n, mono=(left + right) / 2,
               stereo_diff=(left - right) / 2, rds_symbols=syms,
               rds_sps=cfg.sps, **kw)
    truth = dict(ps_name=ps_name, pi=pi, pty=pty, left=left, right=right,
                 bits=bits, radiotext=radiotext, ptyn=ptyn, clock=clock)
    return iq, truth


# ---------------------------------------------------------------------------
# Channel impairments (beyond the reference: its only fixtures are clean
# synthetic or off-air captures; these model what a real tuner front end
# delivers so decode-survival is testable without recordings)
# ---------------------------------------------------------------------------

def impair_iq(iq_u8: np.ndarray, rf_fs: int, *,
              multipath: list[tuple[float, float, float]] | None = None,
              doppler_hz: float = 0.0,
              freq_offset_hz: float = 0.0,
              freq_drift_hz_s: float = 0.0,
              noise_std: float = 0.0,
              iq_gain_db: float = 0.0,
              iq_phase_deg: float = 0.0,
              dc_offset: complex = 0.0,
              phase_noise_linewidth_hz: float = 0.0,
              seed: int = 0) -> np.ndarray:
    """Apply channel impairments to a uint8 interleaved IQ capture.

    multipath: echoes as (delay_seconds, amplitude, phase_rad) added to the
        direct path; with ``doppler_hz`` nonzero each echo k also rotates at
        (k+1)*doppler_hz, i.e. a slow multi-ray fading channel (the sum
        amplitude beats through constructive/destructive interference).
    freq_offset_hz / freq_drift_hz_s: carrier frequency offset and linear
        drift (tuner ppm error and thermal drift).
    noise_std: complex AWGN sigma per I/Q rail (unit-amplitude signal).

    Receiver-analog (tuner) artifacts — the real-RTL-SDR behaviours the
    reference's off-air capture loop exercises (model/fmMonoBasic.py:30-42;
    no capture ships, so these close the loop synthetically):

    iq_gain_db / iq_phase_deg: quadrature demodulator imbalance — the Q
        rail's mixer gain is off by ``iq_gain_db`` and its nominal 90 deg
        split is off by ``iq_phase_deg`` (i' = i, q' = g*(q cos(phi) +
        i sin(phi))); creates the classic image at -f. RTL-SDR (R820T)
        datasheet-typical: ~0.5 dB / ~1-2 deg.
    dc_offset: complex DC term added to the baseband (LO leakage /
        ADC bias; the "center spike"). Typical few % of full scale.
    phase_noise_linewidth_hz: local-oscillator phase noise as a Wiener
        process whose accumulated phase gives a Lorentzian line of this
        3-dB linewidth (var/sample = 2*pi*B/fs). Fractional-N PLL tuners
        sit around tens of Hz equivalent linewidth.
    """
    z = ((iq_u8[0::2].astype(np.float64) - 128.0)
         + 1j * (iq_u8[1::2].astype(np.float64) - 128.0)) / 128.0
    n = len(z)
    t = np.arange(n) / rf_fs
    if multipath:
        acc = z.copy()
        for k, (delay_s, amp, ph) in enumerate(multipath):
            d = int(round(delay_s * rf_fs))
            if not 0 <= d < n:
                raise ValueError(
                    f"multipath delay {delay_s} s = {d} samples is outside "
                    f"the {n}-sample capture")
            echo = np.concatenate([np.zeros(d, dtype=z.dtype), z[:n - d]])
            rot = np.exp(1j * (ph + 2 * np.pi * (k + 1) * doppler_hz * t))
            acc = acc + amp * echo * rot
        z = acc
    if freq_offset_hz or freq_drift_hz_s:
        z = z * np.exp(2j * np.pi * (freq_offset_hz * t
                                     + 0.5 * freq_drift_hz_s * t * t))
    if phase_noise_linewidth_hz > 0:
        rng_pn = np.random.default_rng(seed + 0x9E3779B9)
        sig = np.sqrt(2 * np.pi * phase_noise_linewidth_hz / rf_fs)
        theta = np.cumsum(sig * rng_pn.standard_normal(n))
        z = z * np.exp(1j * theta)
    if iq_gain_db or iq_phase_deg:
        g = 10.0 ** (iq_gain_db / 20.0)
        phi = np.deg2rad(iq_phase_deg)
        i_r, q_r = z.real, z.imag
        z = i_r + 1j * g * (q_r * np.cos(phi) + i_r * np.sin(phi))
    if dc_offset:
        z = z + dc_offset
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        z = z + noise_std * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
    out = np.empty(2 * n)
    out[0::2] = z.real
    out[1::2] = z.imag
    return np.clip(np.round(128.0 + 127.0 * out), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Simple test-fixture generators (src/genfunc.cpp:13-41 twins)
# ---------------------------------------------------------------------------

def generate_sin(fs: float, freq: float, n: int, amplitude: float = 1.0,
                 phase: float = 0.0) -> np.ndarray:
    """Single tone (``generateSin`` twin)."""
    t = np.arange(n) / fs
    return amplitude * np.sin(2 * np.pi * freq * t + phase)


def add_sin(fs: float, freqs, n: int, amplitudes=None,
            phases=None) -> np.ndarray:
    """Sum of tones (``addSin`` twin)."""
    freqs = list(freqs)
    amplitudes = list(amplitudes) if amplitudes else [1.0] * len(freqs)
    phases = list(phases) if phases else [0.0] * len(freqs)
    out = np.zeros(n)
    for f, a, p in zip(freqs, amplitudes, phases):
        out += generate_sin(fs, f, n, a, p)
    return out


def random_samples(n: int, max_value: float = 1.0, seed: int = 0,
                   bits: int = 16) -> np.ndarray:
    """Uniform random fixture (``generateRandomSamples`` twin)."""
    rng = np.random.default_rng(seed)
    levels = 1 << bits
    return (rng.integers(0, levels, n) / levels * 2.0 - 1.0) * max_value


def rate_change(iq_u8: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Offline IQ resampler between canonical RF rates.

    Twin of model/fmRateChange.py: rational resample (from the gcd) of the
    I and Q streams separately, requantized to uint8 — generates
    alternate-mode test inputs from a single capture. Canonical rates:
    {2400, 2880, 2304, 1920, 1440, 1152, 960} kS/s.

    Deliberate requantization divergence from the reference
    (model/fmRateChange.py:60-64): it writes ``128 + int(x*127)`` —
    truncation toward zero, 127/128 gain, and NO clipping (resampler
    overshoot past full scale silently WRAPS the uint8). Here: round,
    full 128 scale, clipped — cross-checked against the reference run
    unmodified in tests/test_reference_oracle.py (agreement within the
    documented 1-2 LSB class on non-overshooting samples).
    """
    g = math.gcd(fs_in, fs_out)
    up, down = fs_out // g, fs_in // g
    i = (iq_u8[0::2].astype(np.float64) - 128.0) / 128.0
    q = (iq_u8[1::2].astype(np.float64) - 128.0) / 128.0
    i2 = sp_signal.resample_poly(i, up, down)
    q2 = sp_signal.resample_poly(q, up, down)
    out = np.empty(2 * len(i2))
    out[0::2] = i2
    out[1::2] = q2
    return np.clip(np.round(128.0 + 128.0 * out), 0, 255).astype(np.uint8)


def wideband_iq(cfg: ReceiverConfig, wide_fs: int, stations: list[dict],
                n_blocks: int) -> tuple[np.ndarray, np.ndarray, list[dict]]:
    """Multi-station wideband capture for the channelizer.

    Each stations[k] dict carries offset_hz (required), an ``amp`` linear
    amplitude scale (default 1.0; amp=10 is a +20 dB interferer), plus any
    station_iq kwargs (ps_name, pi, pty, tone_left, tone_right). Returns
    (i_wide, q_wide float32 at wide_fs, truths). Stations are synthesized at
    cfg.rf_fs, upsampled to wide_fs, and frequency-shifted to their
    offsets; the sum is scaled down by the total amplitude when it exceeds
    1.
    """
    if wide_fs % cfg.rf_fs:
        raise ValueError(f"wide_fs {wide_fs} is not a multiple of the "
                         f"station rate {cfg.rf_fs}")
    up = wide_fs // cfg.rf_fs
    n_wide = cfg.block_size_iq * n_blocks * up
    acc = np.zeros(n_wide, dtype=np.complex128)
    truths = []
    total_amp = sum(float(st.get("amp", 1.0)) for st in stations)
    for st in stations:
        kw = {k: v for k, v in st.items() if k not in ("offset_hz", "amp")}
        iq_u8, truth = station_iq(cfg, n_blocks, **kw)
        truth["offset_hz"] = st["offset_hz"]
        truths.append(truth)
        z = ((iq_u8[0::2].astype(np.float64) - 128.0)
             + 1j * (iq_u8[1::2].astype(np.float64) - 128.0)) / 128.0
        zw = sp_signal.resample_poly(z, up, 1)[:n_wide]
        t = np.arange(len(zw)) / wide_fs
        acc[:len(zw)] += (float(st.get("amp", 1.0)) * zw
                          * np.exp(2j * np.pi * st["offset_hz"] * t))
    acc /= max(1.0, total_amp)
    return (acc.real.astype(np.float32), acc.imag.astype(np.float32),
            truths)
