"""The benchmark's plain reference of the FM receiver, float64 NumPy.

Written from the receiver's mathematics (the loop-level float64 oracle of
the reference C++ project: src/filter.cpp, src/demod.cpp, src/pll.cpp,
src/stereo.cpp), vectorized over rows and over time, with no carried
state: each call processes a span of whole blocks from zero history, and
the caller keeps enough leading blocks for every filter tail and the
carrier loop to settle before the block it compares (``WARM_BLOCKS``).

Two front ends feed the same stereo chain:

- ``listener_demod``: one tuner's interleaved uint8 I/Q at the RF rate,
  low-passed and decimated to the IF rate, then FM-discriminated.
- ``band_demod``: one station of a wideband uint8 capture, mixed down by
  its exact integer-phase tone, filtered by the channel low-pass convolved
  with the RF low-pass upsampled to the wide rate (the exact polyphase
  identity of a channelizer followed by a tuner front end), decimated to
  the IF rate in one step, then FM-discriminated. The discriminator is
  blind to a constant phase rotation, so the mixer's phase origin (the
  span's first sample here, the stream's first in a program) does not
  matter.

``precision="bf16"`` is the control: every operand (input, taps) and
every stage's output rounded to bfloat16, the arithmetic between kept
wide, as bf16 operands with a wide accumulator run on a card. The
benchmark's check must find it wrong.

Imports NumPy only: nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import filters

WARM_BLOCKS = 2          # blocks processed before a compared block

PRECISIONS = ("f64", "bf16")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (nearest, ties to even), as float64."""
    f = np.ascontiguousarray(x, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _fft_conv(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Causal convolution of every row of ``x`` with ``h`` from zero
    history: y[..., n] = sum_k h[k] x[..., n - k], n < N."""
    n, k = x.shape[-1], h.shape[0]
    size = 1 << int(np.ceil(np.log2(n + k - 1)))
    if np.iscomplexobj(x) or np.iscomplexobj(h):
        y = np.fft.ifft(np.fft.fft(x, size) * np.fft.fft(h, size), size)
    else:
        y = np.fft.irfft(np.fft.rfft(x, size) * np.fft.rfft(h, size), size)
    return y[..., :n]


class ReferenceChain:
    """Mode-0 style receiver chain from a configuration's ``receiver``
    group (rates, cutoffs, taps, bands, loop bandwidth, PCM scale)."""

    def __init__(self, rx: dict, precision: str = "f64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.rx = rx
        self.precision = precision
        up = rx["audio_up"]
        self.q = bf16_round if precision == "bf16" else (lambda a: a)
        taps = rx["rf_taps"]
        self.rf_h = self.q(filters.design_lpf(rx["rf_fs"], rx["rf_fc"], taps))
        self.pilot_h = self.q(filters.design_bpf(rx["if_fs"],
                                                 *rx["pilot_band"], taps))
        self.band_h = self.q(filters.design_bpf(rx["if_fs"],
                                                *rx["stereo_band"], taps))
        self.delay = (taps - 1) // 2
        self.audio_h = self.q(filters.design_lpf(
            rx["if_fs"] * up, rx["audio_fc"], taps * up, gain=up))

    # -- front ends -----------------------------------------------------
    def listener_demod(self, iq_u8: np.ndarray) -> np.ndarray:
        """(R, 2N) uint8 interleaved I/Q at the RF rate -> (R, N/decim)
        FM demod at the IF rate."""
        x = (np.asarray(iq_u8, np.float64) - 128.0) / 128.0
        d = self.rx["rf_decim"]
        i = self.q(_fft_conv(x[..., 0::2], self.rf_h)[..., ::d])
        q = self.q(_fft_conv(x[..., 1::2], self.rf_h)[..., ::d])
        return self.q(_discriminate(i, q))

    def band_taps(self, wide_fs: int, taps_factor: int,
                  channel_fc_share: float) -> np.ndarray:
        """The channel low-pass at the wide rate convolved with the RF
        low-pass upsampled to it."""
        rx = self.rx
        d = wide_fs // rx["rf_fs"]
        h_c = filters.design_lpf(wide_fs, rx["rf_fs"] / 2 * channel_fc_share,
                                 rx["rf_taps"] * taps_factor + 1)
        h_f = filters.design_lpf(rx["rf_fs"], rx["rf_fc"], rx["rf_taps"])
        h_up = np.zeros(d * (rx["rf_taps"] - 1) + 1)
        h_up[::d] = h_f
        return self.q(np.convolve(h_c, h_up))

    def band_demod(self, wide_u8: np.ndarray, offsets_hz, wide_fs: int,
                   h_eq: np.ndarray) -> np.ndarray:
        """(2N,) uint8 interleaved wideband I/Q -> (len(offsets), N/dt)
        FM demod at the IF rate, one row per station offset."""
        x = (np.asarray(wide_u8, np.float64) - 128.0) / 128.0
        z = x[0::2] + 1j * x[1::2]
        n = z.shape[0]
        dt = (wide_fs // self.rx["rf_fs"]) * self.rx["rf_decim"]
        k = np.arange(n, dtype=np.int64)
        rows = []
        for f in offsets_hz:
            frac = (((int(f) % wide_fs) * k) % wide_fs) / wide_fs
            mixed = z * np.exp(-2j * np.pi * frac)
            y = _fft_conv(mixed, h_eq)[::dt]
            rows.append(self.q(y.real) + 1j * self.q(y.imag))
        y = np.stack(rows)
        return self.q(_discriminate(y.real, y.imag))

    # -- stereo chain ---------------------------------------------------
    def stereo(self, fm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(R, N) IF demod -> (left, right), each (R, N*up/down)."""
        rx, q = self.rx, self.q
        pilot = q(_fft_conv(fm, self.pilot_h))
        carrier = q(pll(pilot, rx["pilot_freq"], rx["if_fs"],
                        nco_scale=2.0, norm_bw=rx["pll_bw_stereo"]))
        band = q(_fft_conv(fm, self.band_h))
        sub_dc = q(2.0 * band * carrier)
        mono_del = np.zeros_like(fm)
        mono_del[..., self.delay:] = fm[..., :fm.shape[-1] - self.delay]
        mono = q(self.resample(mono_del))
        sub = q(self.resample(sub_dc))
        return mono + sub, mono - sub

    def resample(self, x: np.ndarray) -> np.ndarray:
        """Polyphase rational resampler: zero-stuff by up, filter, keep
        every down-th output."""
        up, down = self.rx["audio_up"], self.rx["audio_down"]
        if up > 1:
            v = np.zeros(x.shape[:-1] + (x.shape[-1] * up,))
            v[..., ::up] = x
            x = v
        return _fft_conv(x, self.audio_h)[..., ::down]

    def pcm(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """int16 interleaved L, R: scaled, clipped, truncated toward
        zero."""
        s = np.stack([left, right], axis=-1) * float(self.rx["audio_scale"])
        s = np.trunc(np.clip(s, -32768.0, 32767.0)).astype(np.int16)
        return s.reshape(s.shape[:-2] + (-1,))


def _discriminate(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Arctan-free FM discriminator from zero history:
    (I dQ - Q dI) / (I^2 + Q^2), 0 where I = Q = 0."""
    ip = np.concatenate([np.zeros(i.shape[:-1] + (1,)), i[..., :-1]], -1)
    qp = np.concatenate([np.zeros(q.shape[:-1] + (1,)), q[..., :-1]], -1)
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    return np.where(den == 0.0, 0.0, num / np.where(den == 0.0, 1.0, den))


def pll(x: np.ndarray, freq: float, fs: float, nco_scale: float,
        norm_bw: float) -> np.ndarray:
    """Type-2 second-order PLL with NCO, one recurrence per sample,
    vectorized over rows, from the unlocked state. Returns the carrier
    (R, N): out[0] = 1, out[n] = cos(nco_scale * arg[n - 1]), the one-sample
    delay of the reference loop."""
    kp = norm_bw * 2.666
    ki = norm_bw * norm_bw * 3.555
    omega = 2.0 * np.pi * freq / fs
    x = np.atleast_2d(np.asarray(x, np.float64))
    rows, n = x.shape
    fbi, fbq = np.ones(rows), np.zeros(rows)
    integ, phase = np.zeros(rows), np.zeros(rows)
    out = np.empty((rows, n))
    out[:, 0] = 1.0
    xt = np.ascontiguousarray(x.T)
    for k in range(n - 1):
        xk = xt[k]
        err = np.arctan2(-xk * fbq, xk * fbi)
        integ += ki * err
        phase += kp * err + integ
        arg = omega * (k + 1) + phase
        fbi, fbq = np.cos(arg), np.sin(arg)
        out[:, k + 1] = np.cos(arg * nco_scale)
    return out


def rel_err(program: np.ndarray, reference: np.ndarray) -> float:
    """||program - reference|| / ||reference|| over one block's samples."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1.0))
