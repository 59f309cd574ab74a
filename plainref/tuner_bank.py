"""Plain reference of a bank of independent FM tuners: float64 PyTorch.

T tuners' interleaved uint8 I/Q streams at the RF rate in, each decoded
alone to 48 kHz stereo PCM and to RDS bits, with no kernel, no graph, no
batching across tuners (a row never reads another row) and no carried
state: a call decodes a span of whole blocks from zero history, as a
receiver starting on the span's first block would.

Written from the receiver's mathematics as a translation of the
benchmark's NumPy reference, ``portbench/reference/chain.py``: its
listener path (``listener_demod``: RF low-pass, decimation, arctan-free
discriminator) and its stereo chain (pilot band-pass, the type-2 PLL at
twice the pilot, the stereo band, the delay-matched mono, the audio
resampler, PCM), over a leading tuner axis. Departures from ``chain.py``:

- Tensors are torch float64 on any device; the causal FIRs are FFT
  convolutions from zero history, as ``chain.py``'s ``_fft_conv``.
- The filter designs are rewritten here (the windowed-sinc low-pass and
  band-pass, the root-raised cosine, as ``portbench/reference/filters.py``
  writes them) so that the file stands alone; so is the RF front end's
  one-sample delay of the discriminator (zero history).
- The PLLs run their per-sample recurrence on Python floats, a row at a
  time (float64, the same operations as ``chain.py``'s vectorized loop,
  without a tensor operation per sample).
- Added: the RDS path, which ``chain.py`` does not have, from the
  receiver's mathematics: the RDS band-pass (54-60 kHz), squared, the
  band-pass at 114 kHz, a PLL at 114 kHz whose NCO runs at half its
  phase (57 kHz, ``pll_bw_rds``), the band delayed by half the taps and
  mixed (x 2), then per block of the RF input, as the receiver does, the
  rational resampler to 39 samples a symbol (up/down reduced from the RDS
  rate over the IF rate, a 3 kHz low-pass at the upsampled rate, the
  polyphase phase restarting at each block from the block's carried input
  tail), the root-raised-cosine filter, and the slicer: the symbol clock
  as the comb phase of largest |energy| over the block (ties to the
  lowest), one symbol a clock tick (> 0), the Manchester pairing (its
  alignment scored on the first decoded block, a trailing half symbol
  carried) and the differential decode, from the seventh block on (the
  receiver's warm-up gate).

``precision="bf16"`` is the control: every operand and every stage's
output rounded to bfloat16 (through float32, as ``chain.py``'s
``bf16_round``), the arithmetic between kept wide.

The constructor turns TF32 off for CUDA matrix products and convolutions
(``torch.backends.cuda.matmul.allow_tf32``, ``cudnn.allow_tf32``), so no
float32 operation it might reach runs in a lower precision. Imports
nothing but torch and the standard library.
"""

from __future__ import annotations

import math

import torch

PRECISIONS = ("f64", "bf16")
WARM_BLOCKS_RDS = 6      # the receiver decodes RDS bits from block 7 on

__all__ = ["TunerBank", "design_lpf", "design_bpf", "design_rrc",
           "PRECISIONS"]


# -- filter designs (the receiver's, float64) ------------------------------

def _hann(taps: int) -> torch.Tensor:
    w = torch.sin(torch.arange(taps, dtype=torch.float64) * math.pi / taps)
    return w * w


def design_lpf(fs: float, fc: float, taps: int,
               gain: float = 1.0) -> torch.Tensor:
    """Windowed-sinc low-pass (Hann window sin^2(pi i / N))."""
    nc = fc / (fs / 2.0)
    i = torch.arange(taps, dtype=torch.float64)
    h = gain * nc * torch.sinc(nc * (i - (taps - 1) / 2.0))
    return h * _hann(taps)


def design_bpf(fs: float, f_low: float, f_high: float,
               taps: int) -> torch.Tensor:
    """Windowed-sinc band-pass by cosine modulation."""
    center = ((f_high + f_low) / 2.0) / (fs / 2.0)
    width = (f_high - f_low) / (fs / 2.0)
    i = torch.arange(taps, dtype=torch.float64)
    h = width * torch.sinc((width / 2.0) * (i - (taps - 1) // 2))
    return h * torch.cos(i * math.pi * center) * _hann(taps)


def design_rrc(fs: float, taps: int, symbol_rate: float,
               beta: float) -> torch.Tensor:
    """Root-raised cosine, its time axis centred at taps/2, the removable
    singularities by their textbook limits."""
    T = 1.0 / symbol_rate
    t = (torch.arange(taps, dtype=torch.float64) - taps / 2.0) / fs
    num = (torch.sin(math.pi * t * (1 - beta) / T)
           + 4.0 * beta * (t / T) * torch.cos(math.pi * t * (1 + beta) / T))
    h = num / (math.pi * t * (1.0 - (4.0 * beta * t / T) ** 2) / T)
    h = torch.where(t == 0.0, 1.0 + beta * (4.0 / math.pi - 1.0), h)
    h_sing = (beta / math.sqrt(2.0)) * (
        (1 + 2.0 / math.pi) * math.sin(math.pi / (4.0 * beta))
        + (1 - 2.0 / math.pi) * math.cos(math.pi / (4.0 * beta)))
    sing = torch.isclose(t.abs(), torch.tensor(T / (4.0 * beta),
                                               dtype=torch.float64))
    return torch.where(sing, h_sing, h)


# -- signal operations -------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 through float32 (nearest, ties to even),
    as float64."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal convolution of every row of ``x`` with ``h`` from zero
    history: y[..., n] = sum_k h[k] x[..., n - k], n < N."""
    n, k = x.shape[-1], h.shape[0]
    size = 1 << math.ceil(math.log2(n + k - 1))
    y = torch.fft.irfft(torch.fft.rfft(x, size) * torch.fft.rfft(h, size),
                        size)
    return y[..., :n]


def delay(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` delayed by ``d`` samples from zero history (the centred
    impulse of an odd tap count)."""
    out = torch.zeros_like(x)
    out[..., d:] = x[..., :x.shape[-1] - d]
    return out


def discriminate(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(I dQ - Q dI) / (I^2 + Q^2) from zero history, 0 where I = Q = 0."""
    ip = torch.cat([torch.zeros_like(i[..., :1]), i[..., :-1]], -1)
    qp = torch.cat([torch.zeros_like(q[..., :1]), q[..., :-1]], -1)
    num = i * (q - qp) - q * (i - ip)
    den = i * i + q * q
    return torch.where(den == 0.0, 0.0,
                       num / torch.where(den == 0.0, 1.0, den))


def pll(x: torch.Tensor, freq: float, fs: float, nco_scale: float,
        norm_bw: float) -> torch.Tensor:
    """Type-2 second-order PLL with NCO from the unlocked state, one
    recurrence per sample, each row alone. Returns the carrier (R, N):
    out[0] = 1, out[n] = cos(nco_scale * arg[n - 1]) (the loop's
    one-sample delay)."""
    kp = norm_bw * 2.666
    ki = norm_bw * norm_bw * 3.555
    omega = 2.0 * math.pi * freq / fs
    rows = []
    for row in x.reshape(-1, x.shape[-1]).tolist():
        fbi, fbq, integ, phase = 1.0, 0.0, 0.0, 0.0
        out = [1.0]
        for k, xk in enumerate(row[:-1]):
            err = math.atan2(-xk * fbq, xk * fbi)
            integ += ki * err
            phase += kp * err + integ
            arg = omega * (k + 1) + phase
            fbi, fbq = math.cos(arg), math.sin(arg)
            out.append(math.cos(arg * nco_scale))
        rows.append(out)
    return torch.tensor(rows, dtype=torch.float64,
                        device=x.device).reshape(x.shape)


def resample_blocks(x: torch.Tensor, h: torch.Tensor, up: int, down: int,
                    block: int) -> torch.Tensor:
    """Polyphase rational resampler run block by block, as the receiver
    runs its RDS resampler: each block of ``block`` input samples gives
    block * up // down outputs, output n of a block at phase (n down) mod
    up over the block's input and the previous block's last ceil(K/up) - 1
    samples (zeros before the first block). (R, nb * block) -> (R, nb *
    (block * up // down))."""
    k = h.shape[0]
    t = -(-k // up)
    n_out = block * up // down
    rows, n = x.shape
    nb = n // block
    xx = torch.cat([torch.zeros(rows, t - 1, dtype=x.dtype,
                                device=x.device), x], -1)
    nn = torch.arange(n_out, device=x.device)
    phase = (nn * down) % up
    q = (nn * down) // up
    m = torch.arange(t, device=x.device)
    tap = phase[:, None] + up * m[None]                   # (n_out, t)
    hh = torch.where(tap < k, h[tap.clamp(max=k - 1)], 0.0)
    out = []
    for b in range(nb):
        idx = b * block + (t - 1) + q[:, None] - m[None]  # into xx
        out.append((xx[:, idx] * hh).sum(-1))
    return torch.cat(out, -1)


def _manchester_bits(symbols: list, first: bool, st: dict) -> list:
    """Manchester alignment and bits of one block's symbols, the
    alignment scored on the first decoded block, a trailing unpaired
    symbol carried into the next block's first bit (``st``: ``start``,
    ``half``)."""
    if not symbols:
        return []
    bits = [st["half"]] if st["start"] else []
    if first:
        score = sum(symbols[i] ^ symbols[i + 1]
                    for i in range(0, len(symbols) - 1, 2))
        score -= sum(symbols[j] ^ symbols[j + 1]
                     for j in range(1, len(symbols) - 1, 2))
        st["start"] = 1 if score < 0 else 0
    bits += symbols[st["start"]:len(symbols) - 1:2]
    if (len(symbols) - st["start"]) % 2:
        st["half"], st["start"] = symbols[-1], 1
    else:
        st["start"] = 0
    return bits


class TunerBank:
    """A bank of independent mode-0 style receivers from a configuration's
    ``receiver`` group (rates, cutoffs, taps, bands, loop bandwidths, the
    RDS rate, PCM scale)."""

    def __init__(self, rx: dict, precision: str = "f64",
                 device: str | torch.device = "cpu"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.rx = rx
        self.device = torch.device(device)
        self.q = _bf16 if precision == "bf16" else (lambda t: t)
        k, fs = rx["rf_taps"], rx["if_fs"]
        up = rx["audio_up"]
        rds_fs = int(rx["rds_symbol_rate"] * rx["rds_sps"])
        g = math.gcd(rds_fs, fs)
        self.rds_up, self.rds_down = rds_fs // g, fs // g
        dev = self.device

        def taps(h):
            return self.q(h).to(dev)
        self.rf_h = taps(design_lpf(rx["rf_fs"], rx["rf_fc"], k))
        self.pilot_h = taps(design_bpf(fs, *rx["pilot_band"], k))
        self.band_h = taps(design_bpf(fs, *rx["stereo_band"], k))
        self.audio_h = taps(design_lpf(fs * up, rx["audio_fc"], k * up,
                                       gain=up))
        self.rds_h = taps(design_bpf(fs, *rx["rds_band"], k))
        self.sq_h = taps(design_bpf(fs, *rx["rds_squared_band"], k))
        self.bb_h = taps(design_lpf(fs * self.rds_up, rx["rds_baseband_fc"],
                                    k * self.rds_up, gain=self.rds_up))
        self.rrc_h = taps(design_rrc(rds_fs, k, rx["rds_symbol_rate"],
                                     rx["rds_rrc_beta"]))
        self.delay = (k - 1) // 2

    # -- front end --------------------------------------------------------
    def demod(self, iq_u8: torch.Tensor) -> torch.Tensor:
        """(T, 2N) uint8 interleaved I/Q at the RF rate -> (T, N / decim)
        FM demod at the IF rate."""
        x = (iq_u8.to(self.device, torch.float64) - 128.0) / 128.0
        d = self.rx["rf_decim"]
        i = self.q(fir(x[..., 0::2], self.rf_h)[..., ::d])
        q = self.q(fir(x[..., 1::2], self.rf_h)[..., ::d])
        return self.q(discriminate(i, q))

    # -- stereo chain -----------------------------------------------------
    def stereo(self, fm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(T, N) IF demod -> (left, right), each (T, N up / down)."""
        rx, q = self.rx, self.q
        pilot = q(fir(fm, self.pilot_h))
        carrier = q(pll(pilot, rx["pilot_freq"], rx["if_fs"], 2.0,
                        rx["pll_bw_stereo"]))
        sub_dc = q(2.0 * q(fir(fm, self.band_h)) * carrier)
        mono = q(self.resample(delay(fm, self.delay)))
        sub = q(self.resample(sub_dc))
        return mono + sub, mono - sub

    def resample(self, x: torch.Tensor) -> torch.Tensor:
        """The audio resampler: zero-stuff by up, filter, keep every
        down-th output."""
        up, down = self.rx["audio_up"], self.rx["audio_down"]
        if up > 1:
            v = torch.zeros(x.shape[:-1] + (x.shape[-1] * up,),
                            dtype=x.dtype, device=x.device)
            v[..., ::up] = x
            x = v
        return fir(x, self.audio_h)[..., ::down]

    def pcm(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """int16 interleaved L, R: scaled, clipped, truncated toward
        zero."""
        s = torch.stack([left, right], -1) * float(self.rx["audio_scale"])
        s = torch.trunc(s.clamp(-32768.0, 32767.0)).to(torch.int16)
        return s.reshape(s.shape[:-2] + (-1,))

    # -- RDS --------------------------------------------------------------
    def rds_clean(self, fm: torch.Tensor) -> torch.Tensor:
        """(T, nb * if_block) IF demod -> (T, nb, rds_block) RRC output,
        block by block as the receiver resamples."""
        rx, q = self.rx, self.q
        band = q(fir(fm, self.rds_h))
        pil = q(fir(q(band * band), self.sq_h))
        car = q(pll(pil, rx["rds_pilot_freq"], rx["if_fs"], 0.5,
                    rx["pll_bw_rds"]))
        mixed = q(2.0 * delay(band, self.delay) * car)
        if_block = rx["block_size_iq"] // rx["rf_decim"]
        filt = q(resample_blocks(mixed, self.bb_h, self.rds_up,
                                 self.rds_down, if_block))
        clean = q(fir(filt, self.rrc_h))
        nb = fm.shape[-1] // if_block
        return clean.reshape(fm.shape[0], nb, -1)

    def rds_bits(self, clean: torch.Tensor) -> list[list[list[int]]]:
        """(T, nb, L) RRC output -> per tuner, per block, the decoded bits
        (none before the warm-up gate opens)."""
        sps = self.rx["rds_sps"]
        out = []
        for row in clean.cpu():
            st, last, blocks = dict(start=0, half=0), 0, []
            for b, blk in enumerate(row):
                if b < WARM_BLOCKS_RDS:
                    blocks.append([])
                    continue
                first = b == WARM_BLOCKS_RDS
                n = blk.shape[0] // sps
                comb = blk[:n * sps].abs().reshape(n, sps).sum(0)
                off = int(torch.argmax(comb))
                syms = (blk[off::sps] > 0).to(torch.int64).tolist()
                bits = _manchester_bits(syms, first, st)
                # differential decode: the first decoded bit against 0,
                # then each against the bit before it, across blocks
                prev = [0 if first else last] + bits[:-1]
                blocks.append([a ^ p for a, p in zip(bits, prev)])
                if bits:
                    last = bits[-1]
            out.append(blocks)
        return out

    def decode(self, iq_u8: torch.Tensor):
        """(T, nb * 2 block_size_iq) uint8 -> (PCM (T, nb * 2 audio_block)
        int16, RDS bits per tuner and block)."""
        fm = self.demod(iq_u8)
        left, right = self.stereo(fm)
        return self.pcm(left, right), self.rds_bits(self.rds_clean(fm))
