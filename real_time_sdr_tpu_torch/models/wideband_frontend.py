"""Fused wideband frontend: one matmul from wideband IQ to per-station FM
demod at the IF rate.

Port of ``real_time_sdr_tpu/models/wideband_frontend.py``. The two-stage
chain (``models/channelizer.py`` fold matmul -> u8 station streams ->
receiver frontend) is a cascade of two LTI decimators, and mixing commutes
with LTI filtering, so the whole cascade folds into ONE framed matmul at
the wide rate:

    h_eq = h_chan (*) upsample_D(h_front)        (exact polyphase identity)
    y_s[u] = e^{-j*w_s*Dt*u} * sum_t (h_eq[t] e^{+j*w_s*t}) * x[u*Dt - t]

with Dt = D * rf_decim. On a periodic station grid the IF-rate tone
static-folds into the weights as in the channelizer (R = lcm(8, lo)), so
only a per-segment (S,) rotation remains, and the FM discriminator runs on
the matmul's result: demod comes out directly, with no u8 hop and no
per-station frontend. The matmul stays ``torch.matmul`` in float32 (no
Pallas kernel did it); bf16/bf16x2 weights are not ported.

``make_wideband_frontend`` is the one policy point: the fused frontend on
every eligible grid (every real raster), else the two-stage Channelizer.
Feed either to ``parallel.channel.ChannelBank.run_wideband`` or
``run_wideband_u8``, which dispatch on its type.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from real_time_sdr_tpu_torch.config import ReceiverConfig
from real_time_sdr_tpu_torch.device import resolve_device
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.models.channelizer import (FOLD_R, Channelizer,
                                                        _check_rails,
                                                        frame_rail, lcm_of)
from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import rotate_stations

__all__ = ["make_wideband_frontend", "FusedWidebandState", "u8_to_rails",
           "FusedWidebandFrontend", "WB_LCM_MAX"]

WB_LCM_MAX = 32  # largest IF-rate tone lcm the fused fold accepts


def make_wideband_frontend(cfg: ReceiverConfig, wide_fs: int,
                           offsets_hz: list[int], taps_factor: int = 2,
                           device: str | torch.device | None = None):
    """The fused one-matmul frontend when the station grid is eligible
    (every real raster is), else the two-stage Channelizer + uint8
    receiver path, on ``device``: the card unless the caller names another
    (``None`` is ``"cuda"`` and raises without one, as ``Receiver``)."""
    dev = resolve_device(device)
    if FusedWidebandFrontend.eligible(cfg, wide_fs, offsets_hz):
        return FusedWidebandFrontend(cfg, wide_fs, offsets_hz,
                                     taps_factor=taps_factor).to(dev)
    return Channelizer(cfg, wide_fs, offsets_hz,
                       taps_factor=taps_factor).to(dev)


class FusedWidebandState(NamedTuple):
    i_tail: torch.Tensor   # (K_eq-1,) raw wideband rail history
    q_tail: torch.Tensor
    prev_i: torch.Tensor   # (S,) carried discriminator samples
    prev_q: torch.Tensor
    pos: torch.Tensor      # () int32 IF-rate sample count mod lo


def u8_to_rails(raw_u8: torch.Tensor):
    """Interleaved raw uint8 capture (2N,) -> ((N,) f32 i, q), computed on
    the capture's device: (x - 128) / 128, then the even and odd samples.
    Live ingest ships bytes to the card, a quarter of the f32 rails."""
    if raw_u8.ndim != 1 or raw_u8.dtype != torch.uint8 or raw_u8.shape[0] % 2:
        raise ValueError(f"raw capture must be (2N,) uint8, got "
                         f"{raw_u8.dtype} {tuple(raw_u8.shape)}")
    x = (raw_u8.to(torch.float32) - 128.0) * (1.0 / 128.0)
    return x[0::2], x[1::2]


class FusedWidebandFrontend(nn.Module):
    """Wideband rails -> per-station IF-rate FM demod, one f32 matmul.

    Needs a periodic station grid whose IF-rate tone lcm is at most
    ``WB_LCM_MAX`` (``eligible``); other grids take Channelizer + the u8
    receiver path. The weights (2J, R*2S) and the rotation tables (lo, S)
    are buffers; ``retune`` rewrites one station's columns in place.
    """

    @staticmethod
    def _tone_period(f: int, dt: int, p: int) -> int:
        """IF-rate output-tone period of one station offset."""
        fd = (int(f) * dt) % p
        return p // math.gcd(fd, p) if fd else 1

    @classmethod
    def output_lcm(cls, wide_fs: int, rf_fs: int, rf_decim: int,
                   offsets_hz: list[int]) -> int:
        """lcm over stations of the IF-rate tone period (lo)."""
        p = int(wide_fs)
        dt = (p // int(rf_fs)) * int(rf_decim)
        return lcm_of(cls._tone_period(f, dt, p) for f in offsets_hz)

    @classmethod
    def eligible(cls, cfg: ReceiverConfig, wide_fs: int,
                 offsets_hz: list[int], cap: int | None = None) -> bool:
        """True when the fused path applies: wide_fs a multiple of the
        station rate and the IF-rate tone lcm at most ``cap`` (default
        ``WB_LCM_MAX``; the weights grow ~quadratically with it)."""
        if wide_fs % cfg.rf_fs:
            return False
        cap = WB_LCM_MAX if cap is None else cap
        return cls.output_lcm(wide_fs, cfg.rf_fs, cfg.rf_decim,
                              offsets_hz) <= cap

    def __init__(self, cfg: ReceiverConfig, wide_fs: int,
                 offsets_hz: list[int], taps_factor: int = 2):
        super().__init__()
        if wide_fs % cfg.rf_fs:
            raise ValueError(f"wide_fs {wide_fs} is not a multiple of the "
                             f"station rate {cfg.rf_fs}")
        if len(offsets_hz) == 0:
            raise ValueError("a wideband frontend needs at least one station")
        self.cfg = cfg
        self.wide_fs = int(wide_fs)
        self.offsets = [int(f) for f in offsets_hz]
        d = self.wide_fs // cfg.rf_fs
        self.decim = d
        self.dt = d * cfg.rf_decim          # wide rate -> IF rate
        # combined taps: the channelizer LPF convolved with the frontend
        # LPF upsampled to the wide rate
        k_c = cfg.rf_taps * taps_factor + 1
        h_c = np.asarray(filters.design_lpf(self.wide_fs,
                                            cfg.rf_fs / 2 * 0.8, k_c),
                         dtype=np.float64)
        h_f = np.asarray(filters.design_lpf(cfg.rf_fs, cfg.rf_fc,
                                            cfg.rf_taps), dtype=np.float64)
        h_up = np.zeros(d * (cfg.rf_taps - 1) + 1, dtype=np.float64)
        h_up[::d] = h_f
        self._h_eq = np.convolve(h_c, h_up)
        self.k_eq = self._h_eq.shape[0]     # k_c + d*(rf_taps-1)
        self.tail_len = self.k_eq - 1
        lo = self.output_lcm(self.wide_fs, cfg.rf_fs, cfg.rf_decim,
                             self.offsets)
        if lo > WB_LCM_MAX:
            raise ValueError(
                f"station grid's IF-rate tone lcm {lo} > {WB_LCM_MAX}; use "
                "Channelizer + the uint8 receiver path for this grid")
        self.lo = lo
        self._init_weights(FOLD_R * lo // math.gcd(FOLD_R, lo))

    def _station_cols(self, f: int):
        """One station's fold columns and rotation rows, host float64:
        (a_cols (2J, R) real-rail columns, b_cols (2J, R) imaginary,
        pc_col (lo,), ps_col (lo,))."""
        p, dt, k_eq, h = self.wide_fs, self.dt, self.k_eq, self._h_eq
        r_n, j_w = self.r_n, self.j_w
        t = np.arange(k_eq, dtype=np.int64)
        ang_t = 2.0 * np.pi * (((f % p) * t) % p).astype(np.float64) / p
        hc, hs = h * np.cos(ang_t), h * np.sin(ang_t)
        u = np.arange(max(self.lo, r_n), dtype=np.int64)
        ang_u = (-2.0 * np.pi
                 * ((((f * dt) % p) * u) % p).astype(np.float64) / p)
        uc_r, us_r = np.cos(ang_u[:r_n]), np.sin(ang_u[:r_n])
        a_cols = np.zeros((2 * j_w, r_n))
        b_cols = np.zeros((2 * j_w, r_n))
        for r in range(r_n):
            rows = (k_eq - 1) + r * dt - t
            a = np.zeros(2 * j_w)
            b = np.zeros(2 * j_w)
            a[rows], a[j_w + rows] = hc, -hs
            b[rows], b[j_w + rows] = hs, hc
            a_cols[:, r] = a * uc_r[r] - b * us_r[r]
            b_cols[:, r] = b * uc_r[r] + a * us_r[r]
        return a_cols, b_cols, np.cos(ang_u[:self.lo]), np.sin(ang_u[:self.lo])

    def _init_weights(self, r_n: int) -> None:
        """(2J, R*2S) fold weights, col = r*2S + u (u < S real rail)."""
        s_ch = len(self.offsets)
        self.r_n = r_n
        self.j_w = self.k_eq + (r_n - 1) * self.dt
        w2 = np.zeros((2 * self.j_w, r_n * 2 * s_ch))
        pc = np.zeros((self.lo, s_ch))
        ps = np.zeros((self.lo, s_ch))
        for si, f in enumerate(self.offsets):
            a_cols, b_cols, pc[:, si], ps[:, si] = self._station_cols(f)
            for r in range(r_n):
                base = r * 2 * s_ch
                w2[:, base + si] = a_cols[:, r]
                w2[:, base + s_ch + si] = b_cols[:, r]
        # buffers that own their memory (torch.tensor copies)
        self.register_buffer("w", torch.tensor(w2.astype(np.float32)))
        self.register_buffer("pc", torch.tensor(pc.astype(np.float32)))
        self.register_buffer("ps", torch.tensor(ps.astype(np.float32)))

    def station_subset(self, stations: slice) -> "FusedWidebandFrontend":
        """A copy that computes only ``stations`` (a slice of the station
        axis): the same taps, ``lo``, R and J with the weights' columns and
        the rotation tables cut down, so a shard runs ``core`` on exactly
        the columns the whole frontend would. The copy owns its buffers, so
        a ``retune`` of it touches no other."""
        sub = copy.deepcopy(self)
        s_ch = len(self.offsets)
        sub.offsets = self.offsets[stations]
        if not sub.offsets:
            raise ValueError(f"{stations} selects no station of {s_ch}")
        w4 = self.w.reshape(2 * self.j_w, self.r_n, 2, s_ch)
        sub.w = w4[..., stations].reshape(2 * self.j_w, -1).clone()
        sub.pc = self.pc[:, stations].clone()
        sub.ps = self.ps[:, stations].clone()
        return sub

    def retune(self, station: int, offset_hz: int) -> None:
        """Re-point one station at a new offset: its columns are rebuilt on
        the host and copied into the buffers on the current stream, so work
        queued before the retune still reads the old weights.

        The new offset's IF-rate tone period must divide ``lo`` (true for
        any retune within the raster the frontend was built on)."""
        if not 0 <= station < len(self.offsets):
            raise ValueError(
                f"station {station} out of range [0, {len(self.offsets)})")
        f = int(offset_hz)
        per = self._tone_period(f, self.dt, self.wide_fs)
        if self.lo % per:
            raise ValueError(
                f"offset {f} Hz has IF-tone period {per}, not a divisor "
                f"of this grid's lo={self.lo}; rebuild the frontend for "
                "off-raster offsets")
        s_ch = len(self.offsets)
        a_cols, b_cols, pc_col, ps_col = self._station_cols(f)
        cols = np.concatenate([np.arange(self.r_n) * 2 * s_ch + station,
                               np.arange(self.r_n) * 2 * s_ch + s_ch
                               + station])
        new_cols = np.concatenate([a_cols, b_cols], axis=1)
        dev = self.w.device
        for buf, idx, val in ((self.w, cols, new_cols),
                              (self.pc, [station], pc_col[:, None]),
                              (self.ps, [station], ps_col[:, None])):
            buf.index_copy_(1, torch.tensor(idx, device=dev), torch.from_numpy(
                val.astype(np.float32)).to(dev, buf.dtype))
        self.offsets[station] = f

    def init_state(self) -> FusedWidebandState:
        s, dev, dt = len(self.offsets), self.w.device, self.w.dtype
        z = torch.zeros((self.tail_len,), dtype=dt, device=dev)
        return FusedWidebandState(
            z, z.clone(), torch.zeros((s,), dtype=dt, device=dev),
            torch.zeros((s,), dtype=dt, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))

    def _plan(self, n: int):
        if n % self.dt:
            raise ValueError(f"segments must be a multiple of {self.dt} "
                             f"wideband samples, got {n}")
        n_if = n // self.dt
        return n_if, self.r_n * self.dt, -(-n_if // self.r_n)

    def core(self, w_cols, pc_t, ps_t, i_tail, q_tail, prev_i, prev_q,
             pos, i_wide: torch.Tensor, q_wide: torch.Tensor):
        """The fused-frontend math on any station-column subset:
        w_cols (2J, R*2*s_l), pc_t/ps_t (lo, s_l), prev_i/prev_q (s_l,).
        Returns (demod (s_l, n_if), last_i, last_q)."""
        n_if, stride, c_frames = self._plan(i_wide.shape[-1])
        r_n = self.r_n
        s_l = w_cols.shape[-1] // (2 * r_n)
        xi = torch.cat([i_tail, i_wide])
        xq = torch.cat([q_tail, q_wide])
        fr = torch.cat([frame_rail(xi, c_frames, stride, self.j_w),
                        frame_rail(xq, c_frames, stride, self.j_w)], dim=-1)
        y = fr @ w_cols                                   # (c, R*2*s_l)
        # residual per-segment rotation (constant over the segment)
        pos_l = (pos % self.lo).reshape(1)
        pc = pc_t.index_select(0, pos_l)[0]
        ps = ps_t.index_select(0, pos_l)[0]
        i_t, q_t = (z.reshape(-1, s_l)[:n_if]             # (n_if, s_l)
                    for z in rotate_stations(y, pc, ps, r_n, s_l))
        # discriminator in the matmul's time-major layout, then ONE
        # transpose of the demod
        ip = torch.cat([prev_i[None, :], i_t[:-1]])
        qp = torch.cat([prev_q[None, :], q_t[:-1]])
        num = i_t * (q_t - qp) - q_t * (i_t - ip)
        den = i_t * i_t + q_t * q_t
        zero = (i_t == 0.0) & (q_t == 0.0)
        demod_t = torch.where(zero, torch.zeros_like(num),
                              num / torch.where(den == 0.0,
                                                torch.ones_like(den), den))
        return (demod_t.T.contiguous(), i_t[n_if - 1].clone(),
                q_t[n_if - 1].clone())

    @torch.no_grad()
    def forward(self, i_wide: torch.Tensor, q_wide: torch.Tensor,
                state: FusedWidebandState):
        """i_wide, q_wide: (N,) at wide_fs, N % (D*rf_decim) == 0, in the
        weights' dtype (float32; float64 after ``.double()``).
        Returns (demod (S, N // (D*rf_decim)), new state)."""
        _check_rails(i_wide, q_wide, self.w.dtype)
        demod, last_i, last_q = self.core(
            self.w, self.pc, self.ps, state.i_tail, state.q_tail,
            state.prev_i, state.prev_q, state.pos, i_wide, q_wide)
        new = FusedWidebandState(
            _rail_tail(state.i_tail, i_wide), _rail_tail(state.q_tail, q_wide),
            last_i, last_q, (state.pos + demod.shape[-1]) % self.lo)
        return demod, new


def _rail_tail(tail: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The last len(tail) samples of [tail | x], as a fresh tensor."""
    tl, n = tail.shape[0], x.shape[0]
    if n >= tl:
        return x[n - tl:].clone()
    return torch.cat([tail[n:], x])
