"""Wideband channelizer: one capture -> many station basebands.

Port of ``real_time_sdr_tpu/models/channelizer.py``. Per station: complex
mix by the offset tone, then low-pass + decimate both rails (batched over
stations). Tones are computed on the host with integer phase reduction,
exp(-2*pi*j*((f*k) mod fs)/fs), so they stay exact at any sample index.

Tone sources, picked from the station grid:

- PERIODIC: every integer offset f has tone period fs/gcd(f, fs); when the
  lcm of the periods is <= 65536 the tones are (S, lcm) tables cycled by
  ONE carried integer position ``pos``, integer-exact across segments.
- GENERAL: full-length tables plus a carried unit phasor advanced by the
  per-segment rotation (f32 continuity, renormalized).

FOLD (periodic grids, the default; ``fold=False`` restores
mix-then-filter): mixing commutes with LTI filtering,

    y_s[m] = e^{-j*w_s*mD} * sum_t (h[t] e^{+j*w_s*t}) * x[mD-t]

so each station's tone folds into static complex bandpass taps; the shared
i/q rails are framed once, (c, 2J), and hit one f32 matmul against the
(2J, R*2S) weights. The leftover output-rate tone e^{-j*w_s*D*m}:

- STATIC (its lcm ``lo`` <= 32, every real raster): R = lcm(8, lo), so
  the r-part of the tone folds into the weight columns and only a
  per-segment (S,) rotation remains. ``call_u8`` finishes with the
  ``chan_epilogue`` kernel (rotation, quantize, station-major transpose,
  I/Q interleave) on the card.
- RUNTIME (lo > 32): the decimated-rate tone is applied from (S, lo)
  tables indexed by ``pos``.

``pos`` stays a device int32 tensor: tables are indexed with it on the
device, so a segment never waits on the host.

Precision (``compute_dtype``, the JAX package's ``RTSDR_CHAN_FIR``):
"f32" (the default; TF32 off) or "bf16". At bf16 the fold product takes
bf16 frames and bf16 weights and returns an f32 result (``fold_product``:
on the card one tensor-core GEMM with f32 accumulation), and the
mix-then-filter form rounds its mixed rails and taps to bf16
(``PolyFIR(compute_dtype="bf16")``). The epilogue, the tables and every
state leaf stay f32 / int32; the carried raw-rail tails are the f32
inputs.
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
from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import (chan_epilogue,
                                                            quantize_u8,
                                                            rotate_stations)
from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank

__all__ = ["ChannelizerState", "Channelizer", "frame_rail", "lcm_of",
           "fold_product", "fold_product_plain", "cat_k"]

TONE_LCM_MAX = 65536   # periodic tone tables up to this many samples
FOLD_R = 8             # outputs per fold frame before lcm promotion
FOLD_STATIC_MAX = 32   # largest output-rate tone lcm folded statically
CHAN_DTYPES = ("f32", "bf16")
# a bf16 product's depth K is zero-padded to a multiple of this: 16-byte
# operand rows, without which the library's GEMM takes a slower kernel
# (2.6-3.2x at the 64-station shapes, PERF.md)
BF16_K_ALIGN = 8


class ChannelizerState(NamedTuple):
    i_tails: torch.Tensor  # (S, T-1) decimator tails; fold: (1, K-1) raw rail
    q_tails: torch.Tensor
    ph_re: torch.Tensor    # (S,) carried tone phasor (general mode; held at
    ph_im: torch.Tensor    # (1, 0) otherwise)
    pos: torch.Tensor      # () int32 table position (periodic modes)


def lcm_of(periods, cap: int | None = None) -> int:
    """lcm of the periods; stops early once it exceeds ``cap``."""
    out = 1
    for q in periods:
        out = out * q // math.gcd(out, q)
        if cap is not None and out > cap:
            break
    return out


def frame_rail(xx: torch.Tensor, c_frames: int, stride: int,
               j_w: int) -> torch.Tensor:
    """(L,) rail -> (c_frames, J) windows advancing by ``stride`` (a view of
    the zero-padded rail)."""
    need = (c_frames - 1) * stride + j_w
    if xx.shape[-1] < need:
        xx = torch.nn.functional.pad(xx, (0, need - xx.shape[-1]))
    return xx[:need].unfold(0, j_w, stride)


def fold_product(fr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fold matmul (c, K) @ (K, N) with a float32 result. f32 operands:
    one f32 matmul. bf16 operands: every product of two bf16 values is
    exact in f32 and the sums run in f32, as the JAX package's einsum with
    ``preferred_element_type=float32``; on the card that is one bf16
    tensor-core GEMM with an f32 output, elsewhere ``fold_product_plain``.
    (``fr @ w`` of two bf16 tensors would round every output to bf16.)"""
    if w.dtype != torch.bfloat16:
        return fr @ w
    if fr.is_cuda:
        return torch.mm(fr, w, out_dtype=torch.float32)
    return fold_product_plain(fr, w)


def fold_product_plain(fr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of a bf16 ``fold_product``: both operands upcast
    to f32 (exact), one f32 matmul."""
    return fr.float() @ w.float()


def cat_k(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat(parts, dim)`` of a product's operand along its depth K
    (the frames' last dim, the weights' first); a bf16 operand's K is
    zero-padded to a multiple of BF16_K_ALIGN in the same copy (the zeros
    add exact zero products)."""
    pad = -sum(p.shape[dim] for p in parts) % BF16_K_ALIGN
    if parts[0].dtype == torch.bfloat16 and pad:
        shape = list(parts[0].shape)
        shape[dim] = pad
        parts = [*parts, parts[0].new_zeros(shape)]
    return torch.cat(parts, dim=dim)


def _check_rails(i_wide: torch.Tensor, q_wide: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> None:
    if i_wide.ndim != 1 or q_wide.shape != i_wide.shape:
        raise ValueError(f"i_wide, q_wide must be (N,) of one length, got "
                         f"{tuple(i_wide.shape)}, {tuple(q_wide.shape)}")
    if i_wide.dtype != dtype or q_wide.dtype != dtype:
        raise TypeError(f"wideband rails are {dtype}, got {i_wide.dtype}/"
                        f"{q_wide.dtype}")


class Channelizer(nn.Module):
    """Extract S stations from a wideband complex capture.

    wide_fs must be an integer multiple of the station rate cfg.rf_fs;
    offsets_hz are integer station offsets from the capture center.
    Tables and weights are buffers built on ``device``: the card unless the
    caller names another (``None`` is ``"cuda"`` and raises
    ``RuntimeError`` without one, as ``Receiver``). ``compute_dtype``:
    "f32" or "bf16" (module docstring).

        ch = Channelizer(cfg, 8 * cfg.rf_fs, offsets)
        u8, cstate = ch.call_u8(i_wide, q_wide, ch.init_state())
    """

    def __init__(self, cfg: ReceiverConfig, wide_fs: int,
                 offsets_hz: list[int], taps_factor: int = 2,
                 fold: bool = True, compute_dtype: str = "f32",
                 device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        if compute_dtype not in CHAN_DTYPES:
            raise ValueError(f"the channelizer computes in one of "
                             f"{CHAN_DTYPES}, got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        if wide_fs % cfg.rf_fs:
            raise ValueError(f"wide_fs {wide_fs} is not a multiple of the "
                             f"station rate {cfg.rf_fs}")
        if len(offsets_hz) == 0:
            raise ValueError("a channelizer needs at least one station")
        self.cfg = cfg
        self.wide_fs = int(wide_fs)
        self.decim = self.wide_fs // cfg.rf_fs
        self.offsets = [int(f) for f in offsets_hz]
        taps = cfg.rf_taps * taps_factor + 1
        h = filters.design_lpf(self.wide_fs, cfg.rf_fs / 2 * 0.8, taps)
        self._h64 = np.asarray(h, dtype=np.float64)
        self.fir = PolyFIR(self._h64, up=1, down=self.decim,
                           compute_dtype=compute_dtype)
        self.bank = make_bank([self.fir])
        self._tone_cache: dict[tuple, tuple] = {}
        p = self.wide_fs
        pers = [p // math.gcd(f % p, p) if f % p else 1 for f in self.offsets]
        lcm = lcm_of(pers, cap=TONE_LCM_MAX)
        self.tone_period = lcm if lcm <= TONE_LCM_MAX else 0
        if self.tone_period:
            k = np.arange(self.tone_period, dtype=np.int64)
            ang = np.stack([-2.0 * np.pi
                            * (((f % p) * k) % p).astype(np.float64) / p
                            for f in self.offsets])
            self.register_buffer("per_c", torch.tensor(
                np.cos(ang).astype(np.float32)))
            self.register_buffer("per_s", torch.tensor(
                np.sin(ang).astype(np.float32)))
        self.fold = bool(self.tone_period) and bool(fold)
        self.fold_static = False
        if self.fold:
            self._init_fold(taps)
        self.to(dev)

    def _init_fold(self, k_taps: int) -> None:
        """Fold weights (2J, R*2S), col = r*2S + u (u < S the real rail),
        and the output-rate tone tables; see the module docstring."""
        p, d, s_ch = self.wide_fs, self.decim, len(self.offsets)
        h = self._h64
        pers = [p // math.gcd((f * d) % p, p) if (f * d) % p else 1
                for f in self.offsets]
        lo = lcm_of(pers)
        if self.tone_period % lo:
            raise ValueError(f"output-rate tone lcm {lo} does not divide the "
                             f"input-rate lcm {self.tone_period}")
        self.fold_L = lo
        self.fold_static = lo <= FOLD_STATIC_MAX
        r_n = FOLD_R * lo // math.gcd(FOLD_R, lo) if self.fold_static \
            else FOLD_R
        j_w = k_taps + (r_n - 1) * d        # window samples per frame
        t = np.arange(k_taps, dtype=np.int64)
        hc = np.empty((s_ch, k_taps))
        hs = np.empty((s_ch, k_taps))
        for si, f in enumerate(self.offsets):
            ang = 2.0 * np.pi * (((f % p) * t) % p).astype(np.float64) / p
            hc[si] = h * np.cos(ang)
            hs[si] = h * np.sin(ang)
        w2 = np.zeros((2 * j_w, r_n * 2 * s_ch))
        cols_s = np.arange(s_ch)[:, None]
        for r in range(r_n):
            # output r of a frame reads xx[(K-1) + r*D - t]
            rows = ((k_taps - 1) + r * d - t)[None, :]
            base = r * 2 * s_ch
            w2[rows, base + cols_s] = hc
            w2[j_w + rows, base + cols_s] = -hs
            w2[rows, base + s_ch + cols_s] = hs
            w2[j_w + rows, base + s_ch + cols_s] = hc
        u = np.arange(max(lo, r_n), dtype=np.int64)
        ang = np.stack([-2.0 * np.pi
                        * ((((f * d) % p) * u) % p).astype(np.float64) / p
                        for f in self.offsets])     # (S, max(lo, R))
        if self.fold_static:
            # rotate each (re, im) column pair by the static r-part of the
            # output tone: v' = v * e^{j*theta(r)} folded into the weights
            uc_r, us_r = np.cos(ang[:, :r_n]), np.sin(ang[:, :r_n])
            for r in range(r_n):
                base = r * 2 * s_ch
                cre = base + np.arange(s_ch)
                cim = base + s_ch + np.arange(s_ch)
                wre, wim = w2[:, cre].copy(), w2[:, cim].copy()
                w2[:, cre] = wre * uc_r[:, r] - wim * us_r[:, r]
                w2[:, cim] = wim * uc_r[:, r] + wre * us_r[:, r]
        self.fold_R, self.fold_J = r_n, j_w
        self.fold_tail = k_taps - 1
        w32 = torch.tensor(w2.astype(np.float32))
        self.register_buffer("fold_W", cat_k([w32.to(torch.bfloat16)], 0)
                             if self.compute_dtype == "bf16" else w32)
        if self.fold_static:
            # residual per-segment rotation, one (S,) row per pos
            self.register_buffer("fold_pc", torch.tensor(
                np.cos(ang[:, :lo]).T.astype(np.float32)))
            self.register_buffer("fold_ps", torch.tensor(
                np.sin(ang[:, :lo]).T.astype(np.float32)))
        else:
            self.register_buffer("fold_uc", torch.tensor(
                np.cos(ang[:, :lo]).astype(np.float32)))
            self.register_buffer("fold_us", torch.tensor(
                np.sin(ang[:, :lo]).astype(np.float32)))

    def station_subset(self, stations: slice) -> "Channelizer":
        """A copy that extracts only ``stations`` (a slice of the station
        axis): the same geometry (decimator, tone period, fold R, J and
        ``lo``) with the station-major tables and the fold weights' columns
        cut down, so a shard computes exactly the columns the whole
        channelizer would. The copy owns its buffers."""
        sub = copy.deepcopy(self)
        s_ch = len(self.offsets)
        sub.offsets = self.offsets[stations]
        if not sub.offsets:
            raise ValueError(f"{stations} selects no station of {s_ch}")
        sub._tone_cache = {}
        for name in ("per_c", "per_s", "fold_uc", "fold_us"):   # (S, n)
            if hasattr(self, name):
                setattr(sub, name, getattr(self, name)[stations].clone())
        for name in ("fold_pc", "fold_ps"):                     # (lo, S)
            if hasattr(self, name):
                setattr(sub, name, getattr(self, name)[:, stations].clone())
        if self.fold:
            rows = self.fold_W.shape[0]
            w4 = self.fold_W.reshape(rows, self.fold_R, 2, s_ch)
            sub.fold_W = w4[..., stations].reshape(rows, -1).clone()
        return sub

    @property
    def _device(self) -> torch.device:
        return self.bank.taps.device

    def _tones(self, n: int):
        """General mode: exact (S, n) f32 cos/sin tables of -2*pi*f*k/fs and
        the per-segment continuation rotation (S,), cached per (n, device)."""
        key = (n, self._device)
        if key in self._tone_cache:
            return self._tone_cache[key]
        p = self.wide_fs
        k = np.arange(n, dtype=np.int64)
        cs, sn, rots = [], [], []
        for f in self.offsets:
            fr = f % p
            if fr * n >= 2 ** 63:
                raise ValueError(f"segment of {n} samples overflows the "
                                 f"int64 phase of offset {f}")
            ang = -2.0 * np.pi * ((fr * k) % p).astype(np.float64) / p
            cs.append(np.cos(ang))
            sn.append(np.sin(ang))
            rots.append(np.exp(-2j * np.pi * ((fr * n) % p) / p))
        rot = np.array(rots)
        as_t = lambda a: torch.tensor(a.astype(np.float32),
                                      device=self._device)
        out = (as_t(np.stack(cs)), as_t(np.stack(sn)), as_t(rot.real),
               as_t(rot.imag))
        self._tone_cache[key] = out
        return out

    def init_state(self) -> ChannelizerState:
        s, dev = len(self.offsets), self._device
        if self.fold:
            # the fold carries the RAW wideband rail history (one pair
            # serves every station) and pos at the output rate
            t = torch.zeros((1, self.fold_tail), dtype=torch.float32,
                            device=dev)
        else:
            t = torch.zeros((s, self.fir.tail_len), dtype=torch.float32,
                            device=dev)
        return ChannelizerState(
            t, t.clone(), torch.ones((s,), dtype=torch.float32, device=dev),
            torch.zeros((s,), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))

    def _fold_call(self, i_wide: torch.Tensor, q_wide: torch.Tensor,
                   state: ChannelizerState, emit: str):
        n = i_wide.shape[-1]
        d, r_n = self.decim, self.fold_R
        if n % d:
            raise ValueError(f"the folded channelizer needs segments of a "
                             f"multiple of {d} samples, got {n}")
        n_out = n // d
        c_frames = -(-n_out // r_n)
        s_ch = len(self.offsets)
        xi = torch.cat([state.i_tails[0], i_wide])
        xq = torch.cat([state.q_tails[0], q_wide])
        y = fold_product(self.fold_frames(xi, xq, c_frames),
                         self.fold_W)                 # (c, R*2S) f32
        lo = self.fold_L
        pos = (state.pos % lo).reshape(1)
        if self.fold_static:
            pc = self.fold_pc.index_select(0, pos)[0]
            ps = self.fold_ps.index_select(0, pos)[0]
            if emit == "u8":
                out = chan_epilogue(y, pc, ps, r_n, s_ch, n_out)
            else:
                i_ds, q_ds = (z.permute(2, 0, 1).reshape(s_ch, -1)[:, :n_out]
                              for z in rotate_stations(y, pc, ps, r_n, s_ch))
        else:
            v = y.reshape(-1, 2 * s_ch)[:n_out].T      # (2S, n_out)
            v_re, v_im = v[:s_ch], v[s_ch:]
            # decimated-rate tone e^{-j*w*D*(pos+m)}, integer-exact
            idx = (pos + torch.arange(n_out, dtype=torch.int32,
                                      device=pos.device)) % lo
            uc = self.fold_uc.index_select(1, idx)
            us = self.fold_us.index_select(1, idx)
            i_ds = uc * v_re - us * v_im
            q_ds = uc * v_im + us * v_re
            if emit == "u8":
                out = self.to_uint8(i_ds, q_ds)
        tl = self.fold_tail
        new = ChannelizerState(xi[None, xi.shape[0] - tl:].clone(),
                               xq[None, xq.shape[0] - tl:].clone(),
                               state.ph_re, state.ph_im,
                               (state.pos + n_out) % lo)
        if emit == "u8":
            return out, new
        return (i_ds, q_ds), new

    def fold_frames(self, xi: torch.Tensor, xq: torch.Tensor,
                    c_frames: int) -> torch.Tensor:
        """The fold product's left operand: (c_frames, 2J) windows of the
        tail-prefixed f32 rails, in the weights' dtype (bf16 at bf16, K
        zero-padded as the weights' rows are)."""
        dt = self.fold_W.dtype
        return cat_k([frame_rail(x.to(dt), c_frames, self.fold_R * self.decim,
                                 self.fold_J) for x in (xi, xq)], -1)

    def fold_cost(self, n: int) -> dict:
        """Work of the fold product on an n-sample segment (``ops/fir.py``
        has the dict's keys): the two rails and their tails read once
        (2-byte elements at bf16), the weights once, the (c, R*2S) f32
        result written once; 2 x M x K x N for (c_frames, 2J) @ (2J,
        R*2S) (a bf16 product's zero padding of K, < BF16_K_ALIGN rows,
        is no work of the function). The ``chan_epilogue`` launch that
        reads the result counts in ``ops.cuda.chan_epilogue.epilogue_cost``.
        """
        if not self.fold:
            raise ValueError("only the folded channelizer has a fold product")
        c_frames = -(-(n // self.decim) // self.fold_R)
        k_dim, n_dim = 2 * self.fold_J, self.fold_R * 2 * len(self.offsets)
        el = self.fold_W.element_size()
        w_bytes = el * k_dim * n_dim
        return {"kind": f"chan_fold_{self.compute_dtype}",
                "flops": 2 * c_frames * k_dim * n_dim,
                "bytes": 2 * el * (n + self.fold_tail) + w_bytes
                + 4 * c_frames * n_dim,
                "w_bytes": w_bytes, "dims": (c_frames, k_dim, n_dim)}

    @torch.no_grad()
    def forward(self, i_wide: torch.Tensor, q_wide: torch.Tensor,
                state: ChannelizerState):
        """i_wide, q_wide: (N,) float32 at wide_fs.

        Returns ((S, N//decim) i/q station basebands, new state)."""
        _check_rails(i_wide, q_wide)
        if self.fold:
            return self._fold_call(i_wide, q_wide, state, emit="f32")
        n = i_wide.shape[-1]
        if self.tone_period:
            idx = (state.pos + torch.arange(n, dtype=torch.int32,
                                            device=i_wide.device)
                   ) % self.tone_period
            c = self.per_c.index_select(1, idx)
            s_ = self.per_s.index_select(1, idx)
        else:
            tone_c, tone_s, rot_re, rot_im = self._tones(n)
            # effective tone = table * carried phasor (complex multiply)
            c = tone_c * state.ph_re[:, None] - tone_s * state.ph_im[:, None]
            s_ = tone_s * state.ph_re[:, None] + tone_c * state.ph_im[:, None]
        # (i + jq) * (c + j s_): downshift by +offset
        mi = i_wide[None, :] * c - q_wide[None, :] * s_
        mq = q_wide[None, :] * c + i_wide[None, :] * s_
        # both rails through ONE FIR-bank call (rows = 2S); a bf16 bank
        # rounds them to bf16 (the JAX package's bf16 mixed rails)
        s_ch = len(self.offsets)
        (ds,), tails = self.bank(torch.cat([mi, mq]),
                                 torch.cat([state.i_tails, state.q_tails]))
        i_ds, q_ds = ds[:s_ch], ds[s_ch:]
        i_tails, q_tails = tails[:s_ch], tails[s_ch:]
        if self.tone_period:
            new = ChannelizerState(i_tails, q_tails, state.ph_re,
                                   state.ph_im,
                                   (state.pos + n) % self.tone_period)
        else:
            # advance + renormalize the continuity phasor
            pr = state.ph_re * rot_re - state.ph_im * rot_im
            pi_ = state.ph_re * rot_im + state.ph_im * rot_re
            norm = torch.rsqrt(pr * pr + pi_ * pi_)
            new = ChannelizerState(i_tails, q_tails, pr * norm, pi_ * norm,
                                   state.pos)
        return (i_ds, q_ds), new

    @torch.no_grad()
    def call_u8(self, i_wide: torch.Tensor, q_wide: torch.Tensor,
                state: ChannelizerState):
        """Channelize straight to the receivers' interleaved uint8
        interface: (u8 (S, 2*N//decim), new state). Bit-identical to
        ``to_uint8(*self(i, q, state))``; in static-fold mode it ends in
        the ``chan_epilogue`` kernel, so the (2S, n_out) f32 basebands are
        never materialized."""
        if self.fold and self.fold_static:
            _check_rails(i_wide, q_wide)
            return self._fold_call(i_wide, q_wide, state, emit="u8")
        (i_ds, q_ds), st = self(i_wide, q_wide, state)
        return self.to_uint8(i_ds, q_ds), st

    @staticmethod
    def to_uint8(i_ds: torch.Tensor, q_ds: torch.Tensor) -> torch.Tensor:
        """Re-encode station basebands (S, n) to the receivers' interleaved
        uint8 interface (S, 2n), as a hardware tuner would."""
        s, n = i_ds.shape
        return quantize_u8(torch.stack([i_ds, q_ds], dim=-1)).reshape(s, 2 * n)
