"""Streaming FIRs with overlap-save carried state: polyphase resampling,
same-geometry banks, and the dual-phase frontend LPF.

Port of ``real_time_sdr_tpu/ops/fir.py``. Every (up, down) FIR reduces to
one framed matmul: group R consecutive outputs (R = up*g, g chosen so R is
~128) into a frame; the frame reads a J-sample window of the tail-prefixed
input advancing by g*down samples per frame,

    y[c*R + r] = sum_j xx[c*g*down + j] * W[j, r]
    W[j, r]    = h[p_r + up*m]   at j = T-1 + qr_r - m, else 0

with p_r = (r*down) % up, qr_r = (r*down) // up, T = ceil(K/up). The same
outputs in direct form are y[n] = sum_m h[p_n + up*m] xx[q_n + T-1 - m],
which is what the CUDA FIR-bank kernel computes (ops/cuda/fir_bank.py).

State contract: the carry holds the last ``T-1`` input samples. A
single-nonzero-tap filter (the all-pass delay) lowers to a scaled slice.

Precision (``compute_dtype``): "f32", or "bf16" as the JAX package's
channelizer FIR takes it: the taps and the tail-prefixed input are rounded
to bf16 and the sums run in f32. The port keeps bf16 values in f32 tensors
(one product of two bf16 values is exact in f32), so the FIR-bank kernel
computes a bf16 FIR with its f32 body; the carried tail holds the rounded
input, as JAX's does.

- ``PolyFIR``: host-side design + plan; calling it runs the plain framed
  matmul (or the delay slice) on any device.
- ``FIRBank`` / ``make_bank``: an nn.Module holding the taps and weights
  as buffers; on a CUDA tensor it launches the FIR-bank kernel.
- ``DecimatingFIR``: one up = 1 FIR bound to the direct-form decimating
  kernel (``ops/cuda/fir_kernels.py``), with the bank's call contract.
- ``DualPhaseFIR``: the frontend's decimating I/Q LPF applied straight to
  the interleaved u8 stream, the plain half of the fused frontend.

Each has ``cost(n)``: the work of the FUNCTION on an n-sample block of one
row, whatever computes it, as a dict ``kind``, ``flops``, ``bytes``,
``w_bytes``, ``dims`` (``utils/logging.stage_costs`` walks them). FLOPs
are 2 x outputs x nonzero taps each output multiplies, summed over a
bank's members; bytes are the input plus its tail read once (one read for
a whole bank), each f32 output written once, and the taps once per launch
(``w_bytes``, the share of ``bytes`` a launch over many rows pays once);
at bf16 the input, its tail and the taps count 2 bytes an element.
"""


from __future__ import annotations

import numpy as np
import torch
from torch import nn

from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (MAX_NF, BankGeometry,
                                                       check_geometry,
                                                       fir_bank,
                                                       fir_bank_plain,
                                                       phase_major)
from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import fir_decimate

__all__ = ["state_len", "PolyFIR", "FIRBank", "make_bank", "DecimatingFIR",
           "DualPhaseFIR"]

TARGET_FRAME = 128  # outputs per frame of the plain framed matmul (~R)
FIR_DTYPES = ("f32", "bf16")
_EL_BYTES = {"f32": 4, "bf16": 2}


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), held as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def state_len(num_taps: int, up: int = 1) -> int:
    """Carried input samples: ceil(num_taps/up) - 1."""
    return -(-num_taps // up) - 1


def _tail_of(xx: torch.Tensor, n: int) -> torch.Tensor:
    return xx[..., xx.shape[-1] - n:].contiguous() if n else xx[..., :0]


def _nz_phase(h: np.ndarray, up: int) -> np.ndarray:
    """(up,) nonzero taps per polyphase phase: output phase p multiplies
    h[p], h[p + up], ..."""
    return np.array([np.count_nonzero(h[p::up]) for p in range(up)],
                    dtype=np.int64)


def _fir_cost(kind: str, nz_phase: np.ndarray, up: int, down: int, n: int,
              tail_len: int, n_filters: int, num_taps: int,
              el: int = 4) -> dict:
    """The cost dict of ``n_filters`` same-geometry FIRs sharing one input
    of ``el``-byte elements (see the module docstring); ``nz_phase`` is
    summed over them."""
    n_out = n * up // down
    # output r multiplies phase (r*down) % up
    per_phase = np.bincount((np.arange(n_out, dtype=np.int64) * down) % up,
                            minlength=up)
    w_bytes = el * n_filters * num_taps
    return {"kind": kind, "flops": 2 * int(per_phase @ nz_phase),
            "bytes": el * (n + tail_len) + 4 * n_filters * n_out + w_bytes,
            "w_bytes": w_bytes,
            "dims": (n_out, -(-num_taps // up), n_filters)}


class PolyFIR:
    """A designed FIR bound to static (up, down) resampling factors.

        f = PolyFIR(h, up=247, down=640)
        y, new_tail = f(x, tail)        # x: (..., N), tail: (..., T-1)

    y has N*up//down samples (C++ truncation). Calling runs the plain
    framed matmul; ``make_bank`` binds FIRs to the kernel.
    ``compute_dtype``: "f32" or "bf16" (module docstring); a single-tap
    delay has no bf16 form.
    """

    def __init__(self, h: np.ndarray, up: int = 1, down: int = 1,
                 compute_dtype: str = "f32"):
        h = np.asarray(h, dtype=np.float64)
        if h.ndim != 1:
            raise ValueError(f"taps must be 1-D, got shape {h.shape}")
        if compute_dtype not in FIR_DTYPES:
            raise ValueError(f"compute_dtype must be one of {FIR_DTYPES}, "
                             f"got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.up = int(up)
        self.down = int(down)
        self.num_taps = K = h.shape[0]
        self.T = -(-K // self.up)
        self._h = h
        nz = np.nonzero(h)[0]
        self.single_tap = len(nz) == 1 and self.up == 1 and self.down == 1
        self._tap_pos = int(nz[0]) if len(nz) else 0
        self._tap_gain = float(h[self._tap_pos]) if len(nz) else 0.0
        if self.single_tap and compute_dtype != "f32":
            raise ValueError("a single-tap (delay) filter lowers to a slice "
                             "and has no bf16 form")
        g = max(1, round(TARGET_FRAME / self.up))
        R = g * self.up
        rs = np.arange(R, dtype=np.int64)
        self._p = (rs * self.down) % self.up
        self._qr = (rs * self.down) // self.up
        J = self.T + int(self._qr.max())
        stride = g * self.down
        self.geometry = BankGeometry(up=self.up, down=self.down, num_taps=K,
                                     R=R, stride=stride, J=J,
                                     s_over=-(-J // stride))
        self._w: np.ndarray | None = None

    @property
    def h(self) -> np.ndarray:
        """The float64 taps."""
        return self._h

    @property
    def tail_len(self) -> int:
        return self.T - 1

    def _rounded(self, a: np.ndarray) -> np.ndarray:
        """float32 values in the compute precision (f32 -> bf16 at bf16, as
        the JAX package rounds its f32 weights)."""
        a = a.astype(np.float32)
        if self.compute_dtype == "bf16":
            a = _round_bf16(torch.from_numpy(a)).numpy()
        return a

    def taps32(self) -> np.ndarray:
        """(K,) float32 taps in the compute precision: the kernel's taps."""
        return self._rounded(self._h)

    def cost(self, n: int) -> dict:
        """Work on an n-sample block of one row (module docstring); the
        all-pass delay is a slice: n read, n written, no operations."""
        if self.single_tap:
            return {"kind": "delay", "flops": 0, "bytes": 8 * n,
                    "w_bytes": 0, "dims": (0, 0, 0)}
        return _fir_cost(f"fir_{self.compute_dtype}",
                         _nz_phase(self._h, self.up), self.up, self.down, n,
                         self.tail_len, 1, self.num_taps,
                         _EL_BYTES[self.compute_dtype])

    def weights(self) -> np.ndarray:
        """(J, R) float32 polyphase weight matrix of the framed matmul, in
        the compute precision."""
        if self._w is None:
            gm, T, K, up = self.geometry, self.T, self.num_taps, self.up
            W = np.zeros((gm.J, gm.R), dtype=np.float64)
            for r in range(gm.R):
                for m in range(T):
                    k = self._p[r] + up * m
                    if k < K:
                        W[T - 1 + self._qr[r] - m, r] = self._h[k]
            self._w = self._rounded(W)
        return self._w

    def __call__(self, x: torch.Tensor, tail: torch.Tensor):
        """Apply to one block. x: (..., N); tail: (..., T-1).

        Returns (y, new_tail) with y: (..., N*up//down)."""
        n = x.shape[-1]
        xx = torch.cat([tail, x.to(tail.dtype)], dim=-1)
        if self.compute_dtype == "bf16":
            xx = _round_bf16(xx)
        if self.single_tap:
            # pure delay: y[n] = h[pos] * xx[T-1 + n - pos]
            start = self.T - 1 - self._tap_pos
            y = self._tap_gain * xx[..., start:start + n]
        else:
            w = torch.as_tensor(self.weights(), device=x.device)
            L = xx.shape[-1]
            y = fir_bank_plain(xx.reshape(-1, L), w, self.geometry)[:, 0]
            y = y.reshape(x.shape[:-1] + (y.shape[-1],))
        return y, _tail_of(xx, self.tail_len)


def _check_bank(firs: list[PolyFIR]) -> None:
    f0 = firs[0]
    if any(f.geometry != f0.geometry for f in firs):
        raise ValueError("bank filters must share (up, down, num_taps)")
    if any(f.compute_dtype != f0.compute_dtype for f in firs):
        raise ValueError("bank filters must share one compute_dtype")
    if f0.single_tap:
        raise ValueError("a single-tap delay lowers to a slice, not a bank")
    if not 1 <= len(firs) <= MAX_NF:
        raise ValueError(f"a bank holds 1..{MAX_NF} filters, got {len(firs)}")


class FIRBank(nn.Module):
    """Same-geometry FIRs bound to the FIR-bank kernel.

    ``bank(x, tail) -> ([y_0, ..., y_{nf-1}], new_tail)`` with the PolyFIR
    state contract; every leading dim of x is a batch row. Taps and the
    plain version's weights are buffers, so ``.to(device)`` moves them;
    ``ptaps`` is the taps phase-major, the table the kernel reads.
    A bf16 bank rounds its input to bf16 and hands the kernel bf16 taps as
    f32 values (module docstring). A geometry whose window of 32 outputs,
    ceil(31*down/up) + ceil(K/up) samples, does not fit one SM's shared
    memory (about 58,000 floats) is refused here (``check_geometry``).
    """

    def __init__(self, firs: list[PolyFIR]):
        super().__init__()
        _check_bank(firs)
        check_geometry(firs[0].geometry)
        self.geometry = firs[0].geometry
        self.compute_dtype = firs[0].compute_dtype
        self.nf = len(firs)
        self._tail_len = firs[0].tail_len
        self._nz_phase = sum(_nz_phase(f.h, f.up) for f in firs)
        taps = np.stack([f.taps32() for f in firs])
        self.register_buffer("taps", torch.as_tensor(taps))
        # the kernel's table (nf, up, T), the taps phase-major
        self.register_buffer("ptaps", torch.as_tensor(
            phase_major(taps, self.geometry.up)), persistent=False)
        self.register_buffer("w", torch.as_tensor(
            np.concatenate([f.weights() for f in firs], axis=1)))

    @property
    def tail_len(self) -> int:
        return self._tail_len

    def cost(self, n: int) -> dict:
        """Work of the whole bank on an n-sample block of one row: its
        members share one read of the input."""
        g, dt = self.geometry, self.compute_dtype
        kind = f"fir_{dt}" if self.nf == 1 else f"fir_{dt}_x{self.nf}shared"
        return _fir_cost(kind, self._nz_phase, g.up, g.down, n,
                         self._tail_len, self.nf, g.num_taps, _EL_BYTES[dt])

    def forward(self, x: torch.Tensor, tail: torch.Tensor):
        xx = torch.cat([tail, x.to(tail.dtype)], dim=-1)
        if self.compute_dtype == "bf16":
            xx = _round_bf16(xx)
        L = xx.shape[-1]
        y = fir_bank(xx.reshape(-1, L), self.ptaps, self.w, self.geometry)
        y = y.reshape(x.shape[:-1] + y.shape[1:])     # (..., nf, n_out)
        return ([y[..., i, :] for i in range(self.nf)],
                _tail_of(xx, self._tail_len))


def make_bank(firs: list[PolyFIR]) -> FIRBank:
    """Bind same-geometry FIRs to one kernel launch per call."""
    return FIRBank(firs)


class DecimatingFIR(nn.Module):
    """One up = 1 FIR bound to the direct-form decimating kernel.

    ``fir(x, tail) -> ([y], new_tail)``: a one-filter bank's contract (the
    carry is the last K-1 input samples; every leading dim of x is a batch
    row), so a site takes either. x's length must be a multiple of
    ``down``. The taps are a buffer, so ``.to(device)`` moves them.
    """

    def __init__(self, fir: PolyFIR):
        super().__init__()
        if fir.up != 1 or fir.single_tap or fir.compute_dtype != "f32":
            raise ValueError("the decimating kernel takes an f32 up = 1 FIR "
                             f"with more than one tap, got up={fir.up}, "
                             f"{fir.compute_dtype}")
        self.down = fir.down
        self.num_taps = fir.num_taps
        self._nz_phase = _nz_phase(fir.h, 1)
        self.register_buffer("taps", torch.as_tensor(
            fir.h.astype(np.float32)))

    @property
    def tail_len(self) -> int:
        return self.num_taps - 1

    def cost(self, n: int) -> dict:
        """Work on an n-sample block of one row (one rail)."""
        return _fir_cost("fir_decimate_f32", self._nz_phase, 1, self.down,
                         n, self.tail_len, 1, self.num_taps)

    def forward(self, x: torch.Tensor, tail: torch.Tensor):
        xx = torch.cat([tail, x.to(tail.dtype)], dim=-1)
        y = fir_decimate(xx.reshape(-1, xx.shape[-1]), self.taps, self.down)
        return ([y.reshape(x.shape[:-1] + y.shape[-1:])],
                _tail_of(xx, self.tail_len))


class DualPhaseFIR(nn.Module):
    """Decimating LPF applied directly to an INTERLEAVED u8 I/Q stream.

    Filtering the even (I) and odd (Q) bytes of the interleaved stream s
    with stride-2 taps folds both phases into one framed matmul whose
    weight matrix carries the I- and Q-columns side by side:

        I_ds[n] = sum_k h[k] * (s[2(n*down - k)] - 128) / 128
        Q_ds[n] = sum_k h[k] * (s[2(n*down - k) + 1] - 128) / 128

    The carried tail is 2K-2 raw bytes. (x - 128) is exact in f32 and the
    /128 folds into the weights. Buffers: ``w`` (J, 2R) for the framed
    matmul and ``taps`` (K,) = h/128 for the fused kernel.
    """

    def __init__(self, h: np.ndarray, down: int):
        super().__init__()
        h = np.asarray(h, dtype=np.float64)
        self.down = int(down)
        self.num_taps = K = h.shape[0]
        R = self.R = TARGET_FRAME
        k2 = 2 * K - 1               # span of the zero-stuffed taps
        dprime = 2 * self.down       # interleaved stride per output
        self.J = J = dprime * (R - 1) + k2 + 1   # +1 for the Q offset
        W = np.zeros((J, 2 * R), dtype=np.float64)
        for r in range(R):
            for k in range(K):
                j = r * dprime + (k2 - 1) - 2 * k
                W[j, r] = h[k]
                W[j + 1, R + r] = h[k]
        self.stride = R * dprime
        self.s_over = -(-J // self.stride)
        self._nz = int(np.count_nonzero(h))
        self.register_buffer("w", torch.as_tensor(
            W.astype(np.float32) / np.float32(128.0)))
        self.register_buffer("taps", torch.as_tensor(
            h.astype(np.float32) / np.float32(128.0)))

    @property
    def tail_len(self) -> int:
        return 2 * self.num_taps - 2

    def n_out(self, n2: int) -> int:
        """Outputs per rail of an n2-byte interleaved segment."""
        return (n2 // 2) // self.down

    def cost(self, n2: int) -> dict:
        """Work on an n2-byte interleaved u8 block of one row: the u8 bytes
        and their tail read once, the I and Q rails written once, K
        multiply-adds per output and rail."""
        n_out = self.n_out(n2)
        w_bytes = 4 * self.num_taps
        return {"kind": "dualphase_u8", "flops": 2 * 2 * self._nz * n_out,
                "bytes": self.tail_len + n2 + 2 * 4 * n_out + w_bytes,
                "w_bytes": w_bytes, "dims": (n_out, self.num_taps, 2)}

    def forward(self, xx_u8: torch.Tensor):
        """xx_u8: (..., 2K-2 + 2N) tail-prefixed u8 -> (I, Q) (..., N//down)
        float32."""
        lead, L = xx_u8.shape[:-1], xx_u8.shape[-1]
        n_out = ((L - self.tail_len) // 2) // self.down
        R, stride = self.R, self.stride
        c_frames = -(-n_out // R)
        pad_to = (c_frames + self.s_over) * stride
        xf = xx_u8.reshape(-1, L).to(torch.float32) - 128.0
        xf = (torch.nn.functional.pad(xf, (0, pad_to - L)) if pad_to >= L
              else xf[:, :pad_to])       # zero pad == byte 128 == no signal
        rows = xf.reshape(xf.shape[0], -1, stride)
        frames = torch.cat([rows[:, s:s + c_frames]
                            for s in range(self.s_over)], dim=-1)[..., :self.J]
        y = frames @ self.w                             # (B, c_frames, 2R)
        i_ds = y[..., :R].reshape(lead + (-1,))[..., :n_out]
        q_ds = y[..., R:].reshape(lead + (-1,))[..., :n_out]
        return i_ds, q_ds
