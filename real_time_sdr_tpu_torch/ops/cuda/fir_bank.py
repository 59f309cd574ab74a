"""Kernel 2: the FIR bank (``csrc/fir_bank.cu``) and its plain version.

``fir_bank(xx, taps, w, geom)`` maps tail-prefixed rows ``xx`` (B, T-1+n)
f32 to ``(B, nf, n_out)`` f32, n_out = n*up//down (C++ truncation), for nf
FIRs of one geometry. Rows are anything independent: channels, stacked
audio rails, per-block RDS batches.

- On a CPU tensor it runs ``fir_bank_plain``: the framed matmul on the
  PolyFIR plan (frames of the input against the zero-padded polyphase
  weight matrix ``w``), the arithmetic of ``real_time_sdr_tpu.ops.fir``.
- On a CUDA tensor it launches the kernel, or raises. The geometry alone
  picks the kernel's body (``kernel_body``): the register-tiled direct form
  at up == down == 1, the general polyphase form otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr

__all__ = ["BankGeometry", "fir_bank", "fir_bank_plain", "FirBankKernel",
           "kernel_body"]

MAX_NF = 4  # filters per launch (csrc/fir_bank.cu instantiates 1..4)
TILED_TILE = 1152  # outputs per block of the tiled body (kTiledTile)


@dataclasses.dataclass(frozen=True)
class BankGeometry:
    """Static polyphase geometry shared by the filters of one bank.

    ``R`` outputs per frame read a ``J``-sample window that advances by
    ``stride`` input samples per frame; the window spans ``s_over`` rows of
    a (-1, stride) reshape (ops.fir.PolyFIR's plan)."""
    up: int
    down: int
    num_taps: int
    R: int
    stride: int
    J: int
    s_over: int

    @property
    def T(self) -> int:
        """Input samples one output touches: ceil(K/up)."""
        return -(-self.num_taps // self.up)

    def n_out(self, n: int) -> int:
        return (n * self.up) // self.down


def fir_bank_plain(xx: torch.Tensor, w: torch.Tensor,
                   geom: BankGeometry) -> torch.Tensor:
    """Framed matmul: xx (B, T-1+n) @ w (J, nf*R) -> (B, nf, n_out)."""
    B, L = xx.shape
    R, stride, J, s_over = geom.R, geom.stride, geom.J, geom.s_over
    nf = w.shape[1] // R
    n_out = geom.n_out(L - (geom.T - 1))
    c_frames = -(-n_out // R)
    pad_to = (c_frames + s_over) * stride
    if pad_to >= L:
        xp = torch.nn.functional.pad(xx, (0, pad_to - L))
    else:
        xp = xx[:, :pad_to]
    rows = xp.reshape(B, -1, stride)
    frames = torch.cat([rows[:, s:s + c_frames] for s in range(s_over)],
                       dim=-1)[..., :J]
    y = frames @ w                                  # (B, c_frames, nf*R)
    y = y.reshape(B, c_frames, nf, R).permute(0, 2, 1, 3)
    return y.reshape(B, nf, c_frames * R)[..., :n_out]


def kernel_body(geom: BankGeometry) -> str:
    """The body of ``csrc/fir_bank.cu`` that runs a geometry; its
    ``launch`` dispatches on the same rule."""
    return "tiled" if geom.up == 1 and geom.down == 1 else "general"


class FirBankKernel:
    """Launch wrapper of ``sdr_fir_bank`` with its launch count, in total
    and per kernel body."""

    name = "fir_bank"
    source = "real_time_sdr_tpu_torch/csrc/fir_bank.cu"
    replaces = "real_time_sdr_tpu/ops/pallas/polyfir.py:69"

    def __init__(self):
        self.launches = 0
        self.body_launches = {"tiled": 0, "general": 0}

    def __call__(self, xx: torch.Tensor, taps: torch.Tensor,
                 w: torch.Tensor, geom: BankGeometry) -> torch.Tensor:
        """xx (B, T-1+n) f32, taps (nf, K) f32, w (J, nf*R) f32 (the plain
        version's weights) -> (B, nf, n_out) f32."""
        if kernel_route(xx, taps, w) == "plain":
            return fir_bank_plain(xx, w, geom)
        return self.launch(xx, taps, geom)

    def launch(self, xx: torch.Tensor, taps: torch.Tensor,
               geom: BankGeometry) -> torch.Tensor:
        """Run the CUDA kernel (CUDA tensors only)."""
        if xx.device.type != "cuda" or taps.device != xx.device:
            raise ValueError(f"fir_bank kernel needs CUDA tensors on one "
                             f"device, got {xx.device} and {taps.device}")
        if xx.dtype != torch.float32 or taps.dtype != torch.float32:
            raise TypeError(f"fir_bank takes float32, got {xx.dtype}/"
                            f"{taps.dtype}")
        if xx.ndim != 2 or taps.ndim != 2:
            raise ValueError(f"fir_bank takes xx (B, L) and taps (nf, K); "
                             f"got {tuple(xx.shape)}, {tuple(taps.shape)}")
        if not (xx.is_contiguous() and taps.is_contiguous()):
            raise ValueError("fir_bank takes contiguous tensors")
        nf, K = taps.shape
        if K != geom.num_taps or not 1 <= nf <= MAX_NF:
            raise ValueError(f"taps {tuple(taps.shape)} do not fit the bank "
                             f"(K={geom.num_taps}, 1 <= nf <= {MAX_NF})")
        B, L = xx.shape
        T = geom.T
        if L < T:
            raise ValueError(f"fir_bank rows (B={B}, L={L}) need L >= T={T}")
        n_out = geom.n_out(L - (T - 1))
        y = torch.empty((B, nf, n_out), dtype=torch.float32, device=xx.device)
        if B == 0 or n_out == 0:
            return y
        lib = library()
        with torch.cuda.device(xx.device):
            err = lib.sdr_fir_bank(xx.data_ptr(), taps.data_ptr(),
                                   y.data_ptr(), B, L, nf, K, geom.up,
                                   geom.down, T, n_out,
                                   stream_ptr(xx.device))
        check(err, "sdr_fir_bank")
        self.launches += 1
        self.body_launches[kernel_body(geom)] += 1
        return y


fir_bank = FirBankKernel()
