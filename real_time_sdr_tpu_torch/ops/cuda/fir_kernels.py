"""Kernel 4: the direct-form decimating FIR (``csrc/fir_decimate.cu``) and
its plain version.

``fir_decimate(xx, h, down)`` is a causal FIR plus decimation over
tail-prefixed rows xx (C, K-1 + N) f32, any ``down >= 1`` with down | N,

    y[c, n] = sum_k h[k] * xx[c, n*down + K-1-k],   y: (C, N/down)

``h`` is K float taps (a sequence, or a (K,) float32 tensor).
``fir_decimate_planes`` keeps the JAX package's signature and contract
(``real_time_sdr_tpu/ops/pallas/fir_kernels.py``), which also wants
down | (K-1): the plane layout of the TPU kernel, nothing this one needs.

- On a CPU tensor it runs ``fir_decimate_plain``: ``conv1d`` with the
  reversed taps and ``stride=down``.
- On a CUDA tensor it launches the kernel, or raises. (K, down) alone picks
  the kernel's body (``kernel_body``): the register-tiled static body at
  the receiver's audio geometries, the general body otherwise.

One filter per launch and no polyphase ``up``: the audio resampler of the
rate modes that do not upsample (``models/audio.py``), and the direct K-tap
form that the FIR bank (``ops/cuda/fir_bank.py``) is measured against.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr

__all__ = ["fir_decimate", "fir_decimate_planes", "fir_decimate_plain",
           "FirDecimateKernel", "kernel_body", "STATIC_GEOMETRIES",
           "STATIC_TILE"]

SMEM_MAX = 227 * 1024  # shared memory one block may use on Hopper
# (K, down) of the static body (csrc/fir_decimate.cu instantiates these):
# the audio resamplers of rate modes 0 and 1
STATIC_GEOMETRIES = ((101, 5), (101, 9))
STATIC_TILE = 896  # outputs per block of the static body (kStaticTile)


def _taps(h: Sequence[float] | torch.Tensor,
          device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(h, dtype=torch.float32, device=device)
    if t.ndim != 1 or t.numel() == 0:
        raise ValueError(f"taps must be a non-empty 1-D sequence, got shape "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _n_out(xx: torch.Tensor, k_taps: int, down: int) -> int:
    if xx.ndim != 2:
        raise ValueError(f"xx must be (C, K-1+N), got {tuple(xx.shape)}")
    if xx.dtype != torch.float32:
        raise TypeError(f"fir_decimate takes float32, got {xx.dtype}")
    if down < 1:
        raise ValueError(f"down must be >= 1, got {down}")
    n = xx.shape[1] - (k_taps - 1)
    if n < 0 or n % down:
        raise ValueError(f"fir_decimate needs down | N (N={n}, K={k_taps}, "
                         f"down={down})")
    return n // down


def kernel_body(k_taps: int, down: int) -> str:
    """The body of ``csrc/fir_decimate.cu`` that runs a geometry; its launch
    dispatches on the same rule."""
    return "static" if (k_taps, down) in STATIC_GEOMETRIES else "general"


def fir_decimate_plain(xx: torch.Tensor, h: torch.Tensor,
                       down: int) -> torch.Tensor:
    """conv1d with the reversed taps: (C, K-1+N) -> (C, N/down)."""
    k_taps = h.shape[0]
    n_out = _n_out(xx, k_taps, down)
    if n_out == 0:
        return xx.new_empty((xx.shape[0], 0))
    y = torch.nn.functional.conv1d(xx[:, None], h.flip(0)[None, None],
                                   stride=down)
    return y[:, 0, :n_out]


class FirDecimateKernel:
    """Launch wrapper of ``sdr_fir_decimate`` with its launch count, in
    total and per kernel body."""

    name = "fir_decimate"
    source = "real_time_sdr_tpu_torch/csrc/fir_decimate.cu"
    replaces = "real_time_sdr_tpu/ops/pallas/fir_kernels.py:39"

    def __init__(self):
        self.launches = 0
        self.body_launches = {"static": 0, "general": 0}

    def __call__(self, xx: torch.Tensor, h: Sequence[float] | torch.Tensor,
                 down: int) -> torch.Tensor:
        taps = _taps(h, xx.device)
        if kernel_route(xx, taps) == "plain":
            return fir_decimate_plain(xx, taps, down)
        return self.launch(xx, taps, down)

    def launch(self, xx: torch.Tensor, taps: torch.Tensor,
               down: int) -> torch.Tensor:
        """Run the CUDA kernel (CUDA tensors only). taps: (K,) float32."""
        dev = xx.device
        if dev.type != "cuda" or taps.device != dev:
            raise ValueError("fir_decimate kernel needs CUDA tensors on one "
                             "device")
        if taps.dtype != torch.float32 or taps.ndim != 1:
            raise TypeError(f"taps must be (K,) float32, got {taps.dtype} "
                            f"{tuple(taps.shape)}")
        if not (xx.is_contiguous() and taps.is_contiguous()):
            raise ValueError("fir_decimate takes contiguous tensors")
        K = taps.shape[0]
        n_out = _n_out(xx, K, down)
        C, L = xx.shape
        y = torch.empty((C, n_out), dtype=torch.float32, device=dev)
        if C == 0 or n_out == 0:
            return y
        lib = library()
        smem = lib.sdr_fir_decimate_smem(K, down)
        if smem > SMEM_MAX:
            raise ValueError(f"fir_decimate block needs {smem} bytes of "
                             f"shared memory (K={K}, down={down}); the card "
                             f"allows {SMEM_MAX}")
        with torch.cuda.device(dev):
            err = lib.sdr_fir_decimate(xx.data_ptr(), taps.data_ptr(),
                                       y.data_ptr(), C, L, K, int(down),
                                       n_out, stream_ptr(dev))
        check(err, "sdr_fir_decimate")
        self.launches += 1
        self.body_launches[kernel_body(K, int(down))] += 1
        return y


fir_decimate = FirDecimateKernel()


def fir_decimate_planes(xx: torch.Tensor, h: Sequence[float] | torch.Tensor,
                        down: int) -> torch.Tensor:
    """Causal FIR + decimation on a tail-prefixed input (the JAX package's
    ``fir_decimate_planes`` contract): xx (C, K-1+N) f32 with down | N and
    down | (K-1) -> y (C, N//down)."""
    k_taps = len(h)
    if down >= 1 and (k_taps - 1) % down:
        raise ValueError(f"fir_decimate_planes needs down | K-1 (K={k_taps}, "
                         f"down={down})")
    return fir_decimate(xx, h, down)
