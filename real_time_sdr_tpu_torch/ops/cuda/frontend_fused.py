"""Kernel 1: the fused frontend (``csrc/frontend_fused.cu``) and its plain
version.

``frontend_fused(xx, dual, prev_i, prev_q)`` maps tail-prefixed raw u8 IQ
rows ``xx`` (C, 2K-2 + n2) to the FM demod (C, n2//2//down) f32 plus the
new carried (prev_i, prev_q), taken from the last output.

- On a CPU tensor it runs the plain version: ``DualPhaseFIR`` (the framed
  dual-phase matmul) followed by ``fm_demod``.
- On a CUDA tensor it launches the kernel, or raises.

The kernel sums plane by plane: the window's pairs are split into ``down``
polyphase planes (pair j to plane j % down, index j // down) and an output
is the sum over the planes of short unit-stride FIRs. That is another
summation order than the plain version's one dot product, so the two agree
by SNR (> 90 dB), not by bits. ``frontend_planes`` is that decomposition in
torch, a test oracle on no path.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr
from real_time_sdr_tpu_torch.ops.demod import fm_demod

if TYPE_CHECKING:
    from real_time_sdr_tpu_torch.ops.fir import DualPhaseFIR

__all__ = ["frontend_fused", "frontend_plain", "frontend_planes",
           "FrontendKernel"]

# csrc/frontend_fused.cu: a block computes SPAN = kP * kThreads outputs, one
# of them the predecessor of its first; TILE of them are new.
SPAN = 9 * 128
TILE = SPAN - 1


def frontend_plain(xx: torch.Tensor, dual: "DualPhaseFIR",
                   prev_i: torch.Tensor, prev_q: torch.Tensor):
    """DualPhaseFIR + fm_demod on the tail-prefixed stream (any device)."""
    i_ds, q_ds = dual(xx)
    return fm_demod(i_ds, q_ds, prev_i, prev_q)


def frontend_planes(xx: torch.Tensor, taps: torch.Tensor, down: int,
                    prev_i: torch.Tensor, prev_q: torch.Tensor):
    """The kernel's plane decomposition in float32 torch (any device):

        I[t] = sum_p sum_q g_p[q] * plane_p[t + q],
        plane_p[i] = xx[2*(i*down + p)] - 128,  g_p[q] = taps[K-1 - q*down - p]

    (Q at byte + 1), planes summed in order p = 0..down-1, then
    ``fm_demod``. ``taps`` = h/128 (K,) f32, as the kernel takes them."""
    K = taps.shape[0]
    n_out = ((xx.shape[-1] - (2 * K - 2)) // 2) // down
    pairs = xx.to(torch.float32).reshape(xx.shape[0], -1, 2) - 128.0
    rails = []
    for r in range(2):
        s = pairs[..., r]
        acc = torch.zeros((xx.shape[0], n_out), dtype=torch.float32,
                          device=xx.device)
        for p in range(min(down, K)):
            g = taps[torch.arange(K - 1 - p, -1, -down, device=taps.device)]
            plane = s[:, p::down][:, :n_out + g.shape[0] - 1]
            acc = acc + plane.unfold(-1, g.shape[0], 1) @ g
        rails.append(acc)
    return fm_demod(rails[0], rails[1], prev_i, prev_q)


class FrontendKernel:
    """Launch wrapper of ``sdr_frontend_fused`` with its launch count."""

    name = "frontend_fused"
    source = "real_time_sdr_tpu_torch/csrc/frontend_fused.cu"
    replaces = "real_time_sdr_tpu/ops/pallas/frontend_fused.py:90"

    def __init__(self):
        self.launches = 0

    def __call__(self, xx: torch.Tensor, dual: "DualPhaseFIR",
                 prev_i: torch.Tensor, prev_q: torch.Tensor):
        """Returns (demod (C, n_out), new_prev_i (C,), new_prev_q (C,))."""
        if kernel_route(xx, dual.taps, prev_i, prev_q) == "plain":
            return frontend_plain(xx, dual, prev_i, prev_q)
        return self.launch(xx, dual.taps, dual.down, prev_i, prev_q)

    def launch(self, xx: torch.Tensor, taps: torch.Tensor, down: int,
               prev_i: torch.Tensor, prev_q: torch.Tensor):
        """Run the CUDA kernel (CUDA tensors only). taps = h/128 (K,) f32."""
        dev = xx.device
        if dev.type != "cuda" or any(t.device != dev
                                     for t in (taps, prev_i, prev_q)):
            raise ValueError("frontend_fused kernel needs CUDA tensors on "
                             "one device")
        if xx.dtype != torch.uint8 or xx.ndim != 2:
            raise TypeError(f"frontend_fused takes (C, L) uint8, got "
                            f"{xx.dtype} {tuple(xx.shape)}")
        C, L = xx.shape
        K = taps.shape[0]
        if (taps.dtype != torch.float32 or taps.ndim != 1
                or prev_i.dtype != torch.float32
                or prev_q.dtype != torch.float32
                or prev_i.shape != (C,) or prev_q.shape != (C,)):
            raise TypeError("frontend_fused takes taps (K,) and prev_i/prev_q "
                            "(C,) as float32")
        if not all(t.is_contiguous() for t in (xx, taps, prev_i, prev_q)):
            raise ValueError("frontend_fused takes contiguous tensors")
        n2 = L - (2 * K - 2)
        if n2 < 0 or L % 2:
            raise ValueError(f"frontend_fused rows (C={C}, L={L}) need an "
                             f"even L >= 2K-2 = {2 * K - 2}")
        if down < 1 or K < 1:
            raise ValueError(f"frontend_fused needs K, down >= 1, got "
                             f"K={K}, down={down}")
        n_out = (n2 // 2) // down
        demod = torch.empty((C, n_out), dtype=torch.float32, device=dev)
        if C == 0 or n_out == 0:
            return demod, prev_i.clone(), prev_q.clone()
        last_i = torch.empty((C,), dtype=torch.float32, device=dev)
        last_q = torch.empty_like(last_i)
        lib = library()
        with torch.cuda.device(dev):
            err = lib.sdr_frontend_fused(
                xx.data_ptr(), taps.data_ptr(), prev_i.data_ptr(),
                prev_q.data_ptr(), demod.data_ptr(), last_i.data_ptr(),
                last_q.data_ptr(), C, L, K, int(down), n_out, stream_ptr(dev))
        check(err, "sdr_frontend_fused")
        self.launches += 1
        return demod, last_i, last_q


frontend_fused = FrontendKernel()
