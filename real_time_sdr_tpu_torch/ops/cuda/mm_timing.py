"""Kernel 6: Mueller–Muller timing recovery (``csrc/mm_timing.cu``), the
alternative RDS receiver's timing loop.

``mm_timing_kernel(z, sps, gain, mu0)`` is ``ops.symbol_timing.mm_timing``'s
one entry point: z (N,) complex64 and a 0-d f32 ``mu0`` -> (symbols (n_max,)
complex64 zero-padded, n_valid 0-d int32), both left on z's device.

- On CPU tensors it runs ``ops.symbol_timing.mm_timing_plain``.
- On CUDA tensors it launches the kernel, or raises: one block per stream,
  one thread of which walks the symbols out of shared-memory tiles that the
  block's other warps stage ahead of it. Every f32 operation is separately
  rounded, in the plain version's order, so the two should agree bit for
  bit on the card.

It replaces no Pallas kernel: the JAX package runs this loop as one compiled
``lax.while_loop`` (``real_time_sdr_tpu/ops/symbol_timing.py:67``), which
eager PyTorch cannot express without a launch and a host round trip per
symbol.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr
from real_time_sdr_tpu_torch.ops.symbol_timing import (check_mm_args,
                                                       mm_buffer_len,
                                                       mm_timing_plain)

__all__ = ["mm_timing_kernel", "MmTimingKernel", "MM_CHAIN_OPS",
           "mm_timing_cost"]

# dependent f32 operations of one symbol's step on the walker's chain
# (mu -> 1 - mu -> product -> sum -> rail -> difference -> product -> sum
# -> err -> gain*err -> + (mu + sps) -> floor -> mu - floor), counted in
# the SASS of csrc/mm_timing.cu (chip_smoke.py --sass): times the latency
# of a dependent f32 operation, the loop's floor per symbol (the next
# pair's shared load, whose address waits on floor(mu), adds to it)
MM_CHAIN_OPS = 12
# f32 operations of one symbol's step: 1 - mu; the two interpolations (4
# products, 2 sums); the rails' 2 compares; the two error terms (4
# differences, 4 products, 2 sums); err; the position update (2 sums, 1
# product), floor and the fractional difference
MM_STEP_FLOPS = 25


def mm_timing_cost(n: int, n_max: int, n_valid: int) -> dict:
    """Work of one call on this input: the n samples read once (8 bytes
    each), the n_max-symbol buffer and n_valid written once, mu0 read;
    MM_STEP_FLOPS per symbol produced (the walk's length depends on the
    data, so n_valid counts it)."""
    return {"bytes": 8 * n + 8 * n_max + 8, "flops": MM_STEP_FLOPS * n_valid}


class MmTimingKernel:
    """Launch wrapper of ``sdr_mm_timing`` with its launch count."""

    name = "mm_timing"
    source = "real_time_sdr_tpu_torch/csrc/mm_timing.cu"
    replaces = ("real_time_sdr_tpu/ops/symbol_timing.py:67 mm_timing "
                "(lax.while_loop)")

    def __init__(self):
        self.launches = 0

    def __call__(self, z: torch.Tensor, sps: float, gain: float,
                 mu0: torch.Tensor):
        if kernel_route(z, mu0) == "plain":
            return mm_timing_plain(z, sps, gain, mu0)
        return self.launch(z, sps, gain, mu0)

    def launch(self, z: torch.Tensor, sps: float, gain: float,
               mu0: torch.Tensor):
        """Run the CUDA kernel (CUDA tensors only)."""
        dev = z.device
        if dev.type != "cuda" or mu0.device != dev:
            raise ValueError("mm_timing kernel needs CUDA tensors on one "
                             "device")
        check_mm_args(z, mu0)
        n = z.shape[0]
        if n > 1 << 30:
            raise ValueError(f"mm_timing takes at most 2^30 samples, got {n}")
        n_max = mm_buffer_len(n, sps)
        zf = torch.view_as_real(z.contiguous())
        syms = torch.zeros(n_max, dtype=torch.complex64, device=dev)
        n_valid = torch.empty((), dtype=torch.int32, device=dev)
        mu0 = mu0.contiguous()
        lib = library()
        with torch.cuda.device(dev):
            err = lib.sdr_mm_timing(
                zf.data_ptr(), n, n_max, mu0.data_ptr(),
                float(np.float32(sps)), float(np.float32(gain)),
                syms.data_ptr(), n_valid.data_ptr(), stream_ptr(dev))
        check(err, "sdr_mm_timing")
        self.launches += 1
        return syms, n_valid


mm_timing_kernel = MmTimingKernel()
