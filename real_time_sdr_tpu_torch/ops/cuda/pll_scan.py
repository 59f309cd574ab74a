"""Kernel 5: the sequential PLL (``csrc/pll_scan.cu``), the tier-1 carrier
loop.

``pll_scan_kernel(x, carry, p)`` is the tier-1 loop's one entry point
(``ops.sync.PllLoop`` calls it): x (C, N) f32 pilot rows and a
``PllCarry`` of (C,) leaves -> (carrier (C, N), new carry).

- On CPU tensors it runs ``ops.pll.pll_scan_plain``.
- On CUDA tensors it launches the kernel, or raises: two warps per row,
  one thread of which walks the N samples while the helper warp loads,
  computes the ramp and the NCO and stores around it; four rows per block.

The kernel evaluates the phase detector without transcendentals
(``e = wrap(pi*[x<0] - arg)``; zero and non-finite samples and the first
sample of a call take the literal ``atan2``), so it agrees with the plain
version to rounding, not bit for bit: carrier > 80 dB (measured 110-140 dB),
``trig`` equal, the float carry within 1e-4 with ``phase`` compared modulo
4*pi. ``ops.pll.pll_scan_wrapped`` mirrors its arithmetic on the CPU.

It replaces no Pallas kernel: the JAX package runs this loop as one
compiled ``lax.scan`` (``real_time_sdr_tpu/ops/pll.py:111``), which eager
PyTorch cannot express without a launch per sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr
from real_time_sdr_tpu_torch.ops.pll import (FOUR_PI, PllCarry, PllParams,
                                             check_args, pll_scan_plain)

__all__ = ["pll_scan_kernel", "PllScanKernel", "PLL_CHAIN_OPS"]

# dependent f32 operations of one sample's step on the chain thread,
# counted in the SASS of csrc/pll_scan.cu's unrolled body: times the latency
# of a dependent f32 operation, the loop's floor per sample
PLL_CHAIN_OPS = 11


class PllScanKernel:
    """Launch wrapper of ``sdr_pll_scan`` with its launch count."""

    name = "pll_scan"
    source = "real_time_sdr_tpu_torch/csrc/pll_scan.cu"
    replaces = "real_time_sdr_tpu/ops/pll.py:111 pll_scan (lax.scan)"

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, carry: PllCarry, p: PllParams):
        if kernel_route(x, *carry) == "plain":
            return pll_scan_plain(x, carry, p)
        return self.launch(x, carry, p)

    def launch(self, x: torch.Tensor, carry: PllCarry, p: PllParams):
        """Run the CUDA kernel (CUDA tensors only)."""
        dev = x.device
        if dev.type != "cuda" or any(t.device != dev for t in carry):
            raise ValueError("pll_scan kernel needs CUDA tensors on one "
                             "device")
        check_args(x, carry)
        if x.stride(-1) != 1:
            raise ValueError("pll_scan takes rows with unit sample stride")
        want = (torch.float32,) * 4 + (torch.int32, torch.float32)
        if tuple(t.dtype for t in carry) != want:
            raise TypeError(f"carry dtypes {[t.dtype for t in carry]} != "
                            f"{list(want)}")
        carry = PllCarry(*(t.contiguous() for t in carry))
        C, N = x.shape
        if N == 0 or C == 0:
            return x.new_empty((C, N)), carry
        out = torch.empty((C, N), dtype=torch.float32, device=dev)
        new = PllCarry(*(torch.empty_like(t) for t in carry))
        fr, fsr = p._ratio
        if p.period >= 1 << 30:
            raise ValueError(f"pll_scan counter period {p.period} needs "
                             "int32 headroom (< 2^30)")

        def f32(v):   # each constant rounded to f32 once, as torch does
            return float(np.float32(v))

        lib = library()
        with torch.cuda.device(dev):
            err = lib.sdr_pll_scan(
                x.data_ptr(), x.stride(0), out.data_ptr(), C, N,
                *(t.data_ptr() for t in carry), *(t.data_ptr() for t in new),
                f32(p.kp), f32(p.ki), fr, fsr, f32(2.0 * math.pi / fsr),
                f32(p.nco_scale), f32(p.phase_adjust), f32(FOUR_PI),
                stream_ptr(dev))
        check(err, "sdr_pll_scan")
        self.launches += 1
        return out, new


pll_scan_kernel = PllScanKernel()

