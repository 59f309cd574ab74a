"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each beside
its plain PyTorch version and with a launch count.

Importing this package builds nothing: ``_build.library()`` compiles the
sources on the first launch.
"""

from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import chan_epilogue
from real_time_sdr_tpu_torch.ops.cuda.costas_scan import costas_kernel
from real_time_sdr_tpu_torch.ops.cuda.fir_bank import fir_bank
from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import fir_decimate
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import frontend_fused
from real_time_sdr_tpu_torch.ops.cuda.mm_timing import mm_timing_kernel
from real_time_sdr_tpu_torch.ops.cuda.pll_scan import pll_scan_kernel

KERNELS = (frontend_fused, fir_bank, chan_epilogue, fir_decimate,
           pll_scan_kernel, mm_timing_kernel, costas_kernel)

__all__ = ["KERNELS", "chan_epilogue", "costas_kernel", "fir_bank",
           "fir_decimate", "frontend_fused", "mm_timing_kernel",
           "pll_scan_kernel"]
