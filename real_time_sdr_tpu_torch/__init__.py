"""real_time_sdr_tpu_torch: the FM/RDS receiver on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``real_time_sdr_tpu`` (JAX), which stays the reference: each
module mirrors its JAX counterpart's name and state contract, so tests feed
both the same numpy input and carried state converts between them
(``utils.state``). Channel batching is native: every tensor on the receive
path has a leading ``(C, ...)`` channel axis.

Layers:
  ops     — FIR banks, discriminator, carrier sync, RDS slicer; the
            alternative RDS receiver's loops (``symbol_timing``: M&M
            timing, ``costas``: the Costas loop); ``spectrum`` (Bartlett
            PSD) and ``fourier`` (the transform ladder); the CUDA kernels
            under ``ops/cuda`` (sources in ``csrc/``)
  models  — Frontend, MonoPath/StereoPath, RdsPath, Receiver, RdsFramer and
            SyncByOffsetDecoder, AltRdsReceiver (``rds_alt``), the wideband
            frontends
  parallel — channel bank over devices, time and station sharding
  utils   — state conversion, PCM formatting, synthetic stations and
            impairments, the measurement layer, the figure functions
            (``viz``), the float64 oracle (``golden_chain``) and the
            captured CUDA graphs behind the ``jit_*`` serving entries
            (``graphs``)
  cli, viz — the pipe CLI and the diagnostic figure sheet
            (``python -m real_time_sdr_tpu_torch.viz``)

Precision: every f32 contraction stays exact f32. A float32 matmul on the
card would otherwise be free to use TF32 (about three decimal digits), and a
float32 convolution through cuDNN does so by default; the receiver's parity
bounds (110 dB per FIR, 60 dB through the chain) need full f32, the rule the
JAX package keeps by pinning ``precision=HIGHEST``. Both flags are set here,
at import, because the plain (non-kernel) paths run through torch's matmul.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from real_time_sdr_tpu_torch.config import ReceiverConfig, mode_config  # noqa: E402

__all__ = ["ReceiverConfig", "mode_config"]
__version__ = "0.1.0"
