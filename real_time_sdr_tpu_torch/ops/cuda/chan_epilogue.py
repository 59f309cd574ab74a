"""Kernel 3: the static-fold channelizer epilogue (``csrc/chan_epilogue.cu``)
and its plain version.

``chan_epilogue(y, pc, ps, r_n, s_ch, n_out)`` maps the fold matmul's result
``y`` (c, R*2S) f32 (frames on rows, column ``r*2S + rail*S + s``) and the
per-station residual rotation ``pc, ps`` (S,) f32 to the receivers'
interleaved u8 station streams (S, 2*n_out), n_out <= c*R:

    z_i = vr*pc - vi*ps,   z_q = vi*pc + vr*ps
    out[s, 2m + rail] = clip(round(128 + 127*z), 0, 255),   m = c_i*R + r

- On a CPU tensor it runs ``chan_epilogue_plain``, the eager twin of the JAX
  package's XLA 4-D epilogue (``models/channelizer.py``) and of
  ``ops/pallas/chan_epilogue.reference_u8``.
- On a CUDA tensor it launches the kernel, or raises. The kernel rounds
  each product and sum as torch eager does, so it is byte-exact against the
  plain version on the card.
"""

from __future__ import annotations

import torch

from real_time_sdr_tpu_torch.device import kernel_route
from real_time_sdr_tpu_torch.ops.cuda._build import check, library, stream_ptr

__all__ = ["chan_epilogue", "chan_epilogue_plain", "ChanEpilogueKernel",
           "rotate_stations", "epilogue_cost"]


def epilogue_cost(y_shape: tuple[int, int], s_ch: int, n_out: int) -> dict:
    """Work of one epilogue launch (``ops/fir.py`` has the dict's keys): the
    f32 matmul result ``y_shape`` read once, the (S, 2*n_out) u8 streams
    written once, 6 f32 operations per complex sample to rotate and 2 to
    quantise."""
    return {"kind": "chan_epilogue", "flops": 8 * s_ch * n_out,
            "bytes": 4 * y_shape[0] * y_shape[1] + 2 * s_ch * n_out,
            "w_bytes": 0, "dims": (y_shape[0], y_shape[1], s_ch)}


def quantize_u8(z: torch.Tensor) -> torch.Tensor:
    """clip(round(128 + 127*z), 0, 255) as uint8 (round half to even)."""
    return torch.clamp(torch.round(128.0 + 127.0 * z), 0, 255).to(torch.uint8)


def rotate_stations(y: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor,
                    r_n: int, s_ch: int):
    """The per-station residual rotation of a fold matmul's result ``y``
    (c, R*2S), column ``r*2S + rail*S + s``: returns (z_i, z_q), each
    (c, R, S), z_i = vr*pc - vi*ps and z_q = vi*pc + vr*ps."""
    y4 = y.reshape(y.shape[0], r_n, 2, s_ch)
    vr, vi = y4[:, :, 0, :], y4[:, :, 1, :]
    return vr * pc - vi * ps, vi * pc + vr * ps


def chan_epilogue_plain(y: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor,
                        r_n: int, s_ch: int, n_out: int) -> torch.Tensor:
    """Rotate, quantize, transpose to station-major, interleave I/Q."""
    z = torch.stack(rotate_stations(y, pc, ps, r_n, s_ch), dim=-1)
    u8 = quantize_u8(z)                               # (c, R, S, 2)
    return u8.permute(2, 0, 1, 3).reshape(s_ch, -1)[:, :2 * n_out]


class ChanEpilogueKernel:
    """Launch wrapper of ``sdr_chan_epilogue`` with its launch count."""

    name = "chan_epilogue"
    source = "real_time_sdr_tpu_torch/csrc/chan_epilogue.cu"
    replaces = "real_time_sdr_tpu/ops/pallas/chan_epilogue.py:51"

    def __init__(self):
        self.launches = 0

    def __call__(self, y: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor,
                 r_n: int, s_ch: int, n_out: int) -> torch.Tensor:
        """Returns the (S, 2*n_out) uint8 station streams."""
        self._check(y, pc, ps, r_n, s_ch, n_out)
        if kernel_route(y, pc, ps) == "plain":
            return chan_epilogue_plain(y, pc, ps, r_n, s_ch, n_out)
        return self.launch(y, pc, ps, r_n, s_ch, n_out)

    @staticmethod
    def _check(y, pc, ps, r_n, s_ch, n_out) -> None:
        if y.dtype != torch.float32 or pc.dtype != torch.float32 \
                or ps.dtype != torch.float32:
            raise TypeError(f"chan_epilogue takes float32, got {y.dtype}/"
                            f"{pc.dtype}/{ps.dtype}")
        if r_n < 1 or s_ch < 1:
            raise ValueError(f"chan_epilogue needs R >= 1 and S >= 1, got "
                             f"R={r_n}, S={s_ch}")
        if y.ndim != 2 or y.shape[1] != r_n * 2 * s_ch:
            raise ValueError(f"y must be (c, R*2S) = (c, {r_n * 2 * s_ch}), "
                             f"got {tuple(y.shape)}")
        if pc.shape != (s_ch,) or ps.shape != (s_ch,):
            raise ValueError(f"pc, ps must be ({s_ch},), got "
                             f"{tuple(pc.shape)}, {tuple(ps.shape)}")
        if not 0 <= n_out <= y.shape[0] * r_n:
            raise ValueError(f"n_out {n_out} outside [0, c*R = "
                             f"{y.shape[0] * r_n}]")

    def launch(self, y: torch.Tensor, pc: torch.Tensor, ps: torch.Tensor,
               r_n: int, s_ch: int, n_out: int) -> torch.Tensor:
        """Run the CUDA kernel (CUDA tensors only)."""
        self._check(y, pc, ps, r_n, s_ch, n_out)
        dev = y.device
        if dev.type != "cuda" or pc.device != dev or ps.device != dev:
            raise ValueError("chan_epilogue kernel needs CUDA tensors on one "
                             "device")
        if not all(t.is_contiguous() for t in (y, pc, ps)):
            raise ValueError("chan_epilogue takes contiguous tensors")
        if s_ch > 32 * 65535:
            raise ValueError(f"chan_epilogue takes at most {32 * 65535} "
                             f"stations, got {s_ch}")
        out = torch.empty((s_ch, 2 * n_out), dtype=torch.uint8, device=dev)
        if n_out == 0:
            return out
        lib = library()
        with torch.cuda.device(dev):
            err = lib.sdr_chan_epilogue(y.data_ptr(), pc.data_ptr(),
                                        ps.data_ptr(), out.data_ptr(), s_ch,
                                        n_out, int(n_out % 2 == 0),
                                        stream_ptr(dev))
        check(err, "sdr_chan_epilogue")
        self.launches += 1
        return out


chan_epilogue = ChanEpilogueKernel()
