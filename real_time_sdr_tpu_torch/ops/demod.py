"""FM discriminator: the arctan-free quadrature-derivative demodulator.

Port of ``real_time_sdr_tpu/ops/demod.py`` ``fm_demod``:

    d[n] = (I[n]*(Q[n]-Q[n-1]) - Q[n]*(I[n]-I[n-1])) / (I[n]^2 + Q[n]^2)

with d = 0 where I = Q = 0 and the previous block's final (I, Q) carried.
"""

from __future__ import annotations

import torch

__all__ = ["fm_demod"]


def fm_demod(i_sig: torch.Tensor, q_sig: torch.Tensor,
             prev_i: torch.Tensor, prev_q: torch.Tensor):
    """i_sig, q_sig: (..., N); prev_i, prev_q: (...,) carried samples.
    Returns (demod (..., N), new_prev_i, new_prev_q)."""
    di = torch.diff(i_sig, dim=-1, prepend=prev_i[..., None])
    dq = torch.diff(q_sig, dim=-1, prepend=prev_q[..., None])
    num = i_sig * dq - q_sig * di
    den = i_sig * i_sig + q_sig * q_sig
    zero = (i_sig == 0) & (q_sig == 0)
    out = torch.where(zero, torch.zeros_like(num),
                      num / torch.where(den == 0, torch.ones_like(den), den))
    return out, i_sig[..., -1], q_sig[..., -1]
