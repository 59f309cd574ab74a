"""FM discriminators: the arctan-free quadrature-derivative demodulator and
the arctan+unwrap variant.

Port of ``real_time_sdr_tpu/ops/demod.py``. ``fm_demod``:

    d[n] = (I[n]*(Q[n]-Q[n-1]) - Q[n]*(I[n]-I[n-1])) / (I[n]^2 + Q[n]^2)

with d = 0 where I = Q = 0 and the previous block's final (I, Q) carried.
``fm_demod_arctan``:

    d[n] = wrap_pi(atan2(Q[n], I[n]) - atan2(Q[n-1], I[n-1]))

carrying the previous wrapped angle (only the running unwrapped phase
modulo 2*pi ever reaches the output). Both are plain elementwise tensor
code; no serving path runs the arctan form.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fm_demod", "fm_demod_arctan"]

_TWO_PI = 2.0 * math.pi


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


def fm_demod_arctan(i_sig: torch.Tensor, q_sig: torch.Tensor,
                    prev_theta: torch.Tensor):
    """i_sig, q_sig: (..., N); prev_theta: (...,) previous wrapped angle.
    Returns (demod (..., N), new_prev_theta). np.unwrap leaves a step of
    exactly +-pi as it is; so does the shift by round(d / 2pi), whose
    round-half-even gives 0 there."""
    theta = torch.atan2(q_sig, i_sig)
    d = torch.diff(theta, dim=-1, prepend=prev_theta[..., None])
    return d - _TWO_PI * torch.round(d / _TWO_PI), theta[..., -1]
