"""Mueller–Muller decision-directed symbol-timing recovery (complex BPSK).

Port of ``real_time_sdr_tpu/ops/symbol_timing.py``: per output symbol, take
the sample at the current fractional position (a 2-point linear
interpolation), form the M&M error from the last three symbol decisions,
and advance the position by ``sps + gain*err``. The position is carried as
an integer index and a fractional part, as in the JAX package's
``lax.while_loop``.

- ``mm_timing`` routes by device: a CPU tensor takes ``mm_timing_plain``
  (a per-symbol loop in PyTorch), a CUDA tensor launches the kernel
  ``csrc/mm_timing.cu`` (``ops.cuda.mm_timing``), or raises. The count of
  symbols stays a device tensor until the caller fetches it.
- ``comb_acquire`` seeds the loop on a comb-energy peak.

Output symbols land in a zero-padded buffer of ``n_max = int(n / sps *
1.01) + 8`` entries (a 1 % rate margin, so a fast transmitter clock does not
truncate the tail); ``n_valid`` says how many were produced.
"""

from __future__ import annotations

import torch

from real_time_sdr_tpu_torch.ops.rds_bits import comb_peak_phase

__all__ = ["comb_acquire", "mm_timing", "mm_timing_plain", "mm_buffer_len",
           "check_mm_args"]


def comb_acquire(z: torch.Tensor, sps: int) -> torch.Tensor:
    """Initial timing phase by comb energy: argmax over the ``sps`` phases
    of mean |z[p::sps]|^2, refined to sub-sample by a parabolic fit of the
    peak and its neighbours (``ops.rds_bits.comb_peak_phase``). The M&M
    loop's error has a weak acquisition basin on biphase-coded signals; one
    reduction puts it on a peak. Returns a 0-d f32 phase in [0, sps)."""
    n = (z.shape[-1] // sps) * sps
    e = (z[..., :n].abs() ** 2).reshape(-1, sps).mean(dim=0)
    return comb_peak_phase(e, sps)


def mm_buffer_len(n: int, sps: float) -> int:
    """Symbols the output buffer holds for an n-sample input."""
    return int(n / sps * 1.01) + 8


def check_mm_args(z: torch.Tensor, mu0: torch.Tensor) -> None:
    """What both versions take: z (N,) complex64, N >= 2; mu0 a 0-d f32
    tensor on z's device."""
    if z.ndim != 1 or z.dtype != torch.complex64:
        raise ValueError(f"mm_timing takes a 1-D complex64 stream, got "
                         f"{z.dtype} {tuple(z.shape)}")
    if z.shape[0] < 2:
        raise ValueError("mm_timing needs at least 2 samples")
    if mu0.ndim != 0 or mu0.dtype != torch.float32:
        raise TypeError(f"mu0 must be a 0-d float32 tensor, got {mu0.dtype} "
                        f"{tuple(mu0.shape)}")


def mm_timing_plain(z: torch.Tensor, sps: float, gain: float,
                    mu0: torch.Tensor):
    """The loop in PyTorch, on z's device: each operation rounds to f32
    separately, in the JAX package's order. Returns (symbols (n_max,)
    complex64, n_valid 0-d int32)."""
    check_mm_args(z, mu0)
    n = z.shape[0]
    n_max = mm_buffer_len(n, sps)
    dev = z.device
    zr, zi = z.real, z.imag
    out_r = torch.zeros(n_max, dtype=torch.float32, device=dev)
    out_i = torch.zeros(n_max, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    o1r = o1i = o2r = o2i = r1r = r1i = r2r = r2i = zero
    i0 = torch.floor(mu0)
    i_in, mu = int(i0.item()), mu0 - i0
    i_out = 0
    while i_in < n - 2 and i_out < n_max:
        i = min(max(i_in, 0), n - 2)       # dynamic_slice clamps its start
        w0 = 1.0 - mu
        cr = zr[i] * w0 + zr[i + 1] * mu
        ci = zi[i] * w0 + zi[i + 1] * mu
        rcr = (cr > 0).to(torch.float32)
        rci = (ci > 0).to(torch.float32)
        # Re((railc - rail2) * conj(out1)) and Re((cur - out2) * conj(rail1))
        xr = (rcr - r2r) * o1r + (rci - r2i) * o1i
        yr = (cr - o2r) * r1r + (ci - o2i) * r1i
        err = yr - xr
        mu = (mu + sps) + gain * err
        adv = torch.floor(mu)
        i_in += int(adv.item())
        mu = mu - adv
        out_r[i_out], out_i[i_out] = cr, ci
        i_out += 1
        o2r, o2i, o1r, o1i = o1r, o1i, cr, ci
        r2r, r2i, r1r, r1i = r1r, r1i, rcr, rci
    syms = torch.complex(out_r, out_i)
    return syms, torch.tensor(i_out, dtype=torch.int32, device=dev)


def mm_timing(z: torch.Tensor, sps: float, gain: float = 0.01,
              mu0: float | torch.Tensor = 0.01):
    """z: (N,) complex64 at ``sps`` samples/symbol. ``mu0``: initial
    fractional sample position (may exceed 1, e.g. from comb_acquire).

    Returns (symbols (n_max,) complex64 zero-padded, n_valid 0-d int32
    tensor on z's device)."""
    from real_time_sdr_tpu_torch.ops.cuda.mm_timing import mm_timing_kernel
    mu0 = torch.as_tensor(mu0, dtype=torch.float32, device=z.device)
    return mm_timing_kernel(z, float(sps), float(gain), mu0)
