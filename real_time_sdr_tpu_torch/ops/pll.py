"""Type-2 second-order PLL + NCO: the exact loop (tier 1), its block-parallel
Newton twin (tier 2), and the loop parameters every carrier synchronizer
shares.

Port of ``real_time_sdr_tpu/ops/pll.py``. Per sample (Cp = 2.666,
Ci = 3.555, kp = bw*Cp, ki = bw^2*Ci):

    e      = atan2(x*(-fbq), x*fbi)        # phase detector
    integ  = integ + ki*e                  # loop integrator
    phase  = (phase + kp*e) + integ        # phase estimate
    trig   = (trig + 1) % period
    arg    = trig_angle(trig) + phase
    fb     = (cos arg, sin arg)            # feedback oscillator
    nco    = cos(arg*nco_scale + phase_adjust)

Consumers see the NCO delayed by one sample: the carrier of a call is
``[last_nco, nco[:-1]]``. The nominal ramp 2*pi*(f/Fs)*trig comes from an
integer counter wrapped modulo period = 2*Fs/gcd(f, Fs), and the phase is
wrapped modulo 4*pi once per call, so float32 never evaluates trig of a
large argument.

- Tier 1 runs through the kernel wrapper
  ``ops.cuda.pll_scan.pll_scan_kernel``: a CPU tensor takes
  ``pll_scan_plain`` (a per-sample loop over the channel column), a CUDA
  tensor launches the sequential-PLL kernel. The kernel evaluates the
  detector without transcendentals (x is real, so e = wrap(pi*[x<0] - arg));
  ``pll_scan_wrapped`` mirrors that arithmetic in torch as a test oracle
  and is on no path.
- ``pll_newton`` (tier 2) is plain torch on any device: Newton sweeps over
  chunks, each solving the linearized recurrence with a log-step scan of
  2x2 affine maps. A correctness twin of tier 1, not a serving path.

Every tensor has a leading channel axis: x (C, N), carry leaves (C,).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["PllCarry", "PllParams", "pll_init", "pll_scan_plain",
           "pll_scan_wrapped", "pll_newton"]

_CP = 2.666
_CI = 3.555
FOUR_PI = 4.0 * math.pi


class PllCarry(NamedTuple):
    """Carried loop state, one entry per channel."""
    fbi: torch.Tensor       # (C,) f32 feedback cos(arg)
    fbq: torch.Tensor       # (C,) f32 feedback sin(arg)
    integ: torch.Tensor     # (C,) f32 loop-filter integrator
    phase: torch.Tensor     # (C,) f32 phase estimate, mod 4*pi across calls
    trig: torch.Tensor      # (C,) int32 oscillator counter, mod period
    last_nco: torch.Tensor  # (C,) f32 previous call's final NCO sample


class PllParams(NamedTuple):
    """Static loop configuration (python ints/floats)."""
    freq: int             # oscillator nominal frequency, Hz (integer)
    fs: int               # sample rate, Hz (integer)
    nco_scale: float = 1.0
    phase_adjust: float = 0.0
    norm_bw: float = 0.01

    @property
    def kp(self) -> float:
        return self.norm_bw * _CP

    @property
    def ki(self) -> float:
        return self.norm_bw * self.norm_bw * _CI

    @property
    def _ratio(self):
        g = math.gcd(self.freq, self.fs)
        return self.freq // g, self.fs // g

    @property
    def period(self) -> int:
        """Integer counter period: trig and trig+period give oscillator
        angles differing by a multiple of 4*pi."""
        return 2 * self._ratio[1]

    def trig_angle(self, trig: torch.Tensor) -> torch.Tensor:
        """Exact wrapped 2*pi*(f/Fs)*trig in [0, 4*pi), float32 (integer
        phase arithmetic in int64)."""
        fr, fsr = self._ratio
        frac = (fr * trig.to(torch.int64)) % (2 * fsr)
        return (2.0 * math.pi / fsr) * frac.to(torch.float32)


def pll_init(batch: int, device=None) -> PllCarry:
    """The reference's initial loop state for ``batch`` channels: feedback
    (1, 0), zero integrator and phase, counter 0, previous NCO 1."""
    def full(v):
        return torch.full((batch,), v, dtype=torch.float32, device=device)
    return PllCarry(fbi=full(1.0), fbq=full(0.0), integ=full(0.0),
                    phase=full(0.0),
                    trig=torch.zeros((batch,), dtype=torch.int32,
                                     device=device),
                    last_nco=full(1.0))


def check_args(x: torch.Tensor, carry: PllCarry) -> None:
    """Raise unless x is (C, N) float32 and every carry leaf is (C,)."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (C, N) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    for name, leaf in zip(carry._fields, carry):
        if tuple(leaf.shape) != (x.shape[0],):
            raise ValueError(f"carry.{name} has shape {tuple(leaf.shape)}, "
                             f"expected ({x.shape[0]},)")


def pll_scan_plain(x: torch.Tensor, carry: PllCarry, p: PllParams):
    """Tier 1, plain version: the exact recurrence as a loop over samples,
    each step an elementwise op over the channel column, in the JAX
    package's operation order. x (C, N) -> (carrier (C, N), carry).

    The ramp angles and the NCO do not feed the recurrence, so they are
    computed for the whole call at once (the same elementwise ops)."""
    check_args(x, carry)
    n = x.shape[-1]
    kp, ki = p.kp, p.ki
    steps = torch.arange(1, n + 1, dtype=torch.int64, device=x.device)
    trig = (carry.trig.to(torch.int64)[:, None] + steps) % p.period
    ramp = p.trig_angle(trig).t().contiguous()               # (N, C)
    fbi, fbq, integ, phase = carry.fbi, carry.fbq, carry.integ, carry.phase
    args = []
    for xk, ak in zip(x.t().contiguous().unbind(0), ramp.unbind(0)):
        e = torch.atan2(xk * (-fbq), xk * fbi)
        integ = integ + ki * e
        phase = phase + kp * e + integ
        arg = ak + phase
        fbi, fbq = torch.cos(arg), torch.sin(arg)
        args.append(arg)
    if n == 0:
        return x.clone(), carry
    nco = torch.cos(torch.stack(args, dim=-1) * p.nco_scale + p.phase_adjust)
    carrier = torch.cat([carry.last_nco[:, None], nco[:, :-1]], dim=-1)
    new = PllCarry(fbi=fbi, fbq=fbq, integ=integ,
                   phase=torch.remainder(phase, FOUR_PI),
                   trig=trig[:, -1].to(torch.int32),
                   last_nco=nco[:, -1].contiguous())
    return carrier, new


# The wrapped detector's constants, each one float32 value (the kernel
# csrc/pll_scan.cu holds the same literals): pi, 2*pi split in two for an
# exact reduction, 1/(2*pi), and 1.5 * 2^23, which rounds a float32 sum to
# the nearest integer (ties to even).
_F32 = torch.float32
PI_F = torch.tensor(math.pi, dtype=_F32).item()
TWO_PI_HI = torch.tensor(2.0 * math.pi, dtype=_F32).item()
TWO_PI_LO = torch.tensor(2.0 * math.pi - TWO_PI_HI, dtype=_F32).item()
INV_TWO_PI = torch.tensor(0.5 / math.pi, dtype=_F32).item()
ROUND_MAGIC = 12582912.0


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once: the product of two float32 values is
    exact in float64, and the float64 sum is rounded to float32 (a double
    rounding that differs from a true fma only at float64 ties)."""
    return (a.double() * b + c).to(_F32)


def wrapped_detector(x: torch.Tensor, arg: torch.Tensor) -> torch.Tensor:
    """The phase detector atan2(x*(-sin arg), x*cos arg) for real, finite,
    non-zero x without transcendentals: -arg (x > 0) or pi - arg (x < 0),
    reduced into [-pi, pi] by r - 2*pi*rint(r/(2*pi)), with -pi mapped to
    +pi. The kernel's arithmetic, operation for operation."""
    r = torch.where(x < 0, PI_F, 0.0).to(_F32) - arg
    k = _fma(r, INV_TWO_PI, ROUND_MAGIC) - ROUND_MAGIC
    e = _fma(-k, TWO_PI_LO, _fma(-k, TWO_PI_HI, r))
    return torch.where(e <= -PI_F, e + TWO_PI_HI, e)


def pll_scan_wrapped(x: torch.Tensor, carry: PllCarry, p: PllParams):
    """Tier 1 as the CUDA kernel computes it: ``pll_scan_plain``'s loop with
    the wrapped detector. A sample that is zero or not finite, and the
    first sample of a call (whose feedback is the carried (fbi, fbq), not
    an angle), takes the literal detector, so signed zeros, +-pi and NaN
    propagate as in the plain version. A test oracle; on no path."""
    check_args(x, carry)
    n = x.shape[-1]
    if n == 0:
        return x.clone(), carry
    kp, ki = p.kp, p.ki
    steps = torch.arange(1, n + 1, dtype=torch.int64, device=x.device)
    trig = (carry.trig.to(torch.int64)[:, None] + steps) % p.period
    ramp = p.trig_angle(trig).t().contiguous()               # (N, C)
    integ, phase = carry.integ, carry.phase
    arg = torch.zeros_like(phase)
    literal = ((x == 0) | ~torch.isfinite(x)).t().contiguous()
    literal[0] = True
    args = []
    for k, (xk, ak, lit) in enumerate(zip(x.t().contiguous().unbind(0),
                                          ramp.unbind(0), literal.unbind(0))):
        e = wrapped_detector(xk, arg)
        if lit.any():
            fbi, fbq = ((carry.fbi, carry.fbq) if k == 0
                        else (torch.cos(arg), torch.sin(arg)))
            e = torch.where(lit, torch.atan2(xk * (-fbq), xk * fbi), e)
        integ = integ + ki * e
        phase = phase + kp * e + integ
        arg = ak + phase
        args.append(arg)
    nco = torch.cos(torch.stack(args, dim=-1) * p.nco_scale + p.phase_adjust)
    carrier = torch.cat([carry.last_nco[:, None], nco[:, :-1]], dim=-1)
    new = PllCarry(fbi=torch.cos(arg), fbq=torch.sin(arg), integ=integ,
                   phase=torch.remainder(phase, FOUR_PI),
                   trig=trig[:, -1].to(torch.int32),
                   last_nco=nco[:, -1].contiguous())
    return carrier, new


def _largest_divisor_leq(n: int, target: int) -> int:
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def pll_newton(x: torch.Tensor, carry: PllCarry, p: PllParams,
               iters: int = 3, chunk_target: int = 512):
    """Tier 2: chunked block-parallel Newton solve of the loop recurrence,
    with the tier-1 loop's interface. The call is split into chunks of the
    largest divisor of N <= ``chunk_target``, solved one after another;
    inside a chunk ``iters`` Newton sweeps each run one vectorized detector
    pass and one log-step scan of affine maps."""
    check_args(x, carry)
    n = x.shape[-1]
    if n == 0:
        return x.clone(), carry
    chunk = _largest_divisor_leq(n, chunk_target)
    ncos = []
    c = carry
    for s in range(0, n, chunk):
        nc, c = _newton_chunk(x[:, s:s + chunk], c, p, iters)
        ncos.append(nc)
    ncos = torch.cat(ncos, dim=-1)
    carrier = torch.cat([carry.last_nco[:, None], ncos[:, :-1]], dim=-1)
    return carrier, c


def _affine_scan(elems):
    """Inclusive scan of 2x2 affine maps (a11, a12, a21, a22, b1, b2), each
    (C, n), under composition (later map applied after earlier), as a
    Hillis-Steele log-step scan along the last axis."""
    a11, a12, a21, a22, b1, b2 = elems
    n = a11.shape[-1]
    d = 1
    while d < n:
        l11, l12, l21, l22, lb1, lb2 = (t[..., :-d] for t in
                                        (a11, a12, a21, a22, b1, b2))
        r11, r12, r21, r22, rb1, rb2 = (t[..., d:] for t in
                                        (a11, a12, a21, a22, b1, b2))
        c11 = r11 * l11 + r12 * l21
        c12 = r11 * l12 + r12 * l22
        c21 = r21 * l11 + r22 * l21
        c22 = r21 * l12 + r22 * l22
        cb1 = r11 * lb1 + r12 * lb2 + rb1
        cb2 = r21 * lb1 + r22 * lb2 + rb2
        a11, a12, a21, a22, b1, b2 = (
            torch.cat([old[..., :d], new], dim=-1)
            for old, new in ((a11, c11), (a12, c12), (a21, c21), (a22, c22),
                             (b1, cb1), (b2, cb2)))
        d *= 2
    return a11, a12, a21, a22, b1, b2


def _newton_chunk(x: torch.Tensor, carry: PllCarry, p: PllParams,
                  iters: int):
    """Solve one chunk (C, n) in parallel; returns (ncos (C, n), carry)."""
    n = x.shape[-1]
    kp, ki = p.kp, p.ki
    kpi = kp + ki
    dev = x.device
    ks = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    a = p.trig_angle((carry.trig.to(torch.int64)[:, None] + ks) % p.period)
    # e_0 is exact: its detector angle comes from the carried feedback
    e0 = torch.atan2(x[:, 0] * (-carry.fbq), x[:, 0] * carry.fbi)
    mask = (x != 0.0).to(x.dtype)     # the detector is 0 at zero samples

    def detector(phi):
        """e_k for k=1..n-1 given the phase trajectory phi[k]."""
        psi = a[:, :-1] + phi         # detector angle = previous step's arg
        return torch.atan2(x[:, 1:] * (-torch.sin(psi)),
                           x[:, 1:] * torch.cos(psi))

    def solve(e_lin, m, phi_ref):
        """Phase trajectory phi[1..n] of the recurrence linearized as
        e_k ~= e_lin_k - m_k*(phi_k - phi_ref_k) (m_0 = 0)."""
        g = e_lin + m * phi_ref
        ones = torch.ones_like(m)
        _, _, p21, p22, _, v2 = _affine_scan(
            (ones, -ki * m, ones, 1.0 - kpi * m, ki * g, kpi * g))
        return p21 * carry.integ[:, None] + p22 * carry.phase[:, None] + v2

    # initial trajectory: the carried phase extrapolated by the integrator
    # (the per-sample frequency correction in lock)
    steps = torch.arange(1, n + 1, dtype=x.dtype, device=dev)
    phi = carry.phase[:, None] + steps * carry.integ[:, None]
    zero = torch.zeros_like(x[:, :1])
    m = torch.cat([zero, mask[:, 1:]], dim=-1)
    for _ in range(iters):
        e_lin = torch.cat([e0[:, None], detector(phi[:, :-1])], dim=-1)
        phi_ref = torch.cat([zero, phi[:, :-1]], dim=-1)
        phi = solve(e_lin, m, phi_ref)

    # exact forward quantities from the converged trajectory
    e_all = torch.cat([e0[:, None], detector(phi[:, :-1])], dim=-1)
    integ = carry.integ[:, None] + ki * torch.cumsum(e_all, dim=-1)
    phase_full = carry.phase[:, None] + torch.cumsum(kp * e_all + integ,
                                                     dim=-1)
    arg = a + phase_full
    ncos = torch.cos(arg * p.nco_scale + p.phase_adjust)
    new = PllCarry(
        fbi=torch.cos(arg[:, -1]), fbq=torch.sin(arg[:, -1]),
        integ=integ[:, -1].contiguous(),
        phase=torch.remainder(phase_full[:, -1], FOUR_PI),
        trig=((carry.trig.to(torch.int64) + n) % p.period).to(torch.int32),
        last_nco=ncos[:, -1].contiguous())
    return ncos, new

