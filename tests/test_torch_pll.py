"""The port's carrier loops (tier 1 exact PLL, tier 2 Newton) against the
JAX package and the float64 golden loop.

The same numpy pilot (a 19 or 114 kHz tone with a frequency offset and a
little noise) goes through ``pll_scan_plain`` batched over two channels and
through JAX ``pll_scan`` one channel at a time. Bounds:

- tier 1 vs JAX: > 40 dB over the first block from a cold carry (the
  acquisition transient amplifies ulp differences between the two
  libraries' atan2/cos), > 80 dB over the following blocks once locked;
  the carry's float leaves within 1e-4 absolute (phase within 1e-3: it is
  an unbounded sum wrapped once per call), ``trig`` exactly;
- an all-zero input gives the detector atan2(+-0, +-0), whose sign rules
  the JAX package follows: the carry agrees within 1e-6, so every
  detector output took the same branch;
- tier 2 vs JAX tier 2: > 60 dB (measured 79.7-84.8 dB on this fixture),
  carry within 1e-3: the Hillis-Steele scan sums in another order than
  ``lax.associative_scan``. From a cold carry both packages' Newton solves
  fail to converge when the pilot's initial phase error is near pi (e.g.
  3.05 rad: -3 dB against tier 1 in JAX), so the fixture's phases, like
  the JAX package's own, stay away from it;
- both tiers vs ``golden/dsp.py`` ``pll_block`` (float64): > 35 dB, the
  JAX package's own bound (tests/test_ops_parity.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import dsp
from real_time_sdr_tpu import config as C
from real_time_sdr_tpu.config import mode_config
from real_time_sdr_tpu.ops import pll as jpll
from real_time_sdr_tpu_torch.ops import pll as tpll
from real_time_sdr_tpu_torch.ops.cuda import pll_scan_kernel

# name: (freq, nco_scale, norm_bw, offset Hz)
LOOPS = {"stereo": (int(C.PILOT_FREQ), 2.0, C.PLL_BW_STEREO, 40.0),
         "rds": (int(C.RDS_PILOT_FREQ), 0.5, C.PLL_BW_RDS, -5.0)}


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _pilot(freq, fs, n, phases, noise, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = np.cos(2 * np.pi * freq * t + np.asarray(phases)[:, None])
    x = x + noise * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def _params(name, fs):
    freq, scale, bw, _ = LOOPS[name]
    return (jpll.PllParams(freq=freq, fs=fs, nco_scale=scale, norm_bw=bw),
            tpll.PllParams(freq=freq, fs=fs, nco_scale=scale, norm_bw=bw))


def _jcarry(carry, c):
    return jpll.PllCarry(*(jnp.asarray(t[c].numpy()) for t in carry))


def _assert_carry_close(tc, jc, c, tol=1e-4):
    for name, a, b in zip(tc._fields, tc, jc):
        a, b = a[c].numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        if name == "trig":
            assert int(a) == int(b)
        else:
            bound = 1e-3 if name == "phase" else tol
            assert abs(float(a) - float(b)) < bound, (name, a, b)


@pytest.mark.parametrize("mode", [0, 3])
@pytest.mark.parametrize("name", sorted(LOOPS))
def test_pll_scan_plain_matches_jax(name, mode):
    cfg = mode_config(mode)
    n = cfg.if_block
    jp, tp = _params(name, cfg.if_fs)
    freq, _, _, off = LOOPS[name]
    x = _pilot(freq + off, cfg.if_fs, 3 * n, [0.3, 2.1], 0.05, mode)
    tc = tpll.pll_init(2)
    jcs = [jpll.pll_init() for _ in range(2)]
    for b in range(3):
        blk = x[:, b * n:(b + 1) * n]
        car, tc = tpll.pll_scan_plain(torch.from_numpy(blk), tc, tp)
        assert car.shape == (2, n) and car.dtype == torch.float32
        for c in range(2):
            jcar, jcs[c] = jpll.pll_scan(jnp.asarray(blk[c]), jcs[c], jp)
            assert _snr(jcar, car[c]) > (40.0 if b == 0 else 80.0)
            _assert_carry_close(tc, jcs[c], c)
    # a locked carry taken from JAX continues as JAX does
    tc = tpll.PllCarry(*(torch.from_numpy(np.stack(
        [np.asarray(j[k]) for j in jcs])) for k in range(6)))
    blk = _pilot(freq + off, cfg.if_fs, 4 * n, [0.3, 2.1], 0.05,
                 mode)[:, 3 * n:]
    car, tc = pll_scan_kernel(torch.from_numpy(blk), tc, tp)  # CPU route
    for c in range(2):
        jcar, jc = jpll.pll_scan(jnp.asarray(blk[c]), jcs[c], jp)
        assert _snr(jcar, car[c]) > 80.0
        _assert_carry_close(tc, jc, c)


def test_pll_scan_zero_input_signed_zeros():
    """x == 0 makes the detector atan2(x*(-fbq), x*fbi) of two signed
    zeros: +-0 where fbi > 0, +-pi where fbi < 0. The carry (integrator
    included) must follow JAX's branches exactly, from the cold carry and
    from carries with fbi < 0."""
    fs = 240_000
    jp, tp = _params("stereo", fs)
    x = np.zeros((3, 200), np.float32)
    x[2, :50] = 0.7                     # a tone that stops: zeros after it
    start = tpll.PllCarry(
        fbi=torch.tensor([1.0, -0.6, 0.8]), fbq=torch.tensor([0.0, 0.8, -0.6]),
        integ=torch.tensor([0.0, 1e-3, -2e-3]),
        phase=torch.tensor([0.0, 2.5, -1.0]),
        trig=torch.tensor([0, 17, 479], dtype=torch.int32),
        last_nco=torch.tensor([1.0, -0.2, 0.5]))
    car, tc = pll_scan_kernel(torch.from_numpy(x), start, tp)
    for c in range(3):
        jcar, jc = jpll.pll_scan(jnp.asarray(x[c]), _jcarry(start, c), jp)
        assert np.max(np.abs(car[c].numpy() - np.asarray(jcar))) < 1e-5
        _assert_carry_close(tc, jc, c, tol=1e-6)
    # fbi < 0 at x == 0 took the +-pi branch: the integrator moved
    assert abs(float(tc.integ[1]) - 1e-3) > 1e-4


def test_pll_newton_matches_jax():
    cfg = mode_config(0)
    n = cfg.if_block
    jp, tp = _params("stereo", cfg.if_fs)
    assert tpll._largest_divisor_leq(n, 512) == jpll._largest_divisor_leq(
        n, 512) == 490
    x = _pilot(19_060.0, cfg.if_fs, 3 * n, [2.1, 0.4], 0.05, 3)
    tc = tpll.pll_init(2)
    jcs = [jpll.pll_init() for _ in range(2)]
    for b in range(3):
        blk = x[:, b * n:(b + 1) * n]
        car, tc = tpll.pll_newton(torch.from_numpy(blk), tc, tp)
        for c in range(2):
            jcar, jcs[c] = jpll.pll_newton(jnp.asarray(blk[c]), jcs[c], jp)
            assert _snr(jcar, car[c]) > 60.0
            _assert_carry_close(tc, jcs[c], c, tol=1e-3)


@pytest.mark.parametrize("tier", [1, 2])
def test_tiers_match_golden_loop(tier):
    fs, f = 240_000, 19_000
    n = 7350
    jp, tp = _params("stereo", fs)
    x = _pilot(f + 40.0, fs, 4 * n, [0.3], 0.05, 0)
    fn = pll_scan_kernel if tier == 1 else tpll.pll_newton
    tc, g = tpll.pll_init(1), dsp.PllState()
    got, ref = [], []
    for b in range(4):
        blk = x[:, b * n:(b + 1) * n]
        car, tc = fn(torch.from_numpy(blk), tc, tp)
        gcar, g = dsp.pll_block(blk[0], f, fs, g, nco_scale=2.0,
                                norm_bw=C.PLL_BW_STEREO)
        got.append(car[0].numpy())
        ref.append(gcar[:n])
    got, ref = np.concatenate(got), np.concatenate(ref)
    assert _snr(ref, got) > 35.0
    assert np.corrcoef(ref, got)[0, 1] > 0.999


def test_pll_params_match_jax():
    for name in LOOPS:
        jp, tp = _params(name, 384_000)
        assert tp._fields == jp._fields
        assert tp.kp == jp.kp and tp.ki == jp.ki
        assert tp.period == jp.period
        trig = np.arange(0, 2 * tp.period, 7, dtype=np.int32)
        np.testing.assert_array_equal(
            tp.trig_angle(torch.from_numpy(trig)).numpy(),
            np.asarray(jp.trig_angle(jnp.asarray(trig))))


def test_pll_scan_routes_by_device():
    """A CPU tensor takes the plain version (no launch counted); a tensor on
    any device but CPU or CUDA raises; bad shapes raise."""
    tp = _params("stereo", 240_000)[1]
    x = torch.from_numpy(_pilot(19_000.0, 240_000, 64, [0.0], 0.0, 1))
    before = pll_scan_kernel.launches
    a, ca = pll_scan_kernel(x, tpll.pll_init(1), tp)
    b, cb = tpll.pll_scan_plain(x, tpll.pll_init(1), tp)
    assert pll_scan_kernel.launches == before
    assert torch.equal(a, b) and all(torch.equal(u, v) for u, v in zip(ca, cb))
    with pytest.raises(ValueError):
        pll_scan_kernel(x.to("meta"), tpll.pll_init(1, "meta"), tp)
    with pytest.raises(ValueError):
        pll_scan_kernel(x[0], tpll.pll_init(1), tp)
    with pytest.raises(ValueError):
        pll_scan_kernel(x, tpll.pll_init(2), tp)


# --- the wrapped detector (the CUDA kernel's arithmetic, mirrored in torch) --
#
# ``pll_scan_wrapped`` replaces atan2(x*(-sin arg), x*cos arg) by the exact
# reduction of pi*[x<0] - arg into [-pi, pi]; the literal detector carries
# the rounding of sin, cos and atan2 (a few 1e-8 per sample), which the loop
# filters. Bounds against ``pll_scan_plain``: carrier > 100 dB (measured
# 113-138 dB), ``trig`` equal, float carry within 1e-5 with ``phase``
# compared modulo 4*pi (measured < 4e-6). Against JAX ``pll_scan`` the
# bounds are the plain version's own (> 40 dB over a cold first block,
# > 80 dB locked, carry 1e-4 / phase 1e-3): two math libraries apart.

def _carry_err(a, b):
    """Max abs difference of the float leaves, phase modulo 4*pi; trig must
    be equal."""
    assert torch.equal(a.trig, b.trig)
    worst = 0.0
    for name, u, v in zip(a._fields, a, b):
        if name == "trig":
            continue
        d = (u.double() - v.double()).abs()
        if name == "phase":
            d = torch.minimum(d, (d - tpll.FOUR_PI).abs())
        worst = max(worst, float(d.max()))
    return worst


@pytest.mark.parametrize("start", ["cold", "locked"])
@pytest.mark.parametrize("name", sorted(LOOPS))
def test_pll_scan_wrapped_matches_plain_and_jax(name, start):
    cfg = mode_config(0)
    n = cfg.if_block
    jp, tp = _params(name, cfg.if_fs)
    freq, _, _, off = LOOPS[name]
    phases = [0.3, 2.1, 2.9]
    x = _pilot(freq + off, cfg.if_fs, 3 * n, phases, 0.05, 7)
    carry = tpll.pll_init(len(phases))
    blk = x[:, :n]
    if start == "locked":
        for b in range(2):
            _, carry = tpll.pll_scan_plain(
                torch.from_numpy(x[:, b * n:(b + 1) * n]), carry, tp)
        blk = x[:, 2 * n:]
    ref, rc = tpll.pll_scan_plain(torch.from_numpy(blk), carry, tp)
    got, gc = tpll.pll_scan_wrapped(torch.from_numpy(blk), carry, tp)
    assert got.shape == ref.shape and got.dtype == torch.float32
    for c in range(len(phases)):
        assert _snr(ref[c], got[c]) > 100.0, (c, _snr(ref[c], got[c]))
    assert _carry_err(gc, rc) < 1e-5
    for c in range(2):
        jcar, jc = jpll.pll_scan(jnp.asarray(blk[c]), _jcarry(carry, c), jp)
        assert _snr(jcar, got[c]) > (40.0 if start == "cold" else 80.0)
        _assert_carry_close(gc, jc, c)


def test_pll_scan_wrapped_zero_and_nonfinite_take_the_literal_path():
    """All-zero rows are all literal: bit-equal to the plain version, signed
    zeros and +-pi included (the fixture of the signed-zero test above). A
    row whose tone stops, and rows with a NaN or an Inf in them, follow the
    plain version: the same NaN pattern, > 100 dB where finite."""
    fs = 240_000
    jp, tp = _params("stereo", fs)
    x = np.zeros((5, 200), np.float32)
    x[2, :50] = 0.7
    x[3:] = _pilot(19_040.0, fs, 200, [0.4, 1.9], 0.05, 5)
    x[3, 120] = np.nan
    x[4, 60] = np.inf
    start = tpll.PllCarry(
        fbi=torch.tensor([1.0, -0.6, 0.8, 1.0, 1.0]),
        fbq=torch.tensor([0.0, 0.8, -0.6, 0.0, 0.0]),
        integ=torch.tensor([0.0, 1e-3, -2e-3, 0.0, 0.0]),
        phase=torch.tensor([0.0, 2.5, -1.0, 0.0, 0.0]),
        trig=torch.tensor([0, 17, 479, 0, 3], dtype=torch.int32),
        last_nco=torch.tensor([1.0, -0.2, 0.5, 1.0, 1.0]))
    ref, rc = tpll.pll_scan_plain(torch.from_numpy(x), start, tp)
    got, gc = tpll.pll_scan_wrapped(torch.from_numpy(x), start, tp)
    assert torch.equal(got[:2], ref[:2])
    for u, v in zip(gc, rc):
        assert torch.equal(u[:2], v[:2])
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[3, 122:]).all() and not torch.isnan(got[4]).any()
    assert torch.isnan(gc.phase[3]) and torch.isnan(rc.phase[3])
    assert _snr(ref[2], got[2]) > 100.0
    assert _snr(ref[3, :120], got[3, :120]) > 100.0
    assert _snr(ref[4], got[4]) > 100.0
    assert _carry_err(tpll.PllCarry(*(t[[2, 4]] for t in gc)),
                      tpll.PllCarry(*(t[[2, 4]] for t in rc))) < 1e-5
    # and the NaN row does what JAX does with it
    jcar, _ = jpll.pll_scan(jnp.asarray(x[3]), _jcarry(start, 3), jp)
    np.testing.assert_array_equal(np.isnan(np.asarray(jcar)),
                                  torch.isnan(got[3]).numpy())


def test_wrapped_detector_is_the_angle_of_the_literal_one():
    """e = wrap(pi*[x<0] - arg) against atan2(x*(-sin arg), x*cos arg) in
    float64 over args in [-30, 30] and both signs of x: within 2e-6 (the
    float32 spacing of arg at 30 is 1.9e-6), in [-pi, pi]."""
    rng = np.random.default_rng(3)
    arg = rng.uniform(-30.0, 30.0, 20_000).astype(np.float32)
    x = rng.choice([-0.8, 0.3], arg.size).astype(np.float32)
    e = tpll.wrapped_detector(torch.from_numpy(x),
                              torch.from_numpy(arg)).numpy()
    a64, x64 = arg.astype(np.float64), x.astype(np.float64)
    lit = np.arctan2(x64 * -np.sin(a64), x64 * np.cos(a64))
    d = np.abs(e - lit)
    d = np.minimum(d, np.abs(d - 2 * np.pi))      # +pi and -pi are one angle
    assert d.max() < 2e-6
    assert np.abs(e).max() <= tpll.PI_F
    assert (e > -tpll.PI_F).all()
