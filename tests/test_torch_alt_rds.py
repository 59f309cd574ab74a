"""The port's alternative RDS receiver and its two loops against the JAX
package's.

Each test feeds the same numpy input to the JAX function and to its port;
on CPU tensors the port runs the kernels' plain versions
(``mm_timing_plain``, ``costas_scan_plain``). Bounds: ``comb_acquire``
within 1e-4; ``mm_timing`` symbols > 90 dB with ``n_valid`` equal;
``costas_scan`` derotated > 80 dB, ``freq_log`` and the carry within 1e-5
rad/sample; ``coarse_freq_bpsk`` equal; ``AltRdsReceiver.decode`` with its
bits, ``n_valid``, PS, PI and groups equal, the baseband > 90 dB and the
symbols > 80 dB. The frontends agree to rounding (the JAX package's CPU
frontend folds the -128 offset after its matmul, the port's kernel subtracts
it exactly), which no decision of the alternative path resolves.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu.models.rds_alt import AltRdsReceiver as JAlt
from real_time_sdr_tpu.ops import costas as jcostas
from real_time_sdr_tpu.ops import symbol_timing as jtiming
from real_time_sdr_tpu.ops.filters import design_rrc
from real_time_sdr_tpu.utils import state as jstate
from real_time_sdr_tpu.utils.synth import station_iq
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.rds_alt import \
    AltRdsReceiver as _AltRdsReceiver
from real_time_sdr_tpu_torch.ops import costas, symbol_timing
from real_time_sdr_tpu_torch.ops.cuda import costas_kernel, mm_timing_kernel
from real_time_sdr_tpu_torch.utils import state as tstate

AltRdsReceiver = functools.partial(_AltRdsReceiver, device="cpu")
CFG = mode_config(0)


def _snr(ref, y):
    ref = np.asarray(ref, np.complex128)
    e = np.asarray(y, np.complex128) - ref
    return 10 * np.log10(np.sum(np.abs(ref) ** 2)
                         / max(np.sum(np.abs(e) ** 2), 1e-300))


def _station(n_blocks=24, **kw):
    return station_iq(CFG, n_blocks, ps_name="ALT-PATH", pi=0x2ABC, **kw)


@functools.cache
def _decoded(n_blocks, **kw):
    """(JAX (decoder, diag), port (decoder, diag)) on one station."""
    iq, _ = _station(n_blocks, **dict(kw))
    return JAlt(CFG).decode(iq), AltRdsReceiver(0).decode(iq)


def _impulse_stream():
    """JAX's comb-acquisition unit case: impulses at phase 11 of 16, a
    triangular pulse."""
    rng = np.random.default_rng(0)
    sps, true_phase = 16, 11
    z = np.zeros(400 * sps, np.complex64)
    z[true_phase::sps] = rng.choice([-1.0, 1.0], size=400)
    return np.convolve(z, [0.5, 1.0, 0.5], mode="same").astype(np.complex64)


def test_comb_acquire_matches_jax():
    z = _impulse_stream()
    got = float(symbol_timing.comb_acquire(torch.from_numpy(z), 16))
    want = float(jtiming.comb_acquire(jnp.asarray(z), 16))
    assert abs(got - want) < 1e-4, (got, want)
    assert abs(got - 11) < 0.25, got


def _rrc_stream(n_sym, ppm, seed=1):
    """JAX's fast-clock case: BPSK impulses at fractional instants of a
    transmitter clock ``ppm`` fast, RRC-shaped; (z, n, eff_sps)."""
    sps = 16.0
    eff_sps = sps * (1.0 - ppm * 1e-6)
    rng = np.random.default_rng(seed)
    sym = rng.choice([-1.0, 1.0], size=n_sym)
    pos = np.arange(n_sym) * eff_sps
    n = int(pos[-1]) + int(sps) + 2
    z = np.zeros(n + 1, np.float64)
    i0 = pos.astype(np.int64)
    np.add.at(z, i0, sym * (1.0 - (pos - i0)))
    np.add.at(z, i0 + 1, sym * (pos - i0))
    rrc = np.asarray(design_rrc(2375.0 * sps, 151), np.float64)
    z = np.convolve(z, rrc, mode="same")[:n].astype(np.complex64)
    return z, n, eff_sps


def test_mm_timing_fast_clock_matches_jax():
    """JAX's case: a +2000 ppm transmitter clock over 30,000 symbols (~25 s
    of RDS; the loop pulls in slowly, so a shorter stream never runs past
    the bound below). The port's loop gives JAX's symbols (> 90 dB) and
    count, runs past the old buffer bound int(n/sps)+4, and exits on the
    input, not on the buffer."""
    z, n, eff_sps = _rrc_stream(30_000, 2000.0)
    js, jn = jtiming.mm_timing(jnp.asarray(z), 16.0, gain=0.05, mu0=0.0)
    ts, tn = symbol_timing.mm_timing(torch.from_numpy(z), 16.0, gain=0.05,
                                     mu0=0.0)
    assert tn.dtype == torch.int32 and tn.ndim == 0
    assert int(tn) == int(jn)
    assert ts.shape == js.shape == (symbol_timing.mm_buffer_len(n, 16.0),)
    assert _snr(np.asarray(js), ts.numpy()) > 90.0
    assert int(tn) > int(n / 16.0) + 4
    assert int(tn) >= n / eff_sps * 0.998
    assert int(tn) < ts.shape[-1]
    assert not ts[int(tn):].any()          # zero-padded beyond n_valid


def test_mm_timing_mode0_baseband_matches_jax():
    """The alternative path's own input: the port's mode-0 unit-RMS
    baseband and its comb seed (mu0 > 1) through both loops."""
    (_, jdiag), (_, tdiag) = _decoded(24)
    bb = tdiag.baseband
    mu0 = symbol_timing.comb_acquire(torch.from_numpy(bb), 16)
    assert float(mu0) > 1.0
    js, jn = jtiming.mm_timing(jnp.asarray(bb), 16.0, gain=0.01,
                               mu0=jnp.float32(float(mu0)))
    ts, tn = symbol_timing.mm_timing(torch.from_numpy(bb), 16.0, gain=0.01,
                                     mu0=mu0)
    assert int(tn) == int(jn) > 800
    assert _snr(np.asarray(js), ts.numpy()) > 90.0


def test_mm_timing_rejects_bad_input():
    with pytest.raises(ValueError):
        symbol_timing.mm_timing(torch.zeros(1, dtype=torch.complex64), 16.0)
    with pytest.raises(ValueError):
        symbol_timing.mm_timing(torch.zeros(64), 16.0)
    with pytest.raises(ValueError):
        symbol_timing.mm_timing(torch.zeros((2, 64), dtype=torch.complex64),
                                16.0)


def _bpsk_symbols(n, f_hz, seed=2):
    """Unit-RMS BPSK symbols at 1187.5 Hz with a residual carrier f_hz and a
    little noise."""
    rng = np.random.default_rng(seed)
    s = rng.choice([-1.0, 1.0], size=n)
    k = np.arange(n)
    z = s * np.exp(1j * (2 * np.pi * f_hz / 1187.5 * k + 0.7))
    z = z + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return z.astype(np.complex64)


@pytest.mark.parametrize("carried", [False, True])
def test_costas_scan_matches_jax(carried):
    """From a cold carry and from the carry of a first call, on two rows:
    derotated > 80 dB, freq_log and the new carry within 1e-5."""
    z = np.stack([_bpsk_symbols(1200, 11.4), _bpsk_symbols(1200, -3.0, 3)])
    phase0 = np.zeros(2, np.float32)
    freq0 = np.array([0.06, -0.015], np.float32)
    if carried:      # the carry after a first call over other symbols
        _, _, c = jcostas.costas_scan(
            jnp.asarray(np.stack([_bpsk_symbols(400, 11.4, 5),
                                  _bpsk_symbols(400, -3.0, 6)])),
            jcostas.CostasCarry(jnp.asarray(phase0), jnp.asarray(freq0)))
        phase0, freq0 = np.array(c.phase), np.array(c.freq)
    jd, jf, jc = jcostas.costas_scan(
        jnp.asarray(z), jcostas.CostasCarry(jnp.asarray(phase0),
                                            jnp.asarray(freq0)))
    td, tf, tc = costas.costas_scan(
        torch.from_numpy(z), costas.CostasCarry(torch.from_numpy(phase0),
                                                torch.from_numpy(freq0)))
    assert td.dtype == torch.complex64 and tf.dtype == torch.float32
    assert _snr(np.asarray(jd), td.numpy()) > 80.0
    assert np.abs(np.asarray(jf) - tf.numpy()).max() < 1e-5
    assert np.abs(np.asarray(jc.freq) - tc.freq.numpy()).max() < 1e-5
    dphase = np.abs(np.asarray(jc.phase) - tc.phase.numpy())
    assert np.minimum(dphase, 2 * np.pi - dphase).max() < 1e-5
    assert ((tc.phase >= 0) & (tc.phase <= 2 * np.pi)).all()


def test_coarse_freq_matches_jax():
    z = _bpsk_symbols(900, 11.4)
    got = costas.coarse_freq_bpsk(torch.from_numpy(z))
    want = jcostas.coarse_freq_bpsk(jnp.asarray(z))
    assert got.dtype == torch.float32 and float(got) == float(want)
    assert abs(float(got) * 1187.5 / (2 * np.pi) - 11.4) < 0.2
    with pytest.raises(ValueError):
        costas.coarse_freq_bpsk(torch.from_numpy(np.stack([z, z])))


def test_costas_carry_cross_loads_with_jax(tmp_path):
    """save_state / load_state of a Costas carry read the JAX package's
    .npz and write one it reads."""
    c = jcostas.CostasCarry(jnp.float32(1.25), jnp.float32(-0.003))
    jstate.save_state(str(tmp_path / "j"), c)
    like = costas.costas_init()
    got = tstate.load_state(str(tmp_path / "j"), like)
    assert isinstance(got, costas.CostasCarry)
    assert float(got.phase) == 1.25 and float(got.freq) == np.float32(-0.003)
    tstate.save_state(str(tmp_path / "t"), got)
    back = jstate.load_state(str(tmp_path / "t"), c)
    assert float(back.phase) == 1.25 and float(back.freq) == float(c.freq)
    assert tstate.map_state(got, lambda t: t * 2).phase == 2.5


def _same_decode(n_blocks, **kw):
    (jdec, jdiag), (tdec, tdiag) = _decoded(n_blocks, **kw)
    assert tdec.synced and tdec.events.ps_name == "ALT-PATH"
    assert tdec.events.ps_name == jdec.events.ps_name
    assert tdec.events.pi == jdec.events.pi == 0x2ABC
    assert tdec.events.groups_decoded == jdec.events.groups_decoded
    assert len(tdiag.symbols) == len(jdiag.symbols)        # n_valid
    np.testing.assert_array_equal(tdiag.bits, jdiag.bits)
    return jdiag, tdiag


def test_alt_receiver_clean_station_matches_jax():
    jdiag, tdiag = _same_decode(24)
    assert tdiag.baseband.dtype == np.complex64
    assert _snr(jdiag.baseband, tdiag.baseband) > 90.0
    assert _snr(jdiag.symbols, tdiag.symbols) > 80.0
    assert _snr(jdiag.derotated, tdiag.derotated) > 80.0
    d = tdiag.derotated[200:]
    assert np.mean(d.real ** 2) > 100 * np.mean(d.imag ** 2)
    assert tdiag.freq_log.dtype == np.float32


def test_alt_receiver_pilot_offset_matches_jax():
    """+200 ppm tuner error: the 57 kHz subcarrier lands 11.4 Hz off the
    fixed mix; the Costas track converges there."""
    _, tdiag = _same_decode(32, pilot_freq=19_000.0 * (1 + 200e-6))
    assert abs(np.median(tdiag.freq_log[-200:]) - 11.4) < 1.5


def test_alt_receiver_rds_clock_ppm_matches_jax():
    _same_decode(32, rds_clock_ppm=300.0)


def test_alt_receiver_runs_the_plain_versions_on_the_cpu():
    m0, c0 = mm_timing_kernel.launches, costas_kernel.launches
    _decoded(24)
    AltRdsReceiver(0).decode(_station(2)[0])
    assert (mm_timing_kernel.launches, costas_kernel.launches) == (m0, c0)
    with pytest.raises(ValueError):
        AltRdsReceiver(0).decode(np.zeros(10, np.uint8))


def test_alt_receiver_default_device_is_the_card():
    """``AltRdsReceiver()`` means the card: without one it raises."""
    if torch.cuda.is_available():
        assert _AltRdsReceiver(0).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            _AltRdsReceiver(0)
