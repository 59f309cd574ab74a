"""The port's receiver on impaired captures against the JAX receiver on the
same bytes: twins of ``tests/test_noise_ber.py``, ``tests/test_pilot_offset.py``
and ``tests/test_timing_recovery.py`` at one or two operating points each.

Captures come from the JAX package's ``station_iq`` / ``impair_iq`` (the
port's copies give the same bytes, ``tests/test_torch_copies.py``). Both
receivers run the same tier; the RDS cases run tier 3 (the per-sample
tier-1 loop of the port's CPU path takes ~0.9 s a block) and the JAX
receiver its Pallas frontend in interpret mode, whose exact x - 128 the
port shares. Held: each side's BER under the JAX test's bound, the two BERs
within 2e-3 of each other, PS and PI decoded by both, and the stereo
separation of both above the JAX test's 20 (13 dB).
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu.config import mode_config
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.models.rds_framing import (RdsFramer,
                                                        SyncByOffsetDecoder)
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from tests.test_noise_ber import measure_ber

Receiver = functools.partial(_Receiver, device="cpu")
CFG = mode_config(0)


def _ber(bits, nbits, truth):
    """(ber, n bits) at the best alignment: the JAX test's measure."""
    return measure_ber(SimpleNamespace(rds_bits=bits, rds_nbits=nbits),
                       truth, len(nbits))


def _decode(bits, nbits, framer):
    for k in range(len(nbits)):
        if nbits[k] > 0:
            framer.feed(bits[k][:nbits[k]])
    return framer.events


@functools.cache
def _jax_receiver(tier, timing):
    """One JAX receiver per configuration, so its compiled segment is
    reused across the captures of one length."""
    return JReceiver(0, stereo=True, rds=True, pll_tier=tier,
                     rds_timing=timing, frontend_impl="pallas_interpret")


def _both(iq, truth, nb, tier=3, timing="comb"):
    """Both receivers over one nb-block segment: {"jax"|"port": (bits,
    nbits, ber, n, state)}."""
    jrx = _jax_receiver(tier, timing)
    jst, jout = jrx.run_segment(jrx.init_state(), jnp.asarray(iq))
    trx = Receiver(0, stereo=True, rds=True, pll_tier=tier,
                   rds_timing=timing)
    tst, tout = trx.run_segment(trx.init_state(1),
                                torch.from_numpy(iq)[None])
    res = {}
    for name, bits, nbits, st in (
            ("jax", np.asarray(jout.rds_bits), np.asarray(jout.rds_nbits),
             jst),
            ("port", tout.rds_bits[0].numpy(), tout.rds_nbits[0].numpy(),
             tst)):
        res[name] = (bits, nbits, *_ber(bits, nbits, truth), st)
    assert res["port"][1].shape == (nb,)
    return res


def _check(res, ps, pi, max_ber, framers=(RdsFramer,)):
    for name in ("jax", "port"):
        bits, nbits, ber, n, _ = res[name]
        assert n > 700, (name, n)
        assert ber < max_ber, (name, ber)
        for cls in framers:
            ev = _decode(bits, nbits, cls(correct_bursts=2))
            assert ev.ps_name == ps and ev.pi == pi, (name, cls.__name__)
    assert abs(res["port"][2] - res["jax"][2]) <= 2e-3, (res["port"][2],
                                                         res["jax"][2])


def test_awgn_ber_matches_jax():
    """sigma 0.05 on unit-amplitude IQ (~26 dB CNR), 30 blocks."""
    iq, truth = jsynth.station_iq(CFG, 30,
                                  ps_name="BERTEST ", pi=0x4242, pty=2,
                                  noise_std=0.05)
    _check(_both(iq, truth, 30), "BERTEST ", 0x4242, 2e-2)


@pytest.mark.parametrize("channel", ["fading", "tuner"])
def test_impaired_channel_matches_jax(channel):
    """A time-varying two-ray channel (rays rotating at 0.5 Hz) with AWGN,
    decoded by both framer architectures; or every tuner artifact at once
    (IQ imbalance, DC offset, 30 Hz phase noise, 400 Hz CFO, AWGN)."""
    iq, truth = jsynth.station_iq(CFG, 30,
                                  ps_name="FADETEST", pi=0x5050, pty=3)
    if channel == "fading":
        iq = jsynth.impair_iq(iq, CFG.rf_fs,
                              multipath=[(2.0e-6, 0.45, 0.7),
                                         (5.3e-6, 0.30, 2.1)],
                              doppler_hz=0.5, noise_std=0.12)
        _check(_both(iq, truth, 30), "FADETEST", 0x5050, 2e-2,
               framers=(RdsFramer, SyncByOffsetDecoder))
    else:
        iq = jsynth.impair_iq(iq, CFG.rf_fs, iq_gain_db=0.5,
                              iq_phase_deg=2.0, dc_offset=0.03 + 0.02j,
                              phase_noise_linewidth_hz=30.0,
                              freq_offset_hz=400.0, noise_std=0.02)
        _check(_both(iq, truth, 30), "FADETEST", 0x5050, 2e-2)


def test_tracked_timing_follows_clock_ppm_like_jax():
    """+400 ppm transmitter symbol clock over 30 blocks (JAX's test runs
    40; 30 share the other cases' compiled JAX segment): the tracking CDR
    holds the BER under 3e-3 on both sides, beats or ties the fixed comb,
    and its drift accumulator takes the sign and size JAX's takes."""
    iq, truth = jsynth.station_iq(CFG, 30,
                                  ps_name="PPMTRACK", pi=0x2222, pty=5,
                                  rds_clock_ppm=400.0)
    tracked = _both(iq, truth, 30, timing="tracked")
    _check(tracked, "PPMTRACK", 0x2222, 3e-3)
    comb = _both(iq, truth, 30, timing="comb")
    for name in ("jax", "port"):
        assert tracked[name][2] <= comb[name][2], name
    rate_j = float(np.asarray(tracked["jax"][4].rds.track.rate))
    rate_t = float(tracked["port"][4].rds.track.rate[0])
    expect = 16 * (1.0 / (1.0 + 400e-6) - 1.0)
    assert rate_t * expect > 0 and rate_j * expect > 0
    assert abs(rate_t - rate_j) < 0.1 * abs(expect), (rate_t, rate_j)


def _band_power(x, fs, f, width=30.0):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    return sp[(freqs > f - width) & (freqs < f + width)].sum()


@pytest.mark.parametrize("tier,offset", [(1, 60.0), (3, -45.0)])
def test_stereo_tracks_pilot_offset_like_jax(tier, offset):
    """A pilot tens of Hz off (tuner ppm error), stereo only, 10 blocks:
    both receivers keep > 20x separation after 4 blocks, and their audio
    agrees to > 40 dB there."""
    jrx = JReceiver(0, stereo=True, rds=False, pll_tier=tier)
    cfg = jrx.cfg
    n = cfg.block_size_iq * 10
    t = np.arange(n) / cfg.rf_fs
    left, right = np.sin(2 * np.pi * 440.0 * t), np.sin(2 * np.pi * 1200 * t)
    iq = jsynth.fm_iq(cfg.rf_fs, n, mono=(left + right) / 2,
                      stereo_diff=(left - right) / 2,
                      pilot_freq=19_000.0 + offset)
    _, jout = jrx.run_segment(jrx.init_state(), jnp.asarray(iq))
    trx = Receiver(0, stereo=True, rds=False, pll_tier=tier)
    _, tout = trx.run_segment(trx.init_state(1), torch.from_numpy(iq)[None])
    skip, fs = 4 * cfg.audio_block, float(cfg.audio_fs)
    rails = {"jax": (np.asarray(jout.left)[skip:],
                     np.asarray(jout.right)[skip:]),
             "port": (tout.left[0, skip:].numpy(),
                      tout.right[0, skip:].numpy())}
    for name, (lft, rgt) in rails.items():
        sep_l = _band_power(lft, fs, 440) / _band_power(rgt, fs, 440)
        sep_r = _band_power(rgt, fs, 1200) / _band_power(lft, fs, 1200)
        assert sep_l > 20 and sep_r > 20, (name, sep_l, sep_r)
    for k in range(2):
        ref = rails["jax"][k].astype(np.float64)
        err = rails["port"][k] - ref
        assert 10 * np.log10(np.sum(ref ** 2) / np.sum(err ** 2)) > 40.0
