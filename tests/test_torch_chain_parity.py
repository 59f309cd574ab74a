"""Chain parity of the port against the float64 oracle ``golden/chain.py``
and the tier-3 quality gates, on the CPU: the twins of
``tests/test_chain_golden_parity.py``, ``tests/test_golden_chain.py`` and
``tests/test_tier3_sync.py`` through the port's modules with
``device="cpu"`` (the kernel wrappers take their plain versions there).

Bounds are the JAX package's: per block with carried state, mono > 60 dB,
stereo left and the RDS-clean stream > 40 dB after the PLL's acquisition
block; tier 3: stereo separation > 30 (power ratio) with PS/PI decoded,
its carrier correlated > 0.95 with the tier-1 loop's after lock, block
and segment calls within 5e-2 after the first block, and both tiers
locked (the right-only tone >= 10 dB separated to the end) by block 2.
The tier-1 loop's plain version is a per-sample loop (~0.4 s per mode-0
block per loop), so its cases run 3 blocks; the acquisition case runs 3
blocks too (the JAX package's 12 at tier 1 would take ~5 s), where both
tiers lock at block 0.
"""

import functools

import numpy as np
import torch

from golden.chain import run_stages
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.models.rds import RdsPath
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.ops.cuda import pll_scan_kernel
from real_time_sdr_tpu_torch.ops.pll import PllParams, pll_init
from real_time_sdr_tpu_torch.ops.sync import FeedforwardSync
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.viz import snr_db

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

CFG = mode_config(0)
BLK = 2 * CFG.block_size_iq


def _blocks(rx, iq, n_blocks):
    """Per-block ``step`` outputs of one channel, carried state."""
    state, outs = rx.init_state(1), []
    for b in range(n_blocks):
        state, out = rx.step(state, torch.from_numpy(
            iq[None, b * BLK:(b + 1) * BLK]))
        outs.append(out)
    return outs


def _per_block(arr, block):
    return np.asarray(arr).reshape(-1, block)


def test_mono_chain_matches_golden_blocks():
    rx = Receiver(0, stereo=False, rds=False)
    iq, _ = synth.station_iq(CFG, 3, tone_left=700.0, tone_right=700.0)
    gold = _per_block(run_stages(CFG, iq, stereo=False, rds=False)["mono"],
                      CFG.audio_block)
    for b, out in enumerate(_blocks(rx, iq, 3)):
        assert snr_db(gold[b], out.mono[0].numpy()) > 60, f"block {b}"


def test_stereo_chain_matches_golden_blocks():
    rx = Receiver(0, stereo=True, rds=False, pll_tier=1)
    iq, _ = synth.station_iq(CFG, 3, tone_left=500.0, tone_right=1500.0)
    gold = _per_block(run_stages(CFG, iq, stereo=True, rds=False)["left"],
                      CFG.audio_block)
    for b, out in enumerate(_blocks(rx, iq, 3)):
        if b > 0:            # skip the acquisition-transient block
            assert snr_db(gold[b], out.left[0].numpy()) > 40, f"block {b}"


def test_rds_chain_clean_matches_golden_blocks():
    """Frontend + RdsPath on their own, to expose ``clean``."""
    iq, _ = synth.station_iq(CFG, 3)
    gold = _per_block(run_stages(CFG, iq, stereo=False, rds=True)[
        "rds_clean"], CFG.rds_block)
    fe, rp = Frontend(CFG), RdsPath(CFG, pll_tier=1)
    fs_, rs_ = fe.init_state(1), rp.init_state(1)
    with torch.no_grad():
        for b in range(3):
            demod, fs_ = fe(torch.from_numpy(iq[None, b * BLK:(b + 1) * BLK]),
                            fs_)
            (_, _, clean), rs_ = rp(demod, rs_)
            if b > 0:
                assert snr_db(gold[b], clean[0].numpy()) > 40, f"block {b}"


def test_run_stages_rates_and_device_parity():
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1)
    iq, _ = synth.station_iq(CFG, 3, ps_name="CHAINTST")
    gold = run_stages(CFG, iq)
    assert set(gold) == {"demod", "pilot", "carrier", "left", "right",
                         "rds_band", "rds_mixed", "rds_clean"}
    assert len(gold["demod"]) == 3 * CFG.if_block
    assert len(gold["left"]) == 3 * CFG.audio_block
    assert len(gold["rds_clean"]) == 3 * CFG.rds_block
    outs = _blocks(rx, iq, 3)
    left = np.concatenate([o.left[0].numpy() for o in outs])
    clean = np.concatenate([o.rds_clean[0].numpy() for o in outs])
    # skip the PLL acquisition block, then the oracle and the port agree
    assert snr_db(gold["left"][CFG.audio_block:],
                  left[CFG.audio_block:]) > 40
    assert snr_db(gold["rds_clean"][CFG.rds_block:],
                  clean[CFG.rds_block:]) > 40


def test_run_stages_mono_only():
    rx = Receiver(0, stereo=False, rds=False)
    iq, _ = synth.station_iq(CFG, 2)
    gold = run_stages(CFG, iq, stereo=False, rds=False)
    assert set(gold) == {"demod", "mono"}
    assert len(gold["mono"]) == 2 * CFG.audio_block
    mono = np.concatenate([o.mono[0].numpy() for o in _blocks(rx, iq, 2)])
    assert snr_db(gold["mono"], mono) > 60


def _band_power(x, fs, f, width=30.0):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    return sp[(freqs > f - width) & (freqs < f + width)].sum()


def test_tier3_stereo_and_rds_e2e():
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    iq, _ = synth.station_iq(CFG, 30, ps_name="TIER3FF ", pi=0x1357, pty=6,
                             tone_left=440.0, tone_right=1200.0)
    _, out = rx.run_segment(rx.init_state(1), torch.from_numpy(iq[None]))
    skip = 3 * CFG.audio_block
    left, right = out.left[0, skip:].numpy(), out.right[0, skip:].numpy()
    fs = float(CFG.audio_fs)
    assert _band_power(left, fs, 440) / _band_power(right, fs, 440) > 30
    assert _band_power(right, fs, 1200) / _band_power(left, fs, 1200) > 30
    framer = RdsFramer()
    bits, nb = out.rds_bits[0].numpy(), out.rds_nbits[0].numpy()
    for b in range(bits.shape[0]):
        if nb[b] > 0:
            framer.feed(bits[b][:nb[b]])
    assert framer.events.ps_name == "TIER3FF "
    assert framer.events.pi == 0x1357


PILOT = PllParams(freq=19_000, fs=240_000, nco_scale=2.0, norm_bw=0.01)


def test_tier3_carrier_tracks_pll():
    """Locked comparison on an offset, noisy pilot: the tier-1 loop (the
    kernel wrapper's plain version) against the feedforward synchronizer,
    block by block."""
    rng = np.random.default_rng(5)
    n = 6 * 7350
    t = np.arange(n) / PILOT.fs
    x = (np.cos(2 * np.pi * (PILOT.freq + 30) * t + 0.7)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    sync = FeedforwardSync(PILOT)
    carry1, carry3 = pll_init(1), sync.init(1)
    outs1, outs3 = [], []
    with torch.no_grad():
        for s in range(0, n, 7350):
            blk = torch.from_numpy(x[None, s:s + 7350])
            c1, carry1 = pll_scan_kernel(blk, carry1, PILOT)
            c3, carry3 = sync(blk, carry3)
            outs1.append(c1[0].numpy())
            outs3.append(c3[0].numpy())
    a = np.concatenate(outs1)[2 * 7350:]
    b = np.concatenate(outs3)[2 * 7350:]
    assert np.corrcoef(a, b)[0, 1] > 0.95


def test_tier3_block_vs_segment_consistency():
    n = 4 * 7350
    t = np.arange(n) / PILOT.fs
    x = np.cos(2 * np.pi * (PILOT.freq + 12) * t + 0.2).astype(np.float32)
    sync = FeedforwardSync(PILOT)
    with torch.no_grad():
        ca, parts = sync.init(1), []
        for s in range(0, n, 7350):
            out, ca = sync(torch.from_numpy(x[None, s:s + 7350]), ca)
            parts.append(out[0].numpy())
        segment, _ = sync(torch.from_numpy(x[None]), sync.init(1))
    np.testing.assert_allclose(np.concatenate(parts)[7350:],
                               segment[0, 7350:].numpy(), atol=5e-2)


def _blocks_to_lock(rx, out, nb, thresh_db=10.0, tone_r=1500.0):
    """First block from which the right-only tone stays >= thresh_db
    separated to the segment's end."""
    ab, fs = CFG.audio_block, float(CFG.audio_fs)
    seps = []
    for b in range(nb):
        l_ = out.left[0, b * ab:(b + 1) * ab].numpy()
        r_ = out.right[0, b * ab:(b + 1) * ab].numpy()
        seps.append(10 * np.log10(_band_power(r_, fs, tone_r)
                                  / (_band_power(l_, fs, tone_r) + 1e-30)))
    for b in range(nb):
        if all(s >= thresh_db for s in seps[b:]):
            return b
    return nb


def test_tier3_acquisition_blocks_to_lock():
    nb = 3
    iq, _ = synth.station_iq(CFG, nb, tone_left=500.0, tone_right=1500.0)
    locks = {}
    for tier in (1, 3):
        rx = Receiver(0, stereo=True, rds=False, pll_tier=tier)
        _, out = rx.run_segment(rx.init_state(1), torch.from_numpy(iq[None]))
        locks[tier] = _blocks_to_lock(rx, out, nb)
    assert locks[1] <= 2, f"tier-1 lock at block {locks[1]}"
    assert locks[3] <= 2, f"tier-3 lock at block {locks[3]}"
    assert locks[3] <= locks[1] + 1, f"tier-3 {locks[3]} vs tier-1 {locks[1]}"
