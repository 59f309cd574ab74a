"""Modes 1-3 and carrier tiers 1-2 of the port's receiver against the JAX
package's receiver.

- Modes 1-3 x types m/s/r at tier 3, 8 blocks of one synthetic station:
  audio > 60 dB (the chain gate; measured ~130 dB), RDS bits and counts
  equal. The JAX side runs its Pallas frontend in interpret mode, whose
  exact (x - 128) arithmetic the port shares (the cold-start RDS carrier
  sign, ROADMAP Queue 3). JAX builds the tier-3 sync with ``derive2`` at
  modes 1-3 (double-angle tables derived on device, ~1e-7 apart from the
  exact tables the port uses); that stays far inside both bounds.
- Segment mode equals block mode at the fractional modes 2-3 (tier 1):
  audio > 110 dB after the first block, RDS bits identical, as
  tests/test_segment_mode.py holds the JAX package.
- Tiers 1 and 2 at mode 0, types s and r: audio > 60 dB against JAX, RDS
  bits equal.
- ``run_blocks`` equals chained ``step`` calls exactly, and the default
  carrier tier is 1, as in the JAX package.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.ops.pll import PllCarry
from real_time_sdr_tpu_torch.ops.sync import FeedforwardSync, PllLoop

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

N_BLOCKS = 8


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _kinds(kind):
    return dict(stereo=kind in "sr", rds=kind == "r")


def _compare(mode, kind, tier, n_blocks=N_BLOCKS):
    jrx = JReceiver(mode, pll_tier=tier, frontend_impl="pallas_interpret",
                    **_kinds(kind))
    iq, _ = jsynth.station_iq(jrx.cfg, n_blocks, ps_name=f"MODE-{mode}{kind} ")
    _, jo = jax.jit(jrx.run_segment)(jrx.init_state(), jnp.asarray(iq))
    rx = Receiver(mode, pll_tier=tier, **_kinds(kind))
    _, out = rx.run_segment(rx.init_state(1), torch.from_numpy(iq)[None])
    n_audio = n_blocks * rx.cfg.audio_block
    rails = (("mono",) if kind == "m" else ("left", "right"))
    for rail in rails:
        got = getattr(out, rail)
        assert got.shape == (1, n_audio)
        assert _snr(getattr(jo, rail), got[0]) > 60.0
    if kind == "r":
        np.testing.assert_array_equal(out.rds_nbits[0].numpy(),
                                      np.asarray(jo.rds_nbits))
        np.testing.assert_array_equal(out.rds_bits[0].numpy(),
                                      np.asarray(jo.rds_bits))
        assert out.rds_nbits[0, -1] > 0
    else:
        assert out.rds_bits is None


@pytest.mark.parametrize("kind", ["m", "s", "r"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_modes_match_jax(mode, kind):
    _compare(mode, kind, tier=3)


@pytest.mark.parametrize("kind", ["s", "r"])
@pytest.mark.parametrize("tier", [1, 2])
def test_tiers_match_jax(tier, kind):
    _compare(0, kind, tier)


@pytest.mark.parametrize("mode", [2, 3])
def test_segment_equals_blocks_fractional(mode):
    """One 8-block segment vs 8 one-block calls at tier 1: the per-block
    resampler output count is an exact integer at modes 2-3, so the two
    orders agree to f32 rounding (tier 1 wraps its phase once per call)."""
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=1)
    cfg = rx.cfg
    assert (cfg.if_block * cfg.audio_up) % cfg.audio_down == 0
    iq, _ = jsynth.station_iq(jmode_config(mode), N_BLOCKS,
                              ps_name="SEGDEV  ")
    x = torch.from_numpy(iq)[None]
    _, seg = rx.run_segment(rx.init_state(1), x)
    _, blk = rx.run_blocks(rx.init_state(1), x.reshape(1, N_BLOCKS, -1))
    ab = cfg.audio_block
    la, lb = blk.left.reshape(-1).numpy(), seg.left[0].numpy()
    assert la.shape == lb.shape
    assert _snr(la[ab:], lb[ab:]) > 110.0
    assert torch.equal(blk.rds_bits, seg.rds_bits)
    assert torch.equal(blk.rds_nbits, seg.rds_nbits)
    assert int(seg.rds_nbits[0, -1]) > 0


def test_run_blocks_equals_chained_steps():
    rx = Receiver(1, stereo=True, rds=True, pll_tier=3)
    iq, _ = jsynth.station_iq(jmode_config(1), 3)
    x = torch.from_numpy(np.stack([iq, np.roll(iq, 4096)]))   # 2 channels
    blocks = x.reshape(2, 3, -1)
    st_b, out_b = rx.run_blocks(rx.init_state(2), blocks)
    st = rx.init_state(2)
    for b in range(3):
        st, out = rx.step(st, blocks[:, b])
        for name in ("left", "right", "rds_bits", "rds_nbits", "rds_clean"):
            assert torch.equal(getattr(out_b, name)[:, b], getattr(out, name))
    assert out_b.left.shape == (2, 3, rx.cfg.audio_block)
    assert out_b.mono is None
    for a, b in zip(jax.tree_util.tree_leaves(st_b),
                    jax.tree_util.tree_leaves(st)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        rx.run_blocks(rx.init_state(2), x)


def test_default_carrier_tier_is_exact_loop():
    """Receiver's default tier is 1, the JAX package's and the CLI's."""
    assert JReceiver(0, stereo=True, rds=True).audio._sync is None
    rx = Receiver(0, stereo=True, rds=True)
    assert rx.pll_tier == 1
    for sync in (rx.audio.sync, rx.rds_path.sync):
        assert isinstance(sync, PllLoop) and sync.tier == 1
    state = rx.init_state(2)
    assert isinstance(state.audio.pll, PllCarry)
    assert isinstance(state.rds.pll, PllCarry)
    assert state.audio.pll.trig.dtype == torch.int32
    assert isinstance(Receiver(0, stereo=True, pll_tier=3).audio.sync,
                      FeedforwardSync)
    with pytest.raises(ValueError):
        Receiver(0, pll_tier=4)
