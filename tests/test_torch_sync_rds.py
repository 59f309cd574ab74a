"""Port carrier sync and RDS slicer against the JAX package.

FeedforwardSync: the same pilot through both, over 3 chained calls. The
carriers agree within 1e-3 max abs, not exactly: the residual unwrap sums
in another order (torch.cumsum vs the JAX package's matmul prefix sum) and
atan2/cos differ by a few ulps between the two libraries.

decode_segment_bits / decode_block_bits: bit-exact (bits, counts and every
state leaf) on identical numpy ``clean`` inputs, with channels batched in
the port and one JAX call per channel.

Tracked CDR: cdr_tracked against JAX over chained blocks, symbols and
counts equal, soft values and the timing carry within 5e-5 absolute on
values of order 1 (measured up to 2.6e-5: the comb energy sums in another
order than XLA's reduction, and the parabolic peak fit divides two small
differences of those sums); decode_block_bits_tracked bit-exact; the
batched call equal to per-channel calls; and a capture whose RDS symbol
clock runs 100 ppm off decodes its PS name through the tracked receiver.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu import config as C
from real_time_sdr_tpu.config import mode_config
from real_time_sdr_tpu.ops import rds_bits as jbits
from real_time_sdr_tpu.ops.pll import PllParams as JPllParams
from real_time_sdr_tpu.ops.sync import FeedforwardSync as JSync
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.ops import rds_bits as tbits
from real_time_sdr_tpu_torch.ops.pll import PllParams
from real_time_sdr_tpu_torch.ops.sync import FeedforwardSync
from real_time_sdr_tpu_torch.utils import synth

CFG = mode_config(0)
SPS, L = CFG.sps, CFG.rds_block
MAX_SYM, MAX_BITS = CFG.max_symbols, CFG.max_bits
N_CH = 3

SYNC_CASES = {
    # name: (freq, nco_scale, norm_bw, smooth_taps, offset Hz)
    "stereo": (int(C.PILOT_FREQ), 2.0, C.PLL_BW_STEREO, 65, 12.0),
    "rds": (int(C.RDS_PILOT_FREQ), 0.5, C.PLL_BW_RDS, 129, -7.0),
}


@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_feedforward_sync_matches_jax(name):
    freq, scale, bw, smooth, off = SYNC_CASES[name]
    fs = CFG.if_fs
    jp = JPllParams(freq=freq, fs=fs, nco_scale=scale, norm_bw=bw)
    tp = PllParams(freq=freq, fs=fs, nco_scale=scale)
    js = JSync(jp, smooth_taps=smooth)
    ts = FeedforwardSync(tp, smooth_taps=smooth)
    np.testing.assert_array_equal(ts.bank.taps.numpy(), np.stack(
        [js.cr_fir._h, js.ci_fir._h]).astype(np.float32))
    rng = np.random.default_rng(freq)
    n = 2 * CFG.if_block
    t = np.arange(3 * n) / fs
    phases = np.array([0.3, 2.0])[:, None]
    x = (np.cos(2 * np.pi * (freq + off) * t + phases)
         + 0.05 * rng.standard_normal((2, 3 * n))).astype(np.float32)
    carry_t = ts.init(2)
    carry_j = [js.init() for _ in range(2)]
    for k in range(3):
        blk = x[:, k * n:(k + 1) * n]
        ct, carry_t = ts(torch.from_numpy(blk), carry_t)
        for c in range(2):
            cj, carry_j[c] = js(jnp.asarray(blk[c]), carry_j[c], jp)
            assert np.max(np.abs(ct[c].numpy() - np.asarray(cj))) < 1e-3
            assert int(carry_t.trig[c]) == int(carry_j[c].trig)
            np.testing.assert_array_equal(carry_t.in_tail[c].numpy(),
                                          np.asarray(carry_j[c].in_tail))
            dr = float(carry_t.resid[c]) - float(carry_j[c].resid)
            assert abs(dr - 4 * np.pi * round(dr / (4 * np.pi))) < 1e-3
    assert carry_t.trig.dtype == torch.int32


def _random_state(rng, first):
    """(C,) numpy leaves of a BitSyncState."""
    return jbits.BitSyncState(
        first=np.full(N_CH, first),
        start=rng.integers(0, 2, N_CH).astype(np.int32),
        half_symbol=rng.integers(0, 2, N_CH).astype(np.int32),
        last_bit=rng.integers(0, 2, N_CH).astype(np.int32))


def _to_torch(state):
    return tbits.BitSyncState(*(torch.from_numpy(np.asarray(a))
                                for a in state))


_jax_segment = jax.jit(jbits.decode_segment_bits, static_argnums=(3, 4, 5))


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("block_count", [0, 3, 5, 6, 20])
def test_decode_segment_bits_bit_exact(block_count, first):
    """C=3 batch == 3 single-channel JAX calls, bit for bit."""
    rng = np.random.default_rng(100 * block_count + first)
    nb = 12
    clean = rng.standard_normal((N_CH, nb, L)).astype(np.float32)
    state = _random_state(rng, first)
    counts = np.full(N_CH, block_count, np.int32)
    bits, n_bits, new = tbits.decode_segment_bits(
        torch.from_numpy(clean), _to_torch(state), torch.from_numpy(counts),
        SPS, MAX_SYM, MAX_BITS)
    assert bits.shape == (N_CH, nb, MAX_BITS) and bits.dtype == torch.int32
    for c in range(N_CH):
        st_c = jbits.BitSyncState(*(jnp.asarray(a[c]) for a in state))
        jb, jn, jst = _jax_segment(jnp.asarray(clean[c]), st_c,
                                   jnp.int32(block_count), SPS, MAX_SYM,
                                   MAX_BITS)
        np.testing.assert_array_equal(bits[c].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(n_bits[c].numpy(), np.asarray(jn))
        for a, b in zip(new, jst):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a[c].numpy(), np.asarray(b))


def test_decode_block_bits_bit_exact():
    """The one-block path (no warm-up gate) over 4 chained blocks."""
    rng = np.random.default_rng(9)
    state = _random_state(rng, True)
    jstates = [jbits.BitSyncState(*(jnp.asarray(a[c]) for a in state))
               for c in range(N_CH)]
    tstate = _to_torch(state)
    for _ in range(4):
        clean = rng.standard_normal((N_CH, L)).astype(np.float32)
        bits, n_bits, tstate = tbits.decode_block_bits(
            torch.from_numpy(clean), tstate, SPS, MAX_SYM, MAX_BITS)
        for c in range(N_CH):
            jb, jn, jstates[c] = jbits.decode_block_bits(
                jnp.asarray(clean[c]), jstates[c], SPS, MAX_SYM, MAX_BITS)
            np.testing.assert_array_equal(bits[c].numpy(), np.asarray(jb))
            assert int(n_bits[c]) == int(jn)
            for a, b in zip(tstate, jstates[c]):
                np.testing.assert_array_equal(a[c].numpy(), np.asarray(b))
    offs = tbits.cdr_offset(torch.from_numpy(clean), SPS)
    np.testing.assert_array_equal(
        offs.numpy(), np.asarray(jbits.cdr_offset(jnp.asarray(clean), SPS)))


def _rds_like(rng, n_ch, n_blocks, sps=SPS, length=L):
    """Symbol-rate +-1 levels plus noise: the comb has a clear peak, as an
    RRC output does."""
    n_sym = n_blocks * length // sps + 2
    levels = np.repeat(rng.choice([-1.0, 1.0], (n_ch, n_sym)), sps, axis=1)
    sig = levels[:, 3:3 + n_blocks * length]
    sig = sig + 0.2 * rng.standard_normal(sig.shape)
    return sig.reshape(n_ch, n_blocks, length).astype(np.float32)


def test_cdr_tracked_matches_jax():
    rng = np.random.default_rng(21)
    clean = _rds_like(rng, N_CH, 4)
    track = tbits.timing_init(N_CH)
    jtracks = [jbits.timing_init() for _ in range(N_CH)]
    for b in range(4):
        sym, soft, n_sym, track = tbits.cdr_tracked(
            torch.from_numpy(clean[:, b]), track, SPS, MAX_SYM)
        assert sym.dtype == n_sym.dtype == torch.int32
        for c in range(N_CH):
            js, jsoft, jn, jtracks[c] = jbits.cdr_tracked(
                jnp.asarray(clean[c, b]), jtracks[c], SPS, MAX_SYM)
            np.testing.assert_array_equal(sym[c].numpy(), np.asarray(js))
            assert int(n_sym[c]) == int(jn)
            np.testing.assert_allclose(soft[c].numpy(), np.asarray(jsoft),
                                       rtol=0, atol=5e-5)
            for a, j in zip(track, jtracks[c]):
                assert a[c].numpy().dtype == np.asarray(j).dtype
                np.testing.assert_allclose(a[c].numpy(), np.asarray(j),
                                           rtol=0, atol=5e-5)


def test_cdr_tracked_batched_matches_per_channel():
    """The interpolating gather indexes per channel row (the flattening
    fault the JAX package's comment names reads every channel's symbols
    from channel 0's samples)."""
    rng = np.random.default_rng(11)
    sps, length, n_ch = 10, 200, 3
    sig = torch.from_numpy(rng.standard_normal((n_ch, length)).astype(
        np.float32))
    b_sym, b_soft, b_n, b_track = tbits.cdr_tracked(
        sig, tbits.timing_init(n_ch), sps, max_symbols=length // sps + 1)
    for c in range(n_ch):
        s_sym, s_soft, s_n, s_track = tbits.cdr_tracked(
            sig[c:c + 1], tbits.timing_init(1), sps,
            max_symbols=length // sps + 1)
        assert torch.equal(b_sym[c], s_sym[0])
        assert torch.equal(b_soft[c], s_soft[0])
        assert int(b_n[c]) == int(s_n[0])
        for a, s1 in zip(b_track, s_track):
            assert torch.equal(a[c], s1[0])


def test_decode_block_bits_tracked_bit_exact():
    rng = np.random.default_rng(5)
    clean = _rds_like(rng, N_CH, 4)
    state = _random_state(rng, True)
    tstate, track = _to_torch(state), tbits.timing_init(N_CH)
    jst = [jbits.BitSyncState(*(jnp.asarray(a[c]) for a in state))
           for c in range(N_CH)]
    jtr = [jbits.timing_init() for _ in range(N_CH)]
    for b in range(4):
        bits, n_bits, tstate, track = tbits.decode_block_bits_tracked(
            torch.from_numpy(clean[:, b]), tstate, track, SPS, MAX_SYM,
            MAX_BITS)
        for c in range(N_CH):
            jb, jn, jst[c], jtr[c] = jbits.decode_block_bits_tracked(
                jnp.asarray(clean[c, b]), jst[c], jtr[c], SPS, MAX_SYM,
                MAX_BITS)
            np.testing.assert_array_equal(bits[c].numpy(), np.asarray(jb))
            assert int(n_bits[c]) == int(jn)
            for a, j in zip(tstate, jst[c]):
                np.testing.assert_array_equal(a[c].numpy(), np.asarray(j))


@pytest.mark.parametrize("ppm", [100.0, -100.0])
def test_tracked_receiver_decodes_clock_ppm(ppm):
    """A transmitter whose RDS symbol clock runs +-100 ppm off: the tracked
    CDR locks and decodes the PS name and PI."""
    nb = 30
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3,
                  rds_timing="tracked", device="cpu")
    iq, _ = synth.station_iq(rx.cfg, nb, ps_name="PPM-TRAK", pi=0x2468,
                             pty=5, rds_clock_ppm=ppm)
    state, out = rx.run_segment(rx.init_state(1), torch.from_numpy(iq)[None])
    assert state.rds.track is not None
    assert int(state.rds.track.locked[0]) == 1
    fr = RdsFramer()
    for b in range(nb):
        fr.feed(out.rds_bits[0, b, :out.rds_nbits[0, b]].numpy())
    assert fr.events.ps_name == "PPM-TRAK"
    assert fr.events.pi == 0x2468
