"""The port's wideband path against the JAX package's.

The same numpy rails (random, or ``synth.wideband_iq`` scenes) go through
the JAX channelizer, fused wideband frontend and channel bank, and through
their ports; on the CPU the port's kernel wrappers run their plain
versions. Captures run at 9.6 MS/s (4 x the mode-0 station rate) with 2-4
stations and 1-2 blocks.

Bounds:
- channelizer basebands > 110 dB (per-op LTI parity, f32 vs f32 in
  another summation order) in the static-fold, runtime-tone-fold, general
  and mix-then-filter forms; ``call_u8`` within 1 LSB on < 1 % of bytes
  (the two matmuls sum in different orders, which may move a value across
  a quantization boundary); carried tails equal within f32 rounding, pos
  equal;
- fused demod > 80 dB (the JAX package's bound against its float64
  oracle), split-vs-single continuity > 100 dB on the JAX package's own
  continuity input; on other seeds the same frontend cast to float64
  agrees split-vs-single to > 240 dB (a correct boundary), and each f32
  run stays > 80 dB from it, so the f32 split-vs-single gap (> 76 dB) is
  rounding inside each run; retune exact;
- the bank on the JAX channelizer's u8: audio > 60 dB (the chain gate),
  RDS bits equal from a carried state;
- ``ChannelBank.step`` / ``run`` (block entries) against JAX's on 2
  channels x 2 blocks from a carried state: audio > 60 dB, RDS bits equal,
  outputs stacked on a leading block axis;
- the whole slice, port only: PS/PI exact and tones within 10 Hz on both
  wideband paths.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import mk_channelizer
from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.parallel.channel import ChannelBank as JBank
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.channelizer import \
    Channelizer as _Channelizer
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend as _FusedWidebandFrontend
from real_time_sdr_tpu_torch.models.wideband_frontend import (
    make_wideband_frontend, u8_to_rails)
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils import synth as tsynth
from real_time_sdr_tpu_torch.utils.state import (state_from_numpy,
                                                 state_to_numpy)

# every test here runs on the CPU: the receiver's and the wideband
# frontends' own default is the card
Receiver = functools.partial(_Receiver, device="cpu")
Channelizer = functools.partial(_Channelizer, device="cpu")
FusedWidebandFrontend = functools.partial(_FusedWidebandFrontend,
                                          device="cpu")

CFG = mode_config(0)        # the port's
JCFG = jmode_config(0)      # the JAX package's
WIDE_FS = 4 * CFG.rf_fs                                    # 9.6 MS/s
RASTER4 = [-450_000, -150_000, 150_000, 450_000]           # 300 kHz raster


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _rails(seed, n, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32) * scale,
            rng.standard_normal(n).astype(np.float32) * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_u8_close(a, b):
    diff = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(
        np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 0.01, (diff != 0).mean()


def _decode(bits, n_bits):
    fr = RdsFramer()
    for b in range(bits.shape[0]):
        fr.feed(bits[b][:n_bits[b]])
    return fr.events


def _tone(x, fs):
    x = np.asarray(x, np.float64)
    x = x[len(x) // 3:]
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    return np.fft.rfftfreq(len(x), 1 / fs)[sp.argmax()]


# -- channelizer -----------------------------------------------------------

FORMS = {
    # name: (offsets, fold, expected port mode)
    "static_fold": (RASTER4, True, "static"),
    "runtime_fold": ([10_000, 300_000], True, "runtime"),  # lo = 480 > 32
    "general": ([7, 300_000], True, "general"),              # no period
    "mix": (RASTER4, False, "mix"),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_channelizer_matches_jax(form):
    """3 chained half-block segments: basebands > 110 dB, call_u8 within
    1 LSB, tails and pos equal; the JAX state after segment 2 converts and
    resumes in the port for segment 3."""
    offs, fold, mode = FORMS[form]
    jch = mk_channelizer(JCFG, WIDE_FS, offs, fold=fold and mode != "general")
    ch = Channelizer(CFG, WIDE_FS, offs, fold=fold)
    got_mode = ("general" if not ch.tone_period else "mix" if not ch.fold
                else "static" if ch.fold_static else "runtime")
    assert got_mode == mode
    assert ch.tone_period == jch.tone_period and ch.fold == jch.fold
    if ch.fold:
        assert ch.fold_static == jch._fold_static
        assert (ch.fold_R, ch.fold_J, ch.fold_L) == (
            jch._fold_R, jch._fold_J, jch._fold_L)
        np.testing.assert_array_equal(ch.fold_W.numpy(), jch._fold_W)
    n = CFG.block_size_iq * ch.decim // 2
    iw, qw = _rails(sum(map(ord, form)), 3 * n)
    js = jch.init_state()
    ps = ch.init_state()
    for k in range(3):
        seg = slice(k * n, (k + 1) * n)
        xi, xq = jnp.asarray(iw[seg]), jnp.asarray(qw[seg])
        (ji, jq), js_new = jch(xi, xq, js)
        ju8, _ = jch.call_u8(xi, xq, js)
        (ti, tq), ps_new = ch(_t(iw[seg]), _t(qw[seg]), ps)
        tu8, ps_u8 = ch.call_u8(_t(iw[seg]), _t(qw[seg]), ps)
        assert ti.shape == ji.shape == (len(offs), n // ch.decim)
        for a, b in ((ji, ti), (jq, tq)):
            assert _snr(a, b) > 110.0, (form, k, _snr(a, b))
        assert tu8.dtype == torch.uint8 and tu8.shape == ju8.shape
        _assert_u8_close(ju8, tu8)
        np.testing.assert_allclose(ps_new.i_tails.numpy(),
                                   np.asarray(js_new.i_tails), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ps_new.q_tails.numpy(),
                                   np.asarray(js_new.q_tails), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ps_new.ph_re.numpy(),
                                   np.asarray(js_new.ph_re), atol=1e-6)
        assert ps_new.pos.dtype == torch.int32 and ps_new.pos.ndim == 0
        assert int(ps_new.pos) == int(js_new.pos)
        for a, b in zip(ps_u8, ps_new):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        if k == 1:
            resumed = state_from_numpy(
                jax.tree_util.tree_map(np.asarray, js_new), "cpu")
            assert type(resumed).__name__ == "ChannelizerState"
        js, ps = js_new, ps_new
    seg = slice(2 * n, 3 * n)
    (ri, rq), _ = ch(_t(iw[seg]), _t(qw[seg]), resumed)
    assert _snr(ji, ri) > 110.0 and _snr(jq, rq) > 110.0


def test_channelizer_rejects_bad_input():
    with pytest.raises(ValueError):
        Channelizer(CFG, WIDE_FS + 1, RASTER4)
    ch = Channelizer(CFG, WIDE_FS, RASTER4)
    x = torch.zeros(CFG.block_size_iq * ch.decim + 1)
    with pytest.raises(ValueError):
        ch(x, x, ch.init_state())
    with pytest.raises(TypeError):
        ch(x.double(), x.double(), ch.init_state())


# -- fused wideband frontend ------------------------------------------------

def test_fused_frontend_matches_jax():
    """Demod > 80 dB against JAX f32 on the same noise input, over two
    chained segments (the second from the converted JAX state too); the
    weights are the JAX package's bit for bit."""
    offs = [-1_700_000, 800_000, 2_300_000]       # 100 kHz raster
    jwf = JFused(JCFG, WIDE_FS, offs, compute_dtype="f32")
    wf = FusedWidebandFrontend(CFG, WIDE_FS, offs)
    assert (wf.lo, wf.r_n, wf.j_w, wf.k_eq) == (jwf.lo, jwf.r_n, jwf.j_w,
                                                jwf.k_eq)
    np.testing.assert_array_equal(wf.w.numpy(), jwf._w)
    np.testing.assert_array_equal(wf.pc.numpy(), jwf._pc_np)
    n = CFG.block_size_iq * wf.decim
    iw, qw = _rails(11, 2 * n)
    js, ps = jwf.init_state(), wf.init_state()
    for k in range(2):
        seg = slice(k * n, (k + 1) * n)
        jd, js_new = jwf(jnp.asarray(iw[seg]), jnp.asarray(qw[seg]), js)
        td, ps = wf(_t(iw[seg]), _t(qw[seg]), ps)
        assert td.shape == jd.shape == (3, n // wf.dt)
        for s in range(3):
            assert _snr(jd[s], td[s]) > 80.0, (k, s, _snr(jd[s], td[s]))
        assert int(ps.pos) == int(js_new.pos)
        np.testing.assert_array_equal(ps.i_tail.numpy(),
                                      np.asarray(js_new.i_tail))
        if k == 0:
            resumed = state_from_numpy(
                jax.tree_util.tree_map(np.asarray, js_new), "cpu")
        js = js_new
    td2, _ = wf(_t(iw[n:]), _t(qw[n:]), resumed)
    assert _snr(jd, td2) > 80.0


def test_fused_segment_continuity():
    """Two chained segments equal one double-length call (> 100 dB): the
    raw-rail tail, the carried discriminator samples and the residual
    rotation line up across the boundary. The input is the JAX package's
    own continuity test input (noise: the discriminator's num/den is
    ill-conditioned where the envelope dips, so the bound is
    input-specific; the matmul's summation order changes with the frame
    count)."""
    offs = [-1_300_000, 2_300_000]
    wf = FusedWidebandFrontend(CFG, WIDE_FS, offs)
    assert (CFG.block_size_iq // CFG.rf_decim) % wf.lo != 0
    n = 2 * CFG.block_size_iq * wf.decim
    iw, qw = (_t(a) for a in _rails(17, n))
    full, _ = wf(iw, qw, wf.init_state())
    st, parts = wf.init_state(), []
    for seg in (slice(0, n // 2), slice(n // 2, n)):
        d, st = wf(iw[seg], qw[seg], st)
        parts.append(d)
    assert _snr(full, torch.cat(parts, -1)) > 100.0


def _split_and_single(wf, iw, qw):
    full, _ = wf(iw, qw, wf.init_state())
    st, parts = wf.init_state(), []
    for a, b in zip(iw.tensor_split(2), qw.tensor_split(2)):
        d, st = wf(a, b, st)
        parts.append(d)
    return full, torch.cat(parts, -1)


@pytest.mark.parametrize("seed", [1, 3, 4, 7])
def test_fused_segment_continuity_float64_witness(seed):
    """The split-vs-single gap of the f32 fused demod is rounding, not the
    boundary: the same frontend cast to float64 (weights, rails, state)
    agrees split-vs-single to > 240 dB (seeds 1-7 read 262-280 dB on the
    CPU), and both f32 runs stay > 80 dB from the float64 result (read
    84.9-107 dB; JAX f32 reads 84.0-107.1 dB). The f32 split-vs-single
    bound, 76 dB, sits below the lowest reading (80.5 dB at seed 4; JAX
    92-115 dB on the same inputs)."""
    offs = [-1_300_000, 2_300_000]
    wf = FusedWidebandFrontend(CFG, WIDE_FS, offs)
    wf64 = FusedWidebandFrontend(CFG, WIDE_FS, offs).double()
    iw, qw = (_t(a) for a in _rails(seed, 2 * CFG.block_size_iq * wf.decim))
    full64, split64 = _split_and_single(wf64, iw.double(), qw.double())
    assert full64.dtype == torch.float64
    assert _snr(full64, split64) > 240.0
    full, split = _split_and_single(wf, iw, qw)
    assert _snr(full, split) > 76.0
    assert _snr(full64, full) > 80.0 and _snr(full64, split) > 80.0


GRIDS = [[-300_000, 100_000], [7], [10_000, 300_000], RASTER4,
         [int((k - 31.5) * 300_000) for k in range(64)]]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_fused_eligibility_matches_jax(grid):
    offs = GRIDS[grid]
    for wide_fs in (WIDE_FS, 8 * CFG.rf_fs):
        assert (_FusedWidebandFrontend.output_lcm(
            wide_fs, CFG.rf_fs, CFG.rf_decim, offs) == JFused.output_lcm(
            wide_fs, CFG.rf_fs, CFG.rf_decim, offs))
        ok = _FusedWidebandFrontend.eligible(CFG, wide_fs, offs)
        assert ok == JFused.eligible(JCFG, wide_fs, offs)
    assert _FusedWidebandFrontend.eligible(CFG, WIDE_FS, [-300_000, 100_000])
    assert not _FusedWidebandFrontend.eligible(CFG, WIDE_FS, [7])
    if not _FusedWidebandFrontend.eligible(CFG, WIDE_FS, offs):
        with pytest.raises(ValueError):
            FusedWidebandFrontend(CFG, WIDE_FS, offs)
        assert isinstance(make_wideband_frontend(CFG, WIDE_FS, offs,
                                                 device="cpu"), _Channelizer)


def test_wideband_frontends_default_to_the_card():
    """Both wideband frontends build on the card when no device is named:
    without one they raise RuntimeError (nothing gives way to the CPU);
    ``device="cpu"`` builds every buffer on the CPU."""
    for cls in (_Channelizer, _FusedWidebandFrontend):
        if torch.cuda.is_available():
            fe = cls(CFG, WIDE_FS, RASTER4)
            assert {b.device.type for b in fe.buffers()} == {"cuda"}
        else:
            with pytest.raises(RuntimeError):
                cls(CFG, WIDE_FS, RASTER4)
        fe = cls(CFG, WIDE_FS, RASTER4, device="cpu")
        assert {b.device.type for b in fe.buffers()} == {"cpu"}
        assert {t.device.type for t in fe.init_state()
                if isinstance(t, torch.Tensor)} == {"cpu"}


def test_fused_precision_and_dtype_errors():
    """The precisions JAX accepts build (f32 by default, TF32 off; bf16
    weights at bf16, [hi ; lo] at bf16x2, their rows zero-padded to a
    multiple of 8; the tables f32); an unknown name raises ValueError (JAX
    asserts); rails are float32 at every precision, so float64 rails raise
    TypeError."""
    wf = FusedWidebandFrontend(CFG, WIDE_FS, RASTER4)
    assert wf.compute_dtype == "f32"
    assert {wf.w.dtype, wf.pc.dtype, wf.ps.dtype} == {torch.float32}
    assert not torch.backends.cuda.matmul.allow_tf32
    for dtype, wdt, rows in (("f32", torch.float32, 2),
                             ("bf16", torch.bfloat16, 2),
                             ("bf16x2", torch.bfloat16, 4)):
        fe = FusedWidebandFrontend(CFG, WIDE_FS, RASTER4, compute_dtype=dtype)
        k = rows * fe.j_w
        assert fe.w.dtype == wdt and fe.w.shape[0] == (
            k if dtype == "f32" else -(-k // 8) * 8)
        assert {fe.pc.dtype, fe.ps.dtype} == {torch.float32}
        x = torch.zeros(CFG.block_size_iq * wf.decim, dtype=torch.float64)
        with pytest.raises(TypeError):
            fe(x, x, fe.init_state())
    for dtype in ("f16", "bf32", "F32", None):
        with pytest.raises(ValueError):
            FusedWidebandFrontend(CFG, WIDE_FS, RASTER4, compute_dtype=dtype)
    with pytest.raises(ValueError):
        Channelizer(CFG, WIDE_FS, RASTER4, compute_dtype="bf16x2")
    with pytest.raises(ValueError):
        FusedWidebandFrontend(CFG, WIDE_FS + 1, RASTER4)


def test_retune_roundtrip_and_fresh_construction():
    """Retune away and back restores the weight and rotation buffers
    exactly; a retune rewrites only the station's columns; any retune
    sequence equals a fresh construction; off-raster offsets are rejected
    with the grid intact."""
    wf = FusedWidebandFrontend(CFG, WIDE_FS, [-600_000, 800_000])
    w0, pc0, ps0 = wf.w.clone(), wf.pc.clone(), wf.ps.clone()
    wf.retune(1, 1_200_000)
    assert not torch.equal(wf.w, w0)
    moved = (wf.w != w0).any(0).nonzero().flatten() % (2 * 2)
    assert set(moved.tolist()) <= {1, 3}            # station 1's columns
    torch.testing.assert_close(wf.pc[:, 0], pc0[:, 0], rtol=0, atol=0)
    wf.retune(1, 800_000)
    for a, b in ((wf.w, w0), (wf.pc, pc0), (wf.ps, ps0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        wf.retune(1, 12_345)
    with pytest.raises(ValueError):
        wf.retune(2, 800_000)
    assert wf.offsets == [-600_000, 800_000]

    rng = np.random.default_rng(21)
    wide_fs = 8 * CFG.rf_fs
    offs = sorted(int(x) * 100_000 for x in
                  rng.choice(np.arange(-80, 81), size=6, replace=False))
    wf = FusedWidebandFrontend(CFG, wide_fs, offs)
    for _ in range(5):
        try:
            wf.retune(int(rng.integers(0, len(offs))),
                      int(rng.integers(-80, 81)) * 100_000)
        except ValueError:
            continue
    fresh = FusedWidebandFrontend(CFG, wide_fs, wf.offsets)
    for a, b in ((wf.w, fresh.w), (wf.pc, fresh.pc), (wf.ps, fresh.ps)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- bank entries -----------------------------------------------------------

@pytest.fixture(scope="module")
def rx():
    return Receiver(0, stereo=True, rds=True, pll_tier=3)


def test_run_channelized_equals_two_step(rx):
    """ChannelBank.run_channelized == call_u8 + run_segment, bit for bit."""
    ch = Channelizer(CFG, WIDE_FS, RASTER4)
    bank = ChannelBank(rx, 4)
    iw, qw = (_t(a) for a in _rails(13, CFG.block_size_iq * ch.decim, 0.2))
    bs_a, out_a, cs_a = bank.run_channelized(bank.init_state(), ch, iw, qw,
                                             ch.init_state())
    u8, cs_b = ch.call_u8(iw, qw, ch.init_state())
    bs_b, out_b = bank.run_segment(bank.init_state(), u8)
    for a, b in zip(jax.tree_util.tree_leaves((out_a, bs_a, cs_a)),
                    jax.tree_util.tree_leaves((out_b, bs_b, cs_b))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        bank.run_segment(bank.init_state(), u8[:3])


def test_wideband_u8_equals_rails(rx):
    """run_wideband_u8 on raw bytes == run_wideband on the u8_to_rails
    rails, both frontends, two chained segments; anything else is refused
    as a frontend."""
    offs = [-1_700_000, 800_000]
    n = 2 * CFG.block_size_iq * (WIDE_FS // CFG.rf_fs)
    raw = np.random.default_rng(31).integers(0, 256, 2 * n).astype(np.uint8)
    iw, qw = u8_to_rails(_t(raw))
    x = (raw.astype(np.float32) - 128.0) / 128.0
    np.testing.assert_array_equal(iw.numpy(), x[0::2])
    np.testing.assert_array_equal(qw.numpy(), x[1::2])
    wf = FusedWidebandFrontend(CFG, WIDE_FS, offs)
    for fe in (wf, Channelizer(CFG, WIDE_FS, offs)):
        bank = ChannelBank(rx, 2)
        sa, ba = fe.init_state(), bank.init_state()
        sb, bb = fe.init_state(), bank.init_state()
        for k in range(2):
            s2 = slice(k * n // 2, (k + 1) * n // 2)
            s2b = slice(k * n, (k + 1) * n)
            ba, out_a, sa = bank.run_wideband(ba, fe, iw[s2], qw[s2], sa)
            bb, out_b, sb = bank.run_wideband_u8(bb, fe, _t(raw[s2b]), sb)
            for a, b in zip(jax.tree_util.tree_leaves((out_a, sa)),
                            jax.tree_util.tree_leaves((out_b, sb))):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, out_c, _ = bank.run_wideband_u8(bank.init_state(), wf, _t(raw[:n]),
                                       wf.init_state())
    assert out_c.left.shape == (2, CFG.audio_block)
    with pytest.raises(TypeError, match="not a wideband frontend"):
        bank.run_wideband_u8(bank.init_state(), rx, _t(raw[:n]),
                             wf.init_state())


def test_bank_on_jax_channelizer_u8_matches_jax_bank(rx):
    """The JAX channelizer's u8 (4 stations, 8 blocks) through the JAX
    ChannelBank and, from the JAX bank state after 6 blocks, through the
    port's bank: audio > 60 dB and RDS bits equal on blocks 7-8."""
    scene = [dict(offset_hz=o, ps_name=f"BANK-{k}  ", pi=0x4A00 + k, pty=k,
                  tone_left=500.0 + 100 * k, tone_right=1300.0)
             for k, o in enumerate(RASTER4)]
    iw, qw, _ = jsynth.wideband_iq(JCFG, WIDE_FS, scene, 8)
    jch = mk_channelizer(JCFG, WIDE_FS, RASTER4, fold=True)
    u8, _ = jch.call_u8(jnp.asarray(iw), jnp.asarray(qw), jch.init_state())
    u8 = np.asarray(u8)
    cut = 6 * 2 * CFG.block_size_iq
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    jbank = JBank(jrx, 4)
    jst, _ = jbank.run_segment(jbank.init_state(), jnp.asarray(u8[:, :cut]))
    _, jout = jbank.run_segment(jst, jnp.asarray(u8[:, cut:]))
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                             "cpu")
    _, out = ChannelBank(rx, 4).run_segment(state, _t(u8[:, cut:]))
    for s in range(4):
        assert _snr(jout.left[s], out.left[s]) > 60.0
        assert _snr(jout.right[s], out.right[s]) > 60.0
    assert int(np.asarray(jout.rds_nbits).sum()) > 0
    np.testing.assert_array_equal(out.rds_nbits.numpy(),
                                  np.asarray(jout.rds_nbits))
    np.testing.assert_array_equal(out.rds_bits.numpy(),
                                  np.asarray(jout.rds_bits))


def test_bank_step_and_run_match_jax_bank(rx):
    """ChannelBank.step (one block per channel) and run ((B, C, n) blocks)
    against the JAX bank's, 2 channels: both carry on from the JAX bank's
    state after 6 blocks; 2 more blocks agree to > 60 dB (the chain gate)
    with the RDS bits equal, outputs on a leading B axis as JAX's scan
    gives them, and run == two steps bit for bit."""
    iq = np.stack([jsynth.station_iq(JCFG, 8, ps_name=f"STEP-{k}  ",
                                     pi=0x5100 + k,
                                     tone_left=500.0 + 300 * k)[0]
                   for k in range(2)])
    blk = 2 * CFG.block_size_iq
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    jbank = JBank(jrx, 2)
    jst, _ = jbank.run_segment(jbank.init_state(),
                               jnp.asarray(iq[:, :6 * blk]))
    blocks = np.ascontiguousarray(
        iq[:, 6 * blk:].reshape(2, 2, blk).transpose(1, 0, 2))   # (B, C, n)
    _, jout = jbank.run(jst, jnp.asarray(blocks))
    bank = ChannelBank(rx, 2)
    state0 = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                             "cpu")
    placed = bank.place(blocks)
    assert placed.device == rx.device and placed.dtype == torch.uint8
    st_run, out = bank.run(state0, placed)
    assert out.left.shape == (2, 2, CFG.audio_block)
    assert out.rds_bits.shape == (2, 2, CFG.max_bits)
    assert out.rds_nbits.shape == (2, 2)
    for rail in ("left", "right"):
        assert _snr(getattr(jout, rail), getattr(out, rail)) > 60.0
    assert int(np.asarray(jout.rds_nbits).sum()) > 0
    np.testing.assert_array_equal(out.rds_nbits.numpy(),
                                  np.asarray(jout.rds_nbits))
    np.testing.assert_array_equal(out.rds_bits.numpy(),
                                  np.asarray(jout.rds_bits))
    st = state0
    for b in range(2):
        st, o = bank.step(st, placed[b])
        torch.testing.assert_close(o.left, out.left[b], rtol=0, atol=0)
        torch.testing.assert_close(o.rds_bits, out.rds_bits[b], rtol=0,
                                   atol=0)
    for a, c in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(st_run)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError):
        bank.step(state0, placed[0][:1])
    with pytest.raises(ValueError):
        bank.run(state0, placed[0])


# -- the slice as a whole -----------------------------------------------------

STATIONS = [
    dict(offset_hz=-1_700_000, ps_name="STATION1", pi=0x1111, pty=5,
         tone_left=440.0, tone_right=440.0),
    dict(offset_hz=2_300_000, ps_name="STATION2", pi=0x2222, pty=9,
         tone_left=900.0, tone_right=900.0),
]


@pytest.fixture(scope="module")
def scene():
    return tsynth.wideband_iq(CFG, WIDE_FS, STATIONS, 30)


@pytest.mark.parametrize("path", ["fused", "two_stage"])
def test_slice_decodes_both_stations(rx, scene, path):
    """30 blocks in 6-block segments through ChannelBank: PS/PI exact and
    each station's tone within 10 Hz."""
    iw, qw, truths = scene
    offs = [s["offset_hz"] for s in STATIONS]
    fe = (make_wideband_frontend(CFG, WIDE_FS, offs, device="cpu")
          if path == "fused"
          else Channelizer(CFG, WIDE_FS, offs))
    assert isinstance(fe, _FusedWidebandFrontend) == (path == "fused")
    bank = ChannelBank(rx, 2)
    bs, fs_ = bank.init_state(), fe.init_state()
    seg = 6 * CFG.block_size_iq * fe.decim
    left, bits, nbits = [], [], []
    for s0 in range(0, len(iw), seg):
        bs, out, fs_ = bank.run_wideband(bs, fe, _t(iw[s0:s0 + seg]),
                                         _t(qw[s0:s0 + seg]), fs_)
        left.append(out.left)
        bits.append(out.rds_bits)
        nbits.append(out.rds_nbits)
    left = torch.cat(left, -1).numpy()
    bits = torch.cat(bits, 1).numpy()
    nbits = torch.cat(nbits, 1).numpy()
    for s, truth in enumerate(truths):
        assert abs(_tone(left[s], float(CFG.audio_fs))
                   - STATIONS[s]["tone_left"]) < 10
        ev = _decode(bits[s], nbits[s])
        assert ev.ps_name == truth["ps_name"], (path, s, ev.ps_name)
        assert ev.pi == truth["pi"]


# -- copies and the jax-free rule ---------------------------------------------

def test_wideband_iq_copy_identical():
    st = [dict(offset_hz=-600_000, ps_name="COPY-A  ", amp=2.0),
          dict(offset_hz=900_000, ps_name="COPY-B  ", tone_left=700.0)]
    a = jsynth.wideband_iq(JCFG, WIDE_FS, st, 2)
    b = tsynth.wideband_iq(CFG, WIDE_FS, st, 2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert [t["bits"] for t in a[2]] == [t["bits"] for t in b[2]]


def test_wideband_states_round_trip():
    """Both wideband states convert to numpy and back unchanged; leaves
    have no channel axis."""
    wf = FusedWidebandFrontend(CFG, WIDE_FS, RASTER4)
    ch = Channelizer(CFG, WIDE_FS, RASTER4)
    for st in (wf.init_state(), ch.init_state()):
        back = state_from_numpy(state_to_numpy(st), "cpu")
        assert type(back) is type(st)
        assert back.pos.ndim == 0 and back.pos.dtype == torch.int32
        for a, b in zip(st, back):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
