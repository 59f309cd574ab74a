"""The port's wideband precision forms against the JAX package's, on the
CPU: ``compute_dtype`` "bf16" / "bf16x2" of the fused wideband frontend,
"bf16" of the channelizer (fold product and mix-then-filter) and of
``PolyFIR`` / ``FIRBank``, their ``cost()``, retune, station shards,
checkpoints and the CLI's ``--wb-fir``; and ``ops.demod.fm_demod_arctan``.

The JAX side takes its precision as its tests do: the keyword of
``FusedWidebandFrontend`` and ``PolyFIR``, ``RTSDR_CHAN_FIR`` for the
channelizer, ``RTSDR_WB_FIR`` for the CLI (set with ``monkeypatch``).

Bounds:
- port against JAX at the same precision > 110 dB (measured on the CPU:
  fused 130.8-131.1 dB, channelizer 134.9-136.1 dB, the FIRs
  138.6-141.1 dB):
  both round to bf16 by round-to-nearest-even, every product of two bf16
  values is exact in f32 and the sums run in f32, in other orders;
- the port's bf16 against its own f32: fused > 35 dB (bf16) and > 45 dB
  (bf16x2), the JAX package's bounds (measured 61.9 and 66.9 dB; bf16x2
  still rounds the rails to bf16); channelizer > 45 dB (measured 52.3-52.4
  dB); split-vs-single continuity > 100 dB (the JAX package's bound);
- demod, basebands and every state leaf f32 / int32, carried tails equal
  to JAX's within f32 rounding; ``call_u8`` bit-identical to ``to_uint8``
  of the basebands; retune and shards exact;
- the CLI's per-station PCM > 60 dB against the JAX CLI's, RDS lines
  equal (the f32 CLI test's bounds).
"""

import contextlib
import functools
import io
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import mk_channelizer
from golden import dsp
from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.ops.demod import fm_demod_arctan as j_arctan
from real_time_sdr_tpu.ops.fir import PolyFIR as JPolyFIR
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.channelizer import \
    Channelizer as _Channelizer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend as _Fused
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    make_wideband_frontend
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.ops.demod import fm_demod_arctan
from real_time_sdr_tpu_torch.ops.fir import (DecimatingFIR, PolyFIR,
                                             make_bank)
from real_time_sdr_tpu_torch.parallel.channel import gather
from real_time_sdr_tpu_torch.parallel.wideband import (ShardedFusedWideband,
                                                       ShardedWideband)
from real_time_sdr_tpu_torch.utils import logging as tlog
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.state import load_state, save_state

# every test here runs on the CPU: the modules' own default is the card
Channelizer = functools.partial(_Channelizer, device="cpu")
Fused = functools.partial(_Fused, device="cpu")
Receiver = functools.partial(_Receiver, device="cpu")

CFG = mode_config(0)
JCFG = jmode_config(0)
WIDE_FS = 4 * CFG.rf_fs                                  # 9.6 MS/s
OFFS2 = [-1_700_000, 800_000]        # tests/test_wideband_fused.py's pair
RASTER4 = [-450_000, -150_000, 150_000, 450_000]
PORT_VS_JAX_DB = 110.0


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf_dtypes(state):
    return {x.dtype for x in state}


@pytest.fixture(scope="module")
def fm_pair():
    """The input of the JAX package's ``test_fused_bf16_parity_and_dtypes``:
    two FM stations at -1.7 and +0.8 MHz in 9.6 MS/s, 3 blocks (a real
    multiplex: on noise the discriminator's envelope passes near zero and
    the comparison is ill-conditioned)."""
    stations = [dict(offset_hz=o, ps_name="PARITY-T", pi=0x1234, pty=1,
                     tone_left=700.0, tone_right=700.0) for o in OFFS2]
    iw, qw, _ = jsynth.wideband_iq(JCFG, WIDE_FS, stations, 3)
    return iw, qw


@pytest.fixture(scope="module")
def fused_f32(fm_pair):
    wf = Fused(CFG, WIDE_FS, OFFS2)
    return wf(_t(fm_pair[0]), _t(fm_pair[1]), wf.init_state())[0]


@pytest.mark.parametrize("dtype, own_db", [("bf16", 35.0), ("bf16x2", 45.0)])
def test_fused_precision_matches_jax(fm_pair, fused_f32, dtype, own_db):
    iw, qw = fm_pair
    jwf = JFused(JCFG, WIDE_FS, OFFS2, compute_dtype=dtype)
    jd, _ = jwf(jnp.asarray(iw), jnp.asarray(qw), jwf.init_state())
    wf = Fused(CFG, WIDE_FS, OFFS2, compute_dtype=dtype)
    assert wf.compute_dtype == dtype and wf.w.dtype == torch.bfloat16
    # K rows: [hi] or [hi ; lo], zero-padded to a multiple of 8 (16-byte
    # rows for the card's GEMM)
    rows = (4 if dtype == "bf16x2" else 2) * wf.j_w
    assert wf.w.shape[0] == -(-rows // 8) * 8 and not wf.w[rows:].any()
    d, st = wf(_t(iw), _t(qw), wf.init_state())
    assert d.dtype == torch.float32
    assert _leaf_dtypes(st) <= {torch.float32, torch.int32}
    assert _snr(np.asarray(jd), d) > PORT_VS_JAX_DB
    assert _snr(fused_f32, d) > own_db
    # two chained segments against one long one
    half = len(iw) // 2
    st = wf.init_state()
    parts = []
    for sl in (slice(0, half), slice(half, None)):
        p, st = wf(_t(iw[sl]), _t(qw[sl]), st)
        parts.append(p)
    assert _snr(d, torch.cat(parts, -1)) > 100.0


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "mix"])
def test_channelizer_bf16_matches_jax(fold, monkeypatch):
    """Two segments of random rails (the JAX package's
    ``test_bf16_channelizer_fir_parity``), both channelizer forms."""
    offs = [-1_000_000, 1_500_000]
    monkeypatch.setenv("RTSDR_CHAN_FIR", "bf16")
    jch = mk_channelizer(JCFG, WIDE_FS, offs, fold)
    monkeypatch.delenv("RTSDR_CHAN_FIR")
    assert jch.fir.compute_dtype == "bf16"
    ch = Channelizer(CFG, WIDE_FS, offs, fold=fold, compute_dtype="bf16")
    ch32 = Channelizer(CFG, WIDE_FS, offs, fold=fold)
    assert ch.fir.compute_dtype == "bf16" and ch.fold == fold
    if fold:
        assert ch.fold_W.dtype == torch.bfloat16
        assert ch32.fold_W.dtype == torch.float32
    rng = np.random.default_rng(9)
    n = 2 * CFG.block_size_iq * ch.decim
    iw = (rng.standard_normal(n) * 0.3).astype(np.float32)
    qw = (rng.standard_normal(n) * 0.3).astype(np.float32)
    js, st, s32 = jch.init_state(), ch.init_state(), ch32.init_state()
    for sl in (slice(0, n // 2), slice(n // 2, n)):
        (ji, jq), js = jch(jnp.asarray(iw[sl]), jnp.asarray(qw[sl]), js)
        u8, _ = ch.call_u8(_t(iw[sl]), _t(qw[sl]), st)
        (i_, q_), st = ch(_t(iw[sl]), _t(qw[sl]), st)
        (i32, q32), s32 = ch32(_t(iw[sl]), _t(qw[sl]), s32)
        assert i_.dtype == q_.dtype == torch.float32
        for mine, jref, ref32 in ((i_, ji, i32), (q_, jq, q32)):
            assert _snr(np.asarray(jref), mine) > PORT_VS_JAX_DB
            assert _snr(ref32, mine) > 45.0
        assert torch.equal(u8, ch.to_uint8(i_, q_))
        assert _leaf_dtypes(st) <= {torch.float32, torch.int32}
        for mine, jref in ((st.i_tails, js.i_tails), (st.q_tails,
                                                       js.q_tails)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(jref),
                                       rtol=0, atol=1e-6)
        assert int(st.pos) == int(js.pos)


@pytest.mark.parametrize("up, down, taps", [(1, 8, 97), (1, 5, 101),
                                            (3, 10, 151)])
def test_polyfir_bf16_matches_jax(up, down, taps):
    """PolyFIR(compute_dtype="bf16") and its FIR bank against the JAX
    PolyFIR at bf16 over two blocks with the carried tail: > 110 dB, the
    tails (bf16-rounded input, as JAX carries it) equal."""
    h = filters.design_lpf(CFG.rf_fs, 100_000, taps)
    fir = PolyFIR(h, up=up, down=down, compute_dtype="bf16")
    jfir = JPolyFIR(h, up=up, down=down, compute_dtype="bf16")
    bank = make_bank([fir])
    rng = np.random.default_rng(up * 100 + down)
    x = (rng.standard_normal((3, 2 * 2000)) * 0.4).astype(np.float32)
    tail = torch.zeros((3, fir.tail_len))
    btail, jtail = tail, jnp.zeros((3, fir.tail_len), jnp.float32)
    for k in range(2):
        xb = x[:, k * 2000:(k + 1) * 2000]
        y, tail = fir(_t(xb), tail)
        (yb,), btail = bank(_t(xb), btail)
        jy, jtail = jfir(jnp.asarray(xb), jtail)
        assert _snr(np.asarray(jy), y) > PORT_VS_JAX_DB
        assert _snr(y, yb) > PORT_VS_JAX_DB
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
        torch.testing.assert_close(btail, tail, rtol=0, atol=0)
    assert tail.dtype == torch.float32
    with pytest.raises(ValueError, match="single-tap"):
        PolyFIR(np.array([0.0, 1.0, 0.0]), compute_dtype="bf16")
    with pytest.raises(ValueError, match="compute_dtype"):
        PolyFIR(h, compute_dtype="bf16x2")
    with pytest.raises(ValueError):
        DecimatingFIR(PolyFIR(h, down=5, compute_dtype="bf16"))
    with pytest.raises(ValueError, match="one compute_dtype"):
        make_bank([fir, PolyFIR(h, up=up, down=down)])


@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16x2"])
def test_cost_matches_jax(dtype):
    """The fused frontend's cost is the JAX package's count at every
    precision (kind, flops, bytes, w_bytes; dims too, save bf16x2's K,
    which the port launches as one product of depth 4J); the roofline
    holds a bf16 kind against the bf16 peak. PolyFIR's count is the
    port's function count (2 x outputs x nonzero taps, ``ops/fir.py``):
    its kind is JAX's, and bf16 halves the bytes of the input, its tail
    and the taps."""
    offs = RASTER4
    n = CFG.block_size_iq * 4 * 3
    got = Fused(CFG, WIDE_FS, offs, compute_dtype=dtype).cost(n)
    want = JFused(JCFG, WIDE_FS, offs, compute_dtype=dtype).cost(n)
    for key in ("kind", "flops", "bytes", "w_bytes"):
        assert got[key] == want[key], key
    c, k, m = want["dims"]
    assert got["dims"] == (c, (2 if dtype == "bf16x2" else 1) * k, m)
    peak = tlog.H100_F32_FLOPS if dtype == "f32" else tlog.H100_BF16_FLOPS
    assert tlog.peak_flops(got["kind"])[0] == peak
    ms, by = tlog.roofline_ms(0, got["flops"], got["kind"])
    assert by == "operations" and math.isclose(ms, got["flops"] / peak * 1e3)

    fdt = "f32" if dtype == "bf16x2" else dtype
    h = filters.design_lpf(WIDE_FS, CFG.rf_fs / 2 * 0.8, 2 * CFG.rf_taps + 1)
    fir, fir32 = PolyFIR(h, down=4, compute_dtype=fdt), PolyFIR(h, down=4)
    c_, c32 = fir.cost(n), fir32.cost(n)
    assert c_["kind"] == JPolyFIR(h, down=4, compute_dtype=fdt).cost(n)[
        "kind"] == f"fir_{fdt}"
    el = 2 if fdt == "bf16" else 4
    assert c_["flops"] == c32["flops"]
    assert c_["w_bytes"] == el * len(h)
    assert c_["bytes"] == el * (n + fir.tail_len + len(h)) + 4 * (n // 4)
    assert make_bank([fir, fir]).cost(n)["kind"] == (
        f"fir_{fdt}_x2shared")
    ch = Channelizer(CFG, WIDE_FS, offs, compute_dtype=fdt)
    fc = ch.fold_cost(n)
    rows, cols = 2 * ch.fold_J, ch.fold_R * 2 * len(offs)
    frames = -(-(n // ch.decim) // ch.fold_R)
    assert fc["kind"] == f"chan_fold_{fdt}"
    assert fc["flops"] == 2 * frames * rows * cols
    assert fc["bytes"] == (2 * el * (n + ch.fold_tail) + el * rows * cols
                           + 4 * frames * cols)


def test_roofline_report_names_its_peak():
    out = io.StringIO()
    tlog.speed_of_light_report(Receiver(0), file=out)
    rows = [ln for ln in out.getvalue().splitlines() if " us  [" in ln]
    assert rows and all("f32 peak]" in ln for ln in rows)
    assert "989 TFLOP/s bf16" in out.getvalue()
    assert tlog.peak_flops("fir_bf16")[1] == "bf16"
    assert tlog.peak_flops("fir_f32_x2shared")[1] == "f32"


@pytest.mark.parametrize("dtype", ["bf16", "bf16x2"])
def test_retune_at_precision(dtype):
    """A retune away and back restores every buffer exactly, and any
    retune sequence equals a fresh construction: the bf16 (and bf16x2 lo)
    columns are rebuilt from the host's f32 columns."""
    wf = Fused(CFG, WIDE_FS, [-600_000, 800_000], compute_dtype=dtype)
    w0, pc0, ps0 = wf.w.clone(), wf.pc.clone(), wf.ps.clone()
    wf.retune(1, 1_200_000)
    assert not torch.equal(wf.w, w0)
    assert wf.w.dtype == torch.bfloat16 and wf.pc.dtype == torch.float32
    wf.retune(1, 800_000)
    for a, b in ((wf.w, w0), (wf.pc, pc0), (wf.ps, ps0)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(21)
    wide_fs = 8 * CFG.rf_fs
    offs = sorted(int(x) * 100_000 for x in
                  rng.choice(np.arange(-80, 81), size=6, replace=False))
    wf = Fused(CFG, wide_fs, offs, compute_dtype=dtype)
    for _ in range(5):
        try:
            wf.retune(int(rng.integers(0, len(offs))),
                      int(rng.integers(-80, 81)) * 100_000)
        except ValueError:
            continue
    fresh = Fused(CFG, wide_fs, wf.offsets, compute_dtype=dtype)
    for a, b in ((wf.w, fresh.w), (wf.pc, fresh.pc), (wf.ps, fresh.ps)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no float64 form"):
        wf.double()


@pytest.fixture(scope="module")
def scene4():
    stations = [dict(offset_hz=o, ps_name=f"PREC-{k}  "[:8], pi=0x6C00 + k,
                     pty=2, tone_left=500.0 + 100 * k, tone_right=1300.0)
                for k, o in enumerate(RASTER4)]
    iw, qw, _ = synth.wideband_iq(CFG, WIDE_FS, stations, 2)
    return iw, qw


@pytest.mark.parametrize("dtype", ["bf16", "bf16x2"])
def test_sharded_fused_at_precision(scene4, dtype):
    """ShardedFusedWideband on two CPU replicas keeps the precision in each
    shard: each shard's demod equals the unsharded frontend's rows, the
    bank outputs of a step match the unsharded frontend's run, and a
    retune on the second shard leaves the first shard's columns as they
    were."""
    iw, qw = (_t(a) for a in scene4)
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    wf = Fused(CFG, WIDE_FS, RASTER4, compute_dtype=dtype)
    sf = ShardedFusedWideband(wf, rx, devices=["cpu", "cpu"])
    assert [sh.compute_dtype for sh in sf.shards] == [dtype, dtype]
    whole, _ = wf(iw, qw, wf.init_state())
    for k, sh in enumerate(sf.shards):
        d, _ = sh(iw, qw, sh.init_state())
        assert _snr(whole[2 * k:2 * k + 2], d) > 120.0
    ws, bs = sf.init_state()
    ws, bs, out = sf.step(ws, bs, iw, qw)
    _, ref = rx.run_segment_demod(rx.init_state(4),
                                  wf(iw, qw, wf.init_state())[0])
    assert _snr(ref.left, gather(out).left) > 70.0
    w0 = sf.shards[0].w.clone()
    sf.retune(3, RASTER4[1])
    assert torch.equal(sf.shards[0].w, w0)
    assert sf.shards[1].w.dtype == torch.bfloat16


def test_sharded_two_stage_keeps_bf16(scene4):
    iw, qw = (_t(a) for a in scene4)
    rx = Receiver(0, stereo=False, rds=False, pll_tier=3)
    ch = Channelizer(CFG, WIDE_FS, RASTER4, compute_dtype="bf16")
    sw = ShardedWideband(ch, rx, devices=["cpu", "cpu"])
    assert [sh.compute_dtype for sh in sw.shards] == ["bf16", "bf16"]
    u8, _ = ch.call_u8(iw, qw, ch.init_state())
    parts = torch.cat([sh.call_u8(iw, qw, sh.init_state())[0]
                       for sh in sw.shards])
    diff = (u8.int() - parts.int()).abs()
    assert diff.max() <= 1 and (diff != 0).float().mean() < 0.01


@pytest.mark.parametrize("dtype", ["bf16", "bf16x2"])
def test_bf16_frontend_loads_f32_checkpoint(scene4, dtype, tmp_path):
    """The state is f32 at every precision: an f32 frontend's checkpoint
    loads into a bf16 frontend and continues as the carried state does."""
    iw, qw = (_t(a) for a in scene4)
    half = iw.shape[0] // 2
    wf32 = Fused(CFG, WIDE_FS, RASTER4)
    _, st = wf32(iw[:half], qw[:half], wf32.init_state())
    save_state(str(tmp_path / "wb"), st)
    wf = make_wideband_frontend(CFG, WIDE_FS, RASTER4, compute_dtype=dtype,
                                device="cpu")
    assert isinstance(wf, _Fused) and wf.compute_dtype == dtype
    loaded = load_state(str(tmp_path / "wb"), wf.init_state())
    a, _ = wf(iw[half:], qw[half:], loaded)
    b, _ = wf(iw[half:], qw[half:], st)
    assert torch.equal(a, b)
    ch = make_wideband_frontend(CFG, WIDE_FS, [7, 300_000],
                                compute_dtype="bf16", device="cpu")
    assert isinstance(ch, _Channelizer) and ch.compute_dtype == "bf16"
    with pytest.raises(ValueError, match="computes in one of"):
        make_wideband_frontend(CFG, WIDE_FS, [7, 300_000],
                               compute_dtype="bf16x2", device="cpu")


def _wb_run(main, args, inp, outdir):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--cpu", *args, "--output-dir", str(outdir), "--input",
                   str(inp)])
    pcm = [np.fromfile(f, "<i2").astype(np.int32)
           for f in sorted(outdir.glob("station_*.pcm"),
                           key=lambda f: int(f.stem.split("_")[1]))]
    return rc, err.getvalue().splitlines(), pcm


def test_cli_wb_fir_bf16_matches_jax_cli(tmp_path, monkeypatch):
    """``--wb-fir bf16`` against the JAX CLI with RTSDR_WB_FIR=bf16 on two
    stations x 24 blocks at 9.6 MS/s (tier 3, ``--segment 12``): the same
    stderr lines, PCM > 60 dB."""
    stations = [dict(offset_hz=-2_000_000, ps_name="BF16-A  ", pi=0xA1A1,
                     pty=5),
                dict(offset_hz=1_500_000, ps_name="BF16-B  ", pi=0xB1B1,
                     pty=9)]
    iw, qw, _ = synth.wideband_iq(CFG, WIDE_FS, stations, 24)
    iq = np.empty(2 * len(iw))
    iq[0::2], iq[1::2] = iw, qw
    path = tmp_path / "wb.raw"
    np.clip(np.round(128 + 127 * iq), 0, 255).astype(np.uint8).tofile(path)
    args = ["0", "r", "--pll-tier", "3", "--stations=-2000000,1500000",
            "--wide-fs", str(WIDE_FS), "--segment", "12"]
    rc, lines, pcm = _wb_run(cli.main, args + ["--wb-fir", "bf16"], path,
                             tmp_path / "t")
    for var, val in (("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc")),
                     ("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1"),
                     ("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")):
        monkeypatch.setenv(var, val)
    from real_time_sdr_tpu import cli as jcli
    monkeypatch.setenv("RTSDR_WB_FIR", "bf16")
    jrc, jlines, jpcm = _wb_run(jcli.main, args, path, tmp_path / "j")
    assert rc == 0 and jrc == 0
    assert lines == jlines, (lines, jlines)
    assert "ch0 ps: BF16-A  " in lines and "ch1 ps: BF16-B  " in lines
    assert [len(p) for p in pcm] == [24 * CFG.audio_block * 2] * 2
    for a, b in zip(pcm, jpcm):
        assert a.shape == b.shape and _snr(b, a) > 60.0


def test_fm_demod_arctan_matches_jax_and_golden():
    """The JAX package's ``test_fm_demod_arctan_matches_golden``: per
    735-sample block with the carried angle, > 80 dB against the float64
    loop of ``golden/dsp.py``, and against the JAX function; a +-pi step
    stays as np.unwrap leaves it."""
    t = np.arange(7350) / 240e3
    msg = np.sin(2 * np.pi * 1000 * t)
    phase = np.cumsum(msg) * 2 * np.pi * 50e3 / 240e3
    i_all = np.cos(phase).astype(np.float32)
    q_all = np.sin(phase).astype(np.float32)
    gp, jp, tp = 0.0, jnp.zeros(()), torch.zeros(())
    for s in range(0, 7350, 735):
        i_b, q_b = i_all[s:s + 735], q_all[s:s + 735]
        g, gp = dsp.fm_demod_arctan_block(i_b, q_b, gp)
        jy, jp = j_arctan(jnp.asarray(i_b), jnp.asarray(q_b), jp)
        y, tp = fm_demod_arctan(_t(i_b), _t(q_b), tp)
        assert y.dtype == torch.float32 and tp.shape == ()
        assert _snr(g, y) > 80.0
        assert _snr(np.asarray(jy), y) > 120.0
    # batched rows, and the exact half-turn step
    y, last = fm_demod_arctan(torch.tensor([[1.0, -1.0]]),
                              torch.tensor([[0.0, 0.0]]), torch.zeros(1))
    assert y.shape == (1, 2) and float(y[0, 1]) == pytest.approx(math.pi)
    assert float(last[0]) == pytest.approx(math.pi)
