"""Port ops (real_time_sdr_tpu_torch.ops) against the JAX package's ops.

The same numpy inputs go through the JAX function and its port. On the CPU
the port's kernel wrappers run their plain versions; the JAX side runs both
its XLA path and its Pallas kernel in interpret mode, as the JAX package's
own tests do. Bounds: every FIR bank > 110 dB (per-op LTI parity, f32 vs
f32 in another summation order), the frontend > 65 dB (the JAX package's
interchange bound: its CPU frontend uses bf16 hi+lo split taps), the
channelizer epilogue byte-exact against the NumPy reference and within
1 LSB on < 1 % of bytes against the Pallas kernel (the JAX package's bound:
its kernel's rotation may contract to FMA), the direct-form decimating
FIR > 110 dB against the Pallas kernel and > 120 dB against the float64
direct form (f32 rounding of a K-term sum). The audio paths at modes 0 and
1, whose resampler is that FIR: the resampler op and ``MonoPath`` > 110 dB
against the JAX package's, ``StereoPath`` > 60 dB (the chain gate: it holds
the tier-3 carrier sync), carried tails equal within f32 rounding.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu import config as C
from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models import audio as jaudio_paths
from real_time_sdr_tpu.models.frontend import Frontend as JFrontend
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops import fir as jfir
from real_time_sdr_tpu.ops.demod import fm_demod as j_fm_demod
from real_time_sdr_tpu.ops.pallas import chan_epilogue as jepi
from real_time_sdr_tpu.ops.pallas.fir_kernels import \
    fir_decimate_planes as j_fir_decimate_planes
from real_time_sdr_tpu.ops.pallas.frontend_fused import FusedFrontendFIR
from real_time_sdr_tpu.ops.pallas.polyfir import FramedFIRBank
from real_time_sdr_tpu.ops.pll import PllParams as JPllParams
from real_time_sdr_tpu.ops.sync import FeedforwardSync as JSync
from real_time_sdr_tpu.utils import audio as jaudio
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models import audio as taudio_paths
from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.ops import fir as tfir
from real_time_sdr_tpu_torch.ops.cuda import (chan_epilogue, fir_bank,
                                              fir_decimate, frontend_fused)
from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import chan_epilogue_plain
from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (TILED_TILE,
                                                       fir_bank_plain,
                                                       kernel_body)
from real_time_sdr_tpu_torch.ops.cuda import fir_kernels
from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import (fir_decimate_planes,
                                                          fir_decimate_plain)
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import (SPAN, TILE,
                                                            frontend_plain,
                                                            frontend_planes)
from real_time_sdr_tpu_torch.ops.demod import fm_demod
from real_time_sdr_tpu_torch.utils import audio as taudio
from real_time_sdr_tpu_torch.utils.state import state_from_numpy

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

FS_IF = 240_000


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _sync_taps(smooth_taps):
    s = JSync(JPllParams(freq=19_000 if smooth_taps == 65 else 114_000,
                         fs=FS_IF), smooth_taps=smooth_taps)
    return [s.cr_fir._h, s.ci_fir._h]


# every FIR bank of the mode-0 slice: (taps list, up, down, batch, n)
BANKS = {
    "if_triple": (lambda: [filters.design_bpf(FS_IF, *b, 101) for b in
                           (C.PILOT_BAND, C.STEREO_BAND, C.RDS_BAND)],
                  1, 1, (2,), 7350),
    "audio_rails": (lambda: [filters.design_lpf(FS_IF, 16_000, 101)],
                    1, 5, (2, 2), 7350),
    "rds_baseband_247_640": (
        lambda: [filters.design_lpf(FS_IF * 247, 3e3, 101 * 247, gain=247)],
        247, 640, (2, 3), 7350),
    "rrc": (lambda: [filters.design_rrc(92625, 101, symbol_rate=2375,
                                        beta=0.9)], 1, 1, (2, 3), 2836),
    "sync_stereo": (lambda: _sync_taps(65), 1, 1, (2,), 7350),
    "sync_rds": (lambda: _sync_taps(129), 1, 1, (2,), 7350),
}


@pytest.mark.parametrize("name", sorted(BANKS))
def test_fir_bank_plain_matches_jax(name):
    """FIRBank (plain) against the JAX XLA path (shared_frames_apply or
    PolyFIR) and the Pallas bank (interpret), and each port PolyFIR against
    its JAX PolyFIR, tails carried over 3 calls."""
    make_taps, up, down, batch, n = BANKS[name]
    taps = make_taps()
    jfirs = [jfir.PolyFIR(h, up=up, down=down) for h in taps]
    tfirs = [tfir.PolyFIR(h, up=up, down=down) for h in taps]
    bank = tfir.make_bank(tfirs)
    pallas = FramedFIRBank(jfirs, interpret=True)
    rng = np.random.default_rng(sum(map(ord, name)))
    tl = jfirs[0].tail_len
    assert bank.tail_len == tl == tfirs[0].tail_len
    tail0 = rng.standard_normal(batch + (tl,)).astype(np.float32)
    t_bank = torch.from_numpy(tail0)
    t_poly = [t_bank] * len(tfirs)
    j_xla = j_pal = jnp.asarray(tail0)
    j_poly = [j_xla] * len(jfirs)
    for _ in range(3):
        x = rng.standard_normal(batch + (n,)).astype(np.float32)
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        ys, t_bank = bank(xt, t_bank)
        if len(jfirs) == 1:
            yj, j_xla = jfirs[0](xj, j_xla)
            yj = [yj]
        else:
            yj, j_xla = jfir.shared_frames_apply(jfirs, xj, j_xla)
        ypal, j_pal = pallas(xj, j_pal)
        for i, (a, b, d) in enumerate(zip(yj, ys, ypal)):
            assert b.shape == a.shape == d.shape
            assert _snr(a, b) > 110.0, (name, _snr(a, b))
            assert _snr(d, b) > 110.0, (name, _snr(d, b))
            yp, t_poly[i] = tfirs[i](xt, t_poly[i])
            ypj, j_poly[i] = jfirs[i](xj, j_poly[i])
            assert _snr(ypj, yp) > 110.0, (name, i, _snr(ypj, yp))
            np.testing.assert_array_equal(t_poly[i].numpy(),
                                          np.asarray(j_poly[i]))
        np.testing.assert_array_equal(t_bank.numpy(), np.asarray(j_xla))
        np.testing.assert_array_equal(np.asarray(j_pal), np.asarray(j_xla))


# (K, n): n at 1 and at the tiled kernel body's tile edges, K from 2 to 191
EDGES = [(2, 1), (101, TILED_TILE - 1), (127, TILED_TILE), (191, TILED_TILE + 1)]


@pytest.mark.parametrize("k_taps, n", EDGES)
@pytest.mark.parametrize("nf", [1, 2, 3, 4])
def test_fir_bank_plain_matches_direct_form(nf, k_taps, n):
    """The oracle of the card tests: the plain framed matmul at up = 1
    against y_f[n] = sum_m h_f[m] xx[n + K-1 - m] in float64 on the same
    f32 taps and input, > 120 dB (f32 rounding of a K-term sum)."""
    rng = np.random.default_rng(nf * 1000 + k_taps)
    h = rng.standard_normal((nf, k_taps)).astype(np.float32)
    bank = tfir.make_bank([tfir.PolyFIR(t) for t in h])
    xx = rng.standard_normal((2, k_taps - 1 + n)).astype(np.float32)
    got = fir_bank_plain(torch.from_numpy(xx), bank.w, bank.geometry).numpy()
    win = np.lib.stride_tricks.sliding_window_view(xx.astype(np.float64),
                                                   k_taps, axis=-1)
    ref = np.einsum("bnk,fk->bfn", win, h[:, ::-1].astype(np.float64))
    assert got.shape == ref.shape == (2, nf, n)
    assert _snr(ref, got) > 120.0, _snr(ref, got)


# every FIR site of the stereo + RDS receiver and the 64-station
# channelizer -> the kernel body its geometry takes (the mode-0 audio
# resampler is the direct-form decimating kernel, static body)
BODIES = {
    "if_bank": "tiled", "audio.pb_bank": "tiled",
    "audio.resamp_bank": "static", "audio.sync.bank": "tiled",
    "rds_path.band_bank": "tiled", "rds_path.pilot_bank": "tiled",
    "rds_path.baseband_bank": "general", "rds_path.rrc_bank": "tiled",
    "rds_path.sync.bank": "tiled", "channelizer.bank": "general",
}


@pytest.fixture(scope="module")
def fir_sites():
    """name -> FIRBank or DecimatingFIR over the receiver and the
    64-station channelizer."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    offs = [int((k - 31.5) * 300_000) for k in range(64)]
    ch = Channelizer(rx.cfg, 8 * rx.cfg.rf_fs, offs)
    return {**{n: m for n, m in rx.named_modules()
               if isinstance(m, (tfir.FIRBank, tfir.DecimatingFIR))},
            "channelizer.bank": ch.bank}


def test_fir_bank_sites_are_all_listed(fir_sites):
    assert set(fir_sites) == set(BODIES)


@pytest.mark.parametrize("site", sorted(BODIES))
def test_fir_bank_body_choice(fir_sites, site):
    """The geometry alone names the body: the FIR bank's tiled one at
    up == down == 1, the decimating FIR's static one at the audio sites."""
    m = fir_sites[site]
    body = (fir_kernels.kernel_body(m.num_taps, m.down)
            if isinstance(m, tfir.DecimatingFIR) else kernel_body(m.geometry))
    assert body == BODIES[site]


def test_apf_delay_slice_exact():
    """The single-tap all-pass delay lowers to a slice: bit-exact."""
    h = filters.design_apf(101)
    jf, tf = jfir.PolyFIR(h), tfir.PolyFIR(h)
    assert tf.single_tap
    rng = np.random.default_rng(3)
    tail = rng.standard_normal((2, tf.tail_len)).astype(np.float32)
    tj, tt = jnp.asarray(tail), torch.from_numpy(tail)
    for _ in range(2):
        x = rng.standard_normal((2, 7350)).astype(np.float32)
        yj, tj = jf(jnp.asarray(x), tj)
        yt, tt = tf(torch.from_numpy(x), tt)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    with pytest.raises(ValueError):
        tfir.make_bank([tf])


def test_fm_demod_matches_jax():
    rng = np.random.default_rng(5)
    ph = np.cumsum(rng.uniform(-2.0, 2.0, (3, 4000)), axis=-1)
    amp = rng.uniform(0.5, 1.5, (3, 4000))
    i_s = (amp * np.cos(ph)).astype(np.float32)
    q_s = (amp * np.sin(ph)).astype(np.float32)
    i_s[0, 10] = q_s[0, 10] = 0.0             # the zero guard
    pi = np.array([0.1, -0.5, 0.0], np.float32)
    pq = np.array([0.2, 0.0, -0.3], np.float32)
    dj, pij, pqj = j_fm_demod(*(jnp.asarray(a) for a in (i_s, q_s, pi, pq)))
    dt, pit, pqt = fm_demod(*(torch.from_numpy(a) for a in (i_s, q_s, pi, pq)))
    assert dt[0, 10] == 0.0
    assert np.allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    np.testing.assert_array_equal(pit.numpy(), np.asarray(pij))
    np.testing.assert_array_equal(pqt.numpy(), np.asarray(pqj))


@pytest.fixture(scope="module")
def frontend_case():
    cfg = jmode_config(0)
    iq, _ = jsynth.station_iq(cfg, 2, ps_name="FRONTEND")
    rng = np.random.default_rng(11)
    iq2 = rng.integers(0, 256, iq.shape, dtype=np.uint8)
    return cfg, np.stack([iq, iq2])


def test_frontend_plain_matches_jax(frontend_case):
    """Port Frontend (plain) vs JAX Frontend(impl='xla') and the fused
    Pallas kernel in interpret mode, 2 blocks, 2 channels, tails carried
    over 2 calls: > 65 dB, u8 tail byte-equal, prev within 1e-4."""
    cfg, iq = frontend_case
    h = filters.design_lpf(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps)
    jx = JFrontend(cfg, impl="xla")
    pal = FusedFrontendFIR(h, down=cfg.rf_decim, interpret=True)
    fe = Frontend(mode_config(0))
    n_half = iq.shape[1] // 2
    st = fe.init_state(2)
    port = []                                  # (demod, state) per call
    for k in range(2):
        d, st = fe(torch.from_numpy(iq[:, k * n_half:(k + 1) * n_half]), st)
        port.append((d, st))
    for c in range(2):
        js = jx.init_state()
        p_tail, p_pi, p_pq = js
        for k in range(2):
            seg = jnp.asarray(iq[c, k * n_half:(k + 1) * n_half])
            dj, js = jx(seg, js)
            dp, p_tail, p_pi, p_pq = pal(seg, p_tail, p_pi, p_pq)
            d, st = port[k]
            assert _snr(dj, d[c]) > 65.0, _snr(dj, d[c])
            assert _snr(dp, d[c]) > 65.0, _snr(dp, d[c])
            assert st.iq_tail.dtype == torch.uint8
            np.testing.assert_array_equal(st.iq_tail[c].numpy(),
                                          np.asarray(js.iq_tail))
            assert abs(float(st.prev_i[c]) - float(js.prev_i)) < 1e-4
            assert abs(float(st.prev_q[c]) - float(js.prev_q)) < 1e-4


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions (and the plain versions agree
    with the wrappers); nothing launches, so no launch is counted."""
    cfg = mode_config(0)
    fe = Frontend(cfg)
    rng = np.random.default_rng(2)
    xx = torch.from_numpy(rng.integers(0, 256, (2, fe.tail_len + 2940),
                                       dtype=np.uint8))
    z = torch.zeros(2)
    before = (frontend_fused.launches, fir_bank.launches)
    a = frontend_fused(xx, fe.rf_fir, z, z)
    b = frontend_plain(xx, fe.rf_fir, z, z)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    bank = tfir.make_bank([tfir.PolyFIR(filters.design_lpf(FS_IF, 16e3, 101),
                                        down=5)])
    x = torch.from_numpy(rng.standard_normal((3, 500)).astype(np.float32))
    (y,), _ = bank(x, torch.zeros(3, bank.tail_len))
    assert y.shape == (3, 100)
    assert (frontend_fused.launches, fir_bank.launches) == before


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_pcm_matches_jax(kind):
    """int16 PCM is exact, loud samples included: both sides clip before
    the cast and truncate toward zero."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-3.0, 3.0, (2, 2, 500)).astype(np.float32)
    x[0, :, :3] = [[0.99997, -2.0000001, 2.5], [-0.5, 1.0, -1.0]]
    if kind == "mono":
        ref = jaudio.mono_pcm(jnp.asarray(x[:, 0]))
        got = taudio.mono_pcm(torch.from_numpy(x[:, 0]))
    else:
        ref = jaudio.stereo_pcm(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]))
        got = taudio.stereo_pcm(torch.from_numpy(x[:, 0]),
                                torch.from_numpy(x[:, 1]))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _epilogue_case(s_ch, r_n, c, seed=7):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((c, r_n * 2 * s_ch)).astype(np.float32)
    pc = np.cos(rng.uniform(0, 7, s_ch)).astype(np.float32)
    ps = np.sin(rng.uniform(0, 7, s_ch)).astype(np.float32)
    return y, pc, ps


@pytest.mark.parametrize("s_ch, r_n, c, short", [(64, 16, 512, 37),
                                                  (5, 3, 40, 2),
                                                  (5, 3, 40, 0)])
def test_chan_epilogue_plain_matches_reference(s_ch, r_n, c, short):
    """The plain epilogue (and the wrapper on CPU tensors) is byte-exact
    against the JAX package's NumPy reference, at the 64-station geometry
    and at an odd one the TPU kernel could not take."""
    y, pc, ps = _epilogue_case(s_ch, r_n, c)
    n_out = c * r_n - short
    ref = jepi.reference_u8(y, pc, ps, r_n, s_ch, n_out)
    args = (torch.from_numpy(y), torch.from_numpy(pc), torch.from_numpy(ps),
            r_n, s_ch, n_out)
    got = chan_epilogue_plain(*args)
    assert got.dtype == torch.uint8 and got.shape == (s_ch, 2 * n_out)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(chan_epilogue(*args).numpy(), ref)


def test_chan_epilogue_plain_matches_pallas():
    """Against the Pallas kernel in interpret mode (64 stations, R = 16,
    512 frames, a partial last frame): within 1 LSB on < 1 % of bytes."""
    s_ch, r_n, c = 64, 16, 512
    y, pc, ps = _epilogue_case(s_ch, r_n, c)
    n_out = c * r_n - 37
    ref = np.asarray(jepi.fold_epilogue_u8(
        jnp.asarray(y), jnp.asarray(pc), jnp.asarray(ps), r_n, s_ch, n_out,
        interpret=True)).astype(np.int32)
    got = chan_epilogue_plain(torch.from_numpy(y), torch.from_numpy(pc),
                              torch.from_numpy(ps), r_n, s_ch,
                              n_out).numpy().astype(np.int32)
    diff = np.abs(got - ref)
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 0.01, (diff != 0).mean()


def test_chan_epilogue_rejects_bad_shapes():
    y, pc, ps = (torch.from_numpy(a) for a in _epilogue_case(4, 2, 8))
    with pytest.raises(ValueError):
        chan_epilogue(y, pc, ps, 3, 4, 10)          # y is not (c, R*2S)
    with pytest.raises(ValueError):
        chan_epilogue(y, pc, ps, 2, 4, 17)          # n_out > c*R
    with pytest.raises(TypeError):
        chan_epilogue(y.double(), pc, ps, 2, 4, 10)


@pytest.mark.parametrize("down", [2, 5, 10])
def test_fir_decimate_plain_matches_pallas(down):
    """K = 101, C = 8, tail-prefixed rows: > 110 dB against the Pallas
    kernel in interpret mode, with the taps as a tuple or a tensor."""
    k_taps, c, n = 101, 8, 2000
    h = filters.design_lpf(FS_IF, 16_000, k_taps)
    rng = np.random.default_rng(down)
    xx = rng.standard_normal((c, k_taps - 1 + n)).astype(np.float32)
    ref = np.asarray(j_fir_decimate_planes(
        jnp.asarray(xx), tuple(float(t) for t in h), down, interpret=True))
    got = fir_decimate_planes(torch.from_numpy(xx), tuple(h), down)
    assert got.shape == ref.shape == (c, n // down)
    assert _snr(ref, got) > 110.0, _snr(ref, got)
    plain = fir_decimate_plain(torch.from_numpy(xx),
                               torch.tensor(h, dtype=torch.float32), down)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_fir_decimate_rejects_non_dividing_geometry():
    h = tuple(filters.design_lpf(FS_IF, 16_000, 101))
    with pytest.raises(ValueError):                 # down does not divide N
        fir_decimate_planes(torch.zeros(2, 100 + 999), h, 5)
    with pytest.raises(ValueError):                 # ... nor K-1
        fir_decimate_planes(torch.zeros(2, 100 + 1000), h, 3)
    with pytest.raises(TypeError):
        fir_decimate_planes(torch.zeros(2, 1100, dtype=torch.float64), h, 5)


# (K, down, n_out): the receiver's two audio geometries (static body), a
# fallback geometry, n_out 1 and around the static body's tile edge
DECIMATE_CASES = [(101, 5, 1470), (101, 9, 1470), (33, 4, 500), (101, 5, 1),
                  (101, 9, 1), (101, 5, fir_kernels.STATIC_TILE - 1),
                  (101, 5, fir_kernels.STATIC_TILE),
                  (101, 9, fir_kernels.STATIC_TILE + 1), (2, 1, 7)]


@pytest.mark.parametrize("k_taps, down, n_out", DECIMATE_CASES)
def test_fir_decimate_plain_matches_direct_form(k_taps, down, n_out):
    """The oracle of the card tests: ``fir_decimate_plain`` against
    y[n] = sum_k h[k] xx[n*down + K-1-k] in float64 on the same f32 taps and
    input, > 120 dB (f32 rounding of a K-term sum). ``down`` need not divide
    K-1 (K 101, down 9)."""
    rng = np.random.default_rng(k_taps * 100 + down + n_out)
    h = rng.standard_normal(k_taps).astype(np.float32)
    xx = rng.standard_normal((3, k_taps - 1 + n_out * down)).astype(np.float32)
    got = fir_decimate(torch.from_numpy(xx), torch.from_numpy(h), down)
    win = np.lib.stride_tricks.sliding_window_view(
        xx.astype(np.float64), k_taps, axis=-1)[:, ::down]
    ref = win @ h[::-1].astype(np.float64)
    assert got.shape == ref.shape == (3, n_out)
    assert _snr(ref, got) > 120.0, _snr(ref, got)


def test_fir_decimate_down_need_not_divide_taps():
    """The CUDA kernel reads its window from the row, so ``fir_decimate``
    takes any down | N; ``fir_decimate_planes`` keeps the TPU kernel's plane
    contract (down | K-1 as well) and its ValueError."""
    h = tuple(filters.design_lpf(FS_IF, 16_000, 101))
    xx = torch.zeros(2, 100 + 900)
    assert fir_decimate(xx, h, 9).shape == (2, 100)       # 100 % 9 == 1
    with pytest.raises(ValueError, match="K-1"):
        fir_decimate_planes(xx, h, 9)
    with pytest.raises(ValueError):                       # down | N still
        fir_decimate(torch.zeros(2, 100 + 901), h, 9)


@pytest.mark.parametrize("k_taps, down, body", [
    (101, 5, "static"), (101, 9, "static"), (101, 4, "general"),
    (101, 10, "general"), (65, 5, "general"), (2, 1, "general")])
def test_fir_decimate_body_choice(k_taps, down, body):
    """(K, down) alone names the body: static at the two audio geometries
    of the receiver (modes 0 and 1)."""
    assert fir_kernels.kernel_body(k_taps, down) == body
    assert set(fir_decimate.body_launches) == {"static", "general"}


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_audio_modules_pick_resampler(mode):
    """The configuration alone picks the audio resampler, once: the
    decimating FIR where the mode does not upsample (modes 0-1), the
    polyphase FIR bank otherwise (modes 2-3); same carry either way."""
    cfg = mode_config(mode)
    want = tfir.DecimatingFIR if cfg.audio_up == 1 else tfir.FIRBank
    assert (cfg.audio_up == 1) == (mode in (0, 1))
    for site in (taudio_paths.MonoPath(cfg).audio_bank,
                 taudio_paths.StereoPath(cfg, 3).resamp_bank):
        assert type(site) is want
        assert site.tail_len == tfir.state_len(cfg.rf_taps * cfg.audio_up,
                                               cfg.audio_up) == 100
    if cfg.audio_up == 1:
        assert fir_kernels.kernel_body(site.num_taps, site.down) == "static"
        assert site.down == cfg.audio_down


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _multiplex(cfg, n, seed):
    """(2, n) FM multiplex-like rows at the IF rate: mono tone, 19 kHz
    pilot, a DSB-SC subcarrier on 38 kHz, a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / cfg.if_fs
    rows = []
    for f_m, f_s, ph in ((1000.0, 700.0, 0.3), (440.0, 1500.0, 1.1)):
        rows.append(0.4 * np.sin(2 * np.pi * f_m * t)
                    + 0.1 * np.cos(2 * np.pi * 19_000 * t + ph)
                    + 0.3 * np.sin(2 * np.pi * f_s * t)
                    * np.cos(2 * (2 * np.pi * 19_000 * t + ph))
                    + 0.01 * rng.standard_normal(n))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("mode", [0, 1])
def test_audio_paths_match_jax(mode):
    """MonoPath and StereoPath (tier 3) at the modes whose resampler is the
    decimating FIR, 2 channels x 2 calls of 2 blocks: the resampler op and
    MonoPath > 110 dB, StereoPath > 60 dB; the JAX state after call 1
    converts and carries the port through call 2; new tails equal within f32
    rounding."""
    cfg, jcfg = mode_config(mode), jmode_config(mode)
    n = 2 * cfg.if_block
    x = _multiplex(cfg, 2 * n, mode)
    jmono, tmono = jaudio_paths.MonoPath(jcfg), taudio_paths.MonoPath(cfg)
    jst = [jmono.init_state() for _ in range(2)]
    tst = tmono.init_state(2)
    for k in range(2):
        seg = x[:, k * n:(k + 1) * n]
        ja = [jmono(jnp.asarray(seg[c]), jst[c]) for c in range(2)]
        jst = [a[1] for a in ja]
        audio, tst = tmono(torch.from_numpy(seg), tst)
        assert audio.shape == (2, n * cfg.audio_up // cfg.audio_down)
        for c in range(2):
            assert _snr(ja[c][0], audio[c]) > 110.0, _snr(ja[c][0], audio[c])
            np.testing.assert_allclose(tst.audio_tail[c].numpy(),
                                       np.asarray(jst[c].audio_tail),
                                       rtol=1e-6, atol=1e-7)
    jster = jaudio_paths.StereoPath(jcfg, pll_tier=3)
    tster = taudio_paths.StereoPath(cfg, pll_tier=3)
    # the resampler op alone, both rails stacked as the path stacks them
    rails = x[:, :n].reshape(1, 2, n)
    tails = np.zeros((1, 2, 100), np.float32)
    (ty,), ttail = tster.resamp_bank(torch.from_numpy(rails),
                                     torch.from_numpy(tails))
    for r in range(2):
        jy, jtail = jster.mono_fir(jnp.asarray(rails[0, r]),
                                   jnp.asarray(tails[0, r]))
        assert _snr(jy, ty[0, r]) > 110.0, _snr(jy, ty[0, r])
        np.testing.assert_array_equal(ttail[0, r].numpy(), np.asarray(jtail))
    run = jax.jit(jster.__call__)
    jst = [jster.init_state() for _ in range(2)]
    mid = []
    for c in range(2):
        _, st = run(jnp.asarray(x[c, :n]), jst[c])
        mid.append(_np_tree(st))
    state = state_from_numpy(jax.tree_util.tree_map(
        lambda *a: np.stack(a), *mid), "cpu")
    (left, right), new = tster(torch.from_numpy(x[:, n:]), state)
    for c in range(2):
        (jl, jr), jnew = run(jnp.asarray(x[c, n:]),
                             jax.tree_util.tree_map(jnp.asarray, mid[c]))
        assert _snr(jl, left[c]) > 60.0, _snr(jl, left[c])
        assert _snr(jr, right[c]) > 60.0, _snr(jr, right[c])
        for leaf in ("mono_tail", "stereo_tail", "delay_tail", "pilot_tail"):
            np.testing.assert_allclose(
                getattr(new, leaf)[c].numpy(),
                np.asarray(getattr(jnew, leaf)), rtol=1e-4, atol=1e-4)


def test_new_wrappers_route_by_device():
    """CPU tensors take the plain versions without counting a launch; any
    device but CPU or CUDA raises."""
    before = (chan_epilogue.launches, fir_decimate.launches)
    y, pc, ps = (torch.from_numpy(a) for a in _epilogue_case(4, 2, 8))
    chan_epilogue(y, pc, ps, 2, 4, 16)
    fir_decimate(torch.zeros(2, 100 + 500), [1.0] * 101, 5)
    assert (chan_epilogue.launches, fir_decimate.launches) == before
    m = lambda t: t.to("meta")
    with pytest.raises(ValueError):
        chan_epilogue(m(y), m(pc), m(ps), 2, 4, 16)
    with pytest.raises(ValueError):
        fir_decimate(torch.empty((2, 600), device="meta"), [1.0] * 101, 5)


# --- the fused frontend's plane decomposition (the CUDA kernel's sums) -------

@pytest.mark.parametrize("down", [3, 4, 10, 7])
def test_frontend_planes_match_plain_and_jax(down):
    """``frontend_planes`` sums ``down`` polyphase planes of short
    unit-stride FIRs, as the CUDA kernel does, where ``frontend_plain`` is
    one framed dot product per output. On a synthetic station capture
    (2 channels, 1 mode-0 block, a carried prev): demod > 110 dB against
    ``frontend_plain`` (measured 119-138 dB; both are f32 sums of the same
    101 exact products in another order), prev within 1e-6; against the JAX
    DualPhaseFIR + fm_demod > 65 dB, the plain version's own bound there
    (JAX subtracts the 128 offset after the matmul)."""
    cfg = jmode_config(0)
    h = filters.design_lpf(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps)
    dual = tfir.DualPhaseFIR(h, down)
    iq, _ = jsynth.station_iq(cfg, 1, ps_name="PLANES  ")
    two = np.stack([iq, np.roll(iq, 2 * 1001)])
    n = ((two.shape[1] - dual.tail_len) // (2 * down)) * 2 * down
    tail, body = two[:, :dual.tail_len], two[:, dual.tail_len:][:, :n]
    xx = torch.from_numpy(np.concatenate([tail, body], axis=1))
    pi = torch.tensor([0.1, -0.2])
    pq = torch.tensor([0.3, 0.05])
    dp, ip, qp = frontend_plain(xx, dual, pi, pq)
    dk, ik, qk = frontend_planes(xx, dual.taps, down, pi, pq)
    assert dk.shape == dp.shape == (2, n // 2 // down)
    for c in range(2):
        assert _snr(dp[c], dk[c]) > 110.0, _snr(dp[c], dk[c])
    assert float((ik - ip).abs().max()) < 1e-6
    assert float((qk - qp).abs().max()) < 1e-6
    jdual = jfir.DualPhaseFIR(h, down)
    for c in range(2):
        i_j, q_j, _ = jdual(jnp.asarray(body[c]), jnp.asarray(tail[c]))
        dj, _, _ = j_fm_demod(i_j, q_j, jnp.float32(pi[c].item()),
                              jnp.float32(pq[c].item()))
        assert _snr(dj, dk[c]) > 65.0, _snr(dj, dk[c])


def test_frontend_planes_short_rows_and_tap_counts():
    """Planes with unequal tap counts (K not a multiple of down), more
    planes than taps (down > K), and one output."""
    rng = np.random.default_rng(9)
    for K, down, n_out in [(5, 3, 7), (3, 5, 4), (101, 10, 1), (4, 4, 2)]:
        dual = tfir.DualPhaseFIR(rng.standard_normal(K), down)
        xx = torch.from_numpy(rng.integers(
            0, 256, (2, 2 * K - 2 + 2 * down * n_out + 2 * (down - 1)),
            dtype=np.uint8))
        z = torch.tensor([0.2, -0.1])
        dp, ip, qp = frontend_plain(xx, dual, z, -z)
        dk, ik, qk = frontend_planes(xx, dual.taps, down, z, -z)
        assert dk.shape == dp.shape == (2, n_out)
        torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(ik, ip, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(qk, qp, rtol=1e-5, atol=1e-5)


def test_frontend_kernel_tile_constants():
    """The wrapper's copy of the kernel's tile: 9 outputs per thread x 128
    threads, one of them the predecessor of the block's first output."""
    assert (SPAN, TILE) == (1152, 1151)
