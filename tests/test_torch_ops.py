"""Port ops (real_time_sdr_tpu_torch.ops) against the JAX package's ops.

The same numpy inputs go through the JAX function and its port. On the CPU
the port's kernel wrappers run their plain versions; the JAX side runs both
its XLA path and its Pallas kernel in interpret mode, as the JAX package's
own tests do. Bounds: every FIR bank > 110 dB (per-op LTI parity, f32 vs
f32 in another summation order), the frontend > 65 dB (the JAX package's
interchange bound: its CPU frontend uses bf16 hi+lo split taps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu import config as C
from real_time_sdr_tpu.config import mode_config
from real_time_sdr_tpu.models.frontend import Frontend as JFrontend
from real_time_sdr_tpu.ops import filters
from real_time_sdr_tpu.ops import fir as jfir
from real_time_sdr_tpu.ops.demod import fm_demod as j_fm_demod
from real_time_sdr_tpu.ops.pallas.frontend_fused import FusedFrontendFIR
from real_time_sdr_tpu.ops.pallas.polyfir import FramedFIRBank
from real_time_sdr_tpu.ops.pll import PllParams as JPllParams
from real_time_sdr_tpu.ops.sync import FeedforwardSync as JSync
from real_time_sdr_tpu.utils import audio as jaudio
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.ops import fir as tfir
from real_time_sdr_tpu_torch.ops.cuda import fir_bank, frontend_fused
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import frontend_plain
from real_time_sdr_tpu_torch.ops.demod import fm_demod
from real_time_sdr_tpu_torch.utils import audio as taudio

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
    cfg = mode_config(0)
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
    fe = Frontend(cfg)
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
