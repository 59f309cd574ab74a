"""The port's own copies of the JAX package's jax-free modules stay equal to
their originals.

``real_time_sdr_tpu_torch`` imports nothing of ``real_time_sdr_tpu``; it keeps
copies of ``config.py``, ``ops/filters.py`` and ``utils/native_io.py``, of the
impairment and fixture generators of ``utils/synth.py``, and of the float64
oracle ``golden/chain.run_stages`` with the ``golden/dsp.py`` functions it
reaches (``utils/golden_chain.py``). Each is pinned here: every public
constant equal, ``mode_config`` field by field and derived size by derived
size for modes 0-3, each filter design function bit-equal (float64,
``assert_array_equal``: the copy runs the same numpy expressions) on the
arguments the receiver gives it, ``native_io``'s public names with the one
library path, the generators' arrays and the oracle's stages bit-equal.
"""

import dataclasses
import inspect

import numpy as np
import pytest

from real_time_sdr_tpu import config as jconfig
from real_time_sdr_tpu.ops import filters as jfilters
from real_time_sdr_tpu.utils import native_io as jnative
from real_time_sdr_tpu_torch import config as tconfig
from real_time_sdr_tpu_torch.ops import filters as tfilters
from real_time_sdr_tpu_torch.utils import native_io as tnative

CONSTANTS = sorted(n for n in vars(jconfig) if n.isupper())
DERIVED = sorted(n for n, v in vars(jconfig.ReceiverConfig).items()
                 if isinstance(v, property))


def _public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v)
                  and getattr(v, "__module__", mod.__name__) == mod.__name__)


@pytest.mark.parametrize("name", CONSTANTS)
def test_config_constant_equal(name):
    a, b = getattr(jconfig, name), getattr(tconfig, name)
    assert type(a) is type(b) and a == b


def test_config_public_names_equal():
    assert len(CONSTANTS) == 11 and len(DERIVED) == 9
    assert _public(tconfig) == _public(jconfig)
    assert ([f.name for f in dataclasses.fields(tconfig.ReceiverConfig)]
            == [f.name for f in dataclasses.fields(jconfig.ReceiverConfig)])


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mode_config_equal(mode):
    j, t = jconfig.mode_config(mode), tconfig.mode_config(mode)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in DERIVED:
        a, b = getattr(j, name), getattr(t, name)
        assert type(a) is type(b) and a == b, name
    assert dataclasses.asdict(tconfig.ReceiverConfig()) == dataclasses.asdict(
        jconfig.ReceiverConfig())


def test_config_errors_are_real():
    """What the original asserts, the copy raises (and keeps raising under
    ``python -O``)."""
    with pytest.raises(ValueError):
        tconfig.mode_config(4)
    with pytest.raises(ValueError):
        tconfig.ReceiverConfig(rf_taps=100)
    with pytest.raises(ValueError):
        tconfig.ReceiverConfig(if_fs=250_000)
    with pytest.raises(ValueError):
        tconfig.ReceiverConfig(audio_up=11)
    with pytest.raises(ValueError):       # block not a multiple of rf_decim
        tconfig.ReceiverConfig(rf_decim=4, audio_up=8, audio_down=5,
                               rf_fs=960_000)
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfig.mode_config(0).mode = 1


def _design_calls(cfg):
    """(function name, args, kwargs) of every filter the receiver designs
    at this mode (models/frontend, audio, rds, channelizer, utils/synth)."""
    c = tconfig
    if_fs, taps = float(cfg.if_fs), cfg.rf_taps
    up, down = cfg.audio_up, cfg.audio_down
    r_up, r_down = cfg.rds_resample
    return [
        ("design_lpf", (cfg.rf_fs, cfg.rf_fc, taps), {}),
        ("design_lpf", (if_fs * up, cfg.audio_fc, taps * up),
         dict(gain=float(up))),
        ("design_lpf", (if_fs * r_up, 3000.0, taps * r_up),
         dict(gain=float(r_up))),
        ("design_lpf", (8 * cfg.rf_fs, cfg.rf_fc, 8 * taps), {}),
        ("design_bpf", (if_fs, *c.PILOT_BAND, taps), {}),
        ("design_bpf", (if_fs, *c.STEREO_BAND, taps), {}),
        ("design_bpf", (if_fs, *c.RDS_BAND, taps), {}),
        ("design_bpf", (if_fs, *c.RDS_SQUARED_BAND, taps), {}),
        ("design_apf", (taps,), {}),
        ("design_apf", (taps, 2.0), {}),
        ("design_rrc", (float(cfg.rds_fs), taps), {}),
        ("design_rrc", (float(cfg.rds_fs), taps),
         dict(symbol_rate=c.RDS_SYMBOL_RATE, beta=c.RDS_RRC_BETA)),
    ]


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_filter_designs_bit_equal(mode):
    for fn, args, kw in _design_calls(tconfig.mode_config(mode)):
        a = getattr(jfilters, fn)(*args, **kw)
        b = getattr(tfilters, fn)(*args, **kw)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=f"{fn}{args}{kw}")
    assert tfilters.__all__ == jfilters.__all__


def test_native_io_public_names_equal():
    assert _public(tnative) == _public(jnative)
    assert tnative._LIB_PATH == jnative._LIB_PATH
    for cls in ("BlockReader", "BlockWriter"):
        for name, fn in inspect.getmembers(getattr(jnative, cls),
                                           inspect.isfunction):
            assert (inspect.signature(getattr(getattr(tnative, cls), name))
                    == inspect.signature(fn)), (cls, name)


def test_native_io_round_trip(tmp_path):
    """The copy's reader and writer move blocks through a file (native
    library or the Python fallback, whichever loads)."""
    data = np.arange(3 * 64, dtype=np.uint8)
    src = tmp_path / "in.raw"
    data.tofile(src)
    with open(src, "rb") as f:
        rd = tnative.BlockReader(f, 64)
        blocks = [rd.next() for _ in range(3)]
        assert rd.next() is None
        rd.close()
    np.testing.assert_array_equal(np.concatenate(blocks), data)
    with open(tmp_path / "out.raw", "wb") as f:
        wr = tnative.BlockWriter(f, 64)
        for b in blocks:
            wr.write(b)
        with pytest.raises(ValueError):
            wr.write(np.zeros(65, np.uint8))
        wr.close()
    np.testing.assert_array_equal(
        np.fromfile(tmp_path / "out.raw", np.uint8), data)


def _capture(n_blocks=1):
    from real_time_sdr_tpu_torch.utils import synth
    return synth.station_iq(tconfig.mode_config(0), n_blocks,
                            ps_name="COPIES  ")[0]


@pytest.mark.parametrize("kw", [
    dict(noise_std=0.05, seed=3),
    dict(multipath=[(2e-6, 0.3, 1.1), (5e-6, 0.15, -0.7)], doppler_hz=1.5,
         noise_std=0.02),
    dict(freq_offset_hz=400.0, freq_drift_hz_s=-150.0),
    dict(iq_gain_db=0.5, iq_phase_deg=2.0, dc_offset=0.03 + 0.02j,
         phase_noise_linewidth_hz=30.0, freq_offset_hz=400.0,
         noise_std=0.02),
], ids=["awgn", "multipath", "drift", "tuner"])
def test_impair_iq_bit_equal(kw):
    from real_time_sdr_tpu.utils import synth as jsynth
    from real_time_sdr_tpu_torch.utils import synth as tsynth
    iq = _capture()
    a = tsynth.impair_iq(iq, 2_400_000, **kw)
    b = jsynth.impair_iq(iq, 2_400_000, **kw)
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tsynth.impair_iq(iq, 2_400_000, multipath=[(1.0, 0.5, 0.0)])


def test_fixture_generators_bit_equal():
    """``rate_change`` (mode 0 -> modes 1 and 3), ``generate_sin``,
    ``add_sin`` and ``random_samples`` give the JAX package's arrays."""
    from real_time_sdr_tpu.utils import synth as jsynth
    from real_time_sdr_tpu_torch.utils import synth as tsynth
    iq = _capture()[:40_000]
    for fs_out in (1_440_000, 1_920_000):
        np.testing.assert_array_equal(
            tsynth.rate_change(iq, 2_400_000, fs_out),
            jsynth.rate_change(iq, 2_400_000, fs_out))
    np.testing.assert_array_equal(tsynth.generate_sin(48e3, 440.0, 960, 0.5,
                                                      0.3),
                                  jsynth.generate_sin(48e3, 440.0, 960, 0.5,
                                                      0.3))
    for kw in (dict(), dict(amplitudes=[1, 0.5], phases=[0.1, 0.2])):
        np.testing.assert_array_equal(
            tsynth.add_sin(48e3, [1000.0, 2000.0], 480, **kw),
            jsynth.add_sin(48e3, [1000.0, 2000.0], 480, **kw))
    np.testing.assert_array_equal(tsynth.random_samples(100, 2.0, 1, 12),
                                  jsynth.random_samples(100, 2.0, 1, 12))


def test_golden_chain_bit_equal():
    """The port's oracle copy (``utils.golden_chain.run_stages``) gives
    ``golden.chain.run_stages``'s every stage on one mode-0 block, with the
    stereo and RDS branches and without them."""
    from golden import chain as jchain
    from real_time_sdr_tpu_torch.utils import golden_chain
    cfg = tconfig.mode_config(0)
    iq = _capture()
    for kw in (dict(), dict(stereo=False, rds=False)):
        a = golden_chain.run_stages(cfg, iq, **kw)
        b = jchain.run_stages(jconfig.mode_config(0), iq, **kw)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float64
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError):
        golden_chain.fir_block(np.zeros(8), np.ones(5), np.zeros(3))
