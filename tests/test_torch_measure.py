"""The port's measurement layer against the JAX package's, on the CPU:
``utils/logging`` (vector dumps, the roofline over the
modules' ``cost()``, the device trace), ``utils/benchkit`` (digests,
shifted channels, staged cells) and ``utils/io`` / ``utils/audio.write_pcm``.

Bounds: files byte-identical to the JAX package's (the port's span
recorder, which replaces ``BlockTimer``, is held by
``tests/test_torch_spans.py``); ``stage_costs`` walks the JAX package's stages
in its order under its row names (the port adds only its tier-1 carrier
loop rows); each kernel site's FLOPs and bytes at the flagship shape (mode
0, 32 channels x 12 blocks) equal the hand count, 2 x outputs x nonzero
taps and the f32 input with its tail once, every output once, the taps
once per launch; each kernel row of the roofline report, scaled to that
shape, within 1 % of the launches' bounds; the fused wideband frontend's
count equal to the JAX package's at f32; digests exact; shifted channels
and staged cells equal to the JAX package's.
"""

import functools
import io as pyio

import numpy as np
import pytest
import torch

from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.utils import audio as jaudio
from real_time_sdr_tpu.utils import benchkit as jbench
from real_time_sdr_tpu.utils import io as jio
from real_time_sdr_tpu.utils import logging as jlog
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend
from real_time_sdr_tpu_torch.ops import filters
from real_time_sdr_tpu_torch.utils import audio as taudio
from real_time_sdr_tpu_torch.utils import benchkit, synth
from real_time_sdr_tpu_torch.utils import io as tio
from real_time_sdr_tpu_torch.utils import logging as tlog

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

CFG = mode_config(0)
CH, BLOCKS = 32, 12


@pytest.fixture(scope="module")
def rx3():
    return Receiver(0, stereo=True, rds=True, pll_tier=3)


def _names(rows):
    return [name for name, _ in rows]


@pytest.mark.parametrize("kw", [dict(stereo=True, rds=True, pll_tier=3),
                                dict(stereo=True, rds=True, pll_tier=1),
                                dict(stereo=True, pll_tier=3), dict()],
                         ids=["0r-tier3", "0r-tier1", "0s-tier3", "0m"])
def test_stage_cost_rows_match_jax(kw):
    """The JAX package's rows in its order and under its names; the port
    adds only the tier-1 loops' rows, each on the pll_scan kernel."""
    rows = tlog.stage_costs(Receiver(0, **kw), channels=CH)
    jrows = jlog.stage_costs(JReceiver(0, **kw), channels=CH)
    extra = [n for n, c in rows if c["kernel"] == "pll_scan"]
    assert [n for n in _names(rows) if n not in extra] == _names(jrows)
    assert extra == (["audio.sync.pll_scan", "rds.sync.pll_scan"]
                     if kw.get("pll_tier") == 1 else [])
    for name, c in rows:
        assert set(c) >= {"kind", "flops", "bytes", "w_bytes", "dims",
                          "kernel"}
        if c["kind"] == "elementwise":      # the JAX package's stream tally
            assert c["bytes"] == dict(jrows)[name]["bytes"]


def _hand_fir(taps, up, down, rows, n):
    """(bytes, flops) of one launch: 2 x outputs x nonzero taps each output
    multiplies, summed over the filters; the f32 input and its tail read
    once, every output written once, the taps once."""
    taps = [np.asarray(h) for h in taps]
    k = len(taps[0])
    n_out = n * up // down
    macs = sum(sum(np.count_nonzero(h[(r * down) % up::up])
                   for r in range(n_out)) for h in taps)
    tail = -(-k // up) - 1
    nbytes = rows * (4 * (n + tail) + 4 * len(taps) * n_out) \
        + 4 * len(taps) * k
    return nbytes, rows * 2 * macs


def _sites(rx):
    """The kernel sites of one 32 x 12 mode-0 segment: (kernel, module,
    its taps, up, down, rows, n)."""
    n_if, a, r = CFG.if_block * BLOCKS, rx.audio, rx.rds_path
    up, down = CFG.rds_resample
    return [
        ("fir_bank", rx.if_bank, [a.pilot_fir.h, a.band_fir.h,
                                  r.band_fir.h], 1, 1, CH, n_if),
        ("fir_bank", a.sync.bank, [a.sync.cr_fir.h, a.sync.ci_fir.h], 1, 1,
         CH, n_if),
        ("fir_bank", r.pilot_bank, [r.pilot_fir.h], 1, 1, CH, n_if),
        ("fir_bank", r.sync.bank, [r.sync.cr_fir.h, r.sync.ci_fir.h], 1, 1,
         CH, n_if),
        ("fir_bank", r.baseband_bank, [r.baseband_fir.h], up, down,
         CH * BLOCKS, CFG.if_block),
        ("fir_bank", r.rrc_bank, [r.rrc_fir.h], 1, 1, CH * BLOCKS,
         CFG.rds_block),
        ("fir_decimate", a.resamp_bank, [a.mono_fir.h], 1, CFG.audio_down,
         2 * CH, n_if),
    ]


def test_kernel_site_costs_are_the_hand_count(rx3):
    for _, site, taps, up, down, rows, n in _sites(rx3):
        assert tlog.launch_cost(site.cost(n), rows) == _hand_fir(
            taps, up, down, rows, n)
    # the frontend: u8 rows with their tail in, the f32 demod out, K
    # multiply-adds per output for I and for Q, the taps once
    h = filters.design_lpf(CFG.rf_fs, CFG.rf_fc, CFG.rf_taps)
    n2 = 2 * CFG.block_size_iq * BLOCKS
    n_out = CFG.if_block * BLOCKS
    nbytes, flops = tlog.launch_cost(rx3.frontend.cost(n2), CH)
    assert nbytes == CH * (2 * CFG.rf_taps - 2 + n2 + 4 * n_out) \
        + 4 * CFG.rf_taps
    assert flops == CH * 2 * 2 * np.count_nonzero(h) * n_out
    ms, by = tlog.roofline_ms(nbytes, flops)
    assert by == "bytes" and round(ms, 4) == 0.0202


def test_report_kernel_rows_match_launch_bounds(rx3):
    """Each kernel row of the report at 32 x 12, from per-block rows,
    within 1 % of the sum of its launches' bounds at the segment shape."""
    rep = tlog.speed_of_light_report(rx3, file=pyio.StringIO(), channels=CH,
                                     blocks=BLOCKS)
    want = {}
    for kernel, site, _, _, _, rows, n in _sites(rx3):
        want[kernel] = want.get(kernel, 0.0) + tlog.roofline_ms(
            *tlog.launch_cost(site.cost(n), rows))[0]
    want["frontend_fused"] = tlog.roofline_ms(*tlog.launch_cost(
        rx3.frontend.cost(2 * CFG.block_size_iq * BLOCKS), CH))[0]
    assert set(rep["kernels"]) == set(want)
    for name, ms in want.items():
        assert abs(rep["kernels"][name]["floor_ms"] / ms - 1) < 0.01, name
    assert rep["kernels"]["fir_bank"]["bound_by"] == "operations"
    assert rep["ceiling_x"] > 1


def test_report_tier1_loop_is_latency_bound():
    out = pyio.StringIO()
    rep = tlog.speed_of_light_report(
        Receiver(0, stereo=True, rds=True), file=out, channels=CH,
        blocks=BLOCKS, sm_clock_hz=1.98e9)
    loop = rep["kernels"]["pll_scan"]
    assert loop["bound_by"] == "latency"
    # two loops x 12 blocks x 7,350 samples x 11 dependent operations x 4
    # cycles at 1.98 GHz
    assert loop["floor_ms"] == pytest.approx(
        2 * BLOCKS * CFG.if_block * 11 * 4 / 1.98e9 * 1e3)
    assert "latency-bound" in out.getvalue()
    assert "H100" in out.getvalue()


def test_fused_wideband_cost_is_the_jax_count_at_f32():
    offs = [-450_000, -150_000, 150_000, 450_000]
    wide_fs = 4 * CFG.rf_fs
    n = CFG.block_size_iq * 4 * 3
    got = FusedWidebandFrontend(CFG, wide_fs, offs, device="cpu").cost(n)
    want = JFused(CFG, wide_fs, offs, compute_dtype="f32").cost(n)
    for key in ("flops", "bytes", "w_bytes", "dims"):
        assert got[key] == want[key], key


def test_log_vector_and_block_timer_match_jax(tmp_path):
    data = np.random.default_rng(0).standard_normal(50) * 1e3
    for kw in (dict(), dict(index=np.arange(50) * 0.5)):
        a = tlog.log_vector("probe", data, out_dir=str(tmp_path / "t"), **kw)
        b = jlog.log_vector("probe", data, out_dir=str(tmp_path / "j"), **kw)
        assert open(a, "rb").read() == open(b, "rb").read()
    lines = open(a).read().strip().splitlines()
    assert lines[0] == "# probe" and len(lines) == 51
    # the port times its serving loops with the span recorder in place of
    # the JAX package's block timer
    assert hasattr(jlog, "BlockTimer") and not hasattr(tlog, "BlockTimer")
    assert "SpanRecorder" in tlog.__all__


def test_device_trace_writes_a_trace(tmp_path):
    with tlog.device_trace(str(tmp_path / "tr"), name="seg") as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "tr" / "seg.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_device_trace_records_the_call_after_its_warmup(tmp_path):
    """With ``warmup=1`` only the call after ``prof.step()`` is recorded
    (and written to the trace)."""
    a, b = torch.ones(16, 16), torch.ones(16, 16)
    with tlog.device_trace(str(tmp_path), name="warm", warmup=1) as prof:
        a @ b
        prof.step()
        a @ b
        a @ b
    mm = [e for e in prof.key_averages() if e.key == "aten::mm"]
    assert sum(e.count for e in mm) == 2
    assert (tmp_path / "warm.json").stat().st_size > 0


def _avg(key, device_type, self_us=0.0, total_us=0.0, count=1):
    """One row of ``key_averages()`` as ``device_busy`` reads it."""
    from types import SimpleNamespace
    return SimpleNamespace(key=key, device_type=device_type, count=count,
                           self_device_time_total=self_us,
                           device_time_total=total_us)


def test_device_busy_adds_an_unrecorded_product():
    """An ``aten::mm`` that ran with no device time: its CUDA-event time
    (per call) is added, once per call, and labelled as such; the
    schedule's step annotation is not work."""
    from torch.autograd import DeviceType
    avg = [_avg("aten::mm", DeviceType.CPU, count=2),
           _avg("fir_bank_tiled", DeviceType.CUDA, self_us=300.0),
           _avg("ProfilerStep#1", DeviceType.CUDA, self_us=9000.0)]
    got = tlog.device_busy(avg, product_ms=1.5)
    assert got == dict(busy_ms=0.3 + 3.0, product_ms=3.0, calls=2,
                       source="CUDA events")
    # no time given: the busy time is the profiler's, and says it lacks it
    got = tlog.device_busy(avg)
    assert got["busy_ms"] == 0.3 and got["product_ms"] is None
    assert got["source"] == "missing"


def test_device_busy_does_not_add_a_recorded_product_twice():
    """Where the profiler recorded the product's kernel, the busy time is
    the profiler's own and the product comes from it."""
    from torch.autograd import DeviceType
    avg = [_avg("aten::mm", DeviceType.CPU, total_us=3200.0),
           _avg("sm90_xmma_gemm_f32f32", DeviceType.CUDA, self_us=3200.0),
           _avg("fir_bank_tiled", DeviceType.CUDA, self_us=300.0)]
    got = tlog.device_busy(avg, product_ms=3.1)
    assert got == dict(busy_ms=3.5, product_ms=3.2, calls=1,
                       source="profiler")
    # no product ran: nothing added, whatever time is given
    got = tlog.device_busy(avg[1:], product_ms=3.1)
    assert got == dict(busy_ms=3.5, product_ms=0.0, calls=0, source="none")


def test_device_busy_on_a_cpu_profile(tmp_path):
    """A real CPU profile (no device time at all) of two products: the
    event time is added for both."""
    a, b = torch.ones(32, 32), torch.ones(32, 32)
    with tlog.device_trace(str(tmp_path), name="mm", warmup=1) as prof:
        a @ b
        prof.step()
        a @ b
        a @ b
    got = tlog.device_busy(prof.key_averages(), product_ms=0.25)
    assert got == dict(busy_ms=0.5, product_ms=0.5, calls=2,
                       source="CUDA events")


def test_io_files_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    iq = rng.integers(0, 256, 2000).astype(np.uint8)
    f32 = rng.standard_normal(300).astype(np.float32)
    audio = np.sin(np.arange(960) * 0.1)
    for mod, tag in ((tio, "t"), (jio, "j")):
        mod.write_iq_u8(str(tmp_path / f"{tag}.raw"), iq)
        mod.write_bin_f32(str(tmp_path / f"{tag}.bin"), f32)
        mod.write_wav(str(tmp_path / f"{tag}.wav"), audio, 48000)
        mod.write_wav(str(tmp_path / f"{tag}s.wav"),
                      (audio * 9000).astype(np.int16), 48000, stereo=True)
    for ext in (".raw", ".bin", ".wav", "s.wav"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    np.testing.assert_array_equal(tio.read_iq_u8(str(tmp_path / "t.raw"),
                                                 max_pairs=10), iq[:20])
    np.testing.assert_array_equal(tio.read_bin_f32(str(tmp_path / "t.bin")),
                                  f32)
    for fn in ("print_real_vector", "print_complex_vector"):
        x = f32[:14] + (1j * f32[14:28] if "complex" in fn else 0)
        assert getattr(tio, fn)(x) == getattr(jio, fn)(x)
    capsys.readouterr()
    pcm = torch.from_numpy((audio * 12000).astype(np.int16))
    a, b = pyio.BytesIO(), pyio.BytesIO()
    with open(tmp_path / "t.pcm", "wb") as f:
        taudio.write_pcm(f, pcm)
    with open(tmp_path / "j.pcm", "wb") as f:
        jaudio.write_pcm(f, pcm.numpy())
    assert (tmp_path / "t.pcm").read_bytes() == \
        (tmp_path / "j.pcm").read_bytes()
    del a, b


def test_shifted_channels_and_staged_cells_match_jax():
    iq, _ = synth.station_iq(CFG, 3)
    n_len = 2 * 2 * CFG.block_size_iq
    want = np.asarray(jbench.shifted_channel_segments(iq, 4, n_len))
    got = benchkit.shifted_channel_segments(iq, 4, n_len, "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        benchkit.shifted_channel_segments_host(iq, 4, n_len),
        jbench.shifted_channel_segments_host(iq, 4, n_len))
    per_ch = benchkit.shifted_channel_segments_host(iq, 4, 3 * 2 *
                                                    CFG.block_size_iq)
    chunk = 2 * CFG.block_size_iq
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    jcells = jbench.stage_cells(jrx, per_ch, 2, 2, 3, chunk)
    cells = benchkit.stage_cells(Receiver(0, stereo=True, rds=True,
                                          pll_tier=3), per_ch, 2, 2, 3, chunk)
    tl = 2 * CFG.rf_taps - 2
    for gi in range(2):
        for k in range(3):
            flat = np.asarray(jcells[gi][k][0]).view(np.uint8).reshape(2, -1)
            np.testing.assert_array_equal(cells[gi][k].numpy(),
                                          flat[:, :tl + chunk])


def test_digest_steps(rx3):
    """digest_step is the sum of every output leaf of run_segment in f32;
    the staged twin gives the same digest bit for bit."""
    iq, _ = synth.station_iq(CFG, 2)
    seg = torch.from_numpy(np.stack([iq, np.roll(iq, 2 * 977)]))
    st = rx3.init_state(2)
    _, out = rx3.run_segment(st, seg)
    want = sum(o.to(torch.float32).sum() for o in out if o is not None)
    s1, d1 = benchkit.digest_step(rx3)(st, seg)
    n2 = seg.shape[-1]
    xp = torch.from_numpy(rx3.frontend.stage_segment(
        st.frontend.iq_tail.numpy(), seg.numpy()))
    s2, d2 = benchkit.digest_step_staged(rx3, n2)(st, xp)
    assert d1.ndim == 0 and d1.dtype == torch.float32
    assert torch.equal(d1, want) and torch.equal(d2, d1)
    assert torch.equal(s1.frontend.iq_tail, s2.frontend.iq_tail)
