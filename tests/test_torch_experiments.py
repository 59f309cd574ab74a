"""The measurement scripts of ``real_time_sdr_tpu_torch/experiments/``
against the JAX package, on the CPU at small sizes.

The JAX scripts (``experiments/*.py``) are not imported: they are entry
points that build their own receivers on the JAX device. Each test holds
the port's module against the JAX package's calls, or the script's own
rule restated here, on the same numpy-seeded input:

- the ladder's grid, the scripts' rule restated (offsets, capture rate,
  ``taps_factor``), and the fused frontend's K_eq at 64 and 128 stations
  equal to the JAX package's (1003, 2005);
- the ladder's longer filters (``taps_factor`` 4 and 8, the 128- and
  256-station factors) on a 4-station grid at 9.6 MS/s: geometry and
  weights bit for bit, demod > 80 dB against JAX f32 on each of two
  chained one-block segments (``tests/test_torch_wideband.py``'s bound),
  the state's ``pos`` and tails equal;
- the retune latency's run through the graph cache's bookkeeping
  (``HostGraph``): no new graph, outputs after a retune onto the same
  raster point equal to the same run with no retune;
- the live-paced CLI under overload: the native reader sheds blocks; the
  ``--stats`` parser on recorded lines;
- the subsystem and mode floors: every key; the rows their floors sum
  under the JAX package's names, the elementwise rows' bytes equal (the
  FIR rows count the function, not JAX's framed operands:
  ``tests/test_torch_measure.py``);
- the trace ranking on a CPU profile and on a Chrome trace;
- each module's ``main`` on the CPU, exit 2 without a card, and no import
  of jax, the JAX package or ``golden``.
"""

import functools
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.utils import logging as jlog
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.experiments import (
    EXPERIMENTS, GateError, e2e_latency, ladder_geometry, mode_floors,
    retune_latency, stage_decompose, trace_top, trace_wideband, tracekit,
    wideband64)
from real_time_sdr_tpu_torch.models import receiver as port_receiver
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend as _FusedWidebandFrontend
from real_time_sdr_tpu_torch.utils import logging as tlog
from real_time_sdr_tpu_torch.utils import native_io
from real_time_sdr_tpu_torch.utils.graphs import GraphCache, HostGraph
from real_time_sdr_tpu_torch.utils.state import state_from_numpy

# every test here runs on the CPU: the port's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")
FusedWidebandFrontend = functools.partial(_FusedWidebandFrontend,
                                          device="cpu")

CFG = mode_config(0)
JCFG = jmode_config(0)
WIDE_FS = 4 * CFG.rf_fs                                    # 9.6 MS/s
RASTER4 = [-450_000, -150_000, 150_000, 450_000]
PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "real_time_sdr_tpu_torch", "experiments")
MODULES = dict(wideband64=wideband64, retune_latency=retune_latency,
               e2e_latency=e2e_latency, stage_decompose=stage_decompose,
               mode_floors=mode_floors, trace_top=trace_top,
               trace_wideband=trace_wideband)


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- (a) the ladder's grid ----------------------------------------------------

def _script_rule(n_st):
    """``experiments/wideband64.py:79-96`` (and ``retune_latency.py:45-51``)
    restated: a 300 kHz raster centred on DC, the smallest even multiple
    >= 8 of the station rate whose Nyquist covers the span plus 150 kHz,
    taps_factor max(2, mult // 4)."""
    offs = [int((k - (n_st - 1) / 2) * 300_000) for k in range(n_st)]
    span = max(abs(o) for o in offs) + 150_000
    mult = 8
    while mult * JCFG.rf_fs // 2 < span:
        mult += 2
    return offs, mult * JCFG.rf_fs, max(2, mult // 4)


@pytest.mark.parametrize("n_st", [8, 64, 128, 256, 512, 1024])
def test_ladder_geometry_is_the_scripts_rule(n_st):
    assert ladder_geometry(n_st) == _script_rule(n_st)


def test_ladder_geometry_rungs_and_bad_input():
    assert [ladder_geometry(n)[1:] for n in (64, 128, 256, 512, 1024)] == [
        (19_200_000, 2), (38_400_000, 4), (76_800_000, 8),
        (153_600_000, 16), (307_200_000, 32)]
    assert ladder_geometry(64, wide_mult=16)[1:] == (38_400_000, 4)
    with pytest.raises(ValueError):
        ladder_geometry(0)
    with pytest.raises(ValueError):
        ladder_geometry(64, wide_mult=4)      # 9.6 MS/s misses the span


@pytest.mark.parametrize("n_st,k_eq", [(64, 1003), (128, 2005)])
def test_ladder_k_eq_matches_jax(n_st, k_eq):
    offs, wide_fs, tf = ladder_geometry(n_st)
    wf = FusedWidebandFrontend(CFG, wide_fs, offs, taps_factor=tf)
    jwf = JFused(JCFG, wide_fs, offs, taps_factor=tf, compute_dtype="f32")
    assert wf.k_eq == jwf.k_eq == k_eq
    assert (wf.lo, wf.r_n, wf.j_w) == (jwf.lo, jwf.r_n, jwf.j_w)


# -- (b) the ladder's longer filters against JAX ------------------------------

@pytest.mark.parametrize("tf", [4, 8])
def test_fused_frontend_taps_factor_matches_jax(tf):
    """At the 128- and 256-station taps factors: geometry and weights
    bit for bit; two chained one-block segments of seeded noise rails,
    demod > 80 dB on each station (the JAX package's bound against its
    float64 oracle), ``pos`` and the rail tails equal, the second segment
    from the converted JAX state too."""
    jwf = JFused(JCFG, WIDE_FS, RASTER4, taps_factor=tf,
                 compute_dtype="f32")
    wf = FusedWidebandFrontend(CFG, WIDE_FS, RASTER4, taps_factor=tf)
    assert (wf.lo, wf.r_n, wf.j_w, wf.k_eq) == (jwf.lo, jwf.r_n, jwf.j_w,
                                                jwf.k_eq)
    assert wf.k_eq == 101 * tf + 1 + wf.decim * 100
    np.testing.assert_array_equal(wf.w.numpy(), jwf._w)
    np.testing.assert_array_equal(wf.pc.numpy(), jwf._pc_np)
    n = CFG.block_size_iq * wf.decim
    rng = np.random.default_rng(40 + tf)
    iw, qw = (rng.standard_normal(2 * n).astype(np.float32) * 0.3
              for _ in range(2))
    js, ps = jwf.init_state(), wf.init_state()
    for k in range(2):
        seg = slice(k * n, (k + 1) * n)
        jd, js_new = jwf(jnp.asarray(iw[seg]), jnp.asarray(qw[seg]), js)
        td, ps = wf(_t(iw[seg]), _t(qw[seg]), ps)
        assert td.shape == jd.shape == (len(RASTER4), n // wf.dt)
        for s in range(len(RASTER4)):
            assert _snr(jd[s], td[s]) > 80.0, (k, s, _snr(jd[s], td[s]))
        assert int(ps.pos) == int(js_new.pos)
        np.testing.assert_array_equal(ps.i_tail.numpy(),
                                      np.asarray(js_new.i_tail))
        np.testing.assert_array_equal(ps.q_tail.numpy(),
                                      np.asarray(js_new.q_tail))
        if k == 0:
            resumed = state_from_numpy(
                jax.tree_util.tree_map(np.asarray, js_new), "cpu")
        js = js_new
    td2, _ = wf(_t(iw[n:]), _t(qw[n:]), resumed)
    for s in range(len(RASTER4)):
        assert _snr(jd[s], td2[s]) > 80.0


# -- the wideband rung on the CPU ---------------------------------------------

def test_wideband64_rung_and_decode_check():
    """A 4-station rung at the ladder's first rate: the numbers' keys, and
    the decode check's stations (slots 2 and 3 of 4: the rule's three
    slots coincide on so small a grid) with PS and PI as sent, and its
    gate on a silent capture."""
    res = wideband64.run(stations=4, seg=1, reps=1, path="fused",
                         device="cpu")
    assert res["frontend"] == "fused" and res["k_eq"] == 1003
    assert (res["wide_fs"], res["taps_factor"], res["seg"]) == (
        19_200_000, 2, 1)
    assert res["peak_gb"] is None and res["device"] == "cpu"
    assert res["x_realtime"] > 0 and res["station_msps"] == 9.6
    rung = wideband64.build(4, "fused", wide_mult=4, seg=13, device="cpu")
    rails = wideband64.scene_rails(rung)
    dec = wideband64.decode_check(rung, rails)
    assert [(r["slot"], r["ps"], r["pi"]) for r in dec] == [
        (k, f"WB64-00{k}", 0x1000 + k) for k in (2, 3)]
    bad = (rails[0] * 0, rails[1] * 0)
    with pytest.raises(GateError, match="0/2 stations"):
        wideband64.decode_check(rung, bad)


def test_wideband64_path_rules():
    with pytest.raises(ValueError, match="at most 64"):
        wideband64.build(65, "u8", device="cpu")
    rung = wideband64.build(2, "u8", device="cpu")
    assert not rung.fused and rung.seg == 24
    assert wideband64.build(2, "auto", device="cpu").fused
    assert wideband64.decode_picks(64) == [3, 32, 62]
    assert wideband64.decode_picks(1) == [0]


# -- (c) retune latency -------------------------------------------------------

@pytest.fixture
def host_graphs(monkeypatch):
    """Receivers built in the test get ``GraphCache(HostGraph)``: the card's
    graph bookkeeping, with an eager re-run in place of the replay."""
    monkeypatch.setattr(port_receiver, "GraphCache",
                        functools.partial(GraphCache, HostGraph))


def test_retune_latency_adds_no_graph_and_moves_no_output(host_graphs):
    res = retune_latency.run(stations=4, seg=1, reps=2, device="cpu")
    assert len(res["latencies_ms"]) == retune_latency.RETUNES == 8
    assert res["graphs_before"] == res["graphs_after"] == 1
    assert res["outputs_equal"]
    assert res["min_ms"] <= res["p50_ms"] <= res["max_ms"]
    assert res["x_station_realtime"] == pytest.approx(
        4 * res["x_wideband"], rel=1e-9)


def test_retune_latency_gate_catches_a_moved_station(host_graphs,
                                                     monkeypatch):
    """A retune that lands one raster step away changes the outputs: the
    check fails."""
    orig = _FusedWidebandFrontend.retune
    monkeypatch.setattr(_FusedWidebandFrontend, "retune",
                        lambda self, s, hz: orig(self, s, hz + 300_000))
    with pytest.raises(GateError, match="differs"):
        retune_latency.run(stations=4, seg=1, reps=1, device="cpu")


# -- (d) the live-paced CLI ---------------------------------------------------

STDERR = """\
output: 48000 Hz s16le stereo  (play with: aplay -r 48000 -f S16_LE -c 2)
warmed up in 1.4 s
block 6: 12.25 ms (15.0x real time)
block 12: 9.10 ms (20.2x real time)
dropped 7 input blocks (consumer too slow)
total: 12 blocks, avg 3.55 ms/block, 8.6x real time
block latency (ingest->PCM out): p50 190.3 ms, p99 214.9 ms, max 214.9 ms, \
steady-state p50 183.1 ms vs 30.62 ms block deadline (dropped 7)
kernel launches: {"frontend_fused": 2, "fir_bank": 12}
warning: --drop-oldest is inactive: the native I/O library did not load
"""


def test_parse_stats_on_recorded_lines():
    got = e2e_latency.parse_stats(STDERR)
    assert got["latency"] == dict(p50_ms=190.3, p99_ms=214.9, max_ms=214.9,
                                  steady_p50_ms=183.1, deadline_ms=30.62,
                                  dropped=7)
    assert got["total"] == dict(blocks=12, avg_ms=3.55, x_realtime=8.6)
    assert got["dropped"] == 7 and got["warmed_s"] == 1.4
    assert got["launches"] == {"frontend_fused": 2, "fir_bank": 12}
    assert got["warnings"] == [STDERR.splitlines()[-1]]
    empty = e2e_latency.parse_stats("block 1: 3.00 ms (10.2x real time)\n")
    assert empty == dict(latency=None, total=None, dropped=None,
                         warmed_s=None, launches=None, warnings=[])


def test_overload_run_sheds_blocks_on_the_cpu():
    """``--drop-oldest --io-depth 2`` behind a sink 3x slower than real
    time, the script's 40 blocks fed at the capture's pace once the child
    is warmed up: the native reader drops input (the CLI a child process
    over real pipes, tier 3: the CPU's tier-1 loop is slow)."""
    if not native_io.available():
        pytest.skip("the native I/O library (make -C native) does not load")
    res = e2e_latency.overload_run(pll_tier=3, device="cpu")
    assert res["rc"] == 0 and res["native"] and res["warmed_s"] is not None
    assert res["dropped"] > 0 and res["latency"]["dropped"] == res["dropped"]
    assert res["total"]["blocks"] + res["dropped"] <= 40 + 4


def test_wideband_offsets_are_distinct_and_in_band():
    offs = e2e_latency.wideband_offsets(8, WIDE_FS)
    assert offs[:2] == [-1_700_000, 800_000] and len(set(offs)) == 8
    assert max(abs(o) for o in offs) + 150_000 <= WIDE_FS // 2
    assert e2e_latency.wideband_offsets(2, WIDE_FS) == [-1_700_000, 800_000]


# -- (e) subsystem and mode floors --------------------------------------------

KEYS_SD = {"per_run_ms", "us_per_blk_ch", "delta_us_vs_prev", "floor_bytes",
           "floor_us", "pct_of_floor", "first_call_s", "device"}
KEYS_MF = {"block_ms_of_signal", "us_per_blk_ch", "floor_us",
           "pct_of_floor", "measured_x", "ceiling_x", "first_call_s",
           "device"}


def test_stage_decompose_keys_and_floors():
    res = stage_decompose.run(channels=2, blocks=1, min_measure=0.0,
                              device="cpu")
    assert list(res) == [n for n, _ in stage_decompose.CONFIGS]
    prev = 0.0
    for name, kw in stage_decompose.CONFIGS:
        r = res[name]
        assert set(r) == KEYS_SD and r["device"] == "cpu"
        assert r["delta_us_vs_prev"] == pytest.approx(r["us_per_blk_ch"]
                                                      - prev)
        prev = r["us_per_blk_ch"]
        rx, jrx = (Receiver(0, pll_tier=3, **kw),
                   JReceiver(0, pll_tier=3, **kw))
        rows = tlog.stage_costs(rx, channels=2, blocks=1)
        jrows = dict(jlog.stage_costs(jrx, channels=2))
        assert [n for n, _ in rows] == list(jrows)
        for n, c in rows:
            if c["kind"] in ("elementwise", "delay"):
                assert c["bytes"] == jrows[n]["bytes"], n
        assert r["floor_bytes"] == pytest.approx(sum(
            c["bytes"] - c["w_bytes"] / 2 for _, c in rows))
        assert r["floor_us"] == pytest.approx(
            r["floor_bytes"] / tlog.H100_HBM_BPS * 1e6)
    # the slicer off: the same stages and bytes, the bits not emitted
    assert res["stereo+rds-nobits"]["floor_bytes"] == \
        res["stereo+rds"]["floor_bytes"]


def test_mode_floors_keys_and_floors():
    res = mode_floors.run(channels=2, blocks=1, min_measure=0.0,
                          device="cpu")
    assert list(res) == ["mode0", "mode1", "mode2", "mode3"]
    for mode in range(4):
        r = res[f"mode{mode}"]
        assert set(r) == KEYS_MF and r["device"] == "cpu"
        cfg = mode_config(mode)
        assert r["block_ms_of_signal"] == pytest.approx(
            cfg.block_size_iq / cfg.rf_fs * 1e3)
        sol = tlog.speed_of_light_report(
            Receiver(mode, stereo=True, rds=True, pll_tier=3),
            file=open(os.devnull, "w"), channels=2, blocks=1)
        assert r["floor_us"] == pytest.approx(sol["floor_s"] * 1e6)
        assert r["pct_of_floor"] == pytest.approx(
            100 * r["floor_us"] / r["us_per_blk_ch"])


# -- (f) the trace ranking ----------------------------------------------------

def test_rank_kernels_on_a_cpu_profile(tmp_path, capsys):
    x = torch.randn(64, 256)

    def run():
        for _ in range(3):
            (x @ x.T).relu_().sum()

    prof = tracekit.profile_reps(str(tmp_path), run, "cpu")
    assert (tmp_path / "cpu.json").exists()
    res = tracekit.rank_kernels(prof, reps=3, top=4, header="cpu: ",
                                wall_ms=1e9)
    out = capsys.readouterr().out
    assert out.startswith("# cpu: 3 reps; CPU self time (no device records)")
    assert len(out.splitlines()) == 5
    assert res["clock"] == "cpu" and res["product"] is None
    us = [r["us_per_call"] for r in res["rows"]]
    assert us == sorted(us, reverse=True) and us[0] > 0
    assert sum(r["share"] for r in res["rows"]) == pytest.approx(1.0)
    assert res["busy_ms"] == pytest.approx(sum(us) / 1e3)
    assert 0.0 < res["idle_share"] <= 1.0
    assert {"aten::mm", "aten::relu_"} <= {r["name"] for r in res["rows"]}
    assert not any(r["name"].startswith("ProfilerStep")
                   for r in res["rows"])


def test_rank_kernels_on_a_chrome_trace(tmp_path, capsys):
    """A trace on disk is ranked by its device events only (kernels,
    copies), per call of the window's reps; the newest trace of a
    directory is read."""
    ev = [dict(ph="X", cat="kernel", name="fir_bank_tiled", dur=30.0),
          dict(ph="X", cat="kernel", name="fir_bank_tiled", dur=30.0),
          dict(ph="X", cat="kernel", name="sgemm", dur=100.0),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", dur=20.0),
          dict(ph="X", cat="cpu_op", name="aten::mm", dur=500.0),
          dict(ph="X", cat="gpu_user_annotation", name="ProfilerStep#1",
               dur=900.0),
          dict(ph="i", cat="kernel", name="marker")]
    (tmp_path / "old.json").write_text(json.dumps({"traceEvents": []}))
    os.utime(tmp_path / "old.json", (0, 0))
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": ev}))
    res = tracekit.rank_kernels(str(tmp_path), reps=2, top=2)
    assert [(r["name"], r["us_per_call"], r["calls_per_call"])
            for r in res["rows"]] == [("sgemm", 50.0, 0.5),
                                      ("fir_bank_tiled", 30.0, 1.0),
                                      ("Memcpy HtoD", 10.0, 0.5)]
    assert res["busy_ms"] == pytest.approx(0.09) and res["idle_share"] is None
    assert len(capsys.readouterr().out.splitlines()) == 3
    with pytest.raises(ValueError, match="no device events"):
        tracekit.rank_kernels(str(tmp_path / "old.json"), reps=1)


# -- the entry points ---------------------------------------------------------

MAIN_ARGS = dict(
    wideband64=["--stations", "4", "--seg", "1", "--reps", "1"],
    retune_latency=["--stations", "2", "--seg", "1", "--reps", "1"],
    stage_decompose=["--channels", "2", "--blocks", "1", "--min-measure",
                     "0"],
    mode_floors=["--channels", "2", "--blocks", "1", "--min-measure", "0"],
    trace_top=["--mode", "0", "--channels", "2", "--blocks", "1", "--reps",
               "1", "--top", "3"],
    trace_wideband=["--stations", "2", "--seg", "1", "--reps", "1",
                    "--top", "3"],
    e2e_latency=["--pll-tier", "3"])
MAIN_LINES = dict(
    wideband64=[r"# frontend: fused one-matmul demod \(lo=8, R=8, f32, "
                r"K_eq 1003\)",
                r"# 4 stations from one 19.2 MS/s capture \(1-block "
                r"segments, 1 reps\): .* ms/block"],
    retune_latency=[r"# retune->decoded latency over steady serving: p50",
                    r"outputs equal to the runs with no retune: True"],
    stage_decompose=[r"^stereo\+rds-nobits +\{"],
    mode_floors=[r"^mode3  \{"],
    trace_top=[r"^# mode 0 2x1: 1 reps; CPU self time"],
    trace_wideband=[r"^# wideband 2st seg1 fused: 1 reps; CPU self time"],
    e2e_latency=[r"^paced: p50 [\d.]+ ms, p99 [\d.]+ ms beside the 30.62 "
                 r"ms block deadline on cpu", r"^dropped \d+ input blocks"])


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_main_on_cpu(name, tmp_path, monkeypatch, capsys):
    if name == "e2e_latency" and not native_io.available():
        pytest.skip("the native I/O library (make -C native) does not load")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    assert MODULES[name].main(["--cpu", *MAIN_ARGS[name]]) == 0
    out = capsys.readouterr().out
    for pat in MAIN_LINES[name]:
        assert re.search(pat, out, re.M), (pat, out[-2000:])
    if name in ("stage_decompose", "mode_floors", "trace_top",
                "trace_wideband"):
        assert json.loads(out[out.rindex("\n{") + 1:])


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_main_without_a_card_exits_2(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert MODULES[name].main([]) == 2
    assert "pass --cpu" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_wideband_entry_refuses_the_two_stage_path_above_64(capsys):
    assert wideband64.main(["--cpu", "--path", "u8", "--stations", "65"]) == 2
    assert trace_wideband.main(["--cpu", "--path", "u8", "--stations",
                                "65"]) == 2
    assert capsys.readouterr().err.count("at most 64") == 2


def test_no_module_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|real_time_sdr_tpu[. ]|"
                     r"real_time_sdr_tpu$|golden)")
    files = sorted(f for f in os.listdir(PKG) if f.endswith(".py"))
    assert len(files) == 1 + len(EXPERIMENTS) + 1        # + tracekit
    for f in files:
        with open(os.path.join(PKG, f)) as fh:
            bad = [ln for ln in fh if pat.match(ln)]
        assert not bad, (f, bad)


def test_experiments_run_without_jax():
    """Importing every experiment module and running one on the CPU loads
    no jax, no module of the JAX package and no ``golden`` (a subprocess:
    this test process imported all three)."""
    code = textwrap.dedent("""
        import sys
        from real_time_sdr_tpu_torch.experiments import (
            e2e_latency, mode_floors, retune_latency, stage_decompose,
            trace_top, trace_wideband, tracekit, wideband64)
        assert retune_latency.main(["--cpu", "--stations", "2", "--seg",
                                    "1", "--reps", "1"]) == 0
        bad = [m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "real_time_sdr_tpu.", "golden"))
            or m == "real_time_sdr_tpu"]
        assert not bad, bad
        print("ok")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == "ok"
