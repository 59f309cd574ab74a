"""The tuner-bank cell (``tuners32.staged``, traffic kind
``paced_tuners``) rehearsed on the CPU on a small throwaway cell: three
tuners of the cell's configuration, fed slower than live (1/40 of a
tuner's rate: the CPU's tier-1 loop takes about a second a block), in a
copy of the benchmark whose added cell is files and manifest entries
only. The program comes out correct, with the cell's end-to-end metrics,
and traced with its span metrics (no device metric from a CPU run); the
control and a planted fault that swaps two tuners' outputs come out not
correct. The reader's own lateness is in the notes of every run. Also:
the frozen front-end arithmetic (``_costs_tuners``) against the port's
own ``cost()`` report at the cell's shape."""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import pytest

from portbench.core.manifest import PKG
from portbench.tests.rehearsal import run_cell, tiny_checkout

SEED = "3000000001"
SECONDS = "36"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SPAN_METRICS = {"skew_wait_ms.tuners", "submit_ms.tuners", "drain_ms.tuners"}

with open(os.path.join(PKG, "configs", "tuners32_mode0.json")) as _f:
    CFG = json.load(_f)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``tiny_checkout`` with the cell ``tiny.tuners`` added: three tuners,
    a tier-1 bank of 4-block segments, fed at 1/40 of live."""
    dst = tiny_checkout(str(tmp_path_factory.mktemp("tiny_tuners")))
    pb = os.path.join(dst, "portbench")
    with open(os.path.join(pb, "traffic", "paced_tuners.json")) as f:
        traffic = json.load(f)
    for rel, obj in (
            ("configs/tiny_tuners.json", dict(CFG, name="tiny_tuners",
                                              tuners=3)),
            ("traffic/tiny_paced_tuners.json", dict(
                traffic, tuners=3, sampled=3, keep_every=1, rate_x=0.025,
                rt_chars=0,
                trace_at_s=20.0, trace_len_s=2.0)),
            ("limits/tiny.tuners.json", json.load(open(os.path.join(
                PKG, "limits", "tuners32.staged.json"))))):
        with open(os.path.join(pb, rel), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tiny_tuners", source="test",
                                 reduced=["tuners"], why="test",
                                 file="portbench/configs/tiny_tuners.json"))
    bench["workloads"].append(dict(name="tiny.tuners", config="tiny_tuners",
                                   traffic="tiny_paced_tuners", chips=1,
                                   why="CPU rehearsal"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tuners32.staged" in m.get("workloads", []):
            m["workloads"].append("tiny.tuners")
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert set(res["checks"]) == {"pcm_rel_err_median", "rds_wrong"}
    return res


@pytest.mark.parametrize("trace", ["0", "1"])
def test_tuner_rehearsal(tiny, trace):
    res = _result(run_cell(tiny, "--workload", "tiny.tuners", "--seed",
                           SEED, "--seconds", SECONDS, "--trace", trace,
                           "--cpu"))
    assert res["correct"] is True, res
    assert res["device"]["platform"] == "cpu"
    assert res["failed"] == 0 and res["attempted"] >= 3 * 25
    lag = [res["notes"][f"reader_lag_ms_{q}"] for q in ("p50", "p95", "max")]
    assert 0 <= lag[0] <= lag[1] <= lag[2]
    assert res["notes"]["reader_probe_blocks"] >= 25
    if trace == "0":
        assert set(res["metrics"]) == {"listener_p95_ms", "setup_s"}
    else:
        assert set(res["metrics"]) == SPAN_METRICS
        assert "breakdown" not in res
        assert all(v["value"] >= 0 for v in res["metrics"].values())


def test_control_is_not_correct(tiny):
    res = _result(run_cell(tiny, "--workload", "tiny.tuners", "--seed",
                           SEED, "--seconds", SECONDS, "--cpu",
                           "--control"))
    assert res["correct"] is False
    c = res["checks"]["pcm_rel_err_median"]
    assert c["value"] > c["limit"]


def test_swapped_tuners_are_not_correct(tiny):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.tests.faulty_tuners",
         "--workload", "tiny.tuners", "--seed", SEED, "--seconds", SECONDS,
         "--cpu"], cwd=tiny, capture_output=True, text=True, timeout=600)
    res = _result(proc)
    assert res["correct"] is False, res
    assert res["checks"]["rds_wrong"]["value"] >= 2
    c = res["checks"]["pcm_rel_err_median"]
    assert c["value"] > c["limit"]


def test_frontend_floor_matches_the_ports_report():
    from real_time_sdr_tpu_torch.models.receiver import Receiver
    from real_time_sdr_tpu_torch.utils.logging import speed_of_light_report

    from portbench.metrics import _costs, _costs_tuners
    rx = functools.partial(Receiver, device="cpu")(
        0, stereo=True, rds=True, pll_tier=CFG["cli"]["pll_tier"])
    with open(os.devnull, "w") as sink:
        rep = speed_of_light_report(rx, file=sink, channels=CFG["tuners"],
                                    blocks=CFG["cli"]["segment"])
    c = _costs_tuners.frontend_launch(CFG)
    assert _costs.floor_s(c["flops"], c["bytes"]) * 1e3 == pytest.approx(
        rep["kernels"]["frontend_fused"]["floor_ms"], rel=1e-9)
    n2 = CFG["cli"]["segment"] * 2 * CFG["receiver"]["block_size_iq"]
    cost = rx.frontend.cost(n2)
    assert c["flops"] == CFG["tuners"] * cost["flops"]
    assert c["bytes"] == CFG["tuners"] * (cost["bytes"] - cost["w_bytes"]) \
        + cost["w_bytes"]
