"""CPU rehearsals of each cell's code path at a tiny size, in a throwaway
copy of the benchmark whose added cells are files and manifest entries
only; the control and the planted faults come out not correct; the
exits without a card and without the program."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.core.manifest import PKG, ROOT
from portbench.tests.rehearsal import run_cell, tiny_checkout

SEED = "3000000001"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_checkout(str(tmp_path_factory.mktemp("tiny")))


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    for name, c in res["checks"].items():
        assert f"check {name} " in proc.stderr
        assert set(c) == {"value", "limit"}
    return res


def test_throwaway_cell_leaves_every_file_as_it_was(tiny):
    cmp = filecmp.dircmp(PKG, os.path.join(tiny, "portbench"),
                         ignore=["__pycache__", ".cache"])

    def same(d):
        assert not d.diff_files and not d.left_only, (d.left, d.diff_files)
        for sub in d.subdirs.values():
            same(sub)
    same(cmp)
    assert cmp.right_only == [] or all(
        n.startswith("tiny") for n in cmp.right_only)


@pytest.mark.parametrize("cell,trace,secs", [("tiny.audio", "0", "6"),
                                             ("tiny.audio", "1", "6"),
                                             ("tiny.band", "0", "36")])
def test_band_rehearsal(tiny, cell, trace, secs):
    res = _result(run_cell(tiny, "--workload", cell, "--seed", SEED,
                           "--seconds", secs, "--trace", trace, "--cpu"))
    assert res["correct"] is True, res
    assert res["device"]["platform"] == "cpu"
    if trace == "0":
        assert set(res["metrics"]) == {"band_latency_p95_ms", "setup_s"}
    else:
        # no device metric from a CPU run
        assert set(res["metrics"]) == {"cli_segment_ms"}
        assert "breakdown" not in res


def test_listener_rehearsal(tiny):
    res = _result(run_cell(tiny, "--workload", "tiny.listeners", "--seed",
                           SEED, "--seconds", "1", "--cpu"))
    assert set(res["metrics"]) == {"listener_p95_ms", "setup_s"}
    assert res["attempted"] >= 30 and res["failed"] == 0
    c = res["checks"]["pcm_rel_err_median"]
    assert c["value"] < c["limit"]


@pytest.mark.parametrize("cell", ["tiny.audio", "tiny.listeners"])
def test_control_is_not_correct(tiny, cell):
    secs = "1" if cell == "tiny.listeners" else "6"
    res = _result(run_cell(tiny, "--workload", cell, "--seed", SEED,
                           "--seconds", secs, "--cpu", "--control"))
    assert res["correct"] is False
    c = res["checks"]["pcm_rel_err_median"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault,cell,secs", [
    ("state", "tiny.audio", "6"), ("half", "tiny.audio", "6"),
    ("answer", "tiny.audio", "6"), ("ps", "tiny.band", "36"),
    ("state", "tiny.listeners", "1"), ("answer", "tiny.listeners", "1")])
def test_planted_fault_is_not_correct(tiny, fault, cell, secs):
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.tests.faulty", fault,
         "--workload", cell, "--seed", SEED, "--seconds", secs, "--cpu"],
        cwd=tiny, capture_output=True, text=True, timeout=600)
    res = _result(proc)
    assert res["correct"] is False, res


def test_unknown_traffic_kind_fails(tiny):
    """A mix whose ``kind`` names no ``portbench/core/<kind>.py`` fails
    before any run: no runner is picked for it by default."""
    with open(os.path.join(tiny, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(tiny, "portbench", "traffic",
                           "tiny_nokind.json"), "w") as f:
        json.dump({"kind": "nonesuch"}, f)
    bench["workloads"].append(dict(name="tiny.nokind", config="tiny_band",
                                   traffic="tiny_nokind", chips=1,
                                   why="CPU rehearsal"))
    shutil.copy(os.path.join(tiny, "portbench", "limits", "tiny.band.json"),
                os.path.join(tiny, "portbench", "limits",
                             "tiny.nokind.json"))
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    proc = run_cell(tiny, "--workload", "tiny.nokind", "--seed", SEED,
                    "--seconds", "1", "--cpu")
    assert proc.returncode == 5 and proc.stdout.strip() == ""
    assert "names no runner" in proc.stderr


def test_exits_2_without_a_card(tiny):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = run_cell(tiny, "--workload", "tiny.audio", "--seed", SEED,
                    "--seconds", "1")
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = run_cell(str(tmp_path), "--workload", "band64.rds_paced", "--seed",
                    SEED, "--seconds", "1", "--cpu")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
