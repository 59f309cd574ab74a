"""Each cell on the card, briefly: a result line, correct, the device
named. Marked ``cuda``; skips without a card (decided in the fixture).
On the card: ``python -m pytest -q portbench/tests -m cuda``."""

from __future__ import annotations

import json

import pytest

from portbench.core import manifest
from portbench.tests.rehearsal import run_cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_cell_on_the_card(card, cell):
    proc = run_cell(manifest.ROOT, "--workload", cell, "--seed",
                    "2147483713", "--seconds", "4")
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
