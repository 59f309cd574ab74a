"""What the benchmark imports, by whole top-level module name: nothing of
JAX or of the JAX package (``real_time_sdr_tpu``; the port,
``real_time_sdr_tpu_torch``, begins with its name) in anything the
harness runs, and nothing of the program in the reference."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from portbench.core.manifest import PKG, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "real_time_sdr_tpu", "golden"}
PROGRAM = "real_time_sdr_tpu_torch"


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def _sources(sub: str = "") -> list[str]:
    out = []
    for dirpath, _, files in os.walk(os.path.join(PKG, sub)):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(
    p, PKG))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    tops = _imports(path)
    assert PROGRAM not in tops
    assert tops <= {"__future__", "numpy", "portbench"}


def test_harness_modules_load_without_jax():
    code = ("import sys, portbench.run, portbench.core.band_paced, "
            "portbench.core.paced_listeners, "
            "portbench.core.listener_child, portbench.core.check, "
            "portbench.traffic.generator, portbench.reference.chain\n"
            "from portbench.core import manifest\n"
            "for m in manifest.load()['per_layer']:\n"
            "    manifest.metric_reader(m['name'])\n"
            "import real_time_sdr_tpu_torch.cli\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN


def test_reference_loads_without_the_program():
    code = ("import sys, portbench.reference.chain, "
            "portbench.reference.filters\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert PROGRAM not in loaded and not loaded & FORBIDDEN


def test_forbidden_by_whole_top_level_name():
    from portbench import run
    assert run.forbidden_modules() == []
    try:
        sys.modules["real_time_sdr_tpu_torch_x"] = sys
        assert run.forbidden_modules() == []
        sys.modules["real_time_sdr_tpu.config"] = sys
        assert run.forbidden_modules() == ["real_time_sdr_tpu"]
    finally:
        sys.modules.pop("real_time_sdr_tpu_torch_x", None)
        sys.modules.pop("real_time_sdr_tpu.config", None)
