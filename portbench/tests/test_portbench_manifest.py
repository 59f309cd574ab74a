"""The manifest and the files it names: names and units in the allowed
characters, every configuration, traffic mix, limit file and metric
reader found by name, each cell reporting what it must."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.core import manifest

B = manifest.load()
PB = manifest.PKG
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(B["command"]) <= 32
    for word in B["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word


def test_names_units_and_lengths():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert manifest.NAME_RE.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert manifest.UNIT_RE.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    assert LINE.match(e[key]), (e["name"], key)
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for g in ("configs", "workloads"):
        ns = [n for gg, n in names if gg == g]
        assert len(ns) == len(set(ns))
    assert len(json.dumps(B)) < 64 * 1024


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_files_found_by_name(cell):
    c = manifest.Cell(B, cell)
    from portbench.run import _runner
    assert callable(_runner(c.traffic["kind"]).run)
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_each_config_used_and_under_paths():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        assert os.path.isfile(os.path.join(manifest.ROOT, c["file"]))
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))


def test_file_names_from_name_characters():
    for dirpath, _, files in os.walk(PB):
        if "__pycache__" in dirpath or ".cache" in dirpath:
            continue
        for f in files:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f
