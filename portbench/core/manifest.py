"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness reads ``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json`` and ``portbench/limits/<cell>.json``,
and each per-layer metric's reader ``portbench/metrics/<metric>.py``.
Adding a cell, a configuration, a mix or a metric adds files and entries;
no file that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "portbench")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: dict, name: str, root: str = ROOT):
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(by_name)})")
        self.workload = by_name[name]
        self.name = name
        self.root = root
        pkg = os.path.join(root, "portbench")
        cfgs = {c["name"]: c for c in manifest["configs"]}
        entry = cfgs[self.workload["config"]]
        self.config = _json(os.path.join(root, entry["file"]))
        self.traffic = _json(os.path.join(
            pkg, "traffic", self.workload["traffic"] + ".json"))
        self.limits = _json(os.path.join(pkg, "limits", name + ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]


def metric_reader(name: str, root: str = ROOT):
    """The ``read(records)`` function of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
