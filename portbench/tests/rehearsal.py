"""A throwaway copy of the benchmark with small cells, for the CPU tests:
the checkout's ``BENCHMARK.json`` and ``portbench/`` copied into a
temporary directory beside links to the program, and tiny band cells and
a tiny listener cell added as files and manifest entries only. The tiny
band cells feed their capture slower than live (``rate_x``), at a pace
the CPU keeps."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench.core.manifest import ROOT

PROGRAM = ("real_time_sdr_tpu_torch", "native")


def tiny_checkout(dst: str) -> str:
    """Copy the benchmark into ``dst`` with the cells ``tiny.band``,
    ``tiny.audio`` and ``tiny.listeners`` added; returns ``dst``."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for name in PROGRAM:
        os.symlink(os.path.join(ROOT, name), os.path.join(dst, name))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = os.path.join(dst, "portbench")

    def put(rel: str, obj) -> None:
        with open(os.path.join(pb, rel), "w") as f:
            json.dump(obj, f)

    def get(rel: str) -> dict:
        with open(os.path.join(pb, rel)) as f:
            return json.load(f)

    band = get("configs/fm_band_64st.json")
    band.update(name="tiny_band",
                band=dict(band["band"], stations=2, wide_fs=4_800_000),
                cli=dict(band["cli"], segment=2, pipeline=1))
    put("configs/tiny_band.json", band)
    put("configs/tiny_listener.json", dict(
        get("configs/listener_mode0.json"), name="tiny_listener"))
    for mix, service, rate in (("tiny_paced_band", "r", 0.025),
                               ("tiny_paced_audio", "s", 0.05)):
        put(f"traffic/{mix}.json", dict(
            get("traffic/band_paced_rds.json"), service=service, rt_chars=0, rate_x=rate,
            sampled=2, keep_every=1, tail_blocks=8, trace_at_s=0.5,
            trace_len_s=0.5))
    put("traffic/tiny_paced.json", dict(
        get("traffic/paced_listeners.json"), listeners=1, sampled=1,
        keep_every=1, trace_at_s=0.5, trace_len_s=0.5))
    band_limits = get("limits/band64.rds_paced.json")
    put("limits/tiny.band.json", band_limits)
    put("limits/tiny.audio.json",
        {"pcm_rel_err_median": band_limits["pcm_rel_err_median"]})
    put("limits/tiny.listeners.json", get("limits/listeners.paced.json"))
    for cell, cfg, mix, like in (
            ("tiny.band", "tiny_band", "tiny_paced_band", "band64.rds_paced"),
            ("tiny.audio", "tiny_band", "tiny_paced_audio",
             "band64.rds_paced"),
            ("tiny.listeners", "tiny_listener", "tiny_paced",
             "listeners.paced")):
        bench["workloads"].append(dict(name=cell, config=cfg, traffic=mix,
                                       chips=1, why="CPU rehearsal"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    bench["configs"] += [
        dict(name="tiny_band", source="test", reduced=["band"], why="test",
             file="portbench/configs/tiny_band.json"),
        dict(name="tiny_listener", source="test", reduced=[], why="test",
             file="portbench/configs/tiny_listener.json")]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def run_cell(checkout: str, *args: str, timeout: float = 600.0,
             env: dict | None = None):
    """``python3 -m portbench.run <args>`` in ``checkout``; returns the
    completed process (stdout and stderr as text)."""
    return subprocess.run([sys.executable, "-m", "portbench.run", *args],
                          cwd=checkout, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, **(env or {})))
