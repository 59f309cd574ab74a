"""Trace-profiling helpers shared by ``trace_top`` and ``trace_wideband``.

Port of ``experiments/tracekit.py``. ``profile_reps`` records a warm
window of a step under torch.profiler (``utils.logging.device_trace``
with ``warmup=1``: the window's call is the second of two, so none of its
first device records go missing) and writes its Chrome trace;
``rank_kernels`` ranks the recorded ops by total time and prints the top
ones with their share of the busy time and the idle share of the run.

    prof = profile_reps(trace_dir, run)          # run() = R warm reps
    rank_kernels(prof, reps=R, top=20, wall_ms=R * ms_per_run)

On the card the ranking is by device time (``device_busy`` sums it, the
wideband fold product counted where the profiler left it unrecorded and
``product_ms`` is given); a profile with no device records (a CPU run) is
ranked by the CPU's own time, and says so. A Chrome trace on disk (a
file, or the newest ``*.json`` of a directory) is ranked by its device
events (kernels, copies, sets).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys

import torch

from real_time_sdr_tpu_torch.utils.logging import device_busy, device_trace

__all__ = ["profile_reps", "rank_kernels", "DEVICE_CATEGORIES"]

# the Chrome trace's categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_reps(trace_dir: str, run, name: str = "trace"):
    """Profile ``run()``, which runs the warm reps: once unrecorded, then
    once recorded (``device_trace(trace_dir, name, warmup=1)``, the trace
    written to ``trace_dir/<name>.json``), each call followed by a wait
    for the card. Returns the profiler, whose ``key_averages()`` hold the
    recorded call."""
    cuda = torch.cuda.is_available()
    with device_trace(trace_dir, name, warmup=1) as prof:
        run()
        if cuda:
            torch.cuda.synchronize()
        prof.step()             # the recorded window: the second call
        run()
        if cuda:
            torch.cuda.synchronize()
    return prof


def _trace_rows(path: str) -> tuple[dict, dict]:
    """(total us, calls) per device op name of a Chrome trace file, or of
    the newest ``*.json`` / ``*.json.gz`` under a directory."""
    if os.path.isdir(path):
        paths = [p for pat in ("*.json", "*.json.gz")
                 for p in glob.glob(os.path.join(path, "**", pat),
                                    recursive=True)]
        if not paths:
            raise ValueError(f"no Chrome trace under {path}")
        path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    totals: dict[str, float] = {}
    counts: dict[str, int] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = ev.get("name", "?")
        totals[name] = totals.get(name, 0.0) + float(ev.get("dur", 0.0))
        counts[name] = counts.get(name, 0) + 1
    if not totals:
        raise ValueError(f"{path} holds no device events")
    return totals, counts


def _profile_rows(averages) -> tuple[dict, dict, str]:
    """(self us, calls, clock) per op of ``key_averages()``: the device
    ops when there are any ("device"), else the CPU ops ("cpu"); the
    schedule's ``ProfilerStep`` annotations left out."""
    from torch.autograd import DeviceType
    rows = [e for e in averages if not e.key.startswith("ProfilerStep")]
    dev = [e for e in rows if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    if dev:
        return ({e.key: float(e.self_device_time_total) for e in dev},
                {e.key: e.count for e in dev}, "device")
    cpu = [e for e in rows if e.self_cpu_time_total > 0]
    return ({e.key: float(e.self_cpu_time_total) for e in cpu},
            {e.key: e.count for e in cpu}, "cpu")


def rank_kernels(source, reps: int, top: int = 20, header: str = "",
                 wall_ms: float | None = None,
                 product_ms: float | None = None, file=None) -> dict:
    """Rank the ops of ``source`` by total time and print the ``top``.

    ``source``: a profiler or its ``key_averages()`` (ranked by self
    device time, or by self CPU time where nothing ran on a card), or the
    path of a Chrome trace or of a directory holding traces (device events
    only). ``reps``: the step calls the window holds, so that times are per
    call. ``wall_ms``: the window's wall time on the host's clock, for the
    idle share; ``product_ms``: one fold product's device time, added
    (by ``device_busy``) where the profiler recorded none.

    Returns ``clock`` ("device" or "cpu"), ``busy_ms`` (per call: the
    summed time), ``idle_share`` (1 - busy over wall, None without
    ``wall_ms``), ``product`` (``device_busy``'s ``source``; None for a
    trace file or a CPU profile) and ``rows``: [{name, us_per_call,
    calls_per_call, share}] by total time, longest first, ``share`` of
    the summed time."""
    file = file or sys.stdout
    product = None
    if isinstance(source, (str, os.PathLike)):
        totals, counts = _trace_rows(os.fspath(source))
        clock = "device"
        busy_us = sum(totals.values())
    else:
        averages = (source.key_averages()
                    if hasattr(source, "key_averages") else source)
        totals, counts, clock = _profile_rows(averages)
        busy_us = sum(totals.values())
        if clock == "device":
            busy = device_busy(averages, product_ms)
            busy_us, product = busy["busy_ms"] * 1e3, busy["source"]
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    busy_ms = busy_us / 1e3 / reps
    idle = None if wall_ms is None else 1.0 - busy_us / 1e3 / wall_ms
    rows = [dict(name=name, us_per_call=tot / reps,
                 calls_per_call=counts[name] / reps,
                 share=tot / busy_us if busy_us else 0.0)
            for name, tot in sorted(totals.items(), key=lambda kv: -kv[1])]
    what = ("device total" if clock == "device"
            else "CPU self time (no device records)")
    print(f"# {header}{reps} reps; {what} {busy_us / 1e3:.3f} ms "
          f"({busy_ms:.4f} ms/run)"
          + ("" if idle is None else f", idle share {idle:.3f}")
          + ("" if product in (None, "none") else
             f"; matrix products: {product}"), file=file)
    for r in rows[:top]:
        print(f"{r['us_per_call']:10.1f} us/run  x{r['calls_per_call']:<6g}"
              f"{100 * r['share']:5.1f} %  {r['name'][:100]}", file=file)
    return dict(clock=clock, busy_ms=busy_ms, idle_share=idle,
                product=product, rows=rows)
