"""The listener cell (traffic ``kind`` ``paced_listeners``): one-tuner
listeners, each the CLI's one-station path (``real_time_sdr_tpu_torch.cli``
``main``, ``_serve``) in a process of its own (``listener_child``), as a
tuner's demodulator is deployed: ``rtl_sdr | <demodulator> | aplay``. This
process never touches the card, so with one listener one process uses it.

Each listener has its own station (content from the seed), made here on
the host, and its own input and output FIFOs. The listeners start one
after another (each warms up, capturing its CUDA graph, and then waits on
its input); then a feeder process writes every listener's blocks on a
fixed schedule, one block period apart (the tuner's block time over
``rate_x``; 1: live), the listeners' phases staggered across one period
(open loop), and a reader process stamps each block of
PCM as it arrives. Each listener's standard error is stamped here line by
line as it arrives (its RDS events and its ``--stats`` block times).

``listener_p95_ms``: the 95th percentile, over every block of every
listener due inside the window, of its PCM's arrival at the reader less
the time its last byte left the tuner: the time it was due, plus the
feeder's own lateness in writing it (the harness's, not the program's;
a program that leaves its input pipe full still waits in the latency).
A block that never arrives is ``failed``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

from portbench.core import check, fifos
from portbench.traffic import generator

# the listener's process: ``python -m <CHILD...> <result> <trace> ...``
CHILD = ["portbench.core.listener_child"]


class _Lines:
    """Every listener's stderr lines, each with its arrival time."""

    def __init__(self):
        self.lines: list[tuple[float, int, str]] = []
        self.lock = threading.Lock()
        self.threads: list[threading.Thread] = []

    def follow(self, k: int, stream) -> None:
        def pump():
            for raw in stream:
                t = time.monotonic()
                with self.lock:
                    self.lines.append(
                        (t, k, raw.decode(errors="replace").rstrip("\n")))
        th = threading.Thread(target=pump, daemon=True)
        th.start()
        self.threads.append(th)

    def wrote(self, k: int, prefix: str) -> bool:
        with self.lock:
            return any(j == k and s.startswith(prefix)
                       for _, j, s in self.lines)


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool, t_process: float) -> dict:
    import torch
    from real_time_sdr_tpu_torch.utils import native_io

    cfg, tr = cell.config, cell.traffic
    rx, cli_cfg = cfg["receiver"], cfg["cli"]
    n = tr["listeners"]
    blk = 2 * rx["block_size_iq"]
    period = rx["block_size_iq"] / rx["rf_fs"] / tr["rate_x"]
    stations = generator.draw_stations(seed, n, tr["rt_chars"])
    captures = [generator.capture([st], [0], rx["rf_fs"],
                                  tr["capture_groups"], tr["iq_level"],
                                  torch.device("cpu"))
                for st in stations]
    native_io.available()             # builds the I/O library once, here

    work = fifos.workdir()
    ins = fifos.make_fifos(work, [f"in_{k}.u8" for k in range(n)])
    outs = fifos.make_fifos(work, [f"out_{k}.pcm" for k in range(n)])
    audio_block = rx["block_size_iq"] // rx["rf_decim"] \
        * rx["audio_up"] // rx["audio_down"]
    plan = check.sample_plan(seed, n, [], min(n, tr["sampled"]),
                              tr["keep_every"])
    offsets = [k * period / n for k in range(n)]
    at_s = min(tr["trace_at_s"], seconds / 3)
    len_s = min(tr["trace_len_s"], seconds / 3)
    reader = fifos.Helper("reader", dict(
        paths=outs, files=False, block_bytes=4 * audio_block,
        keep={str(k): list(v) for k, v in plan.items()}), root=cell.root)
    feeder = fifos.Helper("feeder", dict(
        fifos=ins, nbytes=captures[0].shape[0],
        block_bytes=blk, period_s=period, offsets_s=offsets,
        seconds=seconds, tail_blocks=tr["tail_blocks"]),
        payload=[c.tobytes() for c in captures], root=cell.root)
    lines = _Lines()
    procs: list[subprocess.Popen] = []
    results = [os.path.join(work, f"child_{k}.json") for k in range(n)]
    try:
        reader.wait_ready()
        feeder.wait_ready()
        for k in range(n):
            argv = [str(rx["mode"]), tr["service"], "--input", ins[k],
                    "--output", outs[k],
                    "--pll-tier", str(cli_cfg["pll_tier"]),
                    "--segment", str(cli_cfg["segment"]),
                    "--pipeline", str(cli_cfg["pipeline"]),
                    "--stats", "--warmup"]
            if device.type != "cuda":
                argv.append("--cpu")
            p = subprocess.Popen(
                [sys.executable, "-m", *CHILD, results[k], str(int(trace)), str(at_s), str(len_s), "--",
                 *argv], stderr=subprocess.PIPE, cwd=cell.root,
                env=dict(os.environ, PYTHONUNBUFFERED="1"))
            procs.append(p)
            lines.follow(k, p.stderr)
            _wait_warm(lines, k, p, tr["settle_s"])
        feeder.send("go")
        for p in procs:
            p.wait(timeout=seconds + 120)
        for th in lines.threads:
            th.join(timeout=30)
        fed = feeder.result()
        reader.send("stop")
        got = reader.result()
        kids = []
        for k, p in enumerate(procs):
            if p.returncode != 0 or not os.path.exists(results[k]):
                kids.append(dict(rc=p.returncode or 1, trace=None,
                                 t_start=None, memory_peak_bytes=0,
                                 forbidden=[]))
                continue
            with open(results[k]) as f:
                kids.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        feeder.kill()
        reader.kill()
        shutil.rmtree(work, ignore_errors=True)
    t0 = fed["t0"]
    t_end = t0 + seconds
    # host-clock readings of a traced run: before its profiler records
    starts = [c["t_start"] for c in kids if c.get("t_start")]
    t_host = min([t_end] + starts)
    lat, host_lat, failed, due_in, from_due = [], [], 0, {}, []
    for k in range(n):
        arr = np.frombuffer(got["times"][k], dtype=np.float64)
        due = t0 + offsets[k] + period * (1 + np.arange(fed["blocks"]))
        left = due + fifos.own_lag(fed["lag"][k], due.shape[0])
        due_in[k] = int((due <= t_end).sum())
        m = min(due_in[k], arr.shape[0])
        lat.extend((arr[:m] - left[:m]).tolist())
        host_lat.extend((arr[:m] - left[:m])[due[:m] <= t_host].tolist())
        from_due.extend((arr[:m] - due[:m]).tolist())
        failed += due_in[k] - m
    lat_ms = np.asarray(lat) * 1e3
    traces = [c["trace"] for c in kids if c.get("trace")]
    records = dict(
        latency_ms=(np.asarray(host_lat) * 1e3).tolist(),
        block_ms=[float(s.split(":")[1].split("ms")[0])
                  for t, _, s in lines.lines
                  if s.startswith("block ") and t0 <= t <= t_host],
        trace=traces[0] if len(traces) == 1 else None)

    numbers = check.pcm_numbers(
        rx, check.choose(seed, got["kept"], lambda s, j: j < due_in[s]),
        check.listener_demod_of(cfg, captures), control=control)
    groups, names = _rds_events(lines.lines)
    (numbers["rds_wrong"], numbers["rds_wrong_streams"],
     numbers["rds_miscorrected_pct"]) = check.rds_wrong(
        stations, groups, names, t0 + seconds / 2)
    lags = np.concatenate([np.asarray(x) for x in fed["lag"]]) * 1e3
    done = np.concatenate([np.asarray(x) for x in fed["done"]]) * 1e3
    return dict(
        rc=max(abs(c["rc"]) for c in kids), t0=t0,
        setup_s=t0 - t_process, numbers=numbers,
        attempted=sum(due_in.values()), failed=failed,
        e2e=dict(listener_p95_ms=(float(np.percentile(lat_ms, 95))
                                  if lat_ms.size else None)),
        records=records,
        memory_peak_bytes=max(c["memory_peak_bytes"] for c in kids),
        device_kind=kids[0].get("device_kind"),
        forbidden=sorted({m for c in kids for m in c["forbidden"]}),
        notes=dict(generator_lag_ms_p99=float(np.percentile(lags, 99)),
                   generator_lag_ms_max=float(lags.max()),
                   write_done_ms_p99=float(np.percentile(done, 99)),
                   blocks=int(lat_ms.size),
                   p95_from_due_ms=(float(np.percentile(from_due, 95)) * 1e3
                                    if from_due else None),
                   reader_full_reads=got["full_reads"],
                   trace_start_s=kids[0].get("start_s"),
                   **_thirds(lat, due_in, n)))


def _thirds(lat: list, due_in: dict, n: int) -> dict:
    """The median latency of the first and of the last third of each
    listener's blocks in the window: a backlog that grows shows as the
    last above the first."""
    first, last, i = [], [], 0
    for k in range(n):
        m = due_in[k]
        own = lat[i:i + m]
        i += m
        first += own[:m // 3]
        last += own[m - m // 3:]
    med = (lambda v: float(np.median(v)) * 1e3 if v else None)
    return dict(p50_first_third_ms=med(first), p50_last_third_ms=med(last))


def _wait_warm(lines: _Lines, k: int, proc: subprocess.Popen,
               settle_s: float, timeout: float = 600.0) -> None:
    """Wait for listener k's ``warmed up`` line, then ``settle_s`` more:
    it then waits on its input, and the next one's graph capture runs
    alone on the card."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end and proc.poll() is None:
        if lines.wrote(k, "warmed up"):
            time.sleep(settle_s)
            return
        time.sleep(0.02)
    raise RuntimeError(f"listener {k} did not warm up "
                       f"(exit {proc.poll()}): "
                       + " | ".join(s for _, j, s in lines.lines[-20:]
                                    if j == k))


def _rds_events(lines) -> tuple[dict, dict]:
    """Per listener, the decoded groups' (time, PI) from ``PI: <hex>``
    lines and the names from ``Program Service: NAME`` lines."""
    groups: dict[int, list] = {}
    names: dict[int, list] = {}
    for t, k, s in lines:
        if s.startswith("PI: "):
            groups.setdefault(k, []).append((t, int(s[4:], 16)))
        elif s.startswith("Program Service: "):
            names.setdefault(k, []).append(s[len("Program Service: "):])
    return groups, names
