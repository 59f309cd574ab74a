"""The tuner-bank cell (traffic ``kind`` ``paced_tuners``): T free-running
tuners, one station each, decoded by one process, the CLI's multi-tuner
loop (``real_time_sdr_tpu_torch.cli`` ``--tuners``, ``run_tuners``), in a
process of its own (``listener_child``), as a monitoring server runs it:
many ``rtl_sdr -d <k>`` (or ``rtl_tcp``) feeds into one demodulator.

Each tuner has its own station (content from the seed), made here on the
card the run is given (on the CPU in a rehearsal) and held on the host,
and its own input FIFO. The CLI starts, warms up (capturing its graph)
and waits on its inputs; then a feeder process writes every tuner's
blocks on a fixed schedule, one block period apart (the tuner's block
time over ``rate_x``; 1: live), tuner k offset by k / T of a period (open
loop), and a reader process tails the tuners' PCM files in
``--output-dir`` and stamps each block as it arrives. The CLI's standard
error is stamped here line by line (its ``ch<k>`` RDS lines and its
``--stats`` segment times). A traced run also passes ``--trace-spans``
and reads the CLI's spans and counters into ``records["spans"]``.

``listener_p95_ms``: the 95th percentile, over every block of every tuner
due inside the window, of its PCM's arrival at the reader less the time
its last byte left the tuner (its due time plus the feeder's own
lateness), as in the listener cell. A block that never arrives is
``failed``.

The reader's own lateness is measured beside it: this process appends a
block to a file of its own among the reader's every period and stamps
each write, so the reader's stamp less the write's is how late its round
of reads finds a block (``reader_lag_ms_*`` in the notes; the reader
polls T + 1 files a round).

Correctness: sampled tuners' PCM blocks against the plain reference's
listener path (``portbench/reference/chain.py``, float64, each block
after ``WARM_BLOCKS`` blocks from zero history, ``check.pcm_numbers`` as
in the listener cell: the tuners never interact, so each is one
listener's chain), and every tuner's RDS PI and PS against what its
station sends (``check.rds_wrong``: a tuner that decodes another tuner's
PI is wrong).
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
from portbench.core.band_paced import _rds_events
from portbench.core.paced_listeners import _Lines, _thirds, _wait_warm
from portbench.traffic import generator

# the CLI's process: ``python -m <CHILD...> <result> <trace> ...``
CHILD = ["portbench.core.listener_child"]


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool, t_process: float) -> dict:
    import torch
    cfg, tr = cell.config, cell.traffic
    rx, cli_cfg = cfg["receiver"], cfg["cli"]
    n = tr["tuners"]
    blk = 2 * rx["block_size_iq"]
    period = rx["block_size_iq"] / rx["rf_fs"] / tr["rate_x"]
    stations = generator.draw_stations(seed, n, tr["rt_chars"])
    captures = [generator.capture([st], [0], rx["rf_fs"],
                                  tr["capture_groups"], tr["iq_level"],
                                  device) for st in stations]
    if device.type == "cuda":
        # the CLI's process is the only one working on the card
        torch.cuda.empty_cache()

    work = fifos.workdir()
    outdir = os.path.join(work, "out")
    os.mkdir(outdir)
    ins = fifos.make_fifos(work, [f"in_{k}.u8" for k in range(n)])
    # the tuners' PCM files, made empty here so that the reader holds
    # them open before the CLI opens (and truncates) them
    outs = [os.path.join(outdir, f"station_{k}.pcm") for k in range(n)]
    for p in outs:
        open(p, "wb").close()
    audio_block = rx["block_size_iq"] // rx["rf_decim"] \
        * rx["audio_up"] // rx["audio_down"]
    plan = check.sample_plan(seed, n, [], min(n, tr["sampled"]),
                             tr["keep_every"])
    offsets = [k * period / n for k in range(n)]
    at_s = min(tr["trace_at_s"], seconds / 3)
    len_s = min(tr["trace_len_s"], seconds / 3)
    probe = _Probe(os.path.join(work, "reader_probe.pcm"), 4 * audio_block,
                   period)
    reader = fifos.Helper("reader", dict(
        paths=outs + [probe.path], files=True, block_bytes=4 * audio_block,
        keep={str(k): list(v) for k, v in plan.items()}), root=cell.root)
    feeder = fifos.Helper("feeder", dict(
        fifos=ins, nbytes=captures[0].shape[0],
        block_bytes=blk, period_s=period, offsets_s=offsets,
        seconds=seconds, tail_blocks=tr["tail_blocks"]),
        payload=[c.tobytes() for c in captures], root=cell.root)
    lines = _Lines()
    result = os.path.join(work, "child.json")
    spans_path = os.path.join(work, "spans.json")
    proc = None
    try:
        reader.wait_ready()
        feeder.wait_ready()
        argv = [str(rx["mode"]), tr["service"], "--tuners", ",".join(ins),
                "--output-dir", outdir,
                "--pll-tier", str(cli_cfg["pll_tier"]),
                "--rds-timing", cli_cfg["rds_timing"],
                "--segment", str(cli_cfg["segment"]),
                "--pipeline", str(cli_cfg["pipeline"]),
                "--stats", "--warmup"]
        if trace:
            argv += ["--trace-spans", spans_path]
        if device.type != "cuda":
            argv.append("--cpu")
        proc = subprocess.Popen(
            [sys.executable, "-m", *CHILD, result, str(int(trace)),
             str(at_s), str(len_s), "--", *argv], stderr=subprocess.PIPE,
            cwd=cell.root, env=dict(os.environ, PYTHONUNBUFFERED="1"))
        lines.follow(0, proc.stderr)
        _wait_warm(lines, 0, proc, tr["settle_s"])
        # the clock of the spans' time stamps (time.time) against this one
        wall_off = time.time() - time.monotonic()
        probe.start()
        feeder.send("go")
        proc.wait(timeout=seconds + 120)
        for th in lines.threads:
            th.join(timeout=30)
        probe.close()
        fed = feeder.result()
        reader.send("stop")
        got = reader.result()
        if proc.returncode == 0 and os.path.exists(result):
            with open(result) as f:
                kid = json.load(f)
        else:
            kid = dict(rc=proc.returncode or 1, trace=None, t_start=None,
                       memory_peak_bytes=0, forbidden=[])
        spans = None
        if trace and os.path.exists(spans_path):
            with open(spans_path) as f:
                spans = json.load(f)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        probe.close()
        feeder.kill()
        reader.kill()
        shutil.rmtree(work, ignore_errors=True)
    if kid["rc"]:
        print("\n".join(s for *_, s in lines.lines[-20:]), file=sys.stderr)
    t0 = fed["t0"]
    t_end = t0 + seconds
    # the spans of a traced run: of the segments before its profiler
    t_host = min(t_end, kid.get("t_start") or t_end)
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
    records = dict(
        latency_ms=(np.asarray(host_lat) * 1e3).tolist(),
        trace=kid.get("trace"), config=cfg,
        spans=_segment_spans(spans, t0 + wall_off, t_host + wall_off))

    numbers = check.pcm_numbers(
        rx, check.choose(seed, got["kept"][:n], lambda s, j: j < due_in[s]),
        check.listener_demod_of(cfg, captures), control=control)
    groups, names = _rds_events(lines.lines)
    (numbers["rds_wrong"], numbers["rds_wrong_streams"],
     numbers["rds_miscorrected_pct"]) = check.rds_wrong(
        stations, groups, names, t0 + seconds / 2)
    lags = np.concatenate([np.asarray(x) for x in fed["lag"]]) * 1e3
    done = np.concatenate([np.asarray(x) for x in fed["done"]]) * 1e3
    return dict(
        rc=abs(kid["rc"]), t0=t0, setup_s=t0 - t_process, numbers=numbers,
        attempted=sum(due_in.values()), failed=failed,
        e2e=dict(listener_p95_ms=(float(np.percentile(lat_ms, 95))
                                  if lat_ms.size else None)),
        records=records, memory_peak_bytes=kid["memory_peak_bytes"],
        device_kind=kid.get("device_kind"), forbidden=kid["forbidden"],
        notes=dict(generator_lag_ms_p99=float(np.percentile(lags, 99)),
                   generator_lag_ms_max=float(lags.max()),
                   write_done_ms_p99=float(np.percentile(done, 99)),
                   blocks=int(lat_ms.size),
                   listener_p50_ms=(float(np.median(lat_ms))
                                    if lat_ms.size else None),
                   p95_from_due_ms=(float(np.percentile(from_due, 95)) * 1e3
                                    if from_due else None),
                   reader_round_ms_max=got["lag_ms_max"],
                   **probe.lags_ms(got["times"][n], t0, t_end),
                   trace_start_s=kid.get("start_s"),
                   counters=(spans or {}).get("otherData", {}).get(
                       "counters"),
                   spans_ms_per_segment=_per_segment(records["spans"]),
                   **_thirds(lat, due_in, n)))


class _Probe:
    """The reader's lateness on the cell's files: a file of this process
    that gets one block appended every ``period_s`` (``start`` to
    ``close``), each write's time kept."""

    def __init__(self, path: str, block_bytes: int, period_s: float):
        self.path, self.period_s = path, period_s
        self.block = bytes(block_bytes)
        self.wrote: list[float] = []
        self.fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._write, daemon=True)

    def _write(self) -> None:
        t = time.monotonic()
        while not self.done.wait(max(0.0, t - time.monotonic())):
            self.wrote.append(time.monotonic())
            os.write(self.fd, self.block)
            t += self.period_s

    def start(self) -> None:
        self.thread.start()

    def close(self) -> None:
        if self.fd >= 0:
            self.done.set()
            if self.thread.is_alive():
                self.thread.join(timeout=10)
            os.close(self.fd)
            self.fd = -1

    def lags_ms(self, times: bytes, t_a: float, t_b: float) -> dict:
        """Percentiles of the reader's stamp less the write's time, over
        the blocks written between ``t_a`` and ``t_b``."""
        got = np.frombuffer(times, dtype=np.float64)
        m = min(got.shape[0], len(self.wrote))
        wrote = np.asarray(self.wrote[:m])
        lag = ((got[:m] - wrote)[(wrote >= t_a) & (wrote <= t_b)]) * 1e3
        if not lag.size:
            return {}
        return dict(reader_lag_ms_p50=float(np.percentile(lag, 50)),
                    reader_lag_ms_p95=float(np.percentile(lag, 95)),
                    reader_lag_ms_p99=float(np.percentile(lag, 99)),
                    reader_lag_ms_max=float(lag.max()),
                    reader_probe_blocks=int(lag.size))


def _segment_spans(doc: dict | None, t_a: float, t_b: float):
    """The CLI's phases and spans (``--trace-spans``) of the segments whose
    ``read_wait`` began between ``t_a`` and ``t_b`` (seconds on
    ``time.time``'s clock, the spans' own): {"segments": n, name: [ms,
    ...]}, a name for each phase and span and ``<name>.<key>`` for the
    times summed onto it (the drain's ``write``, ``rds``); None without a
    file."""
    if not doc:
        return None
    base = doc.get("baseTimeNanoseconds", 0) / 1e9
    ev = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    keep = {e["args"]["id"] for e in ev if e["name"] == "read_wait"
            and t_a <= base + e["ts"] / 1e6 <= t_b}
    out: dict = {"segments": len(keep)}
    for e in ev:
        if e["args"]["id"] in keep:
            out.setdefault(e["name"], []).append(e["dur"] / 1e3)
            for key, ms in e["args"].items():
                if key.endswith("_ms"):
                    out.setdefault(f"{e['name']}.{key[:-3]}", []).append(ms)
    return out


def _per_segment(sp: dict | None) -> dict | None:
    """Each of ``_segment_spans``' names summed over its segments, a
    segment (ms)."""
    if not sp or not sp["segments"]:
        return None
    return {k: sum(v) / sp["segments"] for k, v in sp.items()
            if k != "segments"}
