"""End-to-end latency of the pipe CLI fed at a live capture's pace.

    python -m real_time_sdr_tpu_torch.experiments.e2e_latency [--blocks 40]
        [--pipeline 2] [--segment 6] [--pll-tier T] [--wideband N] [--cpu]

Port of ``experiments/e2e_latency.py``. The port's CLI (``python -m
real_time_sdr_tpu_torch.cli 0 r --warmup --stats``) runs as a child
process over real pipes: raw uint8 IQ written into its stdin at the
capture's real byte rate (one mode-0 block per 30.625 ms, as a tuner
delivers it) from the moment the child says it is warmed up, PCM drained
from its stdout, its stderr read on a thread of its own (``--stats``
writes a line per group: a full pipe would stall the child and then the
feeder). A feed started with the child would sit in the pipe through the
child's start-up and then arrive as one burst, whose latency is not a
listener's.

- Run 1: ``synth.station_iq(cfg, 8, ps_name="LATENCY ")`` paced into
  ``--pipeline 2 --segment 6 --max-blocks 40``, a fast sink: the CLI's own
  ``block latency`` p50 / p99 (ingest to PCM out) beside the 30.6 ms
  block deadline, and its ``total:`` line.
- Run 2: the same feed into ``--pipeline 1 --drop-oldest --io-depth 2``
  with a sink that reads one PCM block per 3 x 30.625 ms: the reader must
  shed input (a ``dropped N input blocks`` line, N > 0) instead of
  holding back the source.
- ``--wideband N``: N stations in one 9.6 MS/s capture, two of them real
  (``LIVE-WB0`` at -1.7 MHz, ``LIVE-WB1`` at +0.8 MHz), the others
  distinct load slots over the band, paced at the capture's byte rate into
  ``--stations=... --wide-fs 9600000 --segment 6 --pipeline 2``: the
  ``total:`` line at >= 1.0x real time and both PS decoded live.

Runs 1 and 2 need the native ring-buffered reader (``utils.native_io``;
``make -C native``): without it the CLI reads with plain blocking reads
and ``--drop-oldest`` does nothing, so the run fails with that reason.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.experiments import (add_cpu_flag, check,
                                                 device_name, pick_device)
from real_time_sdr_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHILD_TIMEOUT_S = 900
_LAT = re.compile(
    r"block latency \(ingest->PCM out\): p50 (?P<p50>[\d.]+) ms, p99 "
    r"(?P<p99>[\d.]+) ms, max (?P<max>[\d.]+) ms, steady-state p50 "
    r"(?P<steady>[\d.]+) ms vs (?P<deadline>[\d.]+) ms block deadline "
    r"\(dropped (?P<dropped>\d+)\)")
_TOTAL = re.compile(r"total: (?P<blocks>\d+) blocks, avg (?P<avg>[\d.]+) "
                    r"ms/block, (?P<x>[\d.]+)x real time")
_DROPPED = re.compile(r"dropped (\d+) input blocks")
_WARMED = re.compile(r"warmed up in ([\d.]+) s")


def parse_stats(err: str) -> dict:
    """The CLI's ``--stats`` lines in ``err`` (its stderr): ``latency``
    (p50_ms, p99_ms, max_ms, steady_p50_ms, deadline_ms, dropped) or None,
    ``total`` (blocks, avg_ms, x_realtime) or None, ``dropped`` (N of a
    ``dropped N input blocks`` line, else None), ``warmed_s``,
    ``launches`` (the ``kernel launches`` JSON, else None) and
    ``warnings`` (each ``warning:`` line)."""
    out = dict(latency=None, total=None, dropped=None, warmed_s=None,
               launches=None, warnings=[])
    for line in err.splitlines():
        if m := _LAT.match(line):
            out["latency"] = dict(
                p50_ms=float(m["p50"]), p99_ms=float(m["p99"]),
                max_ms=float(m["max"]), steady_p50_ms=float(m["steady"]),
                deadline_ms=float(m["deadline"]),
                dropped=int(m["dropped"]))
        elif m := _TOTAL.match(line):
            out["total"] = dict(blocks=int(m["blocks"]),
                                avg_ms=float(m["avg"]),
                                x_realtime=float(m["x"]))
        elif m := _DROPPED.match(line):
            out["dropped"] = int(m[1])
        elif m := _WARMED.match(line):
            out["warmed_s"] = float(m[1])
        elif line.startswith("kernel launches: "):
            out["launches"] = json.loads(line.split(": ", 1)[1])
        elif line.startswith("warning:"):
            out["warnings"].append(line)
    return out


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cli(extra: list[str]) -> list[str]:
    return [sys.executable, "-m", "real_time_sdr_tpu_torch.cli", "0", "r",
            "--warmup", "--stats", *extra]


def _feed(proc, data: bytes, block_bytes: int, budget_s: float,
          n_blocks: int, ready: threading.Event) -> None:
    """Once ``ready`` is set, write ``n_blocks`` blocks at the real-time
    cadence (block b at b * ``budget_s`` after the first; one the pipe
    held back is written as soon as it can be), cycling through ``data``;
    then close the child's stdin."""
    try:
        ready.wait(CHILD_TIMEOUT_S)
        t0 = time.perf_counter()
        for b in range(n_blocks):
            dt = t0 + b * budget_s - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            off = (b * block_bytes) % (len(data) - block_bytes)
            proc.stdin.write(data[off:off + block_bytes])
            proc.stdin.flush()
        proc.stdin.close()
    except BrokenPipeError:
        pass


def _drain(proc, per_read_sleep: float = 0.0, chunk: int = 1 << 16):
    while proc.stdout.read(chunk):
        if per_read_sleep:
            time.sleep(per_read_sleep)


def _read_stderr(proc, lines: list, ready: threading.Event) -> None:
    """Collect the child's stderr lines; set ``ready`` at its ``warmed up``
    line (or at its end, so that a child that failed holds no one)."""
    for raw in proc.stderr:
        lines.append(raw.decode(errors="replace"))
        if lines[-1].startswith("warmed up in"):
            ready.set()
    ready.set()


def _serve(args: list[str], data: bytes, block_bytes: int, n_feed: int,
           sink_sleep: float = 0.0,
           sink_chunk: int = 1 << 16) -> tuple[int, str]:
    """Start the CLI with ``args``; once it is warmed up (its ``--warmup``
    line), feed it ``n_feed`` paced blocks; drain its stdout (sleeping
    ``sink_sleep`` after each ``sink_chunk`` read) and its stderr on
    threads; returns (exit code, stderr). The child is killed if it
    outlives ``CHILD_TIMEOUT_S``."""
    cfg = mode_config(0)
    proc = subprocess.Popen(_cli(args), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env=_env(), cwd=REPO)
    try:
        lines: list = []
        ready = threading.Event()
        threads = [threading.Thread(target=_drain, daemon=True,
                                    args=(proc, sink_sleep, sink_chunk)),
                   threading.Thread(target=_read_stderr, daemon=True,
                                    args=(proc, lines, ready))]
        for t in threads:
            t.start()
        _feed(proc, data, block_bytes, cfg.block_size_iq / cfg.rf_fs,
              n_feed, ready)
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
        for t in threads:
            t.join(timeout=30)
        return rc, "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _device_args(device, pll_tier: int | None) -> list[str]:
    return ((["--cpu"] if device.type == "cpu" else [])
            + ([] if pll_tier is None else ["--pll-tier", str(pll_tier)]))


def _station() -> tuple[bytes, int, float]:
    cfg = mode_config(0)
    iq, _ = synth.station_iq(cfg, 8, ps_name="LATENCY ")
    return (np.asarray(iq, np.uint8).tobytes(), 2 * cfg.block_size_iq,
            cfg.block_size_iq / cfg.rf_fs)


def native_reader() -> bool:
    """Whether the native reader loads here, its library built first
    (under the CLI's lock) if it is missing or stale: the child processes
    load the same library."""
    from real_time_sdr_tpu_torch import cli
    return cli._native_io().available()


def paced_run(blocks: int = 40, pipeline: int = 2, segment: int = 6,
              pll_tier: int | None = None, device=None) -> dict:
    """Run 1: ``parse_stats`` of the paced CLI with a fast sink, with its
    ``rc`` and ``stderr``; raises ``GateError`` without the native reader,
    on a failed child or without a ``block latency`` line."""
    device = _device(device)
    check(native_reader(), "the native reader (native/librtsdr_io.so) does "
          "not load: the CLI would read with plain blocking reads")
    data, block_bytes, _ = _station()
    rc, err = _serve(["--pipeline", str(pipeline), "--segment",
                      str(segment), "--max-blocks", str(blocks),
                      *_device_args(device, pll_tier)],
                     data, block_bytes, blocks + 4)
    res = dict(parse_stats(err), rc=rc, stderr=err)
    check(rc == 0, f"the paced CLI exited {rc}:\n{err[-2000:]}")
    check(res["latency"] is not None,
          f"the paced CLI printed no block latency line:\n{err[-2000:]}")
    return res


def overload_run(blocks: int = 40, pll_tier: int | None = None,
                 device=None) -> dict:
    """Run 2: ``parse_stats`` of the CLI under ``--drop-oldest --io-depth
    2`` behind a sink three times slower than real time, with ``rc``,
    ``stderr`` and ``native``: whether the child read through the native
    reader (it warns when ``--drop-oldest`` is inactive). Raises
    ``GateError`` unless it was and dropped blocks."""
    device = _device(device)
    check(native_reader(), "the native reader (native/librtsdr_io.so) does "
          "not load: without it --drop-oldest does nothing")
    cfg = mode_config(0)
    data, block_bytes, budget = _station()
    pcm_block = 2 * cfg.audio_block * 2
    rc, err = _serve(["--pipeline", "1", "--drop-oldest", "--io-depth", "2",
                      "--max-blocks", str(blocks),
                      *_device_args(device, pll_tier)],
                     data, block_bytes, blocks + 4, sink_sleep=3.0 * budget,
                     sink_chunk=pcm_block)
    res = dict(parse_stats(err), rc=rc, stderr=err)
    res["native"] = not any("--drop-oldest" in w for w in res["warnings"])
    check(rc == 0, f"the overloaded CLI exited {rc}:\n{err[-2000:]}")
    check(res["native"], "the child read with plain blocking reads: "
          "--drop-oldest was inactive")
    check(bool(res["dropped"]), "slow sink + --drop-oldest reported no "
          f"drops:\n{err[-2000:]}")
    return res


def wideband_offsets(n_stations: int, wide_fs: int) -> list[int]:
    """The live wideband grid: the two real stations (-1.7 MHz, +0.8 MHz)
    and n-2 distinct load slots spread over the usable band on a 100 kHz
    raster (a one-sided ladder would cross Nyquist and alias)."""
    n_st = max(2, n_stations)
    span = wide_fs // 2 - 300_000
    loads = [int(round((-span + 2 * span * k / max(n_st - 3, 1)) / 1e5)
                 * 100_000) for k in range(n_st - 2)]
    offs = [-1_700_000, 800_000]
    for o in loads:
        while o in offs:        # each load slot distinct: a duplicate would
            o -= 100_000        # under-load by one channel
        offs.append(o)
    check(max(abs(o) for o in offs) + 150_000 <= wide_fs // 2,
          f"the live grid leaves the band: {offs}")
    check(len(set(offs)) == len(offs), f"the live grid repeats: {offs}")
    return offs


def wideband_run(n_stations: int, blocks: int = 40, pipeline: int = 2,
                 segment: int = 6, pll_tier: int | None = None,
                 device=None) -> dict:
    """The live wideband run: ``parse_stats`` of the CLI in ``--stations``
    mode fed at the capture's byte rate, with ``rc``, ``stderr``,
    ``offsets`` and ``ps`` (the PS of each real station seen live).
    Raises ``GateError`` under 1.0x real time or without both PS."""
    device = _device(device)
    cfg = mode_config(0)
    wide_fs = 4 * cfg.rf_fs
    offs = wideband_offsets(n_stations, wide_fs)
    scene = [dict(offset_hz=offs[0], ps_name="LIVE-WB0", pi=0x7A7A, pty=1),
             dict(offset_hz=offs[1], ps_name="LIVE-WB1", pi=0x7B7B, pty=2)]
    # the fixture covers the whole run: cycling a short one would wrap
    # the RDS stream mid-group and PS would never assemble
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, blocks + 6)
    x = np.empty(2 * iw.shape[0], np.float32)
    x[0::2], x[1::2] = iw, qw
    data = np.clip(np.round(128.0 + 127.0 * x), 0,
                   255).astype(np.uint8).tobytes()
    block_bytes = 2 * cfg.block_size_iq * (wide_fs // cfg.rf_fs)
    with tempfile.TemporaryDirectory() as outdir:
        rc, err = _serve(["--stations=" + ",".join(map(str, offs)),
                          "--wide-fs", str(wide_fs), "--output-dir", outdir,
                          "--segment", str(segment), "--pipeline",
                          str(pipeline), "--max-blocks", str(blocks),
                          *_device_args(device, pll_tier)],
                         data, block_bytes, blocks + 2)
    res = dict(parse_stats(err), rc=rc, stderr=err, offsets=offs,
               ps={ps: ps in err for ps in ("LIVE-WB0", "LIVE-WB1")})
    check(rc == 0, f"the live wideband CLI exited {rc}:\n{err[-2000:]}")
    check(res["total"] is not None,
          f"the live wideband CLI printed no total line:\n{err[-2000:]}")
    check(res["total"]["x_realtime"] >= 1.0, "wideband live serving fell "
          f"behind: {res['total']['x_realtime']}x real time")
    check(all(res["ps"].values()), f"PS not decoded live: {res['ps']}")
    return res


def _shown(err: str, prefixes: tuple) -> list[str]:
    return [ln for ln in err.splitlines() if ln.startswith(prefixes)
            or " ps: " in ln]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.e2e_latency",
        description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--pipeline", type=int, default=2)
    ap.add_argument("--segment", type=int, default=6)
    ap.add_argument("--pll-tier", type=int, choices=(1, 2, 3), default=None,
                    help="the CLI's carrier tier (default: the CLI's own, "
                    "1; on the CPU tier 1's plain loop is slow)")
    ap.add_argument("--wideband", type=int, default=0, metavar="N",
                    help="run the live-paced WIDEBAND check with N "
                    "stations instead of the single-station runs")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    on = device_name(device)
    if args.wideband:
        res = wideband_run(args.wideband, args.blocks, args.pipeline,
                           args.segment, args.pll_tier, device)
        print("\n".join(_shown(res["stderr"], ("wideband frontend",
                                               "warmed", "total:"))))
        print(f"wideband live OK: {len(res['offsets'])} stations sustained "
              f"{res['total']['x_realtime']:.1f}x real time on {on}")
        return 0
    res = paced_run(args.blocks, args.pipeline, args.segment, args.pll_tier,
                    device)
    print("\n".join(_shown(res["stderr"], ("block latency", "total:",
                                           "warmed"))))
    lat = res["latency"]
    print(f"paced: p50 {lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms "
          f"beside the {lat['deadline_ms']:.2f} ms block deadline on {on}")
    res = overload_run(args.blocks, args.pll_tier, device)
    err_lines = res["stderr"].splitlines()
    print(next((ln for ln in err_lines if ln.startswith("dropped")),
               "dropped: none reported"))
    print(next(("overload " + ln for ln in err_lines
                if ln.startswith("block latency")), "overload: no latency "
               "line"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
