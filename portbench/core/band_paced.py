"""Band cells (traffic ``kind`` ``band_paced``): the wideband CLI
(``real_time_sdr_tpu_torch.cli`` with ``--stations``) serving one FM-band
capture live, in this process.

The capture (the configuration's station grid, content from the seed) is
made on the device and held on the host. A feeder process plays it in a
loop into the CLI's ``--input`` FIFO at ``rate_x`` times the capture's
own rate (1: live), block by block on a fixed schedule that does not slow when the CLI does (open
loop), from the moment the CLI says ``warmed up``; a reader process
drains the stations' PCM FIFOs in ``--output-dir`` and stamps each block
as it arrives; the CLI's ``main`` runs here, so a traced run's profiler
sees its device work.

``band_latency_p95_ms``: the 95th percentile, over every block of every
station due inside the window, of its PCM's arrival at the reader less
the time the block's last byte left the feed (its due time plus the
feeder's own lateness, as for the listener cell). A block that never
arrives is ``failed``. The station's RDS bits reach its framer in
the same drain step, right after its PCM is written.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from portbench.core import check, fifos
from portbench.core.tap import Tap
from portbench.core.trace import Window
from portbench.traffic import generator


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool, t_process: float) -> dict:
    import torch
    cfg, tr = cell.config, cell.traffic
    rx, band, cli_cfg = cfg["receiver"], cfg["band"], cfg["cli"]
    n_st, wide_fs = band["stations"], band["wide_fs"]
    offs = generator.band_offsets(n_st, band["raster_hz"])
    d = wide_fs // rx["rf_fs"]
    blk_bytes = 2 * rx["block_size_iq"] * d
    seg = cli_cfg["segment"]
    rds = tr["service"] == "r"

    stations = generator.draw_stations(seed, n_st, tr["rt_chars"])
    capture = generator.capture(stations, offs, wide_fs,
                                tr["capture_groups"], tr["iq_level"], device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    work = fifos.workdir()
    outdir = os.path.join(work, "out")
    os.mkdir(outdir)
    (in_fifo,) = fifos.make_fifos(work, ["wide.u8"])
    # the stations' PCM files, made empty here so that the reader holds
    # them open before the CLI opens (and truncates) them
    outs = [os.path.join(outdir, f"station_{k}.pcm") for k in range(n_st)]
    for p in outs:
        open(p, "wb").close()
    audio_block = rx["block_size_iq"] // rx["rf_decim"] \
        * rx["audio_up"] // rx["audio_down"]
    plan = check.sample_plan(seed, n_st, [0, n_st - 1], tr["sampled"],
                              tr["keep_every"])
    window = Window(trace, min(tr["trace_at_s"], seconds / 3),
                    min(tr["trace_len_s"], seconds / 3))
    reader = fifos.Helper("reader", dict(
        paths=outs, files=True, block_bytes=4 * audio_block,
        keep={str(k): list(v) for k, v in plan.items()}), root=cell.root)
    period = rx["block_size_iq"] / rx["rf_fs"] / tr["rate_x"]
    feeder = fifos.Helper("feeder", dict(
        fifos=[in_fifo], nbytes=capture.shape[0],
        block_bytes=blk_bytes, period_s=period, offsets_s=[0.0],
        seconds=seconds, tail_blocks=tr["tail_blocks"]),
        payload=[capture.tobytes()], root=cell.root)
    try:
        reader.wait_ready()
        feeder.wait_ready()
        argv = [str(rx["mode"]), tr["service"],
                "--stations=" + ",".join(str(o) for o in offs),
                "--wide-fs", str(wide_fs), "--output-dir", outdir,
                "--input", in_fifo, "--segment", str(seg),
                "--pipeline", str(cli_cfg["pipeline"]),
                "--pll-tier", str(cli_cfg["pll_tier"]),
                "--wb-fir", "bf16" if control else cfg["precision_flag"],
                "--stats", "--warmup"]
        if device.type != "cuda":
            argv.append("--cpu")
        rc = _serve(argv, window, lambda: feeder.send("go"))
        fed = feeder.result()
        reader.send("stop")
        got = reader.result()
    finally:
        feeder.kill()
        reader.kill()
        shutil.rmtree(work, ignore_errors=True)
    t0 = fed["t0"]
    if t0 is None:
        raise RuntimeError("the CLI never warmed up")
    t_end = t0 + seconds
    # host-clock readings of a traced run: before its profiler records
    t_host = min(t_end, window.t_start or t_end)
    due = t0 + period * (1 + np.arange(fed["blocks"]))
    left = due + fifos.own_lag(fed["lag"][0], due.shape[0])
    due_in = int((due <= t_end).sum())
    lat, host_lat, failed = [], [], 0
    for b in got["times"]:
        arr = np.frombuffer(b, dtype=np.float64)
        m = min(due_in, arr.shape[0])
        lat.append(arr[:m] - left[:m])
        host_lat.append((arr[:m] - left[:m])[due[:m] <= t_host])
        failed += due_in - m
    lat_ms = np.concatenate(lat) * 1e3
    lines = window.tap.lines()
    seg_ms = [float(s.split(":")[1].split("ms")[0]) for t, _, s in lines
              if s.startswith("block ") and t0 <= t <= t_host]
    records = dict(
        segment_ms=seg_ms, latency_ms=(np.concatenate(host_lat)
                                       * 1e3).tolist(),
        trace=window.result(), segment_blocks=seg, stations=n_st,
        rds=rds, config=cfg)
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)

    # -- correctness, after the window and the memory reading -----------
    numbers = check.pcm_numbers(
        rx, check.choose(seed, got["kept"], lambda s, j: j < due_in),
        check.band_demod_of(cfg, capture), control=False)
    if rds:
        groups, names = _rds_events(lines)
        (numbers["rds_wrong"], numbers["rds_wrong_streams"],
         numbers["rds_miscorrected_pct"]) = check.rds_wrong(
            stations, groups, names, t0 + seconds / 2)
    lags = np.asarray(fed["lag"][0]) * 1e3
    return dict(
        rc=rc, t0=t0, setup_s=t0 - t_process, numbers=numbers,
        attempted=n_st * due_in, failed=failed + (rc != 0),
        e2e=dict(band_latency_p95_ms=(float(np.percentile(lat_ms, 95))
                                      if lat_ms.size else None)),
        records=records, memory_peak_bytes=peak,
        notes=dict(generator_lag_ms_p99=float(np.percentile(lags, 99)),
                   generator_lag_ms_max=float(lags.max()),
                   band_latency_p50_ms=(float(np.median(lat_ms))
                                        if lat_ms.size else None),
                   segment_ms_q=_quartiles(seg_ms),
                   trace_start_s=window.start_s,
                   reader_lag_ms_max=got["lag_ms_max"],
                   **getattr(window, "cpu", {})))


def _quartiles(v: list[float]) -> list[float] | None:
    return ([float(x) for x in np.percentile(v, [10, 25, 50, 75, 90])]
            if v else None)


def _serve(argv: list[str], window: Window, on_warm) -> int:
    """The CLI's ``main`` with its stderr taken by a ``Tap``; ``on_warm``
    is called at its ``warmed up`` line, and the tap's block lines drive
    the traced sub-window."""
    import contextlib
    import sys
    from real_time_sdr_tpu_torch import cli

    def on_block(t: float) -> None:
        if window.t_ref is None:
            window.t_ref = t
            window.cpu_ref = time.thread_time()
        window.on_block(t)
    window.tap = Tap(on_block, on_warm)
    with contextlib.redirect_stderr(window.tap):
        rc = cli.main(argv)
    if window.t_ref is not None:
        # the CLI thread's CPU time over its serving against the wall: at
        # the capture's own rate it waits on its input the rest
        wall = time.monotonic() - window.t_ref
        window.cpu = dict(cli_thread_cpu_share=(
            time.thread_time() - window.cpu_ref) / wall)
    if rc:
        print("\n".join(s for *_, s in window.tap.lines()[-20:]),
              file=sys.stderr)
    return rc


def _rds_events(lines) -> tuple[dict, dict]:
    """Per station, the decoded groups' (time, PI) and the PS names, from
    the CLI's ``ch<k> group: (pi, type, pty)`` and ``ch<k> ps: NAME``
    lines."""
    groups: dict[int, list] = {}
    names: dict[int, list] = {}
    for t, _, s in lines:
        if not s.startswith("ch"):
            continue
        head, _, val = s.partition(": ")
        k, _, kind = head[2:].partition(" ")
        if kind == "group":
            groups.setdefault(int(k), []).append(
                (t, int(val.strip("()").split(",")[0])))
        elif kind == "ps":
            names.setdefault(int(k), []).append(val)
    return groups, names

