"""The latency of re-pointing one station while a wideband grid serves.

    python -m real_time_sdr_tpu_torch.experiments.retune_latency
        [--stations 64] [--seg 8] [--reps 32] [--cpu]

Port of ``experiments/retune_latency.py``. The reference's only retune is
restarting ``rtl_sdr -f`` and the whole binary: seconds, all state lost.
Here ``ChannelBank.run_wideband_jit`` serves the fused frontend of the
ladder's rung (``ladder_geometry``) as replays of one captured CUDA graph
that reads the frontend's weight buffers where they lie, and
``FusedWidebandFrontend.retune`` rebuilds one station's columns on the
host and copies them into those buffers in place: no new graph, and every
other station's state carries through.

Prints the steady graphed run (seeded noise rails on the card) in ms per
run and as multiples of real time, then 8 retunes of station (7r + 3) % n
onto its own raster point (the worst case that changes nothing), each
timed on the host's clock from ``retune`` to the host holding the next
run's ``rds_nbits``: p50 / min / max ms. Each retuned run's outputs must
equal, tensor for tensor, the same run from the same state with no
retune, and the bank's graph cache must hold as many graphs after the
retunes as before.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from real_time_sdr_tpu_torch.experiments import (add_cpu_flag, check,
                                                 device_name, pick_device,
                                                 timed)
from real_time_sdr_tpu_torch.experiments import wideband64

RETUNES = 8


def _equal(a, b) -> bool:
    return all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b))


def run(stations: int = 64, seg: int = 8, reps: int = 32,
        device=None) -> dict:
    """Serve the rung's grid and retune it 8 times; returns the steady
    run (``steady_ms``, ``x_station_realtime``: station-seconds decoded
    per second; ``x_wideband``: on the capture), the first call, the 8
    ``latencies_ms`` with their p50 / min / max, ``outputs_equal`` and the
    graph counts. Raises ``GateError`` if a retune added a graph or moved
    an output."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    rung = wideband64.build(stations, "fused", seg=seg, device=device)
    rx, wf, bank = rung.rx, rung.fe, rung.bank
    cfg, dev = rx.cfg, rx.device
    iw, qw = wideband64.noise_rails(rung)
    n = iw.shape[0]
    state = [bank.init_state(), wf.init_state()]

    def step():
        bs, out, ws = bank.run_wideband_jit(state[0], wf, iw, qw, state[1])
        state[:] = [bs, ws]
        return out

    first_s = timed(step, dev)
    per = timed(step, dev, reps)
    graphs_before = len(rx.graphs)
    lat, equal = [], True
    for r in range(RETUNES):
        si = (7 * r + 3) % stations
        bs, ws = state
        ref = bank.run_wideband_jit(bs, wf, iw, qw, ws)[1]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        wf.retune(si, rung.offsets[si])     # the same raster point
        bs, out, ws = bank.run_wideband_jit(bs, wf, iw, qw, ws)
        out.rds_nbits[:4].cpu()             # the effect visible on the host
        lat.append((time.perf_counter() - t0) * 1e3)
        state[:] = [bs, ws]
        equal = equal and _equal(ref, out)
    graphs_after = len(rx.graphs)
    lat_np = np.asarray(lat)
    res = dict(stations=stations, seg=seg, reps=reps, first_s=first_s,
               steady_ms=per * 1e3,
               x_station_realtime=(stations * seg * cfg.block_size_iq
                                   / cfg.rf_fs / per),
               x_wideband=n / rung.wide_fs / per, latencies_ms=lat,
               p50_ms=float(np.percentile(lat_np, 50)),
               min_ms=float(lat_np.min()), max_ms=float(lat_np.max()),
               outputs_equal=equal, graphs_before=graphs_before,
               graphs_after=graphs_after, device=device_name(dev))
    check(graphs_after == graphs_before,
          f"the retunes added graphs: {graphs_before} -> {graphs_after}")
    check(equal, "a run after a retune onto the same raster point differs "
          "from the same run with no retune")
    return res


def lines(res: dict) -> list[str]:
    return [
        f"# {res['stations']} st, graphed, weights read in place: first "
        f"call (graph capture included) {res['first_s']:.2f} s",
        f"# {res['stations']} st: {res['steady_ms']:.2f} ms/run "
        f"({res['x_station_realtime']:.0f}x aggregate station realtime, "
        f"{res['x_wideband']:.1f}x wideband)",
        f"# retune->decoded latency over steady serving: p50 "
        f"{res['p50_ms']:.1f} ms  min {res['min_ms']:.1f}  max "
        f"{res['max_ms']:.1f} ms (vs {res['steady_ms']:.2f} ms steady run; "
        "the delta is the host column rebuild and its copy into the "
        "weight buffers)",
        f"# graphs in the bank's cache: {res['graphs_before']} before the "
        f"retunes, {res['graphs_after']} after; outputs equal to the runs "
        f"with no retune: {res['outputs_equal']}; on {res['device']}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.retune_latency",
        description=__doc__.split("\n")[0])
    ap.add_argument("--stations", type=int, default=64)
    ap.add_argument("--seg", type=int, default=8)
    ap.add_argument("--reps", type=int, default=32)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    print("\n".join(lines(run(args.stations, args.seg, args.reps, device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
