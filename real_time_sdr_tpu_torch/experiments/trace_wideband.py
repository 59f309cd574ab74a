"""The top device ops of the wideband channelize + decode step.

    python -m real_time_sdr_tpu_torch.experiments.trace_wideband
        [--stations 64] [--seg 12] [--reps 8] [--top 25]
        [--path {fused,u8}] [--trace-dir DIR] [--cpu]

Port of ``experiments/trace_wideband.py``. Builds the step of
``wideband64`` (``ChannelBank.run_wideband_jit`` on seeded noise rails on
the card, the frontend of ``--path`` on the ladder's grid for
``--stations``) at ``--seg`` blocks, times ``--reps`` warm calls, records
two windows of them under torch.profiler and ranks the second's device
ops (``tracekit``): the hunt tool for the fold product and the traffic
around it. The fold product's time from CUDA events at the segment's
shapes stands in where the profiler recorded none for it. Last, one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from real_time_sdr_tpu_torch.experiments import (add_cpu_flag,
                                                 pick_device)
from real_time_sdr_tpu_torch.experiments import wideband64
from real_time_sdr_tpu_torch.experiments.trace_top import ranked
from real_time_sdr_tpu_torch.models.channelizer import fold_product


def fold_product_ms(rung: wideband64.Rung, iw: torch.Tensor,
                    qw: torch.Tensor, reps: int = 10) -> float | None:
    """One fold product's device time (ms, CUDA events, the median of
    ``reps``) at the segment's shapes; None off the card."""
    if rung.rx.device.type != "cuda":
        return None
    fe, n = rung.fe, iw.shape[0]
    if rung.fused:
        tl = fe.tail_len
        fr = fe.frames(torch.cat([iw[:tl], iw]), torch.cat([qw[:tl], qw]))
        w = fe.w
    else:
        tl = fe.fold_tail
        fr = fe.fold_frames(torch.cat([iw[:tl], iw]),
                            torch.cat([qw[:tl], qw]),
                            -(-(n // fe.decim) // fe.fold_R))
        w = fe.fold_W
    fold_product(fr, w)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fold_product(fr, w)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def run(stations: int = 64, seg: int = 12, reps: int = 8, top: int = 25,
        path: str = "fused", trace_dir: str | None = None, device=None,
        file=None) -> dict:
    """Rank the device ops of ``reps`` warm wideband calls
    (``trace_top.ranked``); the result also holds ``stations``, ``seg``,
    ``path``, ``product_ms`` and the ``top`` rows only."""
    rung = wideband64.build(stations, path, seg=seg, device=device)
    iw, qw = wideband64.noise_rails(rung)
    state = [rung.bank.init_state(), rung.fe.init_state()]

    def step():
        bs, out, fs = rung.bank.run_wideband_jit(state[0], rung.fe, iw, qw,
                                                 state[1])
        state[:] = [bs, fs]
        return out

    product_ms = fold_product_ms(rung, iw, qw)
    res = ranked(step, rung.rx.device, reps, top, trace_dir,
                 f"wideband {stations}st seg{seg} {path}: ",
                 "trace_wideband", product_ms=product_ms, file=file)
    res["rows"] = res["rows"][:top]
    return dict(res, stations=stations, seg=seg, path=path,
                product_ms=product_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.trace_wideband",
        description=__doc__.split("\n")[0])
    ap.add_argument("--stations", type=int, default=64)
    ap.add_argument("--seg", type=int, default=12)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--path", choices=("u8", "fused"), default="fused",
                    help="the wideband frontend to trace (the fused "
                    "one-matmul path is the serving default)")
    ap.add_argument("--trace-dir", default=None,
                    help="directory for the Chrome trace (default: a new "
                    "temporary directory)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    if args.path == "u8" and args.stations > wideband64.U8_MAX_STATIONS:
        print(f"error: the two-stage (u8) path runs at most "
              f"{wideband64.U8_MAX_STATIONS} stations", file=sys.stderr)
        return 2
    res = run(args.stations, args.seg, args.reps, args.top, args.path,
              args.trace_dir, device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
