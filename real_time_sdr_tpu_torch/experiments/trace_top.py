"""The top device ops of one receiver configuration, by time.

    python -m real_time_sdr_tpu_torch.experiments.trace_top [--mode 1]
        [--channels 32] [--blocks 12] [--reps 8] [--top 20]
        [--trace-dir DIR] [--cpu]

Port of ``experiments/trace_top.py``. Mode ``--mode``'s stereo + RDS
receiver at tier 3 serves the host-staged digest step
(``digest_step_staged`` on ``stage_cells``, one graph replay a call) over
32 channels x 12 blocks; ``--reps`` warm calls are timed on the host's
clock, then recorded under torch.profiler (``tracekit.profile_reps``: the
second of two windows of ``--reps`` calls, its Chrome trace written to
``--trace-dir``, by default a new temporary directory), and
``tracekit.rank_kernels`` prints the ``--top`` device ops by total time
with their share of device busy and the run's idle share. Last, one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from real_time_sdr_tpu_torch.experiments import (add_cpu_flag, device_name,
                                                 pick_device, timed)
from real_time_sdr_tpu_torch.experiments.tracekit import (profile_reps,
                                                          rank_kernels)
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import benchkit, synth


def ranked(step, device, reps: int, top: int, trace_dir: str | None,
           header: str, name: str, product_ms: float | None = None,
           file=None) -> dict:
    """Time ``reps`` warm calls of ``step()`` (after one unrecorded call),
    profile two windows of them and rank the second's ops
    (``tracekit.rank_kernels``, printed to ``file``). Returns the ranking
    with ``wall_ms`` (per call), ``trace`` (the Chrome trace's path) and
    ``device``."""
    step()
    wall = timed(step, device, reps)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix=f"rtsdr_{name}_")

    def run():
        for _ in range(reps):
            step()

    prof = profile_reps(trace_dir, run, name)
    res = rank_kernels(prof, reps, top, header=header,
                       wall_ms=wall * reps * 1e3, product_ms=product_ms,
                       file=file)
    return dict(res, wall_ms=wall * 1e3, reps=reps,
                trace=f"{trace_dir}/{name}.json", device=device_name(device))


def run(mode: int = 1, channels: int = 32, blocks: int = 12, reps: int = 8,
        top: int = 20, trace_dir: str | None = None, device=None,
        file=None) -> dict:
    """Rank the ops of ``reps`` warm staged digest calls of mode ``mode``
    (``ranked``); the result also holds ``mode``, ``channels``, ``blocks``
    and the ``top`` rows only."""
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=3, device=device)
    cfg = rx.cfg
    n_len = blocks * 2 * cfg.block_size_iq
    iq, _ = synth.station_iq(cfg, blocks)
    rows = benchkit.shifted_channel_segments_host(iq, channels, n_len)
    cell = benchkit.stage_cells(rx, rows, 1, channels, 1, n_len)[0][0]
    step_fn = benchkit.digest_step_staged(rx, n_len)
    state = [rx.init_state(channels)]

    def step():
        state[0], dig = step_fn(state[0], cell)
        return dig

    res = ranked(step, rx.device, reps, top, trace_dir,
                 f"mode {mode} {channels}x{blocks}: ", "trace_top",
                 file=file)
    res["rows"] = res["rows"][:top]
    return dict(res, mode=mode, channels=channels, blocks=blocks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.trace_top",
        description=__doc__.split("\n")[0])
    ap.add_argument("--mode", type=int, choices=(0, 1, 2, 3), default=1)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace-dir", default=None,
                    help="directory for the Chrome trace (default: a new "
                    "temporary directory)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    res = run(args.mode, args.channels, args.blocks, args.reps, args.top,
              args.trace_dir, device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
