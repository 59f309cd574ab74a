"""The per-block-channel cost of the receiver, decomposed by subsystem.

    python -m real_time_sdr_tpu_torch.experiments.stage_decompose [--mode 0]
        [--channels 32] [--blocks 12] [--min-measure 1.5] [--cpu]

Port of ``experiments/stage_decompose.py``. Times the graphed digest step
(``utils.benchkit.digest_step``: ``run_segment`` with every output leaf
summed into one scalar) over 32 shifted channels x 12 blocks for a ladder
of receivers at tier 3: mono, stereo, stereo + RDS with the slicer off
(``rds_path.emit_bits = False``: the RDS DSP chain alone) and stereo +
RDS, so the gap between the measured cost and the modelled floor can be
put on a stage. Per receiver: ms per run, us per block-channel, the delta
from the receiver before it, the floor (the bytes of
``utils.logging.stage_costs`` per block-channel, each launch's weights
spread over the ``channels`` x ``blocks`` it serves, over the H100's
HBM rate) and the share of that floor reached, the first call (graph
capture included), and the card. Prints one line per receiver and the
JSON of all four.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from real_time_sdr_tpu_torch.experiments import (add_cpu_flag, device_name,
                                                 pick_device, timed_for)
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import benchkit, synth
from real_time_sdr_tpu_torch.utils.logging import H100_HBM_BPS, stage_costs

CONFIGS = (("mono", dict(stereo=False, rds=False)),
           ("stereo", dict(stereo=True, rds=False)),
           ("stereo+rds-nobits", dict(stereo=True, rds=True)),
           ("stereo+rds", dict(stereo=True, rds=True)))


def floor_bytes(rx: Receiver, channels: int, blocks: int) -> float:
    """Bytes per block-channel of ``rx``'s stages at the serving shape:
    each row of ``stage_costs(rx, channels, blocks)`` with its launch's
    weights spread over the ``channels * blocks`` block-channels the
    launch serves."""
    amort = channels * blocks
    return float(sum(c["bytes"] - c["w_bytes"] + c["w_bytes"] / amort
                     for _, c in stage_costs(rx, channels=channels,
                                             blocks=blocks)))


def measure_digest(rx: Receiver, step, seg, channels: int,
                   min_measure: float) -> tuple[float, float]:
    """(first call s, seconds per warm run) of ``step`` on ``seg`` from a
    fresh state, each round of warm runs chaining the states and ending
    with the host holding the digest."""
    st = rx.init_state(channels)
    t0 = time.perf_counter()
    float(step(st, seg)[1])
    first_s = time.perf_counter() - t0

    def run_round(reps):
        s = st
        for _ in range(reps):
            s, dig = step(s, seg)
        float(dig)

    return first_s, timed_for(run_round, rx.device, min_measure)


def run(mode: int = 0, channels: int = 32, blocks: int = 12,
        min_measure: float = 1.5, device=None, log=None) -> dict:
    """``{config: {per_run_ms, us_per_blk_ch, delta_us_vs_prev,
    floor_bytes, floor_us, pct_of_floor, first_call_s, device}}`` for the
    four receivers of ``CONFIGS``; ``log(line)`` is called with each
    config's line as it is measured."""
    results, prev = {}, 0.0
    for name, kw in CONFIGS:
        rx = Receiver(mode, pll_tier=3, device=device, **kw)
        if name.endswith("-nobits"):
            rx.rds_path.emit_bits = False
        cfg = rx.cfg
        n_len = blocks * 2 * cfg.block_size_iq
        iq, _ = synth.station_iq(cfg, blocks)
        seg = benchkit.shifted_channel_segments(iq, channels, n_len,
                                                rx.device)
        first_s, per_run = measure_digest(rx, benchkit.digest_step(rx), seg,
                                          channels, min_measure)
        us = per_run / (channels * blocks) * 1e6
        fb = floor_bytes(rx, channels, blocks)
        floor_us = fb / H100_HBM_BPS * 1e6
        results[name] = dict(per_run_ms=per_run * 1e3, us_per_blk_ch=us,
                             delta_us_vs_prev=us - prev, floor_bytes=fb,
                             floor_us=floor_us,
                             pct_of_floor=100 * floor_us / us,
                             first_call_s=first_s,
                             device=device_name(rx.device))
        prev = us
        if log is not None:
            log(f"{name:18s} {json.dumps(results[name])}")
        del rx, seg
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.stage_decompose",
        description=__doc__.split("\n")[0])
    ap.add_argument("--mode", type=int, choices=(0, 1, 2, 3), default=0)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--min-measure", type=float, default=1.5)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    res = run(args.mode, args.channels, args.blocks, args.min_measure,
              device, log=print)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
