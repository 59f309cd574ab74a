"""Each rate mode's measured cost beside its modelled floor.

    python -m real_time_sdr_tpu_torch.experiments.mode_floors
        [--channels 32] [--blocks 12] [--min-measure 1.5] [--cpu]

Port of ``experiments/mode_floors.py``. For each reference CLI mode (0-3)
the full stereo + RDS receiver at tier 3 serves the host-staged digest
step (``utils.benchkit.stage_cells``: the shifted channels written as
``[tail | segment]`` operands into pinned memory and uploaded; then
``digest_step_staged``, one graph replay a call), the production serving
path, at 32 channels x 12 blocks. Prints, per mode, the measured us per
block-channel beside ``utils.logging.speed_of_light_report``'s floor at
that shape (each stage's bytes or operations over the H100's peaks,
whichever is larger) and the share of it reached, the real-time multiple
measured and its ceiling, and the first call (graph capture included),
then one JSON object. Modes 1 and 3 carry less signal per block, so their
real-time multiple is lower at the same efficiency: the share of the floor
is the comparable number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from real_time_sdr_tpu_torch.experiments import (add_cpu_flag, device_name,
                                                 pick_device)
from real_time_sdr_tpu_torch.experiments.stage_decompose import \
    measure_digest
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import benchkit, synth
from real_time_sdr_tpu_torch.utils.logging import speed_of_light_report

MODES = (0, 1, 2, 3)


def run(channels: int = 32, blocks: int = 12, min_measure: float = 1.5,
        device=None, log=None) -> dict:
    """``{"mode<m>": {block_ms_of_signal, us_per_blk_ch, floor_us,
    pct_of_floor, measured_x, ceiling_x, first_call_s, device}}`` for
    modes 0-3; ``log(line)`` is called with each mode's line."""
    results = {}
    for mode in MODES:
        rx = Receiver(mode, stereo=True, rds=True, pll_tier=3, device=device)
        cfg = rx.cfg
        budget = cfg.block_size_iq / cfg.rf_fs
        with open(os.devnull, "w") as devnull:
            sol = speed_of_light_report(rx, file=devnull, channels=channels,
                                        blocks=blocks)
        n_len = blocks * 2 * cfg.block_size_iq
        iq, _ = synth.station_iq(cfg, blocks)
        rows = benchkit.shifted_channel_segments_host(iq, channels, n_len)
        seg = benchkit.stage_cells(rx, rows, 1, channels, 1, n_len)[0][0]
        first_s, per_run = measure_digest(
            rx, benchkit.digest_step_staged(rx, n_len), seg, channels,
            min_measure)
        t_blk_ch = per_run / (channels * blocks)
        results[f"mode{mode}"] = dict(
            block_ms_of_signal=budget * 1e3, us_per_blk_ch=t_blk_ch * 1e6,
            floor_us=sol["floor_s"] * 1e6,
            pct_of_floor=100 * sol["floor_s"] / t_blk_ch,
            measured_x=budget / t_blk_ch, ceiling_x=sol["ceiling_x"],
            first_call_s=first_s, device=device_name(rx.device))
        if log is not None:
            log(f"mode{mode}  {json.dumps(results[f'mode{mode}'])}")
        del rx, seg
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.mode_floors",
        description=__doc__.split("\n")[0])
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--min-measure", type=float, default=1.5)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    res = run(args.channels, args.blocks, args.min_measure, device,
              log=print)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
