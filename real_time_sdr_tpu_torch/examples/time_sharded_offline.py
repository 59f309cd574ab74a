"""Sequence parallelism: shard one long capture in TIME.

    python -m real_time_sdr_tpu_torch.examples.time_sharded_offline [--cpu]

Port of ``examples/time_sharded_offline.py``. The block stream is
strictly sequential in the reference (carried filter tails + PLL phase).
Here a 16-block capture is split into 8 shards of 2 blocks, each shard
seeing its left neighbour's last block as a halo, and because every
recurrence in the tier-3 receiver is feedforward, the sharded RDS bits
are BIT-IDENTICAL to the sequential decode and the audio matches it to
float32 summation order (``parallel/time_shard.py``, exact mode).

The JAX script spreads the 8 shards over an 8-device mesh; on one card
the port's shards are the 8 ROWS OF ONE BATCH of ``run_blocks``, run side
by side (``time_sharded_run(rx, blocks, shards=8)``, one captured CUDA
graph of the whole run on the card: the ``frontend_fused``, ``fir_bank``
and ``fir_decimate`` kernels, the sign chain and the global decode). It
is held against the sequential receiver (``rx.jit_run_blocks``): RDS bits
equal, and the audio of every block above 100 dB, the port's bound for
exact sharding on the card (the JAX script holds 120 dB over the whole
run on its CPU devices; the SNR reached is printed).
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.examples import (add_cpu_flag, check,
                                              pick_device, snr_db)
from real_time_sdr_tpu_torch.models.receiver import (Receiver,
                                                     ReceiverOutput)
from real_time_sdr_tpu_torch.parallel.time_shard import time_sharded_run
from real_time_sdr_tpu_torch.utils import synth

BLOCKS, SHARDS = 16, 8
MIN_BLOCK_SNR_DB = 100.0


class ShardedResult(NamedTuple):
    snr_db: float            # left audio over the whole run (the script's)
    worst_block_db: float    # least per-block SNR over both rails
    bits_equal: bool         # rds_bits and rds_nbits equal
    sharded: ReceiverOutput  # (B, ...) leaves on the host
    sequential: ReceiverOutput


def fixture() -> np.ndarray:
    """The synthesized capture as (BLOCKS, 2*block_size_iq) uint8."""
    cfg = mode_config(0)
    iq, _ = synth.station_iq(cfg, BLOCKS, ps_name="SHARDED!")
    return iq.reshape(BLOCKS, 2 * cfg.block_size_iq)


def _host(out: ReceiverOutput) -> ReceiverOutput:
    return ReceiverOutput(*(None if t is None else t.cpu().numpy()
                            for t in out))


def run(blocks: np.ndarray | None = None, device=None) -> ShardedResult:
    """``blocks`` (B, 2*block_size_iq) uint8 (None: ``fixture()``) as
    SHARDS time shards against the sequential receiver; raises
    ``GateError`` unless the RDS bits are equal and every block's audio is
    above MIN_BLOCK_SNR_DB."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=device)
    if blocks is None:
        blocks = fixture()
    x = torch.from_numpy(np.ascontiguousarray(blocks)).to(rx.device)
    sharded = _host(time_sharded_run(rx, x, shards=SHARDS,
                                     devices=[rx.device]))
    _, seq = rx.jit_run_blocks(rx.init_state(1), x[None])
    seq = _host(ReceiverOutput(*(None if t is None else t[0] for t in seq)))
    ref, got = seq.left, sharded.left
    snr = 10 * np.log10(np.mean(ref.astype(np.float64) ** 2)
                        / (np.mean((ref.astype(np.float64) - got) ** 2)
                           + 1e-300))
    worst = min(snr_db(r[b], g[b])
                for r, g in ((seq.left, sharded.left),
                             (seq.right, sharded.right))
                for b in range(r.shape[0]))
    bits_equal = (np.array_equal(sharded.rds_bits, seq.rds_bits)
                  and np.array_equal(sharded.rds_nbits, seq.rds_nbits))
    check(bits_equal, "the sharded RDS bits differ from the sequential "
          "decode")
    check(worst > MIN_BLOCK_SNR_DB,
          f"a block's audio is {worst:.1f} dB from the sequential run, not "
          f"above {MIN_BLOCK_SNR_DB:.0f} dB")
    return ShardedResult(float(snr), worst, bits_equal, sharded, seq)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.examples."
        "time_sharded_offline", description=__doc__.split("\n")[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"shards: {SHARDS} x {BLOCKS // SHARDS} blocks as the rows of one "
          f"batch on 1 x {name}")
    res = run(fixture(), device)
    print(f"sharded vs sequential: audio {res.snr_db:.0f} dB "
          f"(float32 summation order; worst block {res.worst_block_db:.1f} "
          f"dB), RDS bits identical: {res.bits_equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
