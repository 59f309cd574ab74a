"""Checkpoint/resume: decode half a capture, save state, resume exactly.

    python -m real_time_sdr_tpu_torch.examples.checkpoint_resume [--cpu]

Port of ``examples/checkpoint_resume.py``. The whole receiver's carried
DSP state (filter tails, synchronizer carries, RDS bit-alignment) is one
explicit tree of tensors, so resuming a decode is: save the tree, reload
it, keep feeding blocks. The two-run output is checked bit-identical to a
single uninterrupted run (the reference has no equivalent: its state
lives in C++ stack variables). Each run is ``rx.jit_run_blocks``, the
whole block loop as one captured CUDA graph on the card (the
``frontend_fused``, ``fir_bank`` and ``fir_decimate`` kernels). The file
is ``utils.state.save_state``'s ``.npz`` of the one-channel state without
its channel axis: the JAX package's layout, which its ``load_state``
reads.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.examples import (add_cpu_flag, check,
                                              pick_device)
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import state as state_util
from real_time_sdr_tpu_torch.utils import synth

BLOCKS, SPLIT = 12, 6


class ResumeResult(NamedTuple):
    path: str                # the checkpoint written after the first run
    nbytes: int              # its size
    audio_equal: bool        # split run's left audio == uninterrupted run's
    bits_equal: bool         # ... and its RDS bits
    left: np.ndarray         # (B, audio_block) the split run's left audio
    rds_bits: np.ndarray     # (B, max_bits)
    ref_left: np.ndarray     # the uninterrupted run's
    ref_bits: np.ndarray


def fixture() -> np.ndarray:
    """The synthesized capture as (BLOCKS, 2*block_size_iq) uint8."""
    cfg = mode_config(0)
    iq, _ = synth.station_iq(cfg, BLOCKS)
    return iq.reshape(BLOCKS, 2 * cfg.block_size_iq)


def run(blocks: np.ndarray | None = None, ckpt: str | None = None,
        device=None) -> ResumeResult:
    """Decode ``blocks`` (None: ``fixture()``) in one run, then as SPLIT
    blocks, a checkpoint to ``ckpt`` (None: ``receiver.npz`` in a new
    temporary directory, kept, as the JAX script keeps it), a reload and
    the rest; raises ``GateError`` unless the split run's left audio and
    RDS bits equal the uninterrupted run's."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=device)
    if blocks is None:
        blocks = fixture()
    if ckpt is None:
        ckpt = os.path.join(tempfile.mkdtemp(), "receiver.npz")
    x = torch.from_numpy(np.ascontiguousarray(blocks)).to(rx.device)[None]

    # one uninterrupted run
    _, ref = rx.jit_run_blocks(rx.init_state(1), x)

    # run 1: the first SPLIT blocks, then the checkpoint
    st, out1 = rx.jit_run_blocks(rx.init_state(1), x[:, :SPLIT])
    state_util.save_state(ckpt, state_util.map_state(st, lambda t: t[0]))

    # run 2 (a fresh process in real use): load and continue
    like = state_util.map_state(rx.init_state(1), lambda t: t[0])
    st2 = state_util.map_state(state_util.load_state(ckpt, like),
                               lambda t: t[None])
    _, out2 = rx.jit_run_blocks(st2, x[:, SPLIT:])

    left = torch.cat([out1.left[0], out2.left[0]]).cpu().numpy()
    bits = torch.cat([out1.rds_bits[0], out2.rds_bits[0]]).cpu().numpy()
    ref_left = ref.left[0].cpu().numpy()
    ref_bits = ref.rds_bits[0].cpu().numpy()
    audio_equal = bool(np.array_equal(left, ref_left))
    bits_equal = bool(np.array_equal(bits, ref_bits))
    check(audio_equal and bits_equal,
          f"split run != uninterrupted run: audio equal {audio_equal}, RDS "
          f"bits equal {bits_equal}")
    return ResumeResult(ckpt, os.path.getsize(ckpt), audio_equal, bits_equal,
                        left, bits, ref_left, ref_bits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.examples.checkpoint_resume",
        description=__doc__.split("\n")[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    res = run(fixture(), device=device)
    print(f"run 1 decoded {SPLIT} blocks, state saved to {res.path} "
          f"({res.nbytes} bytes)")
    print(f"run 2 resumed and decoded the remaining {BLOCKS - SPLIT} blocks")
    print(f"split run == uninterrupted run: audio {res.audio_equal}, "
          f"RDS bits {res.bits_equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
