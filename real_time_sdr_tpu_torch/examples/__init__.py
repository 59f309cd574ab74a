"""The walkthroughs of ``examples/*.py`` on the port, as runnable modules.

    python -m real_time_sdr_tpu_torch.examples.mono_to_wav [capture.raw] [out.wav] [--mode N]
    python -m real_time_sdr_tpu_torch.examples.stereo_rds_events [capture.raw] [--mode N]
    python -m real_time_sdr_tpu_torch.examples.wideband_multistation
    python -m real_time_sdr_tpu_torch.examples.retune_station
    python -m real_time_sdr_tpu_torch.examples.time_sharded_offline
    python -m real_time_sdr_tpu_torch.examples.checkpoint_resume

Each takes the arguments of the script it ports, plus ``--cpu``. It runs
on the CUDA card unless ``--cpu`` is given; without a card and without
``--cpu`` it exits with status 2 and never runs on the CPU by itself.
Each module has ``run(..., device=None)``, which returns what the
walkthrough shows and raises ``GateError`` where one of the script's
checks fails, and ``main(argv=None) -> int``, which prints the script's
lines. Given no capture, each synthesizes its fixture with
``utils.synth``. ``README.md`` beside this file lists where the port's
forms differ from the scripts.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

__all__ = ["EXAMPLES", "GateError", "add_cpu_flag", "check", "pick_device",
           "load_capture", "feed_blocks", "snr_db"]

EXAMPLES = ("mono_to_wav", "stereo_rds_events", "wideband_multistation",
            "retune_station", "time_sharded_offline", "checkpoint_resume")


class GateError(RuntimeError):
    """A walkthrough's check failed."""


def check(ok: bool, msg: str) -> None:
    """Raise ``GateError(msg)`` unless ``ok`` (a check that ``python -O``
    keeps, unlike ``assert``)."""
    if not ok:
        raise GateError(msg)


def add_cpu_flag(ap) -> None:
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the kernels' plain "
                    "versions (default: the CUDA card)")


def pick_device(cpu: bool) -> torch.device | None:
    """The CPU with ``--cpu``, else the card; None (after a message on
    stderr) when there is no card, for ``main`` to exit 2."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("error: no CUDA card (torch.cuda.is_available() is False); "
              "pass --cpu to run on the CPU", file=sys.stderr)
        return None
    return torch.device("cuda")


def load_capture(path: str, block_bytes: int) -> np.ndarray:
    """A raw uint8 IQ capture cut to whole blocks of ``block_bytes``."""
    iq = np.fromfile(path, dtype=np.uint8)
    n_blocks = iq.size // block_bytes
    if n_blocks == 0:
        raise ValueError(f"{path} holds {iq.size} bytes, less than one "
                         f"{block_bytes}-byte block")
    return iq[:n_blocks * block_bytes]


def feed_blocks(framer, bits: np.ndarray, nbits: np.ndarray) -> None:
    """Feed one channel's per-block slicer output, (B, max_bits) and (B,),
    to a framer in block order."""
    for b in range(bits.shape[0]):
        framer.feed(bits[b, :nbits[b]])


def snr_db(ref, got) -> float:
    """10 log10 of the reference's power over the error's, in float64."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10.0 * math.log10(float(np.sum(ref ** 2))
                             / max(float(np.sum(err ** 2)), 1e-300))
