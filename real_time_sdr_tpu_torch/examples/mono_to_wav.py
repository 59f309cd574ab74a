"""Decode a raw uint8 IQ capture to a mono WAV file.

    python -m real_time_sdr_tpu_torch.examples.mono_to_wav [capture.raw] [out.wav] [--mode N] [--cpu]

Port of ``examples/mono_to_wav.py``. Without a capture path, synthesizes
24 blocks of a clean FM station carrying a 440/1200 Hz stereo pair
(decoded here as mono): the rtl_sdr capture -> decode -> .wav workflow of
model/fmMonoBasic.py:30-42. ``Receiver(mode).run_segment`` decodes the
whole capture in one pass (on the card: the ``frontend_fused``,
``fir_bank`` and, at modes 0-1, ``fir_decimate`` kernels); the check is
the script's own: the WAV holds every audio sample at the mode's audio
rate.
"""

from __future__ import annotations

import argparse
import sys
import wave
from typing import NamedTuple

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.examples import (add_cpu_flag, check,
                                              load_capture, pick_device)
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.io import write_wav

BLOCKS = 24


class MonoResult(NamedTuple):
    audio: np.ndarray      # (n,) float32 mono audio
    fs: int                # its sample rate
    path: str              # the WAV written
    n_blocks: int


def fixture(mode: int = 0) -> np.ndarray:
    """The synthesized capture: BLOCKS blocks of one stereo station."""
    iq, _ = synth.station_iq(mode_config(mode), BLOCKS)
    return iq


def run(iq: np.ndarray | None = None, out_wav: str = "mono.wav",
        mode: int = 0, device=None) -> MonoResult:
    """Decode ``iq`` (whole blocks of uint8 IQ; None: ``fixture(mode)``)
    as mono audio and write it to ``out_wav``; raises ``GateError`` when
    the WAV does not hold every sample at the audio rate."""
    rx = Receiver(mode, stereo=False, rds=False, device=device)
    cfg = rx.cfg
    if iq is None:
        iq = fixture(mode)
    blk = 2 * cfg.block_size_iq
    if iq.size == 0 or iq.size % blk:
        raise ValueError(f"a capture of {iq.size} bytes is not a whole "
                         f"number of {blk}-byte blocks")
    seg = torch.from_numpy(np.ascontiguousarray(iq)).to(rx.device)[None]
    _, out = rx.run_segment(rx.init_state(1), seg)
    audio = out.mono[0].cpu().numpy()
    check(bool(np.isfinite(audio).all()), "the decoded audio is not finite")
    write_wav(out_wav, audio, cfg.audio_fs, stereo=False)
    with wave.open(out_wav, "rb") as w:
        frames, rate, chans = w.getnframes(), w.getframerate(), \
            w.getnchannels()
    check(frames == audio.size and rate == cfg.audio_fs and chans == 1,
          f"{out_wav} holds {frames} frames x {chans} at {rate} Hz, not "
          f"{audio.size} x 1 at {cfg.audio_fs} Hz")
    return MonoResult(audio, cfg.audio_fs, out_wav, iq.size // blk)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.examples.mono_to_wav",
        description=__doc__.split("\n")[0])
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("out_wav", nargs="?", default="mono.wav")
    ap.add_argument("--mode", type=int, default=0)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    cfg = mode_config(args.mode)
    if args.capture:
        iq = load_capture(args.capture, 2 * cfg.block_size_iq)
        print(f"loaded {args.capture}: "
              f"{iq.size // (2 * cfg.block_size_iq)} blocks")
    else:
        iq = fixture(args.mode)
        print(f"synthesized {BLOCKS} blocks (440 Hz left / 1200 Hz right "
              "tones)")
    res = run(iq, args.out_wav, args.mode, device)
    print(f"wrote {res.path}: {res.audio.size} samples at {res.fs} Hz "
          f"({res.audio.size / res.fs:.2f} s), peak "
          f"{np.abs(res.audio).max():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
