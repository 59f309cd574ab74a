"""Decode stereo audio + every RDS data service from a capture.

    python -m real_time_sdr_tpu_torch.examples.stereo_rds_events [capture.raw] [--mode N] [--cpu]

Port of ``examples/stereo_rds_events.py``. Without a capture path,
synthesizes 96 blocks of a station broadcasting the full RDS metadata set
this framework decodes: PS name, RadioText, clock-time (4A), an
alternative-frequency list, and the TP flag. Prints each decoded event as
it happens (the reference prints PI/PTY/PS to stderr,
src/rds_utilities.cpp:180-196). ``Receiver(mode, stereo=True, rds=True,
pll_tier=3).run_segment`` decodes the capture in one pass (on the card:
``frontend_fused``, ``fir_bank`` through both bodies, ``fir_decimate``);
the host ``RdsFramer`` turns its bits into events. On the synthesized
station, PS, PI, PTY, RadioText, the clock, the AF list and TP must come
out as sent: the framer's events on the bits that were sent.
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.examples import (add_cpu_flag, check,
                                              feed_blocks, load_capture,
                                              pick_device)
from real_time_sdr_tpu_torch.models.rds_framing import RdsEvents, RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.utils import synth

BLOCKS = 96
SENT = dict(ps_name="EXAMPLE ", pi=0x3A5C, pty=9,
            radiotext="TPU-NATIVE SDR EXAMPLE",
            clock=(2026, 8, 18, 12, 0, -8), af_mhz=(98.1, 101.5))
# the events the check holds against what was sent
FIELDS = ("pi", "pty", "ps_name", "radiotext", "clock_utc", "alt_freqs_mhz",
          "traffic_program")


class StereoResult(NamedTuple):
    left: np.ndarray       # (n,) float32
    right: np.ndarray
    fs: int
    events: RdsEvents      # the framer's events after the capture
    log: list              # every (kind, value) event in order
    bits: np.ndarray       # (B, max_bits) int32 slicer output
    nbits: np.ndarray      # (B,)


def fixture(mode: int = 0) -> tuple[np.ndarray, dict]:
    """The synthesized capture and what it sends (``station_iq``'s
    truth)."""
    return synth.station_iq(mode_config(mode), BLOCKS, **SENT)


def sent_events(truth: dict) -> RdsEvents:
    """The framer's events on the bits that were sent, twice over."""
    fr = RdsFramer()
    fr.feed(np.asarray(truth["bits"] * 2, np.int8))
    return fr.events


def run(iq: np.ndarray | None = None, *, sent: dict | None = None,
        mode: int = 0, device=None, on_event=None) -> StereoResult:
    """Decode ``iq`` (None: ``fixture(mode)``, whose truth is then
    ``sent``) to stereo audio and RDS events, each event also passed to
    ``on_event(kind, value)``. With ``sent`` (a ``station_iq`` truth)
    raises ``GateError`` unless every field of ``FIELDS`` decodes as
    sent."""
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=3, device=device)
    cfg = rx.cfg
    if iq is None:
        iq, sent = fixture(mode)
    blk = 2 * cfg.block_size_iq
    if iq.size == 0 or iq.size % blk:
        raise ValueError(f"a capture of {iq.size} bytes is not a whole "
                         f"number of {blk}-byte blocks")
    log = []

    def record(kind, val):
        log.append((kind, val))
        if on_event is not None:
            on_event(kind, val)
    framer = RdsFramer(on_event=record)
    seg = torch.from_numpy(np.ascontiguousarray(iq)).to(rx.device)[None]
    _, out = rx.run_segment(rx.init_state(1), seg)
    bits = out.rds_bits[0].cpu().numpy().reshape(-1, out.rds_bits.shape[-1])
    nbits = out.rds_nbits[0].cpu().numpy().reshape(-1)
    feed_blocks(framer, bits, nbits)
    left, right = out.left[0].cpu().numpy(), out.right[0].cpu().numpy()
    check(bool(np.isfinite(left).all() and np.isfinite(right).all()),
          "the decoded audio is not finite")
    ev = framer.events
    if sent is not None:
        want = sent_events(sent)
        for f in FIELDS:
            check(getattr(ev, f) == getattr(want, f),
                  f"{f}: decoded {getattr(ev, f)!r}, sent "
                  f"{getattr(want, f)!r}")
    return StereoResult(left, right, cfg.audio_fs, ev, log, bits, nbits)


def summary(res: StereoResult) -> list[str]:
    """The script's summary lines."""
    ev, left, right = res.events, res.left, res.right
    pi = f"{ev.pi:#06x}" if ev.pi is not None else "never synced"
    return [f"\nstation summary: PI={pi} PTY={ev.pty!r} PS={ev.ps_name!r}",
            f"  RadioText: {ev.radiotext.rstrip()!r}",
            f"  Clock:     {ev.clock_utc}",
            f"  AF:        {ev.alt_freqs_mhz} MHz  TP={ev.traffic_program}",
            f"  audio:     {left.size} samples/ch at {res.fs} Hz, "
            f"L rms {np.sqrt(np.mean(left ** 2)):.3f} "
            f"R rms {np.sqrt(np.mean(right ** 2)):.3f}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.examples.stereo_rds_events",
        description=__doc__.split("\n")[0])
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("--mode", type=int, default=0)
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    sent = None
    if args.capture:
        iq = load_capture(args.capture,
                          2 * mode_config(args.mode).block_size_iq)
    else:
        iq, sent = fixture(args.mode)
        print(f"synthesized {BLOCKS} blocks with PS+RadioText+CT+AF")
    res = run(iq, sent=sent, mode=args.mode, device=device,
              on_event=lambda kind, val: print(f"  {kind}: {val}"))
    print("\n".join(summary(res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
