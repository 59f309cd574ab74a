"""Decode 4 FM stations in parallel from ONE wideband capture.

    python -m real_time_sdr_tpu_torch.examples.wideband_multistation [--cpu]

Port of ``examples/wideband_multistation.py``. Synthesizes a 9.6 MS/s
wideband capture containing four stations at different frequency
offsets, channelizes it and decodes every station through a receiver
bank, one block at a time: the reference needs one rtl_sdr stream and one
process per station; here one capture feeds them all.
``make_wideband_frontend`` picks the fused one-matmul frontend on any real
station raster (the fold product, a library GEMM on the card), and
``ChannelBank(rx, 4).run_wideband_jit`` serves each block as one replay of
a captured CUDA graph (the ``fir_bank`` and ``fir_decimate`` kernels
inside); on the CPU it runs eagerly. The check: every station's PS as
sent.
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.examples import (add_cpu_flag, check,
                                              pick_device)
from real_time_sdr_tpu_torch.models.rds_framing import RdsEvents, RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    make_wideband_frontend
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils import synth

BLOCKS = 24
STATIONS = [
    dict(offset_hz=-3_000_000, ps_name="STATION1", pi=0x1001),
    dict(offset_hz=-1_000_000, ps_name="STATION2", pi=0x1002),
    dict(offset_hz=1_000_000, ps_name="STATION3", pi=0x1003),
    dict(offset_hz=3_000_000, ps_name="STATION4", pi=0x1004),
]


class WidebandResult(NamedTuple):
    frontend: str                 # the frontend the factory picked
    events: list[RdsEvents]       # each station's framer events
    decoded: int                  # stations whose PS came out as sent
    left: np.ndarray              # (S, n) float32
    right: np.ndarray


def wide_fs() -> int:
    return 4 * mode_config(0).rf_fs        # 9.6 MS/s


def fixture() -> tuple[np.ndarray, np.ndarray]:
    """The synthesized capture's float32 I and Q rails at ``wide_fs()``."""
    iw, qw, _ = synth.wideband_iq(mode_config(0), wide_fs(), STATIONS,
                                  BLOCKS)
    return iw, qw


def run(rails: tuple[np.ndarray, np.ndarray] | None = None,
        device=None) -> WidebandResult:
    """Channelize and decode ``rails`` (None: ``fixture()``) block by
    block; raises ``GateError`` unless every station's PS decodes as
    sent."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=device)
    cfg, dev = rx.cfg, rx.device
    iw, qw = fixture() if rails is None else rails
    fe = make_wideband_frontend(cfg, wide_fs(),
                                [s["offset_hz"] for s in STATIONS],
                                device=dev)
    bank = ChannelBank(rx, n_channels=len(STATIONS))
    framers = [RdsFramer() for _ in STATIONS]
    cstate, bstate = fe.init_state(), bank.init_state()
    i_wide = torch.from_numpy(iw).to(dev)
    q_wide = torch.from_numpy(qw).to(dev)
    block_wide = cfg.block_size_iq * fe.decim
    left, right = [], []
    for b in range(i_wide.shape[0] // block_wide):
        sl = slice(b * block_wide, (b + 1) * block_wide)
        bstate, out, cstate = bank.run_wideband_jit(
            bstate, fe, i_wide[sl], q_wide[sl], cstate)
        bits, nbits = out.rds_bits.cpu().numpy(), out.rds_nbits.cpu().numpy()
        for k, fr in enumerate(framers):
            fr.feed(bits[k, :nbits[k]])
        left.append(out.left.cpu().numpy())
        right.append(out.right.cpu().numpy())
    left, right = np.concatenate(left, -1), np.concatenate(right, -1)
    check(bool(np.isfinite(left).all() and np.isfinite(right).all()),
          "the decoded audio is not finite")
    events = [fr.events for fr in framers]
    decoded = sum(ev.ps_name == st["ps_name"]
                  for ev, st in zip(events, STATIONS))
    res = WidebandResult(type(fe).__name__, events, decoded, left, right)
    check(decoded == len(STATIONS),
          f"{decoded}/{len(STATIONS)} stations decoded their PS: "
          f"{[ev.ps_name for ev in events]}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.examples."
        "wideband_multistation", description=__doc__.split("\n")[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    print(f"synthesizing {wide_fs() / 1e6:g} MS/s wideband capture, "
          f"{len(STATIONS)} stations, {BLOCKS} blocks ...")
    res = run(fixture(), device)
    print(f"frontend: {res.frontend}")
    for k, (st, ev) in enumerate(zip(STATIONS, res.events)):
        mark = "ok" if ev.ps_name == st["ps_name"] else "MISMATCH"
        print(f"  station {k} @ {st['offset_hz'] / 1e6:+.1f} MHz: "
              f"PS={ev.ps_name!r} (sent {st['ps_name']!r}) {mark}")
    print(f"{res.decoded}/{len(STATIONS)} stations decoded from one capture")
    return 0


if __name__ == "__main__":
    sys.exit(main())
