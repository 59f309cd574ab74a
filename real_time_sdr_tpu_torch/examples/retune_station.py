"""Re-point one station of a live wideband grid WITHOUT a new graph.

    python -m real_time_sdr_tpu_torch.examples.retune_station [--cpu]

Port of ``examples/retune_station.py``. The reference retunes by
restarting ``rtl_sdr -f`` (and the receiver with it): seconds of dead
air, all state lost. Here ``ChannelBank.run_wideband_jit`` serves the
fused wideband frontend as replays of one captured CUDA graph that reads
the frontend's weight buffers where they lie, and
``FusedWidebandFrontend.retune(station, hz)`` rebuilds one station's
weight columns on the host and copies them into those buffers in place.
So the SAME graph keeps serving (the bank's graph cache holds as many
graphs after the retune as before) and every other station's DSP and
framer state carries straight through. The JAX script passes the weights
as operands (``weights=wf.device_weights()``); the port's graph needs
none. Station 0 runs uninterrupted: its outputs equal, tensor for tensor,
those of the same capture served with no retune. The CLI twin is
``--retune SEG:STATION:HZ``.
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
    FusedWidebandFrontend
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils import synth

# three transmitters on the air; the 2-station grid starts on A + B
SKY = [dict(offset_hz=-600_000, ps_name="SVC-A   ", pi=0xA111),
       dict(offset_hz=800_000, ps_name="SVC-B   ", pi=0xB222),
       dict(offset_hz=1_200_000, ps_name="SVC-C   ", pi=0xC333)]
GRID = [-600_000, 800_000]
RETUNE = (1, 1_200_000)          # station 1: B -> C
BLOCKS, SEG, SEGMENTS_BEFORE = 48, 12, 2


class RetuneResult(NamedTuple):
    before: tuple            # (ch0 PS, ch1 PS) after the first segments
    after: tuple             # (ch0 PS, ch1 PS) at the end
    events: list[RdsEvents]  # both framers' events at the end
    graphs_before: int       # graphs in the bank's cache before the retune
    graphs_after: int        # ... and after the segments that follow it
    station0_equal: bool     # station 0 == the run with no retune
    left: np.ndarray         # (2, n) float32
    right: np.ndarray


def wide_fs() -> int:
    return 4 * mode_config(0).rf_fs        # 9.6 MS/s


def fixture() -> tuple[np.ndarray, np.ndarray]:
    """The synthesized capture's float32 I and Q rails at ``wide_fs()``."""
    iw, qw, _ = synth.wideband_iq(mode_config(0), wide_fs(), SKY, BLOCKS)
    return iw, qw


def run(rails: tuple[np.ndarray, np.ndarray] | None = None, device=None,
        on_retune=None) -> RetuneResult:
    """Serve ``rails`` (None: ``fixture()``) in 12-block segments through
    the 2-station grid, retuning station 1 after the second segment (then
    ``on_retune(before)`` is called, before is ``(ch0 PS, ch1 PS)``), and
    once more with no retune. Raises ``GateError`` unless ch1 decodes
    SVC-B before and SVC-C after the retune, ch0 SVC-A, the retune adds no
    graph, and station 0's outputs equal the run with no retune."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=device)
    cfg, dev = rx.cfg, rx.device
    iw, qw = fixture() if rails is None else rails
    bank = ChannelBank(rx, n_channels=len(GRID))
    i_wide = torch.from_numpy(iw).to(dev)
    q_wide = torch.from_numpy(qw).to(dev)
    n_seg = cfg.block_size_iq * (wide_fs() // cfg.rf_fs) * SEG
    n_segments = i_wide.shape[0] // n_seg

    def serve(wf, bs, ws, s, framers, outs):
        sl = slice(s * n_seg, (s + 1) * n_seg)
        bs, out, ws = bank.run_wideband_jit(bs, wf, i_wide[sl], q_wide[sl],
                                            ws)
        nbits, bits = out.rds_nbits.cpu().numpy(), out.rds_bits.cpu().numpy()
        for k, fr in enumerate(framers):
            for bi in range(nbits.shape[1]):
                if nbits[k, bi] > 0:
                    fr.feed(bits[k, bi][:nbits[k, bi]])
        outs.append(out)
        return bs, ws

    # the same capture with no retune: station 0's reference
    ref = FusedWidebandFrontend(cfg, wide_fs(), list(GRID), device=dev)
    bs, ws, ref_outs = bank.init_state(), ref.init_state(), []
    for s in range(n_segments):
        bs, ws = serve(ref, bs, ws, s, [], ref_outs)

    wf = FusedWidebandFrontend(cfg, wide_fs(), list(GRID), device=dev)
    bs, ws, outs = bank.init_state(), wf.init_state(), []
    framers = [RdsFramer(), RdsFramer()]
    for s in range(SEGMENTS_BEFORE):
        bs, ws = serve(wf, bs, ws, s, framers, outs)
    before = tuple(fr.events.ps_name for fr in framers)
    if on_retune is not None:
        on_retune(before)
    graphs_before = len(rx.graphs)
    wf.retune(*RETUNE)
    framers[RETUNE[0]] = RdsFramer()       # a new program, a fresh framer
    for s in range(SEGMENTS_BEFORE, n_segments):
        bs, ws = serve(wf, bs, ws, s, framers, outs)
    graphs_after = len(rx.graphs)
    after = tuple(fr.events.ps_name for fr in framers)

    station0_equal = all(
        torch.equal(a[0], b[0])
        for o, r in zip(outs, ref_outs)
        for a, b in zip(o, r) if a is not None)
    left = torch.cat([o.left for o in outs], -1).cpu().numpy()
    right = torch.cat([o.right for o in outs], -1).cpu().numpy()
    res = RetuneResult(before, after, [fr.events for fr in framers],
                       graphs_before, graphs_after, station0_equal, left,
                       right)
    check(bool(np.isfinite(left).all() and np.isfinite(right).all()),
          "the decoded audio is not finite")
    check(before[1] == SKY[1]["ps_name"],
          f"before the retune ch1 decoded {before[1]!r}, not "
          f"{SKY[1]['ps_name']!r}")
    check(after == (SKY[0]["ps_name"], SKY[2]["ps_name"]),
          f"after the retune ch0/ch1 decoded {after!r}, not "
          f"{(SKY[0]['ps_name'], SKY[2]['ps_name'])!r}")
    check(graphs_after == graphs_before,
          f"the retune added graphs: {graphs_before} -> {graphs_after}")
    check(station0_equal, "station 0's outputs differ from the run with no "
          "retune")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.examples.retune_station",
        description=__doc__.split("\n")[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2

    def show(before):
        print(f"before retune: ch0 PS={before[0]!r}  ch1 PS={before[1]!r}")
        print(f"retuned station {RETUNE[0]} -> {RETUNE[1] / 1e6:+.1f} MHz "
              "(same graph)")
    res = run(fixture(), device, on_retune=show)
    print(f"after  retune: ch0 PS={res.after[0]!r}  ch1 PS={res.after[1]!r}")
    print(f"graphs in the bank's cache: {res.graphs_before} before the "
          f"retune, {res.graphs_after} after; station 0 equal to the run "
          f"with no retune: {res.station0_equal}")
    print("OK: station 0 uninterrupted, station 1 now decodes SVC-C")
    return 0


if __name__ == "__main__":
    sys.exit(main())
