"""Run one cell with a fault planted in the program underneath: the check
must find each of them. Used by the tests on the CPU.

    python -m portbench.tests.faulty <fault> --workload tiny.audio ...

The listener cell runs the CLI in a child process: the fault is planted
there too (this module stands in for the child, ``child`` first).

Faults: ``state`` (the served step returns the state it was given),
``half`` (half of the stations' audio left out), ``answer`` (one PCM
sample of every block altered where the PCM is produced), ``ps`` (the
framers' station names altered where they are emitted).
"""

from __future__ import annotations

import sys


def plant(fault: str) -> None:
    import torch

    from real_time_sdr_tpu_torch.models import rds_framing
    from real_time_sdr_tpu_torch.models.receiver import Receiver
    from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
    from real_time_sdr_tpu_torch.utils import audio

    band_step = ChannelBank.run_wideband_u8_jit
    one_step = Receiver.jit_run_segment_staged
    if fault == "state":
        def stuck_band(self, state, fe, raw, festate):
            _, out, _ = band_step(self, state, fe, raw, festate)
            return state, out, festate

        def stuck_one(self, state, xp, n):
            return state, one_step(self, state, xp, n)[1]
        ChannelBank.run_wideband_u8_jit = stuck_band
        Receiver.jit_run_segment_staged = stuck_one
    elif fault == "half":
        def half_band(self, state, fe, raw, festate):
            st, out, fst = band_step(self, state, fe, raw, festate)
            keep = torch.ones_like(out.left)
            keep[keep.shape[0] // 2:] = 0
            return st, out._replace(left=out.left * keep,
                                    right=out.right * keep), fst
        ChannelBank.run_wideband_u8_jit = half_band
    elif fault == "answer":
        pcm = audio.stereo_pcm

        def altered(left, right):
            left = left.clone()
            left[..., ::1470] += 0.25
            return pcm(left, right)
        audio.stereo_pcm = altered
    elif fault == "ps":
        init = rds_framing.RdsFramer.__init__

        def renamed(self, on_event=None, **kw):
            def emit(kind, val):
                on_event(kind, val[::-1] if kind == "ps" else val)
            init(self, on_event=None if on_event is None else emit, **kw)
        rds_framing.RdsFramer.__init__ = renamed
    else:
        raise ValueError(f"unknown fault {fault!r}")


if __name__ == "__main__":
    import os
    if sys.argv[1] == "child":
        plant(os.environ["PORTBENCH_TEST_FAULT"])
        from portbench.core.listener_child import main as child
        sys.exit(child(sys.argv[2:]))
    os.environ["PORTBENCH_TEST_FAULT"] = sys.argv[1]
    plant(sys.argv[1])
    from portbench.core import paced_listeners
    paced_listeners.CHILD = ["portbench.tests.faulty", "child"]
    from portbench.run import main
    sys.exit(main(sys.argv[2:]))
