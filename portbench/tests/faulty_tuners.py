"""Run the tuner-bank cell with a fault planted in the CLI's process:
tuners 0 and 1 swap every output of ``ChannelBank.run_segment_staged``
(PCM and RDS alike), so each writes the other's station. Used by the
tests on the CPU:

    python -m portbench.tests.faulty_tuners --workload tiny.tuners ...

The cell runs the CLI in a child process; this module stands in for the
child too (``child`` first).
"""

from __future__ import annotations

import sys


def plant() -> None:
    import torch

    from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
    real = ChannelBank.run_segment_staged

    def swapped(self, state, staged, n2):
        state, out = real(self, state, staged, n2)
        idx = torch.arange(self.n)
        idx[[0, 1]] = idx[[1, 0]]
        return state, out._replace(**{
            f: v[idx.to(v.device)] for f, v in out._asdict().items()
            if v is not None})
    ChannelBank.run_segment_staged = swapped


if __name__ == "__main__":
    if sys.argv[1] == "child":
        plant()
        from portbench.core.listener_child import main as child
        sys.exit(child(sys.argv[2:]))
    from portbench.core import paced_tuners
    paced_tuners.CHILD = ["portbench.tests.faulty_tuners", "child"]
    from portbench.run import main
    sys.exit(main(sys.argv[1:]))
