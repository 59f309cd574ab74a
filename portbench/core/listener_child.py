"""One listener: the port's one-station CLI (``real_time_sdr_tpu_torch.cli``
``main``) in a process of its own, as a tuner's demodulator is deployed
(``rtl_sdr | <demodulator> | aplay``).

    python -m portbench.core.listener_child <result.json> <trace 0|1> \
        <at_s> <len_s> -- <CLI arguments>

The CLI's standard error goes on to this process's (the harness stamps
each line as it arrives). A traced run's profiler is prepared before the
CLI starts and records from ``at_s`` to ``at_s + len_s`` after the CLI's
first ``--stats`` block line, in the CLI's thread. When the CLI returns,
``result.json`` gets its exit code, the card's name and peak memory, the
traced sub-window reduced, and any module of JAX or of the JAX package
this process loaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time


class _Forward(io.TextIOBase):
    """Stands in for ``sys.stderr``: passes every write on, and calls
    ``on_block`` at each ``--stats`` block line."""

    def __init__(self, out, on_block):
        self.out, self.on_block = out, on_block

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        self.out.write(s)
        if s.startswith("block "):
            self.on_block(time.monotonic())
        return len(s)

    def flush(self) -> None:
        self.out.flush()


def main(argv: list[str]) -> int:
    from portbench.core.fifos import die_with_parent
    die_with_parent()
    path, trace, at_s, len_s = argv[0], argv[1] == "1", float(argv[2]), \
        float(argv[3])
    cli_argv = argv[argv.index("--") + 1:]
    import torch
    from portbench.core.trace import Window
    from portbench.run import forbidden_modules
    from real_time_sdr_tpu_torch import cli

    cuda = "--cpu" not in cli_argv
    if cuda:
        # float32 products stay float32: the configuration states f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    window = Window(trace, at_s, len_s)

    def on_block(t: float) -> None:
        if window.t_ref is None:
            window.t_ref = t
        window.on_block(t)

    with contextlib.redirect_stderr(_Forward(sys.stderr, on_block)):
        rc = cli.main(cli_argv)
    out = dict(rc=rc, t_start=window.t_start, start_s=window.start_s,
               trace=window.result(),
               memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                  if cuda else 0),
               device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               forbidden=forbidden_modules())
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
