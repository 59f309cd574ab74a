"""Named pipes between the program under test and the benchmark's
generator and reader processes, and the helper processes' lifecycle.

Every pipe is a FIFO in a private directory under ``TMPDIR``, so no
capture touches the disk. The helper processes import only the
standard library: they start in well under a second and never touch the
card.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import tempfile

F_SETPIPE_SZ, F_GETPIPE_SZ = 1031, 1032
# a pipe's buffer, largest first: the larger, the less often a writer
# waits on its reader
PIPE_BYTES = (1 << 24, 1 << 20, 1 << 19)


def set_pipe_size(fd: int) -> int:
    """Grow a pipe's buffer (a setting of this pipe only) to the largest of
    ``PIPE_BYTES`` the system grants; returns the size it has."""
    for nbytes in PIPE_BYTES:
        try:
            return fcntl.fcntl(fd, F_SETPIPE_SZ, nbytes)
        except OSError:
            continue
    return fcntl.fcntl(fd, F_GETPIPE_SZ)


def open_both_ends(path: str) -> int:
    """Open a FIFO read-write and non-blocking: the peer's blocking open
    returns at once, and the FIFO sees no end of file while it is held."""
    fd = os.open(path, os.O_RDWR | os.O_NONBLOCK)
    set_pipe_size(fd)
    return fd


def own_lag(lag: list, n: int):
    """The feeder's own lateness for each of ``n`` blocks (seconds; 0 for
    a block it never wrote), as a NumPy array."""
    import numpy as np
    out = np.zeros(n)
    k = min(n, len(lag))
    out[:k] = lag[:k]
    return out


def die_with_parent() -> None:
    """Have the kernel end this helper process when the harness ends (a
    setting of this process only)."""
    import ctypes
    import signal
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    except (OSError, AttributeError):
        pass


def workdir() -> str:
    """A private directory under ``TMPDIR`` for this run's FIFOs."""
    return tempfile.mkdtemp(prefix="portbench-")


def make_fifos(directory: str, names: list[str]) -> list[str]:
    paths = [os.path.join(directory, n) for n in names]
    for p in paths:
        os.mkfifo(p)
    return paths


class Helper:
    """A helper process (``python -m portbench.core.<module>``) that takes
    a JSON header line and optional raw bytes on stdin, prints ``ready``
    when set up, takes further command lines, and prints its result as
    its last stdout line of JSON."""

    def __init__(self, module: str, header: dict, payload=(),
                 root: str | None = None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"portbench.core.{module}"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=root,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        self.proc.stdin.write((json.dumps(header) + "\n").encode())
        for chunk in payload:
            self.proc.stdin.write(chunk)
        self.proc.stdin.flush()

    def wait_ready(self) -> None:
        line = self.proc.stdout.readline()
        if line.strip() != b"ready":
            raise RuntimeError(f"helper did not start: {line!r}")

    def send(self, line: str) -> None:
        self.proc.stdin.write((line + "\n").encode())
        self.proc.stdin.flush()

    def result(self, timeout: float = 120.0):
        """Close stdin, wait for the exit, and return the result object
        (a pickle on stdout after the ready line)."""
        import pickle
        out, _ = self.proc.communicate(timeout=timeout)
        if self.proc.returncode != 0:
            raise RuntimeError(f"helper exited {self.proc.returncode}")
        return pickle.loads(out)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
