"""The program's standard error, taken in process.

The band cell runs the CLI's ``main`` inside the harness, so its stderr
lines (RDS events, ``--stats`` block times, set-up messages)
are what a user of the CLI reads. ``Tap`` stands in for ``sys.stderr``
while the program runs: each write is kept with its time and its thread,
and costs an append, about what a write to a terminal's buffer costs.
``on_block`` is called, in the writing thread, at each ``--stats`` block
line: the harness starts and stops its traced sub-window there;
``on_warm`` once, at the ``warmed up`` line: the harness starts its
paced load there.
"""

from __future__ import annotations

import io
import threading
import time
from array import array


class Tap(io.TextIOBase):
    """Kept in three flat arrays (strings are no work for the cyclic
    garbage collector, tuples would be: a run writes some 10^5 chunks)."""

    def __init__(self, on_block=None, on_warm=None):
        self.texts: list[str] = []
        self.times = array("d")
        self.threads = array("Q")
        self.lock = threading.Lock()
        self.on_block = on_block
        self.on_warm = on_warm

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        t = time.monotonic()
        with self.lock:
            self.texts.append(s)
            self.times.append(t)
            self.threads.append(threading.get_ident())
        if self.on_block is not None and s.startswith("block "):
            self.on_block(t)
        elif self.on_warm is not None and s.startswith("warmed up"):
            self.on_warm()
            self.on_warm = None
        return len(s)

    def flush(self) -> None:
        pass

    def lines(self) -> list[tuple[float, int, str]]:
        """(time of its first chunk, thread ident, text) per line, in the
        order each thread wrote them."""
        out, part = [], {}
        for t, tid, s in zip(self.times, self.threads, self.texts):
            t0, acc = part.get(tid, (t, ""))
            acc += s
            while "\n" in acc:
                line, acc = acc.split("\n", 1)
                out.append((t0, tid, line))
                t0 = t
            part[tid] = (t0, acc) if acc else (t, "")
            if not acc:
                part.pop(tid)
        for tid, (t0, acc) in part.items():
            out.append((t0, tid, acc))
        return out
