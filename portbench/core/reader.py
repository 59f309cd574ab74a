"""The benchmark's PCM reader: a process of its own that drains the
program's outputs as fast as they fill, stamps the time each whole block
of PCM arrives (``time.monotonic``, the clock every process of a run
shares), and keeps the bytes of the blocks the correctness check may
compare (every ``mod``-th block from ``res`` of the outputs it is told).

Header (one JSON line on stdin): ``paths``, ``files`` (false: FIFOs,
drained as they fill; true: regular files the program writes, read
from their start every ``POLL_S``), ``block_bytes``, ``keep`` ({output
index: [mod, res]}). It prints ``ready`` once every output is open; the
line ``stop`` on stdin makes it drain what is there and print, as a
pickle, ``times`` (per output, an array of arrival times, one per
block), ``kept`` (per output, {block: bytes}), ``extra`` (bytes after
the last whole block), ``full_reads`` (FIFOs: reads that found a FIFO's
buffer full, where the writer may have waited on this reader) and
``lag_ms_max`` (files: the longest round of reads, how late a stamp can
be).
"""

from __future__ import annotations

import fcntl
import json
import os
import pickle
import selectors
import sys
import time
from array import array

from portbench.core.fifos import F_GETPIPE_SZ, die_with_parent, open_both_ends


POLL_S = 0.001


def main() -> int:
    die_with_parent()
    hdr = json.loads(sys.stdin.buffer.readline())
    bb = int(hdr["block_bytes"])
    keep = {int(k): (int(m), int(r)) for k, m, r in
            ((k, *v) for k, v in hdr.get("keep", {}).items())}
    files = bool(hdr["files"])
    fds = [os.open(p, os.O_RDONLY) if files else open_both_ends(p)
           for p in hdr["paths"]]
    n = len(fds)
    sizes = [0 if files else fcntl.fcntl(fd, F_GETPIPE_SZ) for fd in fds]
    lag, full = [0.0], [0]
    times = [array("d") for _ in range(n)]
    kept: list[dict] = [{} for _ in range(n)]
    pending = [bytearray() for _ in range(n)]
    total = [0] * n
    sel = selectors.DefaultSelector()
    if not files:
        for i, fd in enumerate(fds):
            sel.register(fd, selectors.EVENT_READ, i)
    os.set_blocking(0, True)
    sel.register(0, selectors.EVENT_READ, -1)
    sys.stdout.buffer.write(b"ready\n")
    sys.stdout.buffer.flush()

    def take(i: int, data: bytes, t: float) -> None:
        full[0] += not files and len(data) >= sizes[i]
        before = total[i] // bb
        total[i] += len(data)
        done = total[i] // bb - before
        if i in keep:
            mod, res = keep[i]
            buf = pending[i]
            buf += data
            for j in range(before, before + done):
                if j % mod == res:
                    kept[i][j] = bytes(buf[:bb])
                del buf[:bb]
        if done:
            times[i].extend([t] * done)

    def read_all(i: int, drain: bool = False) -> None:
        while True:
            try:
                data = os.read(fds[i], 1 << 20)
            except BlockingIOError:
                return
            if not data:
                return
            take(i, data, time.monotonic())
            if not (files or drain):
                return

    stopping = False
    while not stopping:
        if files:
            t = time.monotonic()
            for i in range(n):
                read_all(i)
            lag[0] = max(lag[0], time.monotonic() - t)
        for key, _ in sel.select(POLL_S if files else None):
            if key.data < 0:              # "stop", or stdin closed
                os.read(0, 4096)
                stopping = True
            else:
                read_all(key.data)
    for i, fd in enumerate(fds):          # drain what is there
        read_all(i, drain=True)
        os.close(fd)
    sys.stdout.buffer.write(pickle.dumps(dict(
        times=[t.tobytes() for t in times], kept=kept,
        extra=[t % bb for t in total], full_reads=full[0],
        lag_ms_max=lag[0] * 1e3)))
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
