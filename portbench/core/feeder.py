"""The benchmark's load generator: a process of its own that writes the
captures the harness made into the program's input FIFOs, in an open
loop.

One capture per FIFO, played in a loop, block by block on a fixed
schedule that does not slow when the program does: FIFO k's block j is
written whole at its due time ``t0 + offsets_s[k] + (j + 1) * period_s``
(the moment its last byte would leave a tuner), from the ``go`` line on
stdin until ``seconds`` + ``tail_blocks`` periods. It reports, per
block, how late the feeder started its write after it could have (its
due time, or the moment the FIFO took the block before: the generator's
own lag) and how late the write finished (a program that falls behind
fills its pipe).

The header is one JSON line on stdin, followed by the capture bytes; the
result is a pickle on stdout after the ``ready`` line.
"""

from __future__ import annotations

import json
import os
import pickle
import selectors
import sys
import time

from portbench.core.fifos import die_with_parent, open_both_ends

GRACE_S = 60.0   # past the schedule's end, a listener that reads nothing


def _read_exact(f, n: int) -> bytes:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = f.readinto(view[got:])
        if not k:
            raise EOFError(f"capture ended after {got} of {n} bytes")
        got += k
    return bytes(buf)


def paced(hdr: dict, data: bytes) -> dict:
    fds = [open_both_ends(p) for p in hdr["fifos"]]
    for fd in fds:
        os.set_blocking(fd, False)
    nb, bb = int(hdr["nbytes"]), int(hdr["block_bytes"])
    period = float(hdr["period_s"])
    offs = [float(x) for x in hdr["offsets_s"]]
    sys.stdout.buffer.write(b"ready\n")
    sys.stdout.buffer.flush()
    if not sys.stdin.buffer.readline():       # "go", or the harness ended
        return dict(t0=None, blocks=0, lag=[], done=[])
    t0 = time.monotonic()
    n_blocks = int((float(hdr["seconds"]) - max(offs)) / period) \
        + int(hdr["tail_blocks"])
    lag = [[] for _ in fds]           # write started - when it could
    done = [[] for _ in fds]          # write finished - due
    free_at = [0.0] * len(fds)        # when the listener's pipe took the last
    pending: list[memoryview | None] = [None] * len(fds)
    due_of = [0.0] * len(fds)
    nxt = [0] * len(fds)
    sel = selectors.DefaultSelector()

    def push(k: int) -> None:
        try:
            w = os.write(fds[k], pending[k])
        except BlockingIOError:
            w = 0
        pending[k] = pending[k][w:]
        if not len(pending[k]):
            pending[k] = None
            free_at[k] = time.monotonic()
            done[k].append(free_at[k] - due_of[k])
            if fds[k] in sel.get_map():
                sel.unregister(fds[k])
        elif fds[k] not in sel.get_map():
            sel.register(fds[k], selectors.EVENT_WRITE, k)

    view = memoryview(data)
    give_up = t0 + max(offs) + (n_blocks + 1) * period + GRACE_S
    while time.monotonic() < give_up:
        live = [k for k in range(len(fds)) if nxt[k] < n_blocks]
        if not live and not any(p is not None for p in pending):
            break
        due = [(t0 + offs[k] + (nxt[k] + 1) * period, k) for k in live
               if pending[k] is None]
        wake = min(due)[0] if due else time.monotonic() + 0.01
        timeout = max(0.0, wake - time.monotonic())
        if sel.get_map():
            for key, _ in sel.select(timeout):
                push(key.data)
        else:
            time.sleep(timeout)
        now = time.monotonic()
        for d, k in due:
            if d <= now and pending[k] is None:
                # block j of the capture played in a loop
                a = (nxt[k] * bb) % nb
                cap = view[k * nb:(k + 1) * nb]
                pending[k] = (cap[a:a + bb] if a + bb <= nb else
                              memoryview(bytes(cap[a:]) + bytes(cap[:a + bb - nb])))
                due_of[k] = d
                nxt[k] += 1
                lag[k].append(now - max(d, free_at[k]))
                push(k)
    for fd in fds:
        os.close(fd)
    return dict(t0=t0, blocks=n_blocks, lag=lag, done=done)


def main() -> int:
    die_with_parent()
    stdin = sys.stdin.buffer
    hdr = json.loads(stdin.readline())
    data = _read_exact(stdin, int(hdr["nbytes"]) * len(hdr["fifos"]))
    out = paced(hdr, data)
    sys.stdout.buffer.write(pickle.dumps(out))
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
