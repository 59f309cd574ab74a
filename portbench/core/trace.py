"""The traced sub-window of a ``--trace 1`` run and its reduction.

``Window`` prepares ``torch.profiler`` (host and device activity) in
set-up, before the measured window, where its tracer's slow start costs
nothing the window sees; it starts recording ``at_s`` seconds into the
window and stops ``len_s`` seconds later, in the thread that prepared it:
at the CLI's ``--stats`` block lines (whole steady segments or
blocks), in the CLI's own thread. ``reduce_trace`` turns the exported Chrome trace into what the
per-layer readers read: every device operation's name, count and time,
the device's busy time (the union of its kernel, copy and set
intervals), and the longest idle gaps, each named by the host operation
that covers most of it (or as host time with no operation recorded,
Python or a wait on the program's input, where none covers half).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120        # of an operation's name in the breakdown
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


class Window:
    def __init__(self, enabled: bool, at_s: float, len_s: float):
        self.enabled = enabled
        self.at_s, self.len_s = at_s, len_s
        self.t_ref = None           # start of the measured window
        self.prof = None
        self.t_start = self.t_stop = None
        self.start_s = None         # how long starting the recording took
        if enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.prepare_trace()

    def on_block(self, t: float) -> None:
        if not self.enabled or self.t_ref is None or self.t_stop:
            return
        if self.t_start is None and t >= self.t_ref + self.at_s:
            self.start()
        elif self.t_start is not None and t >= self.t_start + self.len_s:
            self.stop()

    def start(self) -> None:
        t = time.monotonic()
        self.prof.start_trace()
        self.t_start = time.monotonic()
        self.start_s = self.t_start - t

    def stop(self) -> None:
        self.prof.stop_trace()
        self.t_stop = time.monotonic()

    def result(self) -> dict | None:
        """The reduced trace, or None when no window was traced."""
        if self.t_start is None:
            return None
        if self.t_stop is None:
            self.stop()
        fd, path = tempfile.mkstemp(suffix=".json")   # under TMPDIR
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return reduce_trace(events, self.t_stop - self.t_start)


def _merge(iv: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list[dict], window_s: float) -> dict:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    ops: dict[str, list] = {}
    for e in dev:
        o = ops.setdefault(e["name"], [0, 0.0])
        o[0] += 1
        o[1] += float(e["dur"]) * 1e-6
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS
            and not str(e.get("name", "")).startswith("ProfilerStep")]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:10]
    idle = []
    for g, a, b in gaps:
        best, name = 0.0, ""
        for e in host:
            ov = min(b, float(e["ts"]) + float(e["dur"])) - max(
                a, float(e["ts"]))
            if ov > best:
                best, name = ov, e["name"]
        if best < g / 2:        # most of the gap outside any recorded op
            name = "host, no operation recorded (Python, or waiting on input)"
        idle.append([name[:NAME_CHARS], g * 1e-6])
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])
    return dict(ops={k: v for k, v in top}, busy_s=busy_s,
                window_s=window_s, idle_gaps=idle,
                device_ops=[[k[:NAME_CHARS], v[1]] for k, v in top[:10]])
