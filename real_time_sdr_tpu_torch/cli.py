"""Command-line receiver on PyTorch: uint8 IQ on stdin -> int16 PCM on
stdout, RDS text on stderr.

    rtl_sdr -f 99.9M -s 2.4M - | python -m real_time_sdr_tpu_torch.cli 0 r \\
        | aplay -r 48000 -f S16_LE -c 2

Both serving paths of ``real_time_sdr_tpu/cli.py`` on the port, with the
same positionals, flags, defaults and stderr lines: the single-station
pipe, and with ``--stations`` the wideband multi-station mode
(``run_wideband``: one wideband capture in, one ``station_<k>.pcm`` per
station under ``--output-dir``, RDS text as ``ch<k> <kind>: <val>``).

    python -m real_time_sdr_tpu_torch.cli 0 r --stations=-2000000,1500000 \
        --wide-fs 9600000 --output-dir stations --segment 12 < wide.raw

It runs on the CUDA card unless ``--cpu`` is given; without a card and
without ``--cpu`` it exits with status 2 instead of running on the CPU.

The host loop reads ``--segment`` blocks per group through the native
ring-buffered reader, uploads the group (``--staged``: as the staged
operand ``[tail | group]`` written into a ring of pinned host buffers, one
asynchronous copy, served by ``Receiver.jit_run_segment_staged``; else
``Receiver.jit_step``), replays the receiver's captured graph for the
group's shape (the first group of a shape, and an EOF partial group,
capture one; on the CPU the eager receiver runs), starts the PCM and RDS
copies back into pinned memory and hands the fetch to a drain thread
(``_DrainWorker``), which waits once per group on its CUDA event and then
writes the PCM and feeds the RDS framer: each group is drained as soon as
the device is done, not when later input arrives. An upload waits while
more than ``--pipeline`` groups are not yet drained (0: each group is
drained before the next read). The wideband loop does the same with one
(S, ...) PCM tensor and one fetch per segment, served by
``ChannelBank.run_wideband_u8_jit``; there ``--pipeline`` bounds the
segments submitted and not yet drained. With ``--tuners``
(``run_tuners``) the same serving thread and drain worker decode
independent tuners, one input per tuner, as the rows of one channel bank
(``ChannelBank.run_segment_staged`` from one pinned (T, ...) staged slot a
segment):

    python -m real_time_sdr_tpu_torch.cli 0 r --tuners a.raw,b.raw,c.raw \
        --output-dir stations --segment 4 --pipeline 2

``--retune SEG:STATION:HZ`` re-points a station
of the fused frontend between segments, ``--checkpoint`` resumes onto the
grid the saved state was built on (its ``.rds.json`` sidecar names it),
and ``--wb-fir {f32,bf16,bf16x2}`` sets the wideband frontend's precision
(the JAX package reads it from ``RTSDR_WB_FIR`` / ``RTSDR_CHAN_FIR``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import select
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# flags that only mean something together with --stations
WIDEBAND_ONLY_FLAGS = ("wide_fs", "output_dir", "retune", "wb_fir")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="real_time_sdr_tpu_torch",
        description="PyTorch/CUDA FM mono/stereo receiver with RDS decoding "
                    "(the port of real_time_sdr_tpu)")
    # both positionals are optional: the reference defaults to mode-0 mono
    # when launched with fewer than two args (src/project.cpp:46-47)
    ap.add_argument("mode", type=int, choices=(0, 1, 2, 3), nargs="?",
                    default=0,
                    help="sample-rate mode (src/project.cpp:67-108); "
                         "default 0")
    ap.add_argument("type", choices=("m", "s", "r"), nargs="?", default="m",
                    help="m=mono, s=stereo, r=stereo+RDS; default m")
    ap.add_argument("--input", default="-", help="raw uint8 IQ file, -=stdin")
    ap.add_argument("--output", default="-", help="PCM out, - = stdout")
    ap.add_argument("--staged", choices=("auto", "0", "1"), default="auto",
                    help="host-staged ingest: the read loop writes [tail | "
                         "group] into a ring of pinned host buffers, uploads "
                         "it asynchronously and the receiver runs it with "
                         "no device-side concatenation (auto = 1; the "
                         "wideband mode pins the group's upload); 0 = a "
                         "plain pageable copy and the unstaged receiver")
    ap.add_argument("--pll-tier", type=int, default=1, choices=(1, 2, 3),
                    help="1=exact sequential PLL, 2=block-parallel Newton, "
                         "3=feedforward sync (fastest; approximates the "
                         "locked loop, not the acquisition transient)")
    ap.add_argument("--rds-timing", choices=("comb", "tracked"),
                    default="comb",
                    help="RDS symbol clock: comb=per-block argmax CDR "
                         "(reference behaviour), tracked=drift-following "
                         "interpolating CDR (survives tuner ppm error)")
    ap.add_argument("--rds-correct", type=int, default=2,
                    metavar="SPAN", choices=range(0, 6),
                    help="max burst span (bits) the RDS framer repairs per "
                         "26-bit block (0=detect only like the reference; "
                         "code limit 5; default 2 keeps false corrections "
                         "on garbage rare)")
    ap.add_argument("--checkpoint", default=None,
                    help="state .npz to resume from / save on EOF (the "
                         "JAX package's layout: either package resumes it)")
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--stats", action="store_true",
                    help="per-block wall clock vs real-time budget on stderr")
    ap.add_argument("--warmup", action="store_true",
                    help="run one silent segment BEFORE consuming the pipe "
                         "(on the card this builds the kernels), so a live "
                         "source (rtl_sdr) is not backpressured by set-up")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) "
                         "instead of the CUDA card")
    ap.add_argument("--io-depth", type=int, default=4,
                    help="ring-buffer depth for the native I/O threads")
    ap.add_argument("--pipeline", type=int, default=1,
                    help="a drain thread drains each group as soon as "
                         "the device has finished it, and an upload waits "
                         "while more than this many groups (with "
                         "--stations or --tuners: this many segments) are "
                         "submitted and not yet drained; a deeper pipeline "
                         "overlaps host work with the device when the "
                         "input arrives faster than real time (0 = fully "
                         "synchronous: each group is drained before the "
                         "next read)")
    ap.add_argument("--segment", type=int, default=1, metavar="G",
                    help="aggregate G input blocks per receiver call "
                         "(segment serving): amortizes per-call launch and "
                         "copy overhead over G blocks and runs the wideband "
                         "DSP as one pass; adds G-1 blocks of latency")
    ap.add_argument("--drop-oldest", action="store_true",
                    help="real-time mode: drop stale input blocks instead of "
                         "backpressuring the source")
    ap.add_argument("--monitor", default=None, metavar="PATH",
                    help="write an atomic .npz diagnostic snapshot (latest "
                         "audio block, RDS matched-filter output, decode "
                         "stats) every --monitor-every blocks, in the JAX "
                         "package's layout (`python -m real_time_sdr_tpu.viz "
                         "<mode> --live PATH` views it)")
    ap.add_argument("--monitor-every", type=int, default=4,
                    help="blocks between --monitor snapshots")
    ap.add_argument("--stations", default=None,
                    help="comma-separated station offsets in Hz: treat the "
                         "input as ONE wideband capture and channelize all "
                         "stations (with --wide-fs, --output-dir)")
    ap.add_argument("--tuners", default=None, metavar="PATH,PATH,...",
                    help="comma-separated inputs, one raw uint8 IQ stream "
                         "per tuner at the mode's RF rate: decode every "
                         "tuner as one row of a channel bank, one graphed "
                         "call per --segment, one station_<k>.pcm per tuner "
                         "under --output-dir, RDS text as ch<k> lines (not "
                         "with --stations, --checkpoint, --staged 0, "
                         "--input or --output)")
    ap.add_argument("--wide-fs", type=int, default=None,
                    help="wideband capture sample rate (integer multiple of "
                         "the mode's RF rate; default 4x)")
    ap.add_argument("--output-dir", default=None,
                    help="per-station PCM output directory (wideband mode)")
    ap.add_argument("--retune", action="append", default=None,
                    metavar="SEG:STATION:HZ",
                    help="at dispatched segment index SEG (0-based), "
                         "re-point station STATION to offset HZ (fused "
                         "wideband frontend only; other stations' DSP state "
                         "is untouched). Repeatable")
    # the port's counterpart of the JAX package's RTSDR_WB_FIR /
    # RTSDR_CHAN_FIR environment variables
    ap.add_argument("--wb-fir", choices=("f32", "bf16", "bf16x2"),
                    default=None,
                    help="precision of the wideband frontend's fold product "
                         "(default f32; bf16x2 splits the taps hi + lo at "
                         "twice the operations; the two-stage frontend "
                         "takes f32 or bf16)")
    ap.add_argument("--trace-spans", default=None, metavar="PATH",
                    help="record the serving loop's spans and counters "
                         "(read_wait, submit, drain and what runs inside "
                         "them, each segment's in_flight wait; segments, "
                         "blocks, rds_feeds, graph_captures) and write them "
                         "at exit to PATH as a Chrome-trace JSON on "
                         "torch.profiler's clock (open it in Perfetto). "
                         "With or without it, a running torch.profiler "
                         "session sees each phase as one of its ranges")
    return ap


def _monitor_snapshot(path: str, cfg, stereo: bool, framer, block: int,
                      pcm_np, clean_np) -> None:
    """Atomic .npz snapshot of the running decode (the JAX CLI's keys)."""
    audio = pcm_np[0::2] if stereo else pcm_np  # int16, one block
    ev = framer.events if framer is not None else None
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, block=block, fs=float(cfg.audio_fs),
                 audio=np.asarray(audio),
                 clean=(np.zeros(0, np.float32) if clean_np is None
                        else np.asarray(clean_np, np.float32)),
                 sps=int(cfg.sps),
                 ps=str((ev.ps_name if ev else None) or ""),
                 pi=int((ev.pi if ev else 0) or 0),
                 groups=int(ev.groups_decoded if ev else 0))
    os.replace(tmp, path)


def _atomic_json(path: str, obj) -> None:
    """Write-then-rename so a mid-dump kill never leaves a truncated file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _emit(kind, val) -> None:
    """The reference CLI's RDS event lines on stderr, each event in one
    write: the drain thread's lines and the serving thread's ``--stats``
    lines never split each other (``print`` writes the newline apart)."""
    if kind == "group":
        pi, _gt, pty = val
        line = f"PI: {pi:x}\nPTY: {pty}"
    elif kind == "ps":
        line = f"Program Service: {val}"
    elif kind == "radiotext":
        line = f"RadioText: {val}"
    elif kind == "ptyn":
        line = f"Program Type Name: {val}"
    elif kind == "clock":
        line = f"Clock Time: {val}"
    elif kind == "af":
        line = "Alternative Frequencies: " + ", ".join(f"{f:.1f}"
                                                       for f in val)
    else:
        return
    sys.stderr.write(f"{line}\n")


class _Uploader:
    """Host -> device copies of input groups.

    staged: each group goes into the next slot of a ring of host buffers
    (page-locked when the device is a card) and is uploaded with
    ``non_blocking=True``. With a ``frontend`` (the single-station and the
    multi-tuner paths) the slot receives the staged operand ``[tail |
    group]`` (``Frontend.stage_segment``) for ``Receiver.run_segment_staged``,
    of each of the ``lead`` rows (``(T,)``: T tuners in one slot, one
    upload), and ``tail`` moves on to the group's last ``tail_len`` bytes
    of each row; without one
    (the wideband path) it receives the group as it is. A slot is reused
    ``slots`` groups later. A group is drained only after its event, which
    follows its upload, completes, and a loop uploads a group only while
    few enough are submitted and not yet released by its drain worker: at
    most ``--pipeline`` in the single-station loop, fewer than
    ``--pipeline`` (at 0 none) in the multi-row loops. So with ``slots``
    >= ``--pipeline`` + 2 no slot is overwritten while its copy is in
    flight. Unstaged: a plain pageable ``.to(device)`` of the
    group."""

    def __init__(self, torch, device, nbytes: int, slots: int, staged: bool,
                 frontend=None, lead: tuple = ()):
        self.torch = torch
        self.device = device
        self.frontend = frontend
        self.tail = (None if frontend is None else
                     np.full(lead + (frontend.tail_len,), 128,
                             dtype=np.uint8))
        size = math.prod(lead) * (
            nbytes + (0 if frontend is None else frontend.tail_len))
        self.ring = ([torch.empty(size, dtype=torch.uint8,
                                  pin_memory=device.type == "cuda")
                      for _ in range(slots)] if staged else None)
        self.k = 0

    @property
    def staged(self) -> bool:
        """True when the uploads are ``[tail | group]`` staged operands."""
        return self.ring is not None and self.frontend is not None

    def __call__(self, seg: np.ndarray):
        if self.ring is None:
            return self.torch.from_numpy(seg).to(self.device)
        return self.stage(seg).to(self.device, non_blocking=True)

    def stage(self, seg: np.ndarray):
        """The group (``lead`` rows of it with a ``frontend``) written into
        the ring's next slot: that slot's host tensor, ready to upload."""
        slot = self.ring[self.k % len(self.ring)]
        self.k += 1
        if self.frontend is None:
            buf = slot[:seg.shape[0]]
            buf.copy_(self.torch.from_numpy(seg))
            return buf
        lead, n = seg.shape[:-1], self.frontend.staged_len(seg.shape[-1])
        buf = slot[:math.prod(lead) * n].view(*lead, n)
        self.frontend.stage_segment(self.tail, seg, out=buf.numpy())
        self.tail = seg[..., seg.shape[-1] - self.tail.shape[-1]:].copy()
        return buf


def _fetch(torch, device, tensors):
    """Start device -> host copies of ``tensors`` (None entries pass):
    into pinned memory with ``non_blocking=True`` and one CUDA event after
    them on a card; the tensors themselves on the CPU. Returns
    (host tensors, event or None)."""
    if device.type != "cuda":
        return tensors, None
    host = [None if t is None else t.to("cpu", non_blocking=True)
            for t in tensors]
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class _DrainWorker:
    """A serving loop's drain on a thread of its own (a one-thread
    executor; every loop has one): ``drain_one`` runs on each
    ``submit``ted segment (or the single-station loop's group) in that
    order, as soon as it is submitted (it waits on the segment's event:
    on a card ``Event.synchronize``, which releases the GIL). A segment
    is released when its drain returns. ``wait(n)`` blocks until at most
    ``n`` submitted segments are unreleased; it, ``pending`` and
    ``take_ns`` raise a drain's exception again in the serving thread.
    ``take_ns`` hands over the time the released drains took, their
    waits on the device included, for the ``--stats`` lines."""

    def __init__(self, drain_one):
        self._drain_one = drain_one
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="drain")
        self._futs: deque = deque()
        self.submitted = self.released = 0
        self._ns = 0

    def _timed(self, item) -> int:
        t = time.perf_counter_ns()
        self._drain_one(item)
        return time.perf_counter_ns() - t

    def submit(self, item) -> None:
        self._futs.append(self._pool.submit(self._timed, item))
        self.submitted += 1

    def wait(self, n: int) -> None:
        while self._futs and (len(self._futs) > n or self._futs[0].done()):
            self._ns += self._futs.popleft().result()
            self.released += 1

    def pending(self) -> int:
        """Segments submitted and not yet released."""
        self.wait(len(self._futs))
        return len(self._futs)

    def take_ns(self) -> int:
        self.pending()
        ns, self._ns = self._ns, 0
        return ns

    def close(self) -> None:
        """Drop what is queued, and join the worker after the drain it is
        in (after a ``wait(0)``, nothing is queued)."""
        self._pool.shutdown(cancel_futures=True)


def _row_drain(spans, outs, framers, lines: list | None = None):
    """The drain of the multi-row loops (``run_wideband``, ``run_tuners``),
    run by their ``_DrainWorker`` on each segment ``((pcm, nbits, bits),
    event, blocks, in_flight span, segment)``: one drain phase (and
    profiler range) a segment, from the start of its wait on the device,
    then row by row the row's PCM into ``outs[row]`` and its RDS bits into
    ``framers[row]`` (``framers`` None: no RDS). The list ``framers`` is
    read at each drain, so a retune may replace a framer in it.

    ``lines`` (``run_tuners``: the list its framers append their event
    lines to; its ``outs`` are unbuffered): a row's PCM is one ``write``,
    its segment's bits one ``feed`` (the framer's walk does not depend on
    how its stream is cut, so the events are the same), and the segment's
    lines one write to stderr at the end. Each call that enters the kernel
    releases the GIL, which the serving thread may then hold until its own
    next system call: fewer such calls keep the drain from queueing behind
    it."""
    now = time.perf_counter_ns

    def drain_one(item) -> None:
        (pcm, nbits, bits), ev, g, fl, gid = item
        dr = spans.live and spans.phase("drain", gid)
        if fl:
            spans.end(fl, dr.t0)
        dw = dr and spans.span("drain_wait", dr)
        if ev is not None:
            ev.synchronize()   # the only wait on the device
        if dw:
            spans.end(dw)
        pcm = pcm.numpy()
        if framers is not None:
            nbits, bits = nbits.numpy(), bits.numpy()
        w_ns = r_ns = 0
        for st in range(len(outs)):
            t = dr and now()
            if lines is not None:
                view = memoryview(pcm[st]).cast("B")
                while view:
                    view = view[outs[st].write(view):]
            else:
                pcm[st].tofile(outs[st])
            if dr:
                t1 = now()
                w_ns += t1 - t
            if framers is not None:
                fed = [bits[st, j, :nbits[st, j]] for j in range(g)
                       if nbits[st, j] > 0]
                if lines is None:
                    for b in fed:
                        framers[st].feed(b)
                elif fed:
                    framers[st].feed(np.concatenate(fed))
                if dr:
                    r_ns += now() - t1
        if lines:
            t = dr and now()
            sys.stderr.write("".join(lines))
            lines.clear()
            if dr:
                r_ns += now() - t
        if dr:
            spans.add(dr, "write", w_ns)
            if framers is not None:
                spans.add(dr, "rds", r_ns)
                spans.count("rds_feeds", int((nbits > 0).sum()))
            spans.end(dr)
    return drain_one


def _wait_bound(worker, bound: int, spans, sub) -> float:
    """Before an upload of a serving loop: wait on the drain worker while
    ``bound`` segments (or groups) are not yet drained (the upload ring's
    slot may still be in flight); returns the seconds waited."""
    if worker.pending() < bound:
        return 0.0
    spans.count("drain_backpressure")
    sp = sub and spans.span("backpressure_wait", sub)
    w0 = time.perf_counter()
    worker.wait(bound - 1)
    waited = time.perf_counter() - w0
    if sp:
        spans.end(sp)
    return waited


def _fetch_rows(torch, device, spans, sub, sp, out, pcm, rds: bool, g: int,
                blocks: int, seg_i: int):
    """The multi-row loops' fetch: ONE batched (rows, ...) PCM tensor, the
    RDS bits (rows, g, ...) when ``rds``, and one fetch a segment. ``sp``
    is the open ``fetch`` span and ``sub`` the submit phase, both closed
    here; ``blocks`` is added to the ``blocks`` counter. Returns the drain
    worker's item."""
    nbits = bits = None
    if rds:
        rows = pcm.shape[0]
        nbits = out.rds_nbits.reshape(rows, g)
        bits = out.rds_bits.reshape(rows, g, -1)
    host, ev = _fetch(torch, device, [pcm, nbits, bits])
    fl = None
    if sp:
        spans.end(sp)
        fl = spans.flight("in_flight", sub, sp.t1)
        spans.count("segments")
        spans.count("blocks", blocks)
    if sub:
        spans.end(sub)
    return host, ev, g, fl, seg_i


def _segment_done(args, worker, t0: float, waited: float, g: int,
                  n_blocks: int, budget: float) -> float:
    """After a serving loop has handed a segment (or group) of ``g`` blocks
    to its worker: at ``--pipeline 0`` wait for its drain, then the segment's
    ``--stats`` time (from ``t0``, ``waited`` and this wait on the worker
    left out, plus the time of the drains released since the line before)
    and, with ``--stats``, its line. Returns that time."""
    if not args.pipeline:
        w0 = time.perf_counter()
        worker.wait(0)
        waited += time.perf_counter() - w0
    dt = max(time.perf_counter() - t0 - waited + worker.take_ns() / 1e9,
             1e-9)
    if args.stats:
        sys.stderr.write(f"block {n_blocks}: {dt*1e3:.2f} ms "
                         f"({g*budget/dt:.1f}x real time)\n")
    return dt


def _print_total(args, device, n_blocks: int, t_total: float,
                 budget: float) -> None:
    """The multi-row loops' ``--stats`` summary line, and the kernels'
    launch counts on a card."""
    if args.stats and n_blocks:
        print(f"total: {n_blocks} blocks, avg {t_total/n_blocks*1e3:.2f} ms"
              f"/block, {budget*n_blocks/t_total:.1f}x real time",
              file=sys.stderr)
        if device.type == "cuda":
            _print_launches()


def _native_io():
    """The native I/O module (``utils.native_io``), its library built at most once
    per checkout: concurrent first runs take turns on a lock file, so no
    process loads a library that another is still linking."""
    import fcntl

    from real_time_sdr_tpu_torch.utils import native_io
    lock = os.path.join(os.path.dirname(native_io._LIB_PATH), ".build.lock")
    try:
        with open(lock, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            native_io.available()   # builds when missing or stale
    except OSError:
        pass                        # read-only checkout: Python I/O fallback
    return native_io


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.io_depth < 1:
        print(f"error: --io-depth must be >= 1, got {args.io_depth}",
              file=sys.stderr)
        return 2
    if args.pipeline < 0:
        print(f"error: --pipeline must be >= 0, got {args.pipeline}",
              file=sys.stderr)
        return 2
    if args.tuners is not None:
        refused = [flag for flag, on in (
            ("--stations", args.stations is not None),
            ("--checkpoint", args.checkpoint is not None),
            ("--staged 0", args.staged == "0"),
            ("--input", args.input != "-"),
            ("--output", args.output != "-")) if on]
        if refused:
            print(f"error: --tuners does not take {', '.join(refused)} (the "
                  "tuners' inputs are its paths, their PCM goes to "
                  "--output-dir)", file=sys.stderr)
            return 2
    given = ["--" + f.replace("_", "-") for f in WIDEBAND_ONLY_FLAGS
             if getattr(args, f) is not None
             and not (f == "output_dir" and args.tuners is not None)]
    if given and args.stations is None:
        print(f"error: {', '.join(given)} only applies to the wideband "
              "(multi-station) mode: give --stations too", file=sys.stderr)
        return 2

    import torch
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("error: no CUDA card (torch.cuda.is_available() is False); "
              "pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda")
    from real_time_sdr_tpu_torch.models.receiver import Receiver
    from real_time_sdr_tpu_torch.utils.logging import SpanRecorder
    spans = SpanRecorder()
    if args.trace_spans:
        spans.start()
    rx = Receiver(args.mode, stereo=args.type in ("s", "r"),
                  rds=args.type == "r", pll_tier=args.pll_tier,
                  rds_timing=args.rds_timing, device=device)
    rx.graphs.spans = spans
    try:
        if args.stations is not None:
            return run_wideband(args, torch, device, rx, rx.cfg, spans)
        if args.tuners is not None:
            return run_tuners(args, torch, device, rx, spans)
        return _serve(args, torch, device, rx, spans)
    finally:
        if args.trace_spans:
            spans.write(args.trace_spans)


def _print_launches() -> None:
    """The kernels' launch counts of this process, one JSON line."""
    from real_time_sdr_tpu_torch.ops.cuda import KERNELS
    print("kernel launches: " + json.dumps(
        {k.name: k.launches for k in KERNELS}), file=sys.stderr)


def _read_into(fin, view) -> int:
    """Fill ``view`` from ``fin`` (a pipe may deliver it in pieces); returns
    the bytes read, short only at EOF."""
    got = 0
    while got < len(view):
        n = fin.readinto(view[got:])
        if not n:
            break
        got += n
    return got


def run_wideband(args, torch, device, rx, cfg, spans) -> int:
    """Multi-station mode: channelize a wideband capture and decode every
    station in parallel through a channel bank.

    The serving thread reads, uploads, dispatches and fetches each
    segment and hands the fetch to a ``_DrainWorker``, whose thread waits
    on the segment's event and then, station by station, writes its PCM
    and feeds its RDS bits to its framer. At most ``--pipeline`` segments
    are submitted and not yet drained: the serving thread waits before an
    upload that would pass that bound, and at ``--pipeline 0`` it waits
    for each segment's drain before the next read. A ``--retune``, EOF and
    ``--max-blocks`` wait for every drain. A ``--stats`` line, printed by
    the serving thread, is the segment's submit (its waits on the worker
    left out) plus the time of the drains released since the line before,
    their waits on the segments' events included, as before the worker:
    at ``--pipeline 0``, or unpaced, those waits hold the device's time,
    and ``total:`` reads no faster than the device runs.

    ``spans``: the ``utils.logging.SpanRecorder`` of ``--trace-spans``
    (serving thread: phases ``read_wait`` and ``submit`` with
    ``backpressure_wait`` / ``upload`` / ``dispatch`` / ``fetch``; worker
    thread: ``drain`` with ``drain_wait`` and the summed ``write`` /
    ``rds`` times; ``in_flight`` from a segment's fetch to its drain;
    counters ``segments``, ``blocks``, ``rds_feeds``,
    ``drained_before_next_read``, a segment drained before the serving
    thread finished reading the next one, and ``drain_backpressure``, an
    upload that waited on the worker)."""
    from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
    from real_time_sdr_tpu_torch.models.wideband_frontend import (
        FusedWidebandFrontend, make_wideband_frontend)
    from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
    from real_time_sdr_tpu_torch.utils import state as state_util
    from real_time_sdr_tpu_torch.utils.audio import mono_pcm, stereo_pcm

    if args.io_depth != 4 or args.drop_oldest or args.monitor:
        print("warning: --io-depth/--drop-oldest/--monitor apply to the "
              "single-station native I/O path and are ignored in "
              "--stations mode", file=sys.stderr)
    try:
        offsets = [int(x) for x in args.stations.split(",")]
    except ValueError:
        print(f"error: --stations must be comma-separated integer Hz "
              f"offsets, got {args.stations!r}", file=sys.stderr)
        return 2
    wide_fs = args.wide_fs or 4 * cfg.rf_fs
    if wide_fs % cfg.rf_fs != 0:
        print(f"error: --wide-fs {wide_fs} must be an integer multiple of "
              f"the mode RF rate {cfg.rf_fs}", file=sys.stderr)
        return 2
    wb_fir = args.wb_fir or "f32"
    if (wb_fir == "bf16x2"
            and not FusedWidebandFrontend.eligible(cfg, wide_fs, offsets)):
        print("error: --wb-fir bf16x2 needs the fused wideband frontend; "
              "this grid takes the two-stage path, which computes in f32 "
              "or bf16", file=sys.stderr)
        return 2
    fe = make_wideband_frontend(cfg, wide_fs, offsets, compute_dtype=wb_fir,
                                device=device)
    fused = isinstance(fe, FusedWidebandFrontend)
    print(f"wideband frontend: "
          f"{'fused one-matmul' if fused else 'two-stage uint8'} path",
          file=sys.stderr)
    retunes: dict[int, list[tuple[int, int]]] = {}
    if args.retune:
        try:
            for spec in args.retune:
                a, b, c = spec.split(":")
                if not 0 <= int(b) < len(offsets):
                    raise ValueError(spec)
                retunes.setdefault(int(a), []).append((int(b), int(c)))
        except ValueError:
            print(f"error: --retune takes SEG:STATION:HZ with STATION < "
                  f"{len(offsets)}, got {args.retune!r}", file=sys.stderr)
            return 2
        if not fused:
            print("error: --retune requires the fused wideband frontend "
                  "(an ineligible grid forces the two-stage path, whose "
                  "grid cannot move)", file=sys.stderr)
            return 2
    n_st = len(offsets)
    bank = ChannelBank(rx, n_st)

    def new_framer(k: int):
        # one write a line: the drain thread's lines and the serving
        # thread's --stats lines never split each other
        return RdsFramer(on_event=lambda kind, val: sys.stderr.write(
            f"ch{k} {kind}: {val}\n"), correct_bursts=args.rds_correct)

    framers = [new_framer(k) for k in range(n_st)] if rx.rds else None
    block_pairs = cfg.block_size_iq * fe.decim
    block_bytes = 2 * block_pairs
    budget = cfg.block_size_iq / cfg.rf_fs
    fstate = fe.init_state()
    bstate = bank.init_state()
    if args.checkpoint:
        framers, load_state = _resume_wideband(args, fe, fused, offsets,
                                               framers, new_framer)
        try:
            if load_state:
                fstate, bstate = state_util.load_state(args.checkpoint,
                                                       (fstate, bstate))
                print(f"resumed state from {args.checkpoint}",
                      file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as e:  # shape-incompatible or corrupt npz: never
            # fatal, start fresh
            print(f"warning: could not resume DSP state ({e!r}); "
                  "starting fresh", file=sys.stderr)

    outdir = args.output_dir or "."
    os.makedirs(outdir, exist_ok=True)
    seg_n = max(1, args.segment)
    n_blocks = 0
    t_total = 0.0

    def pcm_of(out):
        return (stereo_pcm(out.left, out.right) if rx.stereo
                else mono_pcm(out.mono))

    if args.warmup:
        t0 = time.perf_counter()
        silent = torch.full((seg_n * block_bytes,), 128, dtype=torch.uint8,
                            device=device)
        # captures the segment's graph; the outputs are discarded
        _, wout, _ = bank.run_wideband_u8_jit(bank.init_state(), fe, silent,
                                              fe.init_state())
        pcm_of(wout).cpu()
        print(f"warmed up in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)

    upload = _Uploader(torch, device, seg_n * block_bytes, args.pipeline + 2,
                       args.staged != "0")
    with contextlib.ExitStack() as files:
        fin = (sys.stdin.buffer if args.input == "-"
               else files.enter_context(open(args.input, "rb")))
        outs = [files.enter_context(
            open(os.path.join(outdir, f"station_{k}.pcm"), "wb"))
            for k in range(n_st)]
        # (host tensors, event, blocks, in_flight span, segment) per
        # segment; the device runs the segments in order, so they complete
        # in order. Closed before the files (the stack unwinds in reverse).
        worker = _DrainWorker(_row_drain(spans, outs, framers))
        files.callback(worker.close)
        # uploads wait while this many segments are not yet drained
        bound = max(args.pipeline, 1)
        buf = bytearray(seg_n * block_bytes)
        seg_i = 0
        while True:
            if seg_i in retunes:
                # drain first: pending outputs belong to the old grid and
                # must reach the old framers before the station re-points
                worker.wait(0)
                for si, hz in retunes.pop(seg_i):
                    fe.retune(si, hz)
                    if framers is not None:
                        framers[si] = new_framer(si)
                    print(f"retuned station {si} -> {hz} Hz at segment "
                          f"{seg_i}", file=sys.stderr)
            # clamp to --max-blocks, and keep the blocking pipe read OUT of
            # the timed span (a paced live source would otherwise be
            # misreported as barely real-time)
            want = seg_n
            if args.max_blocks:
                want = min(want, args.max_blocks - n_blocks)
                if want <= 0:
                    break
            view = memoryview(buf)[:want * block_bytes]
            rw = spans.live and spans.phase("read_wait", seg_i)
            g = _read_into(fin, view) // block_bytes
            if rw:
                spans.end(rw)
                if seg_i and not worker.pending():
                    spans.count("drained_before_next_read")
            if not g:
                break
            t0 = time.perf_counter()
            sub = spans.live and spans.phase("submit", seg_i)
            waited = _wait_bound(worker, bound, spans, sub)
            # an EOF partial segment runs at its exact shape (the real
            # blocks' outputs do not depend on padding): a graph of its own
            raw = np.frombuffer(buf, dtype=np.uint8, count=g * block_bytes)
            sp = sub and spans.span("upload", sub)
            x = upload(raw)
            if sp:
                spans.end(sp)
                sp = spans.span("dispatch", sub)
            bstate, out, fstate = bank.run_wideband_u8_jit(
                bstate, fe, x, fstate)
            if sp:
                spans.end(sp)
                sp = spans.span("fetch", sub)
            worker.submit(_fetch_rows(torch, device, spans, sub, sp, out,
                                      pcm_of(out), framers is not None, g,
                                      g, seg_i))
            seg_i += 1
            n_blocks += g
            t_total += _segment_done(args, worker, t0, waited, g, n_blocks,
                                     budget)
        worker.wait(0)
        t_total += worker.take_ns() / 1e9
    if args.checkpoint:
        state_util.save_state(args.checkpoint, (fstate, bstate))
        # fe.offsets, not the parsed --stations list: --retune re-points
        # stations mid-stream and the sidecar must describe the grid the
        # saved state was built on. Written with or without RDS, so a
        # resume always knows the grid.
        _atomic_json(args.checkpoint + ".rds.json",
                     {"kind": "wideband", "stations": list(fe.offsets),
                      "framers": [fr.state_dict() for fr in framers or []]})
        print(f"saved state to {args.checkpoint}", file=sys.stderr)
    _print_total(args, device, n_blocks, t_total, budget)
    print(f"channelized {n_st} stations x {n_blocks} blocks",
          file=sys.stderr)
    return 0


def run_tuners(args, torch, device, rx, spans) -> int:
    """Multi-tuner mode: T independent tuners, each its own uint8 IQ stream
    at the mode's RF rate (``--tuners PATH,...``), decoded as the T rows of
    one channel bank, as T one-station CLIs would decode them apart.

    The serving thread reads ``--segment`` blocks from every input, each as
    it has data (free-running tuners complete a segment at staggered
    times), stages ``[tail | segment]`` of every tuner into one pinned
    (T, staged_len) slot of the upload ring, uploads it in one copy,
    replays one graph (``ChannelBank.run_segment_staged``), starts one
    (T, ...) fetch and hands it to a ``_DrainWorker``, which waits on the
    segment's event and, tuner by tuner, writes its PCM to
    ``station_<k>.pcm`` under ``--output-dir`` and feeds its RDS bits to
    its framer (``ch<k> <kind>: <val>`` lines). ``--pipeline``, ``--stats``
    and ``--warmup`` as in ``run_wideband``. The tuners run in lock step:
    the loop ends at the first input's end, on a last partial segment of
    the blocks every input delivered.

    ``spans``: ``run_wideband``'s phases, spans and counters, with
    ``skew_wait`` inside ``read_wait`` (from the first tuner's segment
    complete to the last's), ``stage`` (into the ring's slot) before
    ``upload`` (the copy to the device), ``blocks`` counting every tuner's
    blocks, and the counter ``tuners``."""
    from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
    from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
    from real_time_sdr_tpu_torch.utils.audio import mono_pcm, stereo_pcm

    if args.io_depth != 4 or args.drop_oldest or args.monitor:
        print("warning: --io-depth/--drop-oldest/--monitor apply to the "
              "single-station native I/O path and are ignored in "
              "--tuners mode", file=sys.stderr)
    paths = args.tuners.split(",")
    if "" in paths or "-" in paths:
        print(f"error: --tuners takes comma-separated file paths, got "
              f"{args.tuners!r}", file=sys.stderr)
        return 2
    cfg = rx.cfg
    n_t = len(paths)
    bank = ChannelBank(rx, n_t)
    # the framers' event lines, written once a drain (``_row_drain``)
    lines: list[str] = []
    framers = ([RdsFramer(on_event=lambda kind, val, k=k: lines.append(
        f"ch{k} {kind}: {val}\n"), correct_bursts=args.rds_correct)
        for k in range(n_t)] if rx.rds else None)
    block_bytes = 2 * cfg.block_size_iq
    budget = cfg.block_size_iq / cfg.rf_fs
    seg_n = max(1, args.segment)
    outdir = args.output_dir or "."
    os.makedirs(outdir, exist_ok=True)
    bstate = bank.init_state()
    n_blocks = 0
    t_total = 0.0

    def pcm_of(out):
        return (stereo_pcm(out.left, out.right) if rx.stereo
                else mono_pcm(out.mono))

    if args.warmup:
        t0 = time.perf_counter()
        n2 = seg_n * block_bytes
        silent = torch.full((n_t, rx.frontend.staged_len(n2)), 128,
                            dtype=torch.uint8, device=device)
        # captures the segment's graph; the outputs are discarded
        _, wout = bank.run_segment_staged(bank.init_state(), silent, n2)
        pcm_of(wout).cpu()
        print(f"warmed up in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)

    upload = _Uploader(torch, device, seg_n * block_bytes, args.pipeline + 2,
                       True, frontend=rx.frontend, lead=(n_t,))
    buf = np.empty((n_t, seg_n * block_bytes), dtype=np.uint8)
    with contextlib.ExitStack() as files:
        # unbuffered: each read is one system call, which the poll allows
        fins = [files.enter_context(open(p, "rb", buffering=0))
                for p in paths]
        outs = [files.enter_context(
            open(os.path.join(outdir, f"station_{k}.pcm"), "wb",
                 buffering=0))
            for k in range(n_t)]
        worker = _DrainWorker(_row_drain(spans, outs, framers, lines))
        files.callback(worker.close)
        bound = max(args.pipeline, 1)
        spans.count("tuners", n_t)
        seg_i = g = 0
        got = [0]
        while True:
            want = seg_n
            if args.max_blocks:
                want = min(want, args.max_blocks - n_blocks)
                if want <= 0:
                    break
            rw = spans.live and spans.phase("read_wait", seg_i)
            got, t_first, t_last = _read_rows(fins, buf, want * block_bytes)
            if rw:
                sk = t_first is not None and spans.span("skew_wait", rw,
                                                        t_first)
                if sk:
                    spans.end(sk, t_last)
                spans.end(rw)
                if seg_i and not worker.pending():
                    spans.count("drained_before_next_read")
            g = min(got) // block_bytes
            if not g:
                break
            t0 = time.perf_counter()
            sub = spans.live and spans.phase("submit", seg_i)
            waited = _wait_bound(worker, bound, spans, sub)
            # an EOF partial segment runs at its exact shape: a graph of
            # its own
            sp = sub and spans.span("stage", sub)
            xh = upload.stage(buf[:, :g * block_bytes])
            if sp:
                spans.end(sp)
                sp = spans.span("upload", sub)
            x = xh.to(device, non_blocking=True)
            if sp:
                spans.end(sp)
                sp = spans.span("dispatch", sub)
            bstate, out = bank.run_segment_staged(bstate, x, g * block_bytes)
            if sp:
                spans.end(sp)
                sp = spans.span("fetch", sub)
            worker.submit(_fetch_rows(torch, device, spans, sub, sp, out,
                                      pcm_of(out), framers is not None, g,
                                      n_t * g, seg_i))
            seg_i += 1
            n_blocks += g
            t_total += _segment_done(args, worker, t0, waited, g, n_blocks,
                                     budget)
            if min(got) < want * block_bytes:
                break
        worker.wait(0)
        t_total += worker.take_ns() / 1e9
    left = sum(got) - n_t * g * block_bytes
    if left:
        print(f"warning: the inputs ended unevenly: {left} bytes past the "
              f"shortest input's last whole block were not decoded",
              file=sys.stderr)
    _print_total(args, device, n_blocks, t_total, budget)
    print(f"decoded {n_t} tuners x {n_blocks} blocks", file=sys.stderr)
    return 0


def _read_rows(fins, buf: np.ndarray, n: int):
    """Fill ``buf[k, :n]`` from ``fins[k]`` (unbuffered files) for every
    k, reading each input whenever it has data. Returns (the bytes read per
    row, short only at that input's end, and the ``time.perf_counter_ns``
    at which the first and the last row filled, None when none did)."""
    poll = select.poll()
    rows = {f.fileno(): k for k, f in enumerate(fins)}
    views = [memoryview(r) for r in buf]
    got = [0] * len(fins)
    for fd in rows:
        poll.register(fd, select.POLLIN)
    first = last = None
    while rows:
        for fd, _ in poll.poll():
            k = rows[fd]
            r = fins[k].readinto(views[k][got[k]:n])
            got[k] += r
            if r and got[k] < n:
                continue
            poll.unregister(fd)
            del rows[fd]
            if r:
                last = time.perf_counter_ns()
                first = first or last
    return got, first, last


def _resume_wideband(args, fe, fused, offsets, framers, new_framer):
    """Read ``<checkpoint>.rds.json`` and put the frontend on the grid the
    checkpoint was saved on, so DSP state, framers and frontend never mix
    two grids. Returns ``(framers, load_state)``: the framers to go on with
    (loaded when the sidecar holds them) and whether the DSP state may be
    loaded. It may not when the saved grid cannot be resumed (another
    station count, another grid on the two-stage frontend, whose grid
    cannot move, or an offset the fused frontend cannot retune to): then
    everything starts fresh. Without a sidecar the grid is taken to be
    ``--stations``; a corrupt one rebuilds every framer."""
    path = args.checkpoint + ".rds.json"

    def fresh():
        return (None if framers is None
                else [new_framer(k) for k in range(len(offsets))])

    try:
        with open(path) as f:
            d = json.load(f)
        saved = [int(x) for x in d["stations"]]
        states = list(d["framers"])
    except FileNotFoundError:
        return framers, True
    except Exception as e:  # truncated/corrupt sidecar: never fatal
        print(f"warning: could not resume RDS framer state ({e!r});"
              " starting fresh", file=sys.stderr)
        return fresh(), True
    if d.get("kind") != "wideband" or len(saved) != len(offsets):
        print(f"warning: {path} (kind {d.get('kind')!r}, stations {saved}) "
              f"does not match --stations {offsets}; starting fresh",
              file=sys.stderr)
        return framers, False
    moved = [(k, hz) for k, hz in enumerate(saved) if hz != offsets[k]]
    if moved and not fused:
        print(f"warning: {path} was saved on the grid {saved}, not "
              f"--stations {offsets}, and the two-stage frontend's grid "
              "cannot move; starting fresh", file=sys.stderr)
        return framers, False
    try:
        for k, hz in moved:
            fe.retune(k, hz)
    except ValueError as e:   # an offset off this frontend's raster
        for k, hz in enumerate(offsets):
            if fe.offsets[k] != hz:
                fe.retune(k, hz)
        print(f"warning: cannot resume onto the saved grid {saved} ({e}); "
              "starting fresh", file=sys.stderr)
        return framers, False
    for k, hz in moved:
        print(f"resumed onto the saved grid: station {k} -> {hz} Hz",
              file=sys.stderr)
    if framers is not None and states:
        try:
            for fr, fd in zip(framers, states):
                fr.load_state_dict(fd)
        except Exception as e:  # some framers may be half-loaded: rebuild
            # them all, so "starting fresh" is true
            print(f"warning: could not resume RDS framer state ({e!r});"
                  " starting fresh", file=sys.stderr)
            return fresh(), True
        print(f"resumed {min(len(framers), len(states))} RDS framers from "
              f"{path}", file=sys.stderr)
    return framers, True


def _serve(args, torch, device, rx, spans) -> int:
    """Single-station mode: one tuner's blocks through the receiver, PCM
    out through the native ring writer.

    The serving thread reads a group (``--segment`` blocks), uploads it,
    replays the receiver's graph, starts the fetch and hands it to a
    ``_DrainWorker``, whose thread waits on the group's event and then,
    block by block, writes its PCM (``writer.write``), feeds its RDS bits
    to the framer and takes the ``--monitor`` snapshot: a group is
    drained as soon as the device is done with it, not when later input
    arrives. An upload waits while more than ``--pipeline`` groups are not
    yet drained (the depth of the loop that drained every group more than
    ``--pipeline`` groups old once the next was read), and at
    ``--pipeline 0`` the serving thread waits for each group's drain
    before the next read. EOF and ``--max-blocks`` wait for every drain
    before the totals, the files' close and ``--checkpoint``. A
    ``--stats`` line, printed by the serving thread after each handoff,
    is the group's submit (its waits on the worker left out) plus the time
    of the drains released since the line before, their event waits
    included (``_segment_done``).

    ``spans``: the ``utils.logging.SpanRecorder`` of ``--trace-spans``,
    with ``run_wideband``'s phases, spans and counters (``upload`` here
    stages ``[tail | group]`` as well; ``write`` / ``rds`` are
    ``writer.write`` and ``framer.feed``; ``groups`` in place of
    ``segments``)."""
    from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
    from real_time_sdr_tpu_torch.utils import state as state_util
    from real_time_sdr_tpu_torch.utils.audio import mono_pcm, stereo_pcm

    stereo, rds = rx.stereo, rx.rds
    cfg = rx.cfg
    seg_n = max(1, args.segment)
    block_bytes = 2 * cfg.block_size_iq
    budget = cfg.block_size_iq / cfg.rf_fs  # real-time seconds per block

    native_io = _native_io()
    fin = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    fout = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    reader = native_io.BlockReader(fin, block_bytes, depth=args.io_depth,
                                   drop_oldest=args.drop_oldest)
    if args.drop_oldest and not reader.native:
        print("warning: --drop-oldest is inactive: the native I/O library "
              "(native/librtsdr_io.so; make -C native builds it) did not "
              "load, so input is read with plain blocking reads and no "
              "block is dropped", file=sys.stderr)
    max_pcm_bytes = (2 if stereo else 1) * cfg.audio_block * 2
    writer = native_io.BlockWriter(fout, max_pcm_bytes,
                                   depth=2 * args.io_depth)

    # the single-station state is one channel; its checkpoint drops that
    # axis, so the file matches the JAX CLI's unbatched state
    state = rx.init_state(1)
    if args.checkpoint:
        try:
            one = state_util.map_state(state, lambda t: t[0])
            state = state_util.map_state(
                state_util.load_state(args.checkpoint, one),
                lambda t: t[None])
            print(f"resumed state from {args.checkpoint}", file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as e:  # shape-incompatible or corrupt npz: never
            # fatal, start fresh
            print(f"warning: could not resume DSP state ({e!r}); "
                  "starting fresh", file=sys.stderr)

    print(f"output: {int(cfg.audio_fs)} Hz s16le "
          f"{'stereo' if stereo else 'mono'}  (play with: aplay -r "
          f"{int(cfg.audio_fs)} -f S16_LE -c {2 if stereo else 1})",
          file=sys.stderr)

    def pcm_of(out):
        return (stereo_pcm(out.left, out.right) if stereo
                else mono_pcm(out.mono))[0]

    staged = args.staged != "0"
    if args.warmup:
        t0 = time.perf_counter()
        n2 = seg_n * block_bytes
        silent = torch.full((1, rx.frontend.staged_len(n2) if staged else n2),
                            128, dtype=torch.uint8, device=device)
        # captures the group's graph; the outputs are discarded
        _, wout = (rx.jit_run_segment_staged(rx.init_state(1), silent, n2)
                   if staged else rx.jit_step(rx.init_state(1), silent))
        pcm_of(wout).cpu()
        print(f"warmed up in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)

    framer = (RdsFramer(on_event=_emit, correct_bursts=args.rds_correct)
              if rds else None)
    if framer is not None and args.checkpoint:
        try:
            with open(args.checkpoint + ".rds.json") as f:
                d = json.load(f)
            if d.get("kind") != "single":
                print(f"warning: {args.checkpoint}.rds.json is not a "
                      "single-station checkpoint; starting framer fresh",
                      file=sys.stderr)
            else:
                framer.load_state_dict(d["framer"])
                print(f"resumed RDS framer from {args.checkpoint}.rds.json",
                      file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as e:  # truncated/corrupt sidecar: never fatal
            print(f"warning: could not resume RDS framer state ({e!r}); "
                  "starting fresh", file=sys.stderr)
            framer = RdsFramer(on_event=_emit,
                               correct_bursts=args.rds_correct)

    n_disp = 0

    def read_group():
        """Up to --segment blocks as one array, with the ingest time of its
        first block (the start of its ingest->PCM latency)."""
        want = seg_n
        if args.max_blocks:
            want = min(want, args.max_blocks - n_disp)
            if want <= 0:
                return None
        bufs, t_in = [], None
        while len(bufs) < want:
            buf = reader.next()
            if buf is None:
                break
            bufs.append(buf)
            if t_in is None:
                t_in = time.perf_counter()
        if not bufs:
            return None
        arr = bufs[0] if len(bufs) == 1 else np.concatenate(bufs)
        return arr, t_in, len(bufs)

    # staged: the host keeps the tail and writes [tail | group] into the
    # pinned ring, so the device runs no concatenation; a resumed run's
    # tail is the checkpoint's
    upload = _Uploader(torch, device, seg_n * block_bytes,
                       args.pipeline + 2, staged, frontend=rx.frontend)
    upload.tail = state.frontend.iq_tail[0].cpu().numpy().copy()
    monitor_every = max(1, args.monitor_every)
    n_blocks = 0
    t_total = 0.0
    latencies: list[float] = []
    now = time.perf_counter_ns
    n_groups = 0

    def drain_one(item) -> None:
        """One group ((pcm, nbits, bits, clean), event, ingest time,
        blocks, in_flight span, group), on the worker's thread."""
        nonlocal n_blocks
        (pcm, nbits, bits, clean), ev, t_in, g, fl, gid = item
        dr = spans.live and spans.phase("drain", gid)
        if fl:
            spans.end(fl, dr.t0)
        dw = dr and spans.span("drain_wait", dr)
        if ev is not None:
            ev.synchronize()   # the only wait on the device
        if dw:
            spans.end(dw)
        pcm = pcm.numpy()
        step_len = pcm.shape[0] // g
        for j in range(g):
            t = dr and now()
            writer.write(pcm[j * step_len:(j + 1) * step_len])
            if dr:
                t1 = now()
                spans.add(dr, "write", t1 - t)
            if framer is not None:
                nj = int(nbits[j])
                if nj > 0:
                    framer.feed(bits[j, :nj].numpy())
                    if dr:
                        spans.count("rds_feeds")
                if dr:
                    spans.add(dr, "rds", now() - t1)
            n_blocks += 1
            if args.monitor and n_blocks % monitor_every == 0:
                _monitor_snapshot(
                    args.monitor, cfg, stereo, framer, n_blocks,
                    pcm[j * step_len:(j + 1) * step_len],
                    None if clean is None else clean[j].numpy())
        latencies.append(time.perf_counter() - t_in)
        if dr:
            spans.end(dr)

    # the device runs the groups in order, so they complete in order
    worker = _DrainWorker(drain_one)
    # an upload waits while this many groups are not yet drained
    bound = args.pipeline + 1
    try:
        rw = spans.live and spans.phase("read_wait", 0)
        nxt = read_group()
        if rw:
            spans.end(rw)
        while nxt is not None:
            t0 = time.perf_counter()
            seg, t_in, g = nxt
            sub = spans.live and spans.phase("submit", n_groups)
            waited = _wait_bound(worker, bound, spans, sub)
            # an EOF partial group runs at its exact shape (the real
            # blocks' outputs do not depend on padding): a graph of its own
            sp = sub and spans.span("upload", sub)
            x = upload(seg)[None]
            if sp:
                spans.end(sp)
                sp = spans.span("dispatch", sub)
            state, out = (rx.jit_run_segment_staged(state, x, seg.shape[0])
                          if upload.staged else rx.jit_step(state, x))
            if sp:
                spans.end(sp)
                sp = spans.span("fetch", sub)
            pcm = pcm_of(out)
            nbits = bits = clean = None
            if framer is not None:
                nbits = out.rds_nbits[0].reshape(g)
                bits = out.rds_bits[0].reshape(g, -1)
                # only groups that will write a --monitor snapshot fetch
                # the (larger) RRC output
                if args.monitor and any(
                        (n_disp + j + 1) % monitor_every == 0
                        for j in range(g)):
                    clean = out.rds_clean[0].reshape(g, -1)
            host, ev = _fetch(torch, device, [pcm, nbits, bits, clean])
            fl = None
            if sp:
                spans.end(sp)
                fl = spans.flight("in_flight", sub, sp.t1)
                spans.count("groups")
                spans.count("blocks", g)
            if sub:
                spans.end(sub)
            worker.submit((host, ev, t_in, g, fl, n_groups))
            n_disp += g
            n_groups += 1
            t_total += _segment_done(args, worker, t0, waited, g, n_disp,
                                     budget)
            # blocked on the SOURCE, not processing: a paced live source
            # delivers a g-block group in g*30.6 ms
            rw = spans.live and spans.phase("read_wait", n_groups)
            nxt = read_group()
            if rw:
                spans.end(rw)
                if not worker.pending():
                    spans.count("drained_before_next_read")
        worker.wait(0)
        t_total += worker.take_ns() / 1e9
    finally:
        worker.close()
    reader.close()
    writer.close()  # drains the ring
    if reader.dropped:
        print(f"dropped {reader.dropped} input blocks (consumer too slow)",
              file=sys.stderr)
    fout.flush()
    if fin is not sys.stdin.buffer:
        fin.close()
    if fout is not sys.stdout.buffer:
        fout.close()

    if framer is not None and framer.events.groups_decoded:
        ev = framer.events
        print(f"RDS summary: {ev.groups_decoded} groups decoded, "
              f"{ev.blocks_corrected} blocks burst-corrected", file=sys.stderr)
    if args.checkpoint:
        state_util.save_state(args.checkpoint,
                              state_util.map_state(state, lambda t: t[0]))
        if framer is not None:
            _atomic_json(args.checkpoint + ".rds.json",
                         {"kind": "single", "framer": framer.state_dict()})
        print(f"saved state to {args.checkpoint}", file=sys.stderr)
    if args.stats and n_blocks:
        print(f"total: {n_blocks} blocks, avg {t_total/n_blocks*1e3:.2f} ms"
              f"/block, {budget*n_blocks/t_total:.1f}x real time",
              file=sys.stderr)
        if latencies:
            lat = np.sort(np.asarray(latencies))
            p50 = lat[len(lat) // 2]
            p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
            # steady state = last half: separates the startup transient
            # from whether the pipeline keeps up
            half = np.sort(np.asarray(latencies[len(latencies) // 2:]))
            print(f"block latency (ingest->PCM out): p50 {p50*1e3:.1f} ms, "
                  f"p99 {p99*1e3:.1f} ms, max {lat[-1]*1e3:.1f} ms, "
                  f"steady-state p50 {half[len(half)//2]*1e3:.1f} ms vs "
                  f"{budget*1e3:.2f} ms block deadline "
                  f"(dropped {reader.dropped})", file=sys.stderr)
        if device.type == "cuda":
            _print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
