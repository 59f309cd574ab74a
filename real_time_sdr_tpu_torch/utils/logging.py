"""Observability: gnuplot-style vector dumps, the serving loops' span and
counter recorder, the per-stage speed-of-light (roofline) report and a
device trace.

Port of ``real_time_sdr_tpu/utils/logging.py``. ``log_vector`` writes what
the JAX package's does. ``SpanRecorder`` is the port's own: the CLI's two
serving loops (``cli.run_wideband``, ``cli._serve``) record their phases
(the read wait, the submit, the drain), the steps inside them and each
segment's wait in flight, with counters beside them, and ``--trace-spans``
writes them out at exit as a Chrome trace on torch.profiler's clock; while
a profiler records, each phase is also one of its ranges. The roofline
counts the FUNCTION's work, from the ``cost()`` of each module
(``ops/fir``, ``models/frontend``, ``ops/sync``), against the data-sheet
peaks of an NVIDIA H100 SXM (80 GB HBM3, 700 W): the same count the kernel
checks of ``chip_smoke.py`` hold each kernel's time against.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, schedule

from real_time_sdr_tpu_torch.ops.fir import DecimatingFIR
from real_time_sdr_tpu_torch.ops.sync import FeedforwardSync

__all__ = ["log_vector", "Span", "SpanRecorder", "H100_HBM_BPS",
           "H100_F32_FLOPS", "H100_BF16_FLOPS", "F32_LATENCY_CYCLES",
           "peak_flops",
           "roofline_ms", "launch_cost", "stage_costs",
           "speed_of_light_report", "device_trace", "device_busy"]

# NVIDIA H100 SXM data sheet (80 GB HBM3, 700 W): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (every kernel of the port), and the dense bf16
# tensor-core rate (the wideband fold products at bf16 / bf16x2)
H100_HBM_BPS = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
# cycles of a dependent FADD/FMUL/FFMA/FSEL on sm_90: a serial chain of f32
# operations runs no faster than this many cycles per operation
F32_LATENCY_CYCLES = 4


def log_vector(name: str, data, out_dir: str = "data",
               index=None) -> str:
    """Dump (index, value) pairs to <out_dir>/<name>.dat, one per line
    after a ``# name`` header (the gnuplot layout)."""
    os.makedirs(out_dir, exist_ok=True)
    data = np.asarray(data).ravel()
    if index is None:
        index = np.arange(len(data))
    path = os.path.join(out_dir, f"{name}.dat")
    with open(path, "w") as f:
        f.write(f"# {name}\n")
        for i, v in zip(np.asarray(index).ravel(), data):
            f.write(f"{i}\t{v:.8g}\n")
    return path


class Span:
    """One interval of a ``SpanRecorder``: its name, kind (``phase``,
    ``span`` or ``flight``), the segment or group id it belongs to
    (``gid``), the span that caused it (``parent``), its start and end
    (``time.perf_counter_ns``), the thread (``threading.get_ident``: the
    native id costs a system call, taken once a thread by the recorder),
    whether a torch.profiler session ran in the process when it started
    (``profiled``: a phase's range went to it), and the times
    ``SpanRecorder.add`` summed onto it (``args``, ns)."""

    __slots__ = ("name", "kind", "gid", "parent", "profiled", "rf", "tid",
                 "args", "t0", "t1")

    def __init__(self, name: str, kind: str, gid, parent, profiled: bool,
                 rf, t0: int):
        self.name, self.kind, self.gid, self.parent = name, kind, gid, parent
        self.profiled, self.rf, self.t0 = profiled, rf, t0
        self.tid = threading.get_ident()
        self.args: dict | None = None
        self.t1: int | None = None


def _enter_range(name: str):
    """An entered profiler range (a ``cpu_op`` event named ``name``).
    ``_RecordFunctionFast`` opens and closes it in C++ without releasing
    the GIL, so no other thread runs between its stamp and the span's;
    ``record_function`` goes through an operator that does release it,
    and its stamps could lie a thread's turn (up to ~5 ms) off."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _clock_pair() -> tuple[int, int]:
    """(``perf_counter_ns``, ``time_ns``) read together: of five tries,
    the one whose two ``perf_counter_ns`` reads around ``time_ns`` lie
    closest, at their midpoint."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


class SpanRecorder:
    """Spans and counters of a serving loop, kept in memory and written
    out at the end as one Chrome-trace JSON on torch.profiler's clock
    (``write``).

    Kinds of span: a ``phase`` is a step of the loop's top level (in one
    thread no two overlap); while a torch.profiler session records in the
    thread, a phase is also a profiler range (``_enter_range``), which
    the profiler stamps on its own clock: the span's start is taken just
    after the range opens, its end just before it closes, where the
    profiler's own stamps lie nearest. A ``span`` is a step inside a phase
    (memory only). A ``flight`` is a wait that overlaps the phases, such
    as a segment's time in flight (memory only: as a profiler range it
    would cover every idle gap). ``add`` sums time onto a span from many
    short calls inside it. ``profile_range`` opens a profiler range alone,
    for consecutive phases that share one (a drain of several segments).
    A counter is a name and a running total, sampled at each ``count``.
    Spans and counters may come from several threads (the wideband loop's
    drain runs in a worker); each span keeps its thread.

    Recording (``on``, set by ``start``) is off by default. The profiler
    ranges do not wait for it: ``live`` is true while recording or while a
    torch.profiler session runs in the process, so a profiled run names
    its host phases with or without recording. A range is opened in any
    thread while a session runs; the session records it when it records
    that thread: by default only the thread that started it, every thread
    under ``experimental_config=_ExperimentalConfig(profile_all_threads=
    True)``. A phase site tests ``live``
    first (``sp = rec.live and rec.phase(...)``, then ``if sp:
    rec.end(sp)``); with neither, that test is all a site costs, and no
    profiler call is made. ``span``, ``flight`` and ``count`` do nothing
    unless recording. Times are ``time.perf_counter_ns``, the clock of the
    CLI's ``--stats`` lines; ``write`` maps them onto ``time.time_ns``
    (the clock of a torch.profiler Chrome trace's ``ts`` plus its
    ``baseTimeNanoseconds``) through two anchors, taken at ``start`` and
    at ``write``."""

    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.samples: list[tuple[str, int, int]] = []
        self.anchor: tuple[int, int] | None = None
        self.natives: dict[int, int] = {}
        self._lock = threading.Lock()

    def start(self) -> None:
        """Turn recording on, from empty."""
        self.spans, self.counters, self.samples = [], {}, []
        self.natives = {}
        self.anchor = _clock_pair()
        self.on = True

    @property
    def live(self) -> bool:
        """Recording, or a torch.profiler session recording in this
        process (the profiler's own flag for such checks)."""
        return self.on or _autograd_profiler._is_profiler_enabled

    def _open(self, name: str, kind: str, gid, parent,
              profile: bool) -> Span:
        profiled = _autograd_profiler._is_profiler_enabled
        rf = _enter_range(name) if profiled and profile else None
        sp = Span(name, kind, gid, parent, profiled, rf,
                  time.perf_counter_ns())
        if self.on:
            self.spans.append(sp)
            if sp.tid not in self.natives:   # a system call, once a thread
                self.natives[sp.tid] = threading.get_native_id()
        return sp

    def phase(self, name: str, gid=None, profile: bool = True) -> Span:
        """Open a top-level step of segment or group ``gid``; with
        ``profile`` False it sends no range of its own to the profiler.
        Kept only while recording."""
        return self._open(name, "phase", gid, None, profile)

    def span(self, name: str, parent: Span,
             t0: int | None = None) -> Span | None:
        """Open a step inside ``parent``, from ``t0``
        (``time.perf_counter_ns``; default now) (memory only; None unless
        recording)."""
        if not self.on:
            return None
        sp = self._open(name, "span", parent.gid, parent, False)
        if t0 is not None:
            sp.t0 = t0
        return sp

    def flight(self, name: str, parent: Span,
               t0: int | None = None) -> Span | None:
        """Open a wait of ``parent``'s segment that overlaps the phases,
        from ``t0`` (``time.perf_counter_ns``; default now) (memory only;
        None unless recording)."""
        if not self.on:
            return None
        sp = self._open(name, "flight", parent.gid, parent, False)
        if t0 is not None:
            sp.t0 = t0
        return sp

    def end(self, sp: Span, t1: int | None = None) -> None:
        """Close ``sp`` now, or at ``t1`` (``time.perf_counter_ns``): a
        span that ends where another starts, in another thread, shares
        its stamp."""
        sp.t1 = time.perf_counter_ns() if t1 is None else t1
        if sp.rf is not None:
            self.close_range(sp.rf)
            sp.rf = None

    @staticmethod
    def add(sp: Span, key: str, ns: int) -> None:
        """Sum ``ns`` nanoseconds onto ``sp`` under ``key``."""
        if sp.args is None:
            sp.args = {}
        sp.args[key] = sp.args.get(key, 0) + ns

    @staticmethod
    def profile_range(name: str):
        """An entered range ``name`` while a torch.profiler session runs,
        else None."""
        return (_enter_range(name) if _autograd_profiler._is_profiler_enabled
                else None)

    @staticmethod
    def close_range(rf) -> None:
        if rf is not None:
            rf.__exit__(None, None, None)

    def count(self, name: str, n: int = 1) -> None:
        if not self.on:
            return
        with self._lock:
            total = self.counters.get(name, 0) + n
            self.counters[name] = total
            self.samples.append((name, time.perf_counter_ns(), total))

    def write(self, path: str) -> None:
        """The spans and counters as a Chrome-trace JSON: phases and spans
        as complete events (``X``; ``cat`` their kind), flights as async
        begin/end pairs (``b``/``e``), counter samples as ``C`` events;
        ``args`` carry ``span`` (the span's index), ``parent`` (its
        parent's), ``id`` (segment or group), ``profiled`` and any summed
        times in ms (``<key>_ms``). ``ts`` is in microseconds from
        ``baseTimeNanoseconds`` on ``time.time_ns``'s clock, as in a
        torch.profiler export; ``otherData`` holds the counters' totals
        and the anchors."""
        end = _clock_pair()
        (p0, u0), (p1, u1) = self.anchor, end
        rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0
        base = u0 // 10**9 * 10**9
        pid = os.getpid()

        def ts(t: int) -> float:
            return ((u0 - base) + (t - p0) * rate) / 1e3

        index = {id(sp): k for k, sp in enumerate(self.spans)}
        events = []
        for k, sp in enumerate(self.spans):
            if sp.t1 is None:
                continue
            args = {"span": k, "parent": index.get(id(sp.parent)),
                    "id": sp.gid, "profiled": sp.profiled}
            for key, ns in (sp.args or {}).items():
                args[key + "_ms"] = ns / 1e6
            head = {"cat": sp.kind, "name": sp.name, "pid": pid,
                    "tid": self.natives.get(sp.tid, sp.tid)}
            if sp.kind == "flight":
                events.append(dict(head, ph="b", id=k, ts=ts(sp.t0),
                                   args=args))
                events.append(dict(head, ph="e", id=k, ts=ts(sp.t1)))
            else:
                events.append(dict(head, ph="X", ts=ts(sp.t0),
                                   dur=(sp.t1 - sp.t0) * rate / 1e3,
                                   args=args))
        tid = threading.get_native_id()
        for name, t, total in self.samples:
            events.append({"ph": "C", "cat": "counter", "name": name,
                           "pid": pid, "tid": tid, "ts": ts(t),
                           "args": {name: total}})
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "baseTimeNanoseconds": base,
               "otherData": {"counters": dict(self.counters),
                             "anchors": [list(self.anchor), list(end)]}}
        with open(path, "w") as f:
            json.dump(doc, f)


def peak_flops(kind: str = "") -> tuple[float, str]:
    """(FLOP/s, name) of the peak a cost of ``kind`` is held against: the
    bf16 tensor-core peak for a ``*_bf16`` or ``*_bf16x2`` kind, the f32
    peak for every other."""
    if {"bf16", "bf16x2"} & set(kind.split("_")):
        return H100_BF16_FLOPS, "bf16"
    return H100_F32_FLOPS, "f32"


def roofline_ms(nbytes: float, flops: float,
                kind: str = "") -> tuple[float, str]:
    """The least time the card could take for the work, in ms, and what
    bounds it: the larger of the bytes over the HBM rate ("bytes") and the
    operations over the peak of the cost's ``kind`` ("operations",
    ``peak_flops``)."""
    t_b = nbytes / H100_HBM_BPS * 1e3
    t_f = flops / peak_flops(kind)[0] * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def launch_cost(cost: dict, rows: int) -> tuple[float, float]:
    """(bytes, flops) of one launch over ``rows`` rows of a module's
    per-row ``cost()``: the weights are read once per launch."""
    w = cost.get("w_bytes", 0)
    return rows * (cost["bytes"] - w) + w, rows * cost["flops"]


def _ew(n_streams: float, n: int, const_streams: float = 0.0,
        channels: int = 1) -> dict:
    """Elementwise-chain cost: ``n_streams`` f32 arrays of length ``n``
    read or written once, plus ``const_streams`` whose source is a
    per-call constant shared by every channel (the ramp tables; amortized
    over the channel batch). The operations are negligible next to the
    bytes."""
    return {"kind": "elementwise", "flops": 0,
            "bytes": int(4 * n * (n_streams + const_streams / channels)),
            "w_bytes": 0, "dims": (0, 0, 0)}


def _kernel_of(site) -> str:
    """The kernel behind a FIR site: the decimating FIR or the FIR bank."""
    return "fir_decimate" if isinstance(site, DecimatingFIR) else "fir_bank"


def stage_costs(rx, channels: int = 1,
                blocks: int = 1) -> list[tuple[str, dict]]:
    """Walk a Receiver's stages and collect per-block, per-channel cost
    dicts, each with a ``kernel`` key naming the port's kernel that
    computes it (None for elementwise torch work and the delay slices).
    A stage that runs a whole segment of ``blocks`` blocks per launch
    reads its carried tail once per segment: its row is the segment's
    count over ``blocks`` (``w_bytes`` stays the launch's, for
    ``speed_of_light_report`` to amortize), so rows scaled to the serving
    shape are the launches' counts.

    The walk and the row names are the JAX package's; the port adds one
    row per tier-1 carrier loop (``audio.sync.pll_scan``,
    ``rds.sync.pll_scan``), which the JAX package counts only in its
    ``pll+mix`` traffic. A bank's rows count one read of its shared input
    (``FIRBank.cost``). The stereo audio resampler is one launch over both
    rails (``fir_decimate`` at modes 0-1, a FIR bank at modes 2-3): its
    two rows ``audio.mono_fir`` and ``audio.stereo_fir`` count one rail
    each and the taps once. The elementwise rows keep the JAX package's
    stream tallies: each materialized input read once and the output
    written once, the least a fused implementation moves."""
    cfg = rx.cfg
    n_if = cfg.if_block
    out = []

    def add(name, cost, kernel):
        out.append((name, dict(cost, kernel=kernel)))

    def seg_cost(site, n):
        """Per-block share of ``site.cost`` over a segment of n-sample
        blocks."""
        c = site.cost(n * blocks)
        w = c["w_bytes"]
        share = dict(c, flops=c["flops"] / blocks,
                     bytes=(c["bytes"] - w) / blocks + w)
        if "chain_ops" in c:
            share["chain_ops"] = c["chain_ops"] // blocks
        return share

    def add_sync(prefix, sync):
        if isinstance(sync, FeedforwardSync):
            add(f"{prefix}.cfir(2 shared)", seg_cost(sync.bank, n_if),
                "fir_bank")
        elif sync.tier == 1:
            add(f"{prefix}.pll_scan", seg_cost(sync, n_if), "pll_scan")

    add("frontend.rf(u8)", seg_cost(rx.frontend, 2 * cfg.block_size_iq),
        "frontend_fused")
    audio, r = rx.audio, rx.rds_path
    if not rx.stereo:
        add("audio.audio_fir", seg_cost(audio.audio_bank, n_if),
            _kernel_of(audio.audio_bank))
    else:
        if rx.if_bank is not None:
            add("if.bank(3 shared BPFs)", seg_cost(rx.if_bank, n_if),
                "fir_bank")
        else:
            add("audio.pb_bank(2 shared)", seg_cost(audio.pb_bank, n_if),
                "fir_bank")
        add("audio.delay_fir", audio.delay_fir.cost(n_if), None)
        rail = seg_cost(audio.resamp_bank, n_if)
        kernel = _kernel_of(audio.resamp_bank)
        add("audio.mono_fir", rail, kernel)
        add("audio.stereo_fir", dict(rail, bytes=rail["bytes"]
                                     - rail["w_bytes"], w_bytes=0), kernel)
        add_sync("audio.sync", audio.sync)
    if r is not None:
        if rx.if_bank is None:
            add("rds.band_fir", seg_cost(r.band_bank, n_if), "fir_bank")
        add("rds.pilot_fir", seg_cost(r.pilot_bank, n_if), "fir_bank")
        add("rds.delay_fir", r.delay_fir.cost(n_if), None)
        # the narrowband tail runs one batch row per (channel, block)
        add("rds.baseband_fir", r.baseband_bank.cost(n_if), "fir_bank")
        add("rds.rrc_fir", r.rrc_bank.cost(cfg.rds_block), "fir_bank")
        add_sync("rds.sync", r.sync)

    # -- elementwise chains (bytes only, see _ew) ---------------------------
    n_audio = n_if * cfg.audio_up // cfg.audio_down
    if rx.stereo and isinstance(audio.sync, FeedforwardSync):
        # sync epilogue + DSB mix: c_re/c_im, the stereo band and the delay
        # slice read, the mixed stream written; the ramp tables are
        # constants shared by the channel batch
        add("audio.sync.epi+mix", _ew(5, n_if, 2, channels), None)
        # L/R matrixing at the audio rate
        add("audio.matrix", _ew(4, n_audio), None)
    elif rx.stereo:
        add("audio.pll+mix", _ew(5, n_if), None)
    if r is not None and isinstance(r.sync, FeedforwardSync):
        # c_re/c_im + delay reads, the wrapped delta through the prefix sum
        # (write + read), the mixed write; the angle table is a constant
        add("rds.sync.epi+unwrap+mix", _ew(6, n_if, 1, channels), None)
        # decode tail at the RDS rate: RRC output re-read by the CDR comb
        # and the slicer, per-block reductions, bit emission
        add("rds.decode-tail", _ew(5, cfg.rds_block), None)
    elif r is not None:
        add("rds.pll+mix", _ew(5, n_if), None)
        add("rds.decode-tail", _ew(5, cfg.rds_block), None)
    return out


def speed_of_light_report(rx, file=None, channels: int = 1,
                          blocks: int = 1,
                          sm_clock_hz: float | None = None) -> dict:
    """Print per-stage FLOPs / bytes / speed-of-light floor per blk/ch at
    the serving shape ``channels`` x ``blocks``, then one row per kernel
    at that shape, and return the totals.

    A stage's floor is max(flops / peak, bytes / H100_HBM_BPS), the peak
    that of its kind (``peak_flops``); each row names it.
    Weights stream once per launch and one launch covers every channel and
    block of a segment, so ``w_bytes`` divides by channels * blocks. The
    tier-1 carrier loop is bound by its serial chain, not by bytes or
    operations: its row prints the chain (cycles per block and row, ms at
    ``sm_clock_hz`` when given), and its time stays out of the summed
    floor (its bytes and operations are in the totals).

    Returns {"flops", "bytes", "floor_s", "ceiling_x"} per blk/ch (the
    JAX package's keys) and "kernels": {name: {"floor_ms", "bound_by"}}
    at the serving shape, each kernel's floor the sum of its rows'."""
    file = file or sys.stderr
    cfg = rx.cfg
    budget = cfg.block_size_iq / cfg.rf_fs
    amort = channels * blocks
    tot_f = tot_b = tot_t = 0.0
    kernels: dict[str, dict] = {}
    print(f"# speed-of-light per blk/ch at serving shape {channels}ch x "
          f"{blocks}blk ({budget*1e3:.2f} ms of signal), NVIDIA H100 SXM "
          f"data-sheet peaks ({H100_HBM_BPS/1e12:.2f} TB/s HBM, "
          f"{H100_F32_FLOPS/1e12:.0f} TFLOP/s f32, "
          f"{H100_BF16_FLOPS/1e12:.0f} TFLOP/s bf16):", file=file)
    for name, c in stage_costs(rx, channels=channels, blocks=blocks):
        w_b = c["w_bytes"]
        byts = c["bytes"] - w_b + w_b / amort
        cf, j, r = c["dims"]
        head = (f"#  {name:26s} {c['flops']/1e6:9.2f} MFLOP "
                f"{byts/1e3:9.1f} kB  ({cf}x{j}x{r})  ")
        tot_f += c["flops"]
        tot_b += byts
        if "chain_ops" in c:
            cycles = c["chain_ops"] * F32_LATENCY_CYCLES
            chain_ms = (blocks * cycles / sm_clock_hz * 1e3
                        if sm_clock_hz else None)
            k = kernels.setdefault(c["kernel"], dict(floor_ms=0.0,
                                                     bound_by="latency"))
            if chain_ms is None:
                k["floor_ms"] = None
            elif k["floor_ms"] is not None:
                k["floor_ms"] += chain_ms
            print(head + f"chain {cycles} cycles per blk and row "
                  "[latency-bound]", file=file)
            continue
        t_s, by = roofline_ms(byts, c["flops"], c["kind"])
        t = t_s / 1e3
        tot_t += t
        if c["kernel"] is not None:
            k = kernels.setdefault(c["kernel"], dict(floor_ms=0.0,
                                                     by={}))
            k["floor_ms"] += t * amort * 1e3
            k["by"][by] = k["by"].get(by, 0.0) + t
        print(head + f"floor {t*1e6:8.3f} us  [{by}-bound, "
              f"{peak_flops(c['kind'])[1]} peak]", file=file)
    print(f"#  {'TOTAL':26s} {tot_f/1e6:9.2f} MFLOP {tot_b/1e3:9.1f} kB"
          f"{'':20s}floor {tot_t*1e6:8.3f} us -> SoL ceiling "
          f"{budget/tot_t:,.0f}x realtime per channel", file=file)
    for name, k in kernels.items():
        if "by" in k:           # the bound that holds most of the floor
            by = k.pop("by")
            k["bound_by"] = max(by, key=by.get)
        floor = ("n/a without a clock" if k["floor_ms"] is None
                 else f"{k['floor_ms']:.4f} ms")
        print(f"#  kernel {name:17s} floor {floor} at {channels}ch x "
              f"{blocks}blk [{k['bound_by']}-bound]", file=file)
    return {"flops": tot_f, "bytes": tot_b, "floor_s": tot_t,
            "ceiling_x": budget / tot_t, "kernels": kernels}


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace", warmup: int = 0):
    """torch.profiler around a region (CPU activity, and the card's when
    there is one); yields the profiler, whose ``key_averages()`` are ready
    after the region, and writes a Chrome trace to <log_dir>/<name>.json
    (open it in chrome://tracing or Perfetto). With ``warmup`` n the
    region calls ``prof.step()`` after each of its first n calls, and only
    the call after them is recorded: a window's first records can go
    missing on the card."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sched = (schedule(wait=0, warmup=warmup, active=1, repeat=1) if warmup
             else None)
    with profile(activities=acts, schedule=sched) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def device_busy(averages, product_ms: float | None = None) -> dict:
    """Device busy of a profiled window from its ``key_averages()``: the
    self device time of every device op (the schedule's ``ProfilerStep``
    annotations, which span the window, excepted), with the window's
    matrix products (``aten::mm``: the wideband fold product) in it.

    The profiler does not record every library GEMM kernel. Where an
    ``aten::mm`` ran and no device time came with it, ``product_ms`` (one
    product's device time from CUDA events) times its calls is added.
    Returns ``busy_ms``, ``product_ms`` (None when unknown), ``calls`` (of
    ``aten::mm``) and ``source``: "profiler", "CUDA events", "none" (no
    product ran) or "missing" (a product ran unrecorded and no time was
    given: ``busy_ms`` lacks it)."""
    from torch.autograd import DeviceType
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep"))
    mm = [e for e in averages if e.key == "aten::mm"]
    calls = sum(e.count for e in mm)
    recorded_us = sum(e.device_time_total for e in mm)
    out = dict(busy_ms=busy_us / 1e3, product_ms=0.0, calls=calls,
               source="none")
    if recorded_us > 0:
        out.update(product_ms=recorded_us / 1e3, source="profiler")
    elif calls and product_ms is None:
        out.update(product_ms=None, source="missing")
    elif calls:
        out.update(busy_ms=out["busy_ms"] + calls * product_ms,
                   product_ms=calls * product_ms, source="CUDA events")
    return out
