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
ring-buffered reader, uploads the group (``--staged``: through a ring of
pinned host buffers with an asynchronous copy), queues the receiver's
kernels (launches are asynchronous), and starts the PCM and RDS copies
back into pinned memory. Up to ``--pipeline`` groups stay in flight; a
drain waits once per group on a CUDA event, then writes the PCM and feeds
the RDS framer. The wideband loop is the same with one (S, ...) PCM tensor
and one fetch per segment; ``--retune SEG:STATION:HZ`` re-points a station
of the fused frontend between segments, and ``--checkpoint`` resumes onto
the grid the saved state was built on (its ``.rds.json`` sidecar names it).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from collections import deque

import numpy as np

# flags that only mean something together with --stations
WIDEBAND_ONLY_FLAGS = ("wide_fs", "output_dir", "retune")


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
                    help="host-staged ingest: the read loop copies each "
                         "group into a ring of pinned host buffers and "
                         "uploads it asynchronously (auto = 1); 0 = a plain "
                         "pageable copy to the device")
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
                    help="groups kept in flight on the device before the "
                         "PCM fetch syncs; each adds latency but overlaps "
                         "host work with the device (0 = fully synchronous)")
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
    """The reference CLI's RDS event lines on stderr."""
    if kind == "group":
        pi, _gt, pty = val
        print(f"PI: {pi:x}", file=sys.stderr)
        print(f"PTY: {pty}", file=sys.stderr)
    elif kind == "ps":
        print(f"Program Service: {val}", file=sys.stderr)
    elif kind == "radiotext":
        print(f"RadioText: {val}", file=sys.stderr)
    elif kind == "ptyn":
        print(f"Program Type Name: {val}", file=sys.stderr)
    elif kind == "clock":
        print(f"Clock Time: {val}", file=sys.stderr)
    elif kind == "af":
        print("Alternative Frequencies: "
              + ", ".join(f"{f:.1f}" for f in val), file=sys.stderr)


class _Uploader:
    """Host -> device copies of input groups.

    staged: each group is copied into the next slot of a ring of host
    buffers (page-locked when the device is a card) and uploaded with
    ``non_blocking=True``. A slot is reused ``slots`` groups later; the
    loop drains every group more than ``--pipeline`` groups old (waiting
    on its event, which follows its upload), so with ``slots`` >=
    ``--pipeline`` + 2 no slot is overwritten while its copy is in flight.
    Unstaged: a plain pageable ``.to(device)``."""

    def __init__(self, torch, device, nbytes: int, slots: int, staged: bool):
        self.torch = torch
        self.device = device
        self.ring = ([torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=device.type == "cuda")
                      for _ in range(slots)] if staged else None)
        self.k = 0

    def __call__(self, seg: np.ndarray):
        torch = self.torch
        if self.ring is None:
            return torch.from_numpy(seg).to(self.device)
        buf = self.ring[self.k % len(self.ring)][:seg.shape[0]]
        self.k += 1
        buf.copy_(torch.from_numpy(seg))
        return buf.to(self.device, non_blocking=True)


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
    given = ["--" + f.replace("_", "-") for f in WIDEBAND_ONLY_FLAGS
             if getattr(args, f) is not None]
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
    rx = Receiver(args.mode, stereo=args.type in ("s", "r"),
                  rds=args.type == "r", pll_tier=args.pll_tier,
                  rds_timing=args.rds_timing, device=device)
    if args.stations is not None:
        return run_wideband(args, torch, device, rx, rx.cfg)
    return _serve(args, torch, device, rx)


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


def run_wideband(args, torch, device, rx, cfg) -> int:
    """Multi-station mode: channelize a wideband capture and decode every
    station in parallel through a channel bank."""
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
    fe = make_wideband_frontend(cfg, wide_fs, offsets, device=device)
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
        return RdsFramer(on_event=lambda kind, val: print(
            f"ch{k} {kind}: {val}", file=sys.stderr),
            correct_bursts=args.rds_correct)

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
        _, wout, _ = bank.run_wideband_u8(bank.init_state(), fe, silent,
                                          fe.init_state())   # discarded
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
        # (host tensors, event, blocks) per segment in flight; the device
        # runs the segments in order, so they complete in order
        in_flight: deque = deque()

        def drain(k: int) -> None:
            for _ in range(k):
                (pcm, nbits, bits), ev, g = in_flight.popleft()
                if ev is not None:
                    ev.synchronize()   # the only wait on the device
                pcm = pcm.numpy()
                if framers is not None:
                    nbits, bits = nbits.numpy(), bits.numpy()
                for st in range(n_st):
                    pcm[st].tofile(outs[st])
                    if framers is not None:
                        for j in range(g):
                            if nbits[st, j] > 0:
                                framers[st].feed(bits[st, j, :nbits[st, j]])

        buf = bytearray(seg_n * block_bytes)
        seg_i = 0
        while True:
            if seg_i in retunes:
                # drain first: pending outputs belong to the old grid and
                # must reach the old framers before the station re-points
                drain(len(in_flight))
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
            g = _read_into(fin, view) // block_bytes
            if not g:
                break
            t0 = time.perf_counter()
            # an EOF partial segment runs at its exact shape: the real
            # blocks' outputs do not depend on padding, and nothing is
            # recompiled
            raw = np.frombuffer(buf, dtype=np.uint8, count=g * block_bytes)
            bstate, out, fstate = bank.run_wideband_u8(
                bstate, fe, upload(raw), fstate)
            seg_i += 1
            nbits = bits = None
            if framers is not None:
                nbits = out.rds_nbits.reshape(n_st, g)
                bits = out.rds_bits.reshape(n_st, g, -1)
            # ONE batched (S, ...) PCM tensor and one fetch per segment
            host, ev = _fetch(torch, device, [pcm_of(out), nbits, bits])
            in_flight.append((host, ev, g))
            if len(in_flight) > args.pipeline:
                drain(max(1, (len(in_flight) + 1) // 2))
            n_blocks += g
            dt = time.perf_counter() - t0
            t_total += dt
            if args.stats:
                print(f"block {n_blocks}: {dt*1e3:.2f} ms "
                      f"({g*budget/dt:.1f}x real time)", file=sys.stderr)
        drain(len(in_flight))
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
    if args.stats and n_blocks:
        print(f"total: {n_blocks} blocks, avg {t_total/n_blocks*1e3:.2f} ms"
              f"/block, {budget*n_blocks/t_total:.1f}x real time",
              file=sys.stderr)
        if device.type == "cuda":
            _print_launches()
    print(f"channelized {n_st} stations x {n_blocks} blocks",
          file=sys.stderr)
    return 0


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


def _serve(args, torch, device, rx) -> int:
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

    if args.warmup:
        t0 = time.perf_counter()
        silent = torch.full((1, seg_n * block_bytes), 128, dtype=torch.uint8,
                            device=device)
        _, wout = rx.run_segment(rx.init_state(1), silent)   # discarded
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

    upload = _Uploader(torch, device, seg_n * block_bytes,
                       args.pipeline + 2, args.staged != "0")
    monitor_every = max(1, args.monitor_every)
    n_blocks = 0
    t_total = 0.0
    latencies: list[float] = []
    # (host tensors, event, ingest time, blocks) per group in flight; the
    # device runs the groups in order, so they complete in order
    in_flight: deque = deque()

    def drain(k: int) -> None:
        nonlocal n_blocks
        for _ in range(k):
            (pcm, nbits, bits, clean), ev, t_in, g = in_flight.popleft()
            if ev is not None:
                ev.synchronize()   # the only wait on the device
            pcm = pcm.numpy()
            step_len = pcm.shape[0] // g
            for j in range(g):
                writer.write(pcm[j * step_len:(j + 1) * step_len])
                if framer is not None:
                    nj = int(nbits[j])
                    if nj > 0:
                        framer.feed(bits[j, :nj].numpy())
                n_blocks += 1
                if args.monitor and n_blocks % monitor_every == 0:
                    _monitor_snapshot(
                        args.monitor, cfg, stereo, framer, n_blocks,
                        pcm[j * step_len:(j + 1) * step_len],
                        None if clean is None else clean[j].numpy())
            latencies.append(time.perf_counter() - t_in)

    nxt = read_group()
    while nxt is not None:
        t0 = time.perf_counter()
        seg, t_in, g = nxt
        # an EOF partial group runs at its exact shape: the real blocks'
        # outputs do not depend on padding, and nothing is recompiled
        state, out = rx.run_segment(state, upload(seg)[None])
        pcm = pcm_of(out)
        nbits = bits = clean = None
        if framer is not None:
            nbits = out.rds_nbits[0].reshape(g)
            bits = out.rds_bits[0].reshape(g, -1)
            # only groups that will write a --monitor snapshot fetch the
            # (larger) RRC output
            if args.monitor and any((n_disp + j + 1) % monitor_every == 0
                                    for j in range(g)):
                clean = out.rds_clean[0].reshape(g, -1)
        host, ev = _fetch(torch, device, [pcm, nbits, bits, clean])
        n_disp += g
        in_flight.append((host, ev, t_in, g))
        r0 = time.perf_counter()
        nxt = read_group()
        # blocked on the SOURCE, not processing: a paced live source
        # delivers a g-block group in g*30.6 ms
        read_wait = time.perf_counter() - r0
        if len(in_flight) > args.pipeline:
            # drain half the window per wait: the queue stays half full,
            # so the device keeps running while the host writes
            drain(max(1, (len(in_flight) + 1) // 2))
        dt = max(time.perf_counter() - t0 - read_wait, 1e-9)
        t_total += dt
        if args.stats:
            print(f"block {n_blocks}: {dt*1e3:.2f} ms "
                  f"({g*budget/dt:.1f}x real time)", file=sys.stderr)
    drain(len(in_flight))
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
