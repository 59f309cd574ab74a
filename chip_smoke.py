#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one card and check it.

    python3 chip_smoke.py [--profile PATH]

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit. It imports no jax. Phases, each of which exits
non-zero on failure:

1. card and versions (``nvidia-smi`` name and power limit, torch, CUDA);
2. build: the kernels compile from ``real_time_sdr_tpu_torch/csrc`` into
   the git-ignored ``real_time_sdr_tpu_torch/_build/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (mode 0, 32 channels x 12 blocks): frontend demod
   > 90 dB, every FIR-bank site > 110 dB; median device times of both;
4. main path: a synthetic station tiled to 32 channels (distinct time
   shifts) through ``Receiver(0, stereo=True, rds=True, pll_tier=3,
   device="cuda").run_segment`` over three chained 12-block segments; both
   kernels' launch counts must rise; channel 0's PS/PI must decode and its
   left/right channels carry their tones; channels 0-1 of the first two
   segments must agree with the port's own CPU run (audio > 60 dB, RDS
   bits equal from a carried state); warm segments are timed for the
   aggregate real-time multiple.

The last two lines are the kernels' JSON and the device JSON.
``--profile PATH`` also writes a torch.profiler table of one warm segment.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

CH, BLOCKS, SEGMENTS = 32, 12, 3
PS, PI, PTY = "H100 FM ", 0x3A5C, 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def snr_db(ref, y) -> float:
    ref = ref.double()
    err = (y.double() - ref).pow(2).sum().item()
    return 10.0 * math.log10(ref.pow(2).sum().item() / max(err, 1e-300))


def device_ms(torch, fn, reps: int = 10) -> float:
    """Median device time of fn per call: the calls queue up behind a
    sleeping kernel, so host launch cost stays out of the measurement."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def band_power(np, x, fs, f, width=30.0):
    sp = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1 / fs)
    return sp[(freqs > f - width) & (freqs < f + width)].sum()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", help="write a torch.profiler table of one "
                    "warm segment to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
        from real_time_sdr_tpu_torch.models.receiver import Receiver
        from real_time_sdr_tpu_torch.ops.cuda import _build
        from real_time_sdr_tpu_torch.ops.cuda import (KERNELS, fir_bank,
                                                      frontend_fused)
        from real_time_sdr_tpu_torch.ops.cuda.fir_bank import fir_bank_plain
        from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import \
            frontend_plain
        from real_time_sdr_tpu_torch.utils import synth
        from real_time_sdr_tpu_torch.utils.state import map_state
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the root "
             "of a checkout")

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{lib_path.relative_to(_build.CSRC.parent.parent)}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    # -- fixture: one station, 36 blocks, tiled to 32 shifted channels -------
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=dev)
    cfg = rx.cfg
    seg_len = 2 * cfg.block_size_iq * BLOCKS
    iq, truth = synth.station_iq(cfg, BLOCKS * SEGMENTS, ps_name=PS, pi=PI,
                                 pty=PTY)
    pairs = iq.reshape(-1, 2)
    shifts = [0] + [int(s) for s in
                    np.random.default_rng(0).integers(1, len(pairs), CH - 1)]
    tiled = np.stack([np.roll(pairs, -s, axis=0).reshape(-1)
                      for s in shifts])                       # (CH, 36 blk)
    segs = [np.ascontiguousarray(tiled[:, k * seg_len:(k + 1) * seg_len])
            for k in range(SEGMENTS)]
    print(f"fixture: {CH} ch x {BLOCKS} blk x {SEGMENTS} segments, "
          f"{segs[0].nbytes / 1e6:.1f} MB IQ per segment")

    # -- 3. kernels vs plain ------------------------------------------------
    rng = np.random.default_rng(1)
    kernels = []
    fe = rx.frontend
    xx = torch.cat([fe.init_state(CH).iq_tail,
                    torch.from_numpy(segs[0]).to(dev)], dim=-1)
    pi0, pq0 = (torch.from_numpy(rng.uniform(-0.5, 0.5, CH).astype(
        np.float32)).to(dev) for _ in range(2))
    dk, ik, qk = frontend_fused.launch(xx, fe.rf_fir.taps, fe.rf_fir.down,
                                       pi0, pq0)
    dp, ip, qp = frontend_plain(xx, fe.rf_fir, pi0, pq0)
    torch.cuda.synchronize()
    fe_snr = snr_db(dp, dk)
    fe_err = (dk - dp).abs().max().item()
    prev_err = max((ik - ip).abs().max().item(), (qk - qp).abs().max().item())
    fe_ms = device_ms(torch, lambda: frontend_fused.launch(
        xx, fe.rf_fir.taps, fe.rf_fir.down, pi0, pq0))
    fe_plain_ms = device_ms(torch, lambda: frontend_plain(
        xx, fe.rf_fir, pi0, pq0))
    print(f"kernel frontend_fused: ({CH}, {xx.shape[1]}) u8 -> "
          f"{tuple(dk.shape)}: SNR {fe_snr:.1f} dB vs plain, max abs err "
          f"{fe_err:.3g}, prev err {prev_err:.3g}; kernel {fe_ms:.4f} ms, "
          f"plain {fe_plain_ms:.4f} ms")
    if not (fe_snr > 90.0 and prev_err < 1e-4):
        fail(f"frontend kernel disagrees with its plain version "
             f"({fe_snr:.1f} dB, prev err {prev_err:.3g})")
    kernels.append(dict(name=frontend_fused.name, route="cuda",
                        source=frontend_fused.source,
                        replaces=frontend_fused.replaces, max_abs_err=fe_err,
                        ms=fe_ms, plain_ms=fe_plain_ms))

    n_if = cfg.if_block * BLOCKS
    sites = [  # (name, bank, rows, n) at the main path's shapes
        ("if_triple", rx.if_bank, CH, n_if),
        ("stereo_sync", rx.audio.sync.bank, CH, n_if),
        ("audio_rails", rx.audio.resamp_bank, 2 * CH, n_if),
        ("rds_pilot", rx.rds_path.pilot_bank, CH, n_if),
        ("rds_sync", rx.rds_path.sync.bank, CH, n_if),
        ("rds_baseband_247_640", rx.rds_path.baseband_bank, CH * BLOCKS,
         cfg.if_block),
        ("rrc", rx.rds_path.rrc_bank, CH * BLOCKS, cfg.rds_block),
    ]
    bank_err, bank_ms, bank_plain_ms = 0.0, 0.0, 0.0
    for name, bank, rows, n in sites:
        xb = torch.from_numpy(rng.standard_normal(
            (rows, bank.tail_len + n)).astype(np.float32)).to(dev)
        g = bank.geometry
        yk = fir_bank.launch(xb, bank.taps, g)
        yp = fir_bank_plain(xb, bank.w, g)
        torch.cuda.synchronize()
        s = snr_db(yp, yk)
        err = (yk - yp).abs().max().item()
        t_k = device_ms(torch, lambda: fir_bank.launch(xb, bank.taps, g))
        t_p = device_ms(torch, lambda: fir_bank_plain(xb, bank.w, g))
        print(f"kernel fir_bank[{name}]: rows {rows}, n {n}, nf {bank.nf}, "
              f"K {g.num_taps}, {g.up}/{g.down} -> {tuple(yk.shape)}: "
              f"SNR {s:.1f} dB, max abs err {err:.3g}; kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms")
        if not s > 110.0:
            fail(f"fir_bank[{name}] disagrees with its plain version "
                 f"({s:.1f} dB)")
        bank_err = max(bank_err, err)
        bank_ms += t_k
        bank_plain_ms += t_p
    kernels.append(dict(name=fir_bank.name, route="cuda",
                        source=fir_bank.source, replaces=fir_bank.replaces,
                        max_abs_err=bank_err, ms=bank_ms,
                        plain_ms=bank_plain_ms))
    print(f"fir_bank over the {len(sites)} sites of one segment: kernel "
          f"{bank_ms:.4f} ms, plain {bank_plain_ms:.4f} ms")

    # -- 4. main path --------------------------------------------------------
    for k in KERNELS:
        k.launches = 0
    state = rx.init_state(CH)
    outs, states, seg_ms = [], [], []
    for seg in segs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state, out = rx.run_segment(state, torch.from_numpy(seg).to(dev))
        b.record()
        b.synchronize()
        seg_ms.append(a.elapsed_time(b))
        outs.append(out)
        states.append(state)
    launches = {k.name: k.launches for k in KERNELS}
    print(f"main path: {SEGMENTS} chained segments of {CH} ch x {BLOCKS} "
          f"blk, {', '.join(f'{t:.2f}' for t in seg_ms)} ms (H2D included); "
          f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for kd in kernels:
        kd["launches"] = launches[kd["name"]]

    n_audio = cfg.audio_block * BLOCKS
    for out in outs:
        for t, shape in ((out.left, (CH, n_audio)), (out.right, (CH, n_audio)),
                         (out.rds_bits, (CH, BLOCKS, cfg.max_bits)),
                         (out.rds_nbits, (CH, BLOCKS))):
            if tuple(t.shape) != shape:
                fail(f"output shape {tuple(t.shape)} != {shape}")
        if not (torch.isfinite(out.left).all() and
                torch.isfinite(out.right).all()):
            fail("non-finite audio")
    left = torch.cat([o.left for o in outs], -1).cpu().numpy()
    right = torch.cat([o.right for o in outs], -1).cpu().numpy()
    bits = torch.cat([o.rds_bits for o in outs], 1).cpu().numpy()
    nbits = torch.cat([o.rds_nbits for o in outs], 1).cpu().numpy()
    decoded = []
    for c in range(CH):
        fr = RdsFramer()
        for b in range(bits.shape[1]):
            fr.feed(bits[c, b, :nbits[c, b]])
        decoded.append(fr.events)
    ev = decoded[0]
    print(f"channel 0: PS {ev.ps_name!r}, PI {ev.pi and hex(ev.pi)}, PTY "
          f"{ev.pty!r}, groups {ev.groups_decoded}; PS decoded on "
          f"{sum(e.ps_name == PS for e in decoded)}/{CH} channels")
    if ev.ps_name != PS or ev.pi != PI:
        fail("channel 0 did not decode the station's PS/PI")
    fs = float(cfg.audio_fs)
    skip = 3 * cfg.audio_block
    sep_l = (band_power(np, left[0, skip:], fs, 440)
             / band_power(np, right[0, skip:], fs, 440))
    sep_r = (band_power(np, right[0, skip:], fs, 1200)
             / band_power(np, left[0, skip:], fs, 1200))
    print(f"channel 0 stereo separation: 440 Hz L/R {sep_l:.1f}, "
          f"1200 Hz R/L {sep_r:.1f}")
    if not (sep_l > 30 and sep_r > 30):
        fail("left/right do not carry their tones")

    # reference on a small input: the port's own CPU run (plain versions)
    # on channels 0-1. Segment 1 from a cold start: audio (the cold-start
    # RDS carrier sign is set by rounding at ~1e-31 magnitudes, which
    # differential decoding absorbs). Segment 2 from the card's state after
    # segment 1, moved to the CPU: audio and RDS bits.
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cpu")
    _, r1 = ref.run_segment(ref.init_state(2), torch.from_numpy(segs[0][:2]))
    _, r2 = ref.run_segment(map_state(states[0], lambda t: t[:2].cpu()),
                            torch.from_numpy(segs[1][:2]))
    snrs = [snr_db(r.left[c], o.left[c].cpu())
            for r, o in ((r1, outs[0]), (r2, outs[1])) for c in range(2)]
    snrs += [snr_db(r.right[c], o.right[c].cpu())
             for r, o in ((r1, outs[0]), (r2, outs[1])) for c in range(2)]
    same_bits = (torch.equal(r2.rds_bits, outs[1].rds_bits[:2].cpu())
                 and torch.equal(r2.rds_nbits, outs[1].rds_nbits[:2].cpu()))
    print(f"card vs CPU run (ch 0-1, segments 1-2): audio SNR min "
          f"{min(snrs):.1f} dB, segment-2 RDS bits equal: {same_bits}")
    if not (min(snrs) > 60.0 and same_bits):
        fail("the card's main path disagrees with the CPU run")

    # warm timing: the chain continues over the same segments; events
    # split each segment into its H2D copy (pageable host memory) and the
    # receiver's run
    warm_ms, h2d_ms = seg_ms[1:], []
    for k in range(10):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        x = torch.from_numpy(segs[k % SEGMENTS]).to(dev)
        marks[1].record()
        state, _ = rx.run_segment(state, x)
        marks[2].record()
        marks[2].synchronize()
        warm_ms.append(marks[0].elapsed_time(marks[2]))
        h2d_ms.append(marks[0].elapsed_time(marks[1]))
    med = statistics.median(warm_ms)
    radio_s = CH * BLOCKS * cfg.block_size_iq / cfg.rf_fs
    print(f"warm segment: median {med:.3f} ms over {len(warm_ms)} "
          f"(min {min(warm_ms):.3f}, max {max(warm_ms):.3f}), of which H2D "
          f"{statistics.median(h2d_ms):.3f} ms; aggregate "
          f"{radio_s / (med / 1e3):.1f}x real time ({CH} ch x "
          f"{radio_s / CH:.4f} s of radio per segment) on {card}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          "GB")

    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        seg = torch.from_numpy(segs[0]).to(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = rx.run_segment(state, seg)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in avg
                      if e.device_type == DeviceType.CUDA)
        table = avg.table(sort_by="device_time_total", row_limit=40)
        with open(args.profile, "w") as f:
            f.write(f"{card}\n{table}\n")
        run_ms = med - statistics.median(h2d_ms)
        print(f"profile of one warm segment (H2D excluded) -> "
              f"{args.profile}: device busy {busy_us / 1e3:.3f} ms of the "
              f"~{run_ms:.3f} ms run (idle share "
              f"{1 - busy_us / 1e3 / run_ms:.2f})")
        print("\n".join(table.splitlines()[:25]))

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
