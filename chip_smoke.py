#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one card and check them.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
and the CUDA toolkit. It imports no jax. Phases, each of which exits
non-zero on failure:

1. card and versions (``nvidia-smi`` name and power limit, torch, CUDA);
2. build: the kernels compile from ``real_time_sdr_tpu_torch/csrc`` into
   the git-ignored ``real_time_sdr_tpu_torch/_build/`` (one ``nvcc`` per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes, with median device times of both: frontend demod
   > 90 dB and every FIR-bank site > 110 dB (mode 0, 32 channels x 12
   blocks; each site prints the kernel body its geometry takes, tiled at
   up = down = 1 and general otherwise, its useful GFLOP and TFLOP/s);
   the channelizer epilogue byte-equal at the 64-station shape;
   the direct-form decimating FIR > 110 dB at the audio-rail geometry,
   beside the FIR bank at the same geometry;
4. mode-0 path: a synthetic station tiled to 32 channels (distinct time
   shifts) through ``Receiver(0, stereo=True, rds=True, pll_tier=3,
   device="cuda").run_segment`` over three chained 12-block segments; the
   frontend and FIR-bank launch counts must rise, through both FIR-bank
   bodies; channel 0's PS/PI must
   decode and its left/right channels carry their tones; channels 0-1 of
   the first two segments must agree with the port's own CPU run (audio
   > 60 dB, RDS bits equal from a carried state); warm segments are timed
   for the aggregate real-time multiple;
5. wideband paths: 64 stations on the 300 kHz raster in one 19.2 MS/s
   capture (3 real stations, the other slots empty), raw u8 bytes through
   ``ChannelBank.run_wideband_u8`` in 12-block segments, once through the
   two-stage ``Channelizer`` (the epilogue, frontend and FIR-bank kernels
   must launch, the FIR bank's tiled body among them) and once through the
   fused frontend (the FIR bank's tiled body must launch); PS/PI must
   decode on the 3 stations on both paths; the
   two-stage u8 of the first 2 blocks must agree with the CPU run (within
   1 LSB on < 1 % of bytes); warm segments are timed.

Each path's kernel counts are set to 0 just before it and read just after.
The last two lines are the kernels' JSON and the device JSON.
``--profile DIR`` also writes a torch.profiler table of one warm segment
of each path to DIR and prints the segment's FIR-bank device time.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

CH, BLOCKS, SEGMENTS = 32, 12, 3
PS, PI, PTY = "H100 FM ", 0x3A5C, 5
WB_STATIONS, WB_MULT, WB_SLOTS = 64, 8, (3, 32, 62)


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


def decode(RdsFramer, bits, nbits, c):
    fr = RdsFramer()
    for b in range(bits.shape[1]):
        fr.feed(bits[c, b, :nbits[c, b]])
    return fr.events


def profile_segment(torch, card, path, name, run, run_ms):
    """torch.profiler table of one warm segment -> DIR/<name>.txt; prints
    device busy time and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in avg
                  if e.device_type == DeviceType.CUDA)
    fir_us = {body: sum(e.self_device_time_total for e in avg
                        if e.device_type == DeviceType.CUDA
                        and f"fir_bank_{body}" in e.key)
              for body in ("tiled", "general")}
    table = avg.table(sort_by="device_time_total", row_limit=40)
    out = os.path.join(path, f"{name}.txt")
    with open(out, "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"profile of one warm {name} segment -> {out}: device busy "
          f"{busy_us / 1e3:.3f} ms of the ~{run_ms:.3f} ms run (idle share "
          f"{1 - busy_us / 1e3 / run_ms:.2f}); FIR-bank kernels "
          f"{sum(fir_us.values()) / 1e3:.3f} ms (tiled "
          f"{fir_us['tiled'] / 1e3:.3f}, general "
          f"{fir_us['general'] / 1e3:.3f})")
    print("\n".join(table.splitlines()[:22]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler table of one warm segment "
                    "of each path into this directory")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        from real_time_sdr_tpu_torch.models.channelizer import Channelizer
        from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
        from real_time_sdr_tpu_torch.models.receiver import Receiver
        from real_time_sdr_tpu_torch.models.wideband_frontend import (
            FusedWidebandFrontend, make_wideband_frontend, u8_to_rails)
        from real_time_sdr_tpu_torch.ops.cuda import _build
        from real_time_sdr_tpu_torch.ops.cuda import (KERNELS, chan_epilogue,
                                                      fir_bank, fir_decimate,
                                                      frontend_fused)
        from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import \
            chan_epilogue_plain
        from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (
            fir_bank_plain, kernel_body)
        from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import \
            fir_decimate_plain
        from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import \
            frontend_plain
        from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank
        from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
        from real_time_sdr_tpu_torch.utils import synth
        from real_time_sdr_tpu_torch.utils.state import map_state
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the root "
             "of a checkout")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

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
    kernels = {}
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
    kernels[frontend_fused.name] = dict(max_abs_err=fe_err, ms=fe_ms,
                                        plain_ms=fe_plain_ms)
    del xx, dk, dp

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
    bank_err, bank_ms, bank_plain_ms, bank_sites = 0.0, 0.0, 0.0, {}
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
        body = kernel_body(g)
        gflop = 2 * rows * yk.shape[-1] * bank.nf * g.T / 1e9   # useful
        print(f"kernel fir_bank[{name}]: rows {rows}, n {n}, nf {bank.nf}, "
              f"K {g.num_taps}, {g.up}/{g.down} -> {tuple(yk.shape)}: "
              f"SNR {s:.1f} dB, max abs err {err:.3g}; body {body}, "
              f"{gflop:.4f} GFLOP useful; kernel {t_k:.4f} ms "
              f"({gflop / t_k:.2f} TFLOP/s), plain {t_p:.4f} ms "
              f"({gflop / t_p:.2f} TFLOP/s)")
        if not s > 110.0:
            fail(f"fir_bank[{name}] disagrees with its plain version "
                 f"({s:.1f} dB)")
        bank_err = max(bank_err, err)
        bank_ms += t_k
        bank_plain_ms += t_p
        bank_sites[name] = dict(ms=t_k, plain_ms=t_p, body=body)
    kernels[fir_bank.name] = dict(max_abs_err=bank_err, ms=bank_ms,
                                  plain_ms=bank_plain_ms, sites=bank_sites)
    tiled = [v for v in bank_sites.values() if v["body"] == "tiled"]
    print(f"fir_bank over the {len(sites)} sites of one segment: kernel "
          f"{bank_ms:.4f} ms, plain {bank_plain_ms:.4f} ms; the "
          f"{len(tiled)} tiled sites: kernel "
          f"{sum(v['ms'] for v in tiled):.4f} ms, plain "
          f"{sum(v['plain_ms'] for v in tiled):.4f} ms")

    # channelizer epilogue at the 64-station, 12-block, 19.2 MS/s shape:
    # S = 64, R = 16, c = n_out / R frames
    s_ch, r_n = WB_STATIONS, 16
    n_out_wb = BLOCKS * cfg.block_size_iq                 # station rate
    gen = torch.Generator(device=dev).manual_seed(3)
    y = 0.5 * torch.randn((n_out_wb // r_n, r_n * 2 * s_ch), device=dev,
                          generator=gen)
    ang = 7.0 * torch.rand(s_ch, device=dev, generator=gen)
    pc, ps = torch.cos(ang), torch.sin(ang)
    uk = chan_epilogue.launch(y, pc, ps, r_n, s_ch, n_out_wb)
    up = chan_epilogue_plain(y, pc, ps, r_n, s_ch, n_out_wb)
    torch.cuda.synchronize()
    epi_err = (uk.int() - up.int()).abs().max().item()
    epi_ms = device_ms(torch, lambda: chan_epilogue.launch(
        y, pc, ps, r_n, s_ch, n_out_wb))
    epi_plain_ms = device_ms(torch, lambda: chan_epilogue_plain(
        y, pc, ps, r_n, s_ch, n_out_wb))
    moved = y.numel() * 4 + uk.numel()
    print(f"kernel chan_epilogue: y {tuple(y.shape)} f32, R {r_n}, S {s_ch} "
          f"-> {tuple(uk.shape)} u8: byte-equal {torch.equal(uk, up)}, max "
          f"abs err {epi_err} LSB; kernel {epi_ms:.4f} ms "
          f"({moved / epi_ms / 1e9:.2f} TB/s of {moved / 1e6:.1f} MB), "
          f"plain {epi_plain_ms:.4f} ms")
    if not torch.equal(uk, up):
        fail("chan_epilogue kernel is not byte-equal to its plain version")
    kernels[chan_epilogue.name] = dict(max_abs_err=float(epi_err), ms=epi_ms,
                                       plain_ms=epi_plain_ms)
    del y, uk, up

    # direct-form decimating FIR at the audio-rail geometry (64 rails x
    # 12 blocks of IF, K = 101, down = 5), beside the FIR bank there
    h = rx.audio.resamp_bank.taps[0].contiguous()
    k_taps, down = h.shape[0], 5
    xd = torch.randn((2 * CH, k_taps - 1 + n_if), device=dev, generator=gen)
    dk_ = fir_decimate.launch(xd, h, down)
    dp_ = fir_decimate_plain(xd, h, down)
    torch.cuda.synchronize()
    fd_snr = snr_db(dp_, dk_)
    fd_err = (dk_ - dp_).abs().max().item()
    fd_ms = device_ms(torch, lambda: fir_decimate.launch(xd, h, down))
    fd_plain_ms = device_ms(torch, lambda: fir_decimate_plain(xd, h, down))
    dbank = make_bank([PolyFIR(h.double().cpu().numpy(), down=down)]).to(dev)
    fb_ms = device_ms(torch, lambda: fir_bank.launch(xd, dbank.taps,
                                                     dbank.geometry))
    fb_out = fir_bank.launch(xd, dbank.taps, dbank.geometry)[:, 0]
    print(f"kernel fir_decimate: ({2 * CH}, {xd.shape[1]}) K {k_taps} down "
          f"{down} -> {tuple(dk_.shape)}: SNR {fd_snr:.1f} dB vs plain, max "
          f"abs err {fd_err:.3g}; kernel {fd_ms:.4f} ms, plain (conv1d) "
          f"{fd_plain_ms:.4f} ms; fir_bank at the same geometry "
          f"{fb_ms:.4f} ms (max abs diff vs fir_decimate "
          f"{(fb_out - dk_).abs().max().item():.3g})")
    if not fd_snr > 110.0:
        fail(f"fir_decimate disagrees with its plain version "
             f"({fd_snr:.1f} dB)")
    kernels[fir_decimate.name] = dict(max_abs_err=fd_err, ms=fd_ms,
                                      plain_ms=fd_plain_ms)
    del xd, dk_, dp_

    launches = {k.name: 0 for k in KERNELS}
    by_path, bodies_by_path = {}, {}

    def reset_counts():
        for k in KERNELS:
            k.launches = 0
        fir_bank.body_launches = dict.fromkeys(fir_bank.body_launches, 0)

    def count_path(path, needed, bodies):
        got = {k.name: k.launches for k in KERNELS}
        by_path[path] = got
        bodies_by_path[path] = dict(fir_bank.body_launches)
        for name, n in got.items():
            launches[name] += n
        print(f"{path} launches {got}, fir_bank bodies "
              f"{bodies_by_path[path]}")
        for name in needed:
            if got[name] <= 0:
                fail(f"kernel {name} was not launched on the {path} path")
        for body in bodies:
            if bodies_by_path[path][body] <= 0:
                fail(f"fir_bank's {body} body was not launched on the "
                     f"{path} path")

    # -- 4. mode-0 path -------------------------------------------------------
    reset_counts()
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
    count_path("mode0", (frontend_fused.name, fir_bank.name),
               ("tiled", "general"))
    print(f"mode-0 path: {SEGMENTS} chained segments of {CH} ch x {BLOCKS} "
          f"blk, {', '.join(f'{t:.2f}' for t in seg_ms)} ms (H2D included)")

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
    decoded = [decode(RdsFramer, bits, nbits, c) for c in range(CH)]
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
        fail("the card's mode-0 path disagrees with the CPU run")

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
    radio_s = BLOCKS * cfg.block_size_iq / cfg.rf_fs
    print(f"mode-0 warm segment: median {med:.3f} ms over {len(warm_ms)} "
          f"(min {min(warm_ms):.3f}, max {max(warm_ms):.3f}), of which H2D "
          f"{statistics.median(h2d_ms):.3f} ms; aggregate "
          f"{CH * radio_s / (med / 1e3):.1f}x real time ({CH} ch x "
          f"{radio_s:.4f} s of radio per segment) on {card}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB on {card}")
    if args.profile:
        seg = torch.from_numpy(segs[0]).to(dev)
        profile_segment(torch, card, args.profile, "mode0",
                        lambda: rx.run_segment(state, seg),
                        med - statistics.median(h2d_ms))
    del outs, states, state, segs, tiled

    # -- 5. wideband paths ----------------------------------------------------
    wide_fs = WB_MULT * cfg.rf_fs
    offs = [int((k - (WB_STATIONS - 1) / 2) * 300_000)
            for k in range(WB_STATIONS)]
    stations = [dict(offset_hz=offs[k], ps_name=f"WB64-{k:03d}"[:8],
                     pi=0x1000 + k, pty=4, tone_left=400.0 + 200 * j,
                     tone_right=1500.0) for j, k in enumerate(WB_SLOTS)]
    t0 = time.perf_counter()
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, stations,
                                  BLOCKS * SEGMENTS)
    x = np.empty(2 * len(iw), np.float32)
    x[0::2], x[1::2] = iw, qw
    raw = np.clip(np.round(128.0 + 127.0 * x), 0, 255).astype(np.uint8)
    del iw, qw, x
    wseg = 2 * BLOCKS * cfg.block_size_iq * WB_MULT      # bytes per segment
    wsegs = [raw[k * wseg:(k + 1) * wseg] for k in range(SEGMENTS)]
    print(f"wideband fixture: {WB_STATIONS} stations on the 300 kHz raster "
          f"in {wide_fs / 1e6:g} MS/s, real stations at slots "
          f"{list(WB_SLOTS)}, {SEGMENTS} segments of {BLOCKS} blk = "
          f"{wseg / 1e6:.1f} MB u8 each (synthesized in "
          f"{time.perf_counter() - t0:.1f} s)")
    wbank = ChannelBank(rx, WB_STATIONS)
    radio_s = BLOCKS * cfg.block_size_iq / cfg.rf_fs

    def run_wideband(path, fe, needed):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        bs, fs_ = wbank.init_state(), fe.init_state()
        bits, nbits, seg_t = [], [], []
        for seg in wsegs:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            bs, out, fs_ = wbank.run_wideband_u8(
                bs, fe, torch.from_numpy(seg).to(dev), fs_)
            b.record()
            b.synchronize()
            seg_t.append(a.elapsed_time(b))
            if not torch.isfinite(out.left).all():
                fail(f"{path}: non-finite audio")
            bits.append(out.rds_bits)
            nbits.append(out.rds_nbits)
        count_path(path, needed, ("tiled",))
        bits = torch.cat(bits, 1).cpu().numpy()
        nbits = torch.cat(nbits, 1).cpu().numpy()
        for st in stations:
            k = offs.index(st["offset_hz"])
            ev = decode(RdsFramer, bits, nbits, k)
            print(f"{path} station {k} @ {st['offset_hz'] / 1e6:+.2f} MHz: "
                  f"PS {ev.ps_name!r}, PI {ev.pi and hex(ev.pi)}, groups "
                  f"{ev.groups_decoded}")
            if ev.ps_name != st["ps_name"] or ev.pi != st["pi"]:
                fail(f"{path}: station {k} did not decode its PS/PI")
        warm, h2d = seg_t[1:], []
        for k in range(8):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            seg = torch.from_numpy(wsegs[k % SEGMENTS]).to(dev)
            marks[1].record()
            bs, _, fs_ = wbank.run_wideband_u8(bs, fe, seg, fs_)
            marks[2].record()
            marks[2].synchronize()
            warm.append(marks[0].elapsed_time(marks[2]))
            h2d.append(marks[0].elapsed_time(marks[1]))
        med = statistics.median(warm)
        rt = radio_s / (med / 1e3)
        print(f"{path} wideband segment ({WB_STATIONS} st x {BLOCKS} blk, "
              f"H2D of {wseg / 1e6:.1f} MB included): first "
              f"{seg_t[0]:.2f} ms; warm median {med:.3f} ms over "
              f"{len(warm)} (min {min(warm):.3f}, max {max(warm):.3f}), of "
              f"which H2D {statistics.median(h2d):.3f} ms; "
              f"{rt:.2f}x real time on the {wide_fs / 1e6:g} MS/s input, "
              f"{WB_STATIONS * cfg.rf_fs * rt / 1e6:.1f} MS/s of station IQ "
              f"decoded; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on {card}")
        if args.profile:
            seg = torch.from_numpy(wsegs[0]).to(dev)
            profile_segment(torch, card, args.profile, path,
                            lambda: wbank.run_wideband_u8(bs, fe, seg, fs_),
                            med - statistics.median(h2d))

    ch = Channelizer(cfg, wide_fs, offs).to(dev)
    if not (ch.fold_static and ch.fold_R == 16 and ch.fold_J == 323):
        fail(f"unexpected channelizer geometry (static {ch.fold_static}, "
             f"R {ch.fold_R}, J {ch.fold_J})")
    run_wideband("two_stage", ch,
                 (chan_epilogue.name, frontend_fused.name, fir_bank.name))
    # card against the port's own CPU run on the first 2 blocks
    first = torch.from_numpy(raw[:2 * 2 * cfg.block_size_iq * WB_MULT])
    u8_card, _ = ch.call_u8(*u8_to_rails(first.to(dev)), ch.init_state())
    ch_cpu = Channelizer(cfg, wide_fs, offs)
    u8_cpu, _ = ch_cpu.call_u8(*u8_to_rails(first), ch_cpu.init_state())
    diff = (u8_card.cpu().int() - u8_cpu.int()).abs()
    frac = (diff != 0).float().mean().item()
    print(f"two_stage u8 card vs CPU run (2 blocks, {tuple(u8_cpu.shape)}): "
          f"max diff {diff.max().item()} LSB on {frac:.2e} of bytes")
    if not (diff.max().item() <= 1 and frac < 0.01):
        fail("the card's channelizer disagrees with the CPU run")
    del ch, ch_cpu, u8_card, u8_cpu, diff

    wf = make_wideband_frontend(cfg, wide_fs, offs).to(dev)
    if not isinstance(wf, FusedWidebandFrontend):
        fail("make_wideband_frontend did not pick the fused frontend")
    print(f"fused frontend: lo {wf.lo}, R {wf.r_n}, J {wf.j_w}, weights "
          f"{tuple(wf.w.shape)}")
    run_wideband("fused", wf, (fir_bank.name,))

    if "jax" in sys.modules:
        fail("jax was imported")
    kernels[fir_bank.name]["body_launches_by_path"] = bodies_by_path
    rows = []
    for k in KERNELS:
        rows.append(dict(name=k.name, route="cuda", source=k.source,
                         replaces=k.replaces, launches=launches[k.name],
                         launches_by_path={p: v[k.name]
                                           for p, v in by_path.items()},
                         **kernels[k.name]))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
