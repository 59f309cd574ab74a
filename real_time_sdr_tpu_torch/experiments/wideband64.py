"""64+ FM stations channelized and decoded from ONE wideband capture.

    python -m real_time_sdr_tpu_torch.experiments.wideband64 [--stations 64]
        [--seg N] [--reps N] [--path {auto,fused,u8}] [--wide-mult M]
        [--wb-fir {f32,bf16,bf16x2}] [--decode-check] [--cpu]

Port of ``experiments/wideband64.py``, the wideband scale ladder. One
capture carries ``--stations`` stations on a 300 kHz raster centred on DC
(``ladder_geometry``): 64 stations from 19.2 MS/s (8x the mode-0 station
rate), and beyond 64 the capture widens to the smallest even multiple that
holds the raster (128 stations from 38.4 MS/s, 256 from 76.8) while the
combined filter's taps grow with the decimation (``taps_factor`` 2, 4, 8).
Seeded f32 noise rails, already on the card, go through
``ChannelBank.run_wideband_jit`` (the frontend, then every station's
stereo + RDS decode at tier 3, one captured CUDA graph per segment shape)
segment after segment, the states carried. Prints ms per block, the
wideband rate and real-time multiple on the capture, the station IQ the
capture carries, K_eq, the weights' build, the first call (graph capture
included) and the peak memory.

``--path``: ``fused`` (``FusedWidebandFrontend``: one fold product per
segment straight to each station's FM demod), ``u8`` (the two-stage
``Channelizer`` to uint8 station streams, at most 64 stations) or ``auto``
(``make_wideband_frontend``, which takes the fused frontend on a raster;
above 64 stations the fused one always). ``--wb-fir`` is the frontend's
``compute_dtype``, as the CLI's flag of that name. ``--decode-check``
also synthesizes three real stations into the scene (slots min(3, n-1),
n//2 and max(n-2, 0)) and decodes 26 blocks of it: each PS ``WB64-kkk``
and PI 0x1000 + k exact.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.experiments import (add_cpu_flag, check,
                                                 device_name,
                                                 ladder_geometry,
                                                 peak_memory_gb, pick_device,
                                                 reset_peak_memory, timed)
from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.rds_framing import RdsFramer
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import (
    WB_DTYPES, FusedWidebandFrontend, make_wideband_frontend)
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils import synth

PATHS = ("auto", "fused", "u8")
U8_MAX_STATIONS = 64      # the two-stage path's rung; the ladder above is
#                           the fused frontend's
DECODE_BLOCKS = 26


class Rung(NamedTuple):
    """One rung of the ladder, built: the receiver, its frontend and its
    bank on one device, and the grid."""
    rx: Receiver
    fe: FusedWidebandFrontend | Channelizer
    bank: ChannelBank
    offsets: list[int]
    wide_fs: int
    taps_factor: int
    seg: int              # blocks per segment
    build_s: float        # the frontend's build: host weights + upload

    @property
    def fused(self) -> bool:
        return isinstance(self.fe, FusedWidebandFrontend)

    @property
    def block_pairs(self) -> int:
        """Wideband I/Q samples per mode-0 block."""
        return self.rx.cfg.block_size_iq * self.fe.decim


def build(stations: int = 64, path: str = "auto",
          wide_mult: int | None = None, wb_fir: str = "f32",
          seg: int | None = None, device=None) -> Rung:
    """The receiver (mode 0, stereo + RDS, tier 3), the rung's frontend
    and a ``stations``-channel bank on ``device`` (the card unless the
    caller names another). ``seg`` None: 8 blocks fused, 24 two-stage (the
    JAX script's defaults). Raises ``ValueError`` for the two-stage path
    above 64 stations and for a precision the frontend lacks."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if wb_fir not in WB_DTYPES:
        raise ValueError(f"wb_fir must be one of {WB_DTYPES}, got "
                         f"{wb_fir!r}")
    if path == "u8" and stations > U8_MAX_STATIONS:
        raise ValueError(f"the two-stage (u8) path runs at most "
                         f"{U8_MAX_STATIONS} stations; above, use the fused "
                         "frontend")
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device=device)
    cfg = rx.cfg
    offs, wide_fs, tf = ladder_geometry(stations, wide_mult, cfg.rf_fs)
    t0 = time.perf_counter()
    if path == "fused" or (path == "auto" and stations > U8_MAX_STATIONS):
        fe = FusedWidebandFrontend(cfg, wide_fs, offs, taps_factor=tf,
                                   compute_dtype=wb_fir, device=rx.device)
    elif path == "u8":
        fe = Channelizer(cfg, wide_fs, offs, taps_factor=tf,
                         compute_dtype=wb_fir, device=rx.device)
        check(bool(fe.tone_period), "expected the periodic-exact tone mode "
              "of the two-stage channelizer on the raster")
    else:
        fe = make_wideband_frontend(cfg, wide_fs, offs, taps_factor=tf,
                                    compute_dtype=wb_fir, device=rx.device)
    if rx.device.type == "cuda":
        torch.cuda.synchronize(rx.device)
    build_s = time.perf_counter() - t0
    fused = isinstance(fe, FusedWidebandFrontend)
    seg = seg if seg is not None else (8 if fused else 24)
    if seg < 1:
        raise ValueError(f"seg must be >= 1, got {seg}")
    return Rung(rx, fe, ChannelBank(rx, stations), offs, wide_fs, tf, seg,
                build_s)


def describe(rung: Rung) -> str:
    fe = rung.fe
    if rung.fused:
        return (f"fused one-matmul demod (lo={fe.lo}, R={fe.r_n}, "
                f"{fe.compute_dtype}, K_eq {fe.k_eq})")
    return (f"two-stage uint8 (tone lcm {fe.tone_period}, "
            f"{fe.compute_dtype})")


def noise_rails(rung: Rung) -> tuple[torch.Tensor, torch.Tensor]:
    """One segment of seeded f32 noise rails (0.1 rms) on the rung's
    device: the JAX script's input."""
    n = rung.seg * rung.block_pairs
    rng = np.random.default_rng(0)
    iw = rng.standard_normal((n,)).astype(np.float32) * 0.1
    qw = rng.standard_normal((n,)).astype(np.float32) * 0.1
    dev = rung.rx.device
    return torch.from_numpy(iw).to(dev), torch.from_numpy(qw).to(dev)


def measure(rung: Rung, reps: int | None = None, rails=None) -> dict:
    """The first call (graph capture included) and ``reps`` warm calls of
    ``run_wideband_jit`` on one segment of rails (``noise_rails`` when
    None), states carried from call to call. ``reps`` None: max(8,
    512 // seg), the JAX script's default."""
    reps = reps if reps is not None else max(8, 512 // rung.seg)
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    cfg, dev, n_st = rung.rx.cfg, rung.rx.device, len(rung.offsets)
    iw, qw = noise_rails(rung) if rails is None else rails
    state = [rung.bank.init_state(), rung.fe.init_state()]

    def step():
        bs, _, fs = rung.bank.run_wideband_jit(state[0], rung.fe, iw, qw,
                                               state[1])
        state[:] = [bs, fs]

    reset_peak_memory(dev)
    first_s = timed(step, dev)
    per_block = timed(step, dev, reps) / rung.seg
    wb_msps = rung.block_pairs / per_block / 1e6
    return dict(stations=n_st, frontend="fused" if rung.fused else "u8",
                compute_dtype=rung.fe.compute_dtype, wide_fs=rung.wide_fs,
                mult=rung.wide_fs // cfg.rf_fs, taps_factor=rung.taps_factor,
                k_eq=rung.fe.k_eq if rung.fused else None, seg=rung.seg,
                reps=reps, build_s=rung.build_s, first_s=first_s,
                ms_per_block=per_block * 1e3, wideband_msps=wb_msps,
                x_realtime=wb_msps / (rung.wide_fs / 1e6),
                station_msps=n_st * cfg.rf_fs / 1e6,
                peak_gb=peak_memory_gb(dev), device=device_name(dev))


def decode_picks(n_stations: int) -> list[int]:
    """The decode check's three slots (fewer on a grid of 1-2)."""
    return sorted({min(3, n_stations - 1), n_stations // 2,
                   max(n_stations - 2, 0)})


def expected_ps(k: int) -> str:
    return f"WB64-{k:03d}"[:8]


def scene_rails_for(n_stations: int, wide_mult: int | None = None,
                    n_blocks: int = DECODE_BLOCKS) -> tuple[np.ndarray,
                                                            np.ndarray]:
    """The decode check's capture on the ladder's grid for ``n_stations``
    (host float32 rails): the picked slots carry real stations (PS
    ``WB64-kkk``, PI 0x1000 + k, PTY 4), synthesized on the host
    (``utils.synth.wideband_iq``); the other slots are empty. A function
    of its arguments only, so that it can run in a worker process while
    the card is busy."""
    cfg = mode_config(0)
    offs, wide_fs, _ = ladder_geometry(n_stations, wide_mult, cfg.rf_fs)
    scene = [dict(offset_hz=offs[k], ps_name=expected_ps(k), pi=0x1000 + k,
                  pty=4) for k in decode_picks(n_stations)]
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, n_blocks)
    return iw, qw


def scene_rails(rung: Rung,
                n_blocks: int = DECODE_BLOCKS) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """``scene_rails_for`` the rung's grid."""
    return scene_rails_for(len(rung.offsets),
                           rung.wide_fs // rung.rx.cfg.rf_fs, n_blocks)


def decode_check(rung: Rung, rails=None) -> list[dict]:
    """Decode ``rails`` (``scene_rails`` when None) segment by segment
    through ``run_wideband_jit`` (a short last segment is a shape of its
    own) and frame each picked station's RDS bits on the host. Returns
    one dict per picked station (slot, offset_hz, ps, pi, groups); raises
    ``GateError`` unless each PS and PI is as sent."""
    iw, qw = scene_rails(rung) if rails is None else rails
    dev, picks = rung.rx.device, decode_picks(len(rung.offsets))
    n_blocks = iw.shape[0] // rung.block_pairs
    i_wide = torch.from_numpy(np.ascontiguousarray(iw)).to(dev)
    q_wide = torch.from_numpy(np.ascontiguousarray(qw)).to(dev)
    rows = torch.tensor(picks, device=dev)
    bs, fs = rung.bank.init_state(), rung.fe.init_state()
    framers = {k: RdsFramer() for k in picks}
    for s0 in range(0, n_blocks, rung.seg):
        blks = min(rung.seg, n_blocks - s0)
        sl = slice(s0 * rung.block_pairs, (s0 + blks) * rung.block_pairs)
        bs, out, fs = rung.bank.run_wideband_jit(bs, rung.fe, i_wide[sl],
                                                 q_wide[sl], fs)
        nbits = out.rds_nbits.index_select(0, rows).cpu().numpy()
        bits = out.rds_bits.index_select(0, rows).cpu().numpy()
        for j, k in enumerate(picks):
            for bi in range(nbits.shape[1]):
                if nbits[j, bi] > 0:
                    framers[k].feed(bits[j, bi][:nbits[j, bi]])
    res = [dict(slot=k, offset_hz=rung.offsets[k],
                ps=framers[k].events.ps_name, pi=framers[k].events.pi,
                groups=framers[k].events.groups_decoded) for k in picks]
    bad = [r for r in res
           if r["ps"] != expected_ps(r["slot"]) or r["pi"] != 0x1000
           + r["slot"]]
    check(not bad, f"decode check: {len(res) - len(bad)}/{len(res)} "
          f"stations decoded their PS and PI; wrong: "
          f"{[(r['slot'], r['ps'], r['pi']) for r in bad]}")
    return res


def run(stations: int = 64, seg: int | None = None, reps: int | None = None,
        path: str = "auto", wide_mult: int | None = None,
        decode: bool = False, wb_fir: str = "f32", device=None,
        rails=None) -> dict:
    """Build the rung, measure it (``measure``) and with ``decode`` run
    the decode check on ``rails`` (``scene_rails`` when None). Returns
    ``measure``'s dict with ``frontend_line`` and ``decode`` (the check's
    list, or None)."""
    return report(build(stations, path, wide_mult, wb_fir, seg, device),
                  reps, decode, rails)


def report(rung: Rung, reps: int | None = None, decode: bool = False,
           rails=None) -> dict:
    """``run``'s result for a rung already built."""
    res = measure(rung, reps)
    res["frontend_line"] = describe(rung)
    res["decode"] = decode_check(rung, rails) if decode else None
    return res


def lines(res: dict) -> list[str]:
    """The script's lines for ``run``'s result."""
    peak = ("not measured (CPU)" if res["peak_gb"] is None
            else f"{res['peak_gb']:.2f} GB")
    out = [f"# frontend: {res['frontend_line']}",
           f"# weights built in {res['build_s']:.2f} s (host float64 "
           "columns, then the upload)",
           f"# first call (graph capture included): {res['first_s']:.2f} s",
           f"# {res['stations']} stations from one "
           f"{res['wide_fs'] / 1e6:g} MS/s capture ({res['seg']}-block "
           f"segments, {res['reps']} reps): {res['ms_per_block']:.3f} "
           f"ms/block, {res['wideband_msps']:.0f} MS/s wideband = "
           f"{res['x_realtime']:.2f}x realtime ({res['station_msps']:g} "
           f"MS/s of station IQ decoded); peak memory {peak}; on "
           f"{res['device']}"]
    for r in res["decode"] or ():
        out.append(f"# station {r['slot']} @ {r['offset_hz'] / 1e6:+.1f} "
                   f"MHz: PS={r['ps']!r} PI={r['pi']:#06x} "
                   f"groups={r['groups']}")
    if res["decode"]:
        out.append(f"# decode check OK ({len(res['decode'])}/"
                   f"{len(res['decode'])} stations)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_sdr_tpu_torch.experiments.wideband64",
        description=__doc__.split("\n")[0])
    ap.add_argument("--stations", type=int, default=64)
    ap.add_argument("--seg", type=int, default=None,
                    help="blocks per call (default: 8 for the fused "
                    "frontend, 24 for the two-stage u8 path)")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed calls (default: max(8, 512 // seg))")
    ap.add_argument("--path", choices=PATHS, default="auto",
                    help="wideband frontend: fused one-matmul demod, the "
                    "two-stage uint8 Channelizer (<= 64 stations), or auto "
                    "(make_wideband_frontend; fused above 64 stations)")
    ap.add_argument("--wide-mult", type=int, default=None,
                    help="capture rate as a multiple of the station rate "
                    "(default: the smallest even multiple >= 8 fitting the "
                    "300 kHz raster span)")
    ap.add_argument("--wb-fir", choices=WB_DTYPES, default="f32",
                    help="precision of the frontend's fold product (the "
                    "two-stage frontend takes f32 or bf16)")
    ap.add_argument("--decode-check", action="store_true",
                    help="also synthesize 3 real stations in the scene and "
                    "check their PS and PI (host-side synthesis: slow)")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    device = pick_device(args.cpu)
    if device is None:
        return 2
    try:
        rung = build(args.stations, args.path, args.wide_mult, args.wb_fir,
                     args.seg, device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print("\n".join(lines(report(rung, args.reps, args.decode_check))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
