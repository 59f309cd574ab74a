"""Recorded outputs of the FIR bank's general body, and a timing pass.

The general body of ``csrc/fir_bank.cu`` sums each output as one ``fmaf``
chain with m ascending, so any form of it that keeps that order gives the
same bits. This module fixes seeded cases at which to check that:

- every site of the serving path that takes the general body, at its
  path's shape (the RDS baseband banks of modes 0-3 over 32 channels x 12
  blocks, the audio resamplers of modes 2-3 over 64 rails, the
  alternative decode's two rows, the wideband path's 768 rows, one CLI
  row, a time-sharded step's 32 rows) and the mode-0 geometry at 2 and 64
  rows;
- the random geometries of the FIR property test (``SWEEP_SEEDS``, the
  generator copied from ``tests/test_fir_property.py``) at 1, 2 and 33
  rows, nf 1-4, with row starts shifted off 16-byte boundaries.

``case_inputs`` makes a case's bank and tail-prefixed rows from numpy
seeds; ``digest`` is the SHA-256 of the output's float32 bytes.
``fir_bank_digests.json`` beside this module holds the digests that the
first form of the general body (one output a thread) gave on an
NVIDIA H100 80GB HBM3, with its device times. On a card:

    python -m real_time_sdr_tpu_torch.utils.fir_digest [--json FILE]

digests and times every case (median of 10 launches behind a sleeping
kernel), compares each digest with the recorded one where there is one,
and prints one line a case; ``--json`` also writes them. It exits 1 when
a digest differs. ``--tiles`` also runs each case on every tile of the
general body that can take it (``tile_plans``: the lines tile, the
direct tile with its taps staged and through L1), digest and time, the
evidence behind ``general_plan``'s choice.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import math
import statistics
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

__all__ = ["SITE_CASES", "SWEEP_SEEDS", "SWEEP_ROWS", "RECORDED_PATH",
           "random_geometry", "cases", "case_inputs", "digest", "recorded",
           "run_cases", "tile_plans", "launch_plan"]

RECORDED_PATH = Path(__file__).with_name("fir_bank_digests.json")

# (name, source, rows, blocks of the source's block length); source is
# (mode, bank attribute path) or "alt" (AltRdsReceiver(0).bb_bank, whose
# rows are the 32-block +200 ppm station's mixed (re, im) pair)
SITE_CASES = [
    ("mode0_rds_247_640_r384", (0, "rds_path.baseband_bank"), 384, 1),
    ("mode1_rds_247_960_r384", (1, "rds_path.baseband_bank"), 384, 1),
    ("mode2_rds_19_96_r384", (2, "rds_path.baseband_bank"), 384, 1),
    ("mode2_audio_147_800_r64", (2, "audio.resamp_bank"), 64, 12),
    ("mode3_rds_95_768_r384", (3, "rds_path.baseband_bank"), 384, 1),
    ("mode3_audio_147_1280_r64", (3, "audio.resamp_bank"), 64, 12),
    ("alt_19_240_r2", "alt", 2, 32),
    ("wideband_247_640_r768", (0, "rds_path.baseband_bank"), 768, 1),
    ("cli_247_640_r1", (0, "rds_path.baseband_bank"), 1, 1),
    ("time_sharded_247_640_r32", (0, "rds_path.baseband_bank"), 32, 1),
    ("mode0_rds_247_640_r2", (0, "rds_path.baseband_bank"), 2, 1),
    ("mode0_rds_247_640_r64", (0, "rds_path.baseband_bank"), 64, 1),
]
SWEEP_SEEDS = range(12)
SWEEP_ROWS = (1, 2, 33)


def random_geometry(rng) -> tuple[int, int, int, int]:
    """(up, down, taps, n): ``_random_geometry`` of
    tests/test_fir_property.py, draw for draw."""
    up = int(rng.choice([1, 1, 1, 2, 3, 5, 7, 16, 49, 147, 247]))
    down = int(rng.choice([1, 2, 3, 5, 8, 9, 10, 13, 64, 640, 800, 1280]))
    taps = int(rng.choice([7, 31, 101, 151])) * (up if up > 1 else 1)
    n = int(rng.integers(4, 40)) * down * max(1, 128 // max(up, 1))
    return up, down, taps, n


def _sweep_geometry(seed: int):
    return random_geometry(np.random.default_rng(1000 + seed))


def cases() -> list[dict]:
    """Every case: the path sites, then each sweep geometry that takes
    the general body (up != 1 or down != 1) at ``SWEEP_ROWS``."""
    out = [dict(name=name, source=src, rows=rows, blocks=blocks, nf=1,
                shift=0) for name, src, rows, blocks in SITE_CASES]
    for seed in SWEEP_SEEDS:
        up, down, k_taps, n = _sweep_geometry(seed)
        if up == 1 and down == 1:
            continue
        for rows in SWEEP_ROWS:
            nf = 1 + (seed + rows) % 4
            out.append(dict(
                name=f"sweep{seed}_{up}_{down}_k{k_taps}_r{rows}_nf{nf}",
                source=("sweep", seed), rows=rows, n=n, nf=nf,
                shift=(seed + rows) % 4))
    return out


@functools.cache
def _receiver(mode: int, device: str):
    from real_time_sdr_tpu_torch.models.receiver import Receiver
    return Receiver(mode, stereo=True, rds=True, pll_tier=3, device=device)


@functools.cache
def _alt(device: str):
    from real_time_sdr_tpu_torch.models.rds_alt import AltRdsReceiver
    return AltRdsReceiver(0, device=device)


def case_inputs(case: dict, device) -> tuple:
    """(bank, xx, n): the case's ``FIRBank`` on ``device`` and its
    (rows, tail + n) float32 rows, seeded standard normals; a sweep case's
    rows start ``shift`` floats past the storage's start."""
    from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank
    dev = str(torch.device(device))
    src = case["source"]
    if src == "alt":
        alt = _alt(dev)
        bank, n = alt.bb_bank, alt.cfg.if_block * case["blocks"]
    elif src[0] == "sweep":
        up, down, k_taps, n = _sweep_geometry(src[1])
        rng = np.random.default_rng(7 * src[1] + case["nf"])
        bank = make_bank([PolyFIR(rng.standard_normal(k_taps)
                                  / np.sqrt(k_taps), up=up, down=down)
                          for _ in range(case["nf"])]).to(dev)
    else:
        rx = _receiver(src[0], dev)
        bank = rx
        for part in src[1].split("."):
            bank = getattr(bank, part)
        n = rx.cfg.if_block * case["blocks"]
    rows, length = case["rows"], bank.tail_len + n
    rng = np.random.default_rng(zlib.crc32(case["name"].encode()))
    store = torch.from_numpy(rng.standard_normal(
        rows * length + case["shift"]).astype(np.float32)).to(dev)
    return bank, store[case["shift"]:].view(rows, length), n


def digest(y: torch.Tensor) -> str:
    """SHA-256 of a float32 tensor's bytes in row-major order."""
    return hashlib.sha256(
        y.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def recorded() -> dict:
    """The recorded cases (name -> dict with ``digest`` and ``ms``), or {}
    where the file is missing."""
    if not RECORDED_PATH.exists():
        return {}
    return json.loads(RECORDED_PATH.read_text())["cases"]


def _device_ms(fn, reps: int = 10) -> float:
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


def tile_plans(geom, rows: int, n_out: int, nf: int) -> dict:
    """Every tile of the general body that can take the shape: name ->
    plan (``lines`` where one fits; ``direct_staged``, the direct tile
    with its taps in shared memory, where they fit; ``direct_l1``, its
    taps through L1)."""
    from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (DirectPlan,
                                                           blocks_per_sm,
                                                           direct_plan,
                                                           lines_plan)
    out = {}
    lp = lines_plan(geom, rows, n_out, nf)
    if lp is not None:
        out["lines"] = lp
    dp = direct_plan(geom, rows, n_out, nf)
    if not dp.staged:       # staged all the same, where it fits
        period = geom.up // math.gcd(geom.up, geom.down)
        trows, ts = min(period, dp.bo), geom.T + (4 - geom.T) % 8
        smem = 4 * (dp.ws + nf * trows * ts)
        if blocks_per_sm(smem) >= 1:
            out["direct_staged"] = DirectPlan(dp.bo, trows, ts, dp.ws, True,
                                              dp.grid, smem)
    else:
        out["direct_staged"] = dp
        dp = dataclasses.replace(dp, staged=False, rows=0, ts=0,
                                 smem=4 * dp.ws)
    out["direct_l1"] = dp
    return out


def launch_plan(xx: torch.Tensor, ptaps: torch.Tensor, geom,
                plan) -> torch.Tensor:
    """One launch of the general body on ``plan`` (any tile), past the
    wrapper: no launch counted."""
    import ctypes
    from real_time_sdr_tpu_torch.ops.cuda._build import (check, library,
                                                         stream_ptr)
    rows, length = xx.shape
    nf = ptaps.shape[0]
    n_out = geom.n_out(length - (geom.T - 1))
    y = torch.empty((rows, nf, n_out), dtype=torch.float32,
                    device=xx.device)
    ints = (ctypes.c_int * 8)(*plan.as_ints())
    check(library().sdr_fir_bank(
        xx.data_ptr(), ptaps.data_ptr(), y.data_ptr(), rows, length, nf,
        geom.num_taps, geom.up, geom.down, geom.T, n_out, ints,
        stream_ptr(xx.device)), "sdr_fir_bank")
    return y


def _snr_db(ref, y) -> float:
    ref = ref.double()
    err = (y.double() - ref).pow(2).sum().item()
    return 10.0 * math.log10(ref.pow(2).sum().item() / max(err, 1e-300))


def run_cases(device="cuda", plain: bool = True, select=None,
              out=sys.stdout, tiles: bool = False) -> dict:
    """Digest, check against the plain version and time every case (or
    those whose name ``select`` accepts) on the card: name -> dict of
    digest, equal (to the recorded digest, None where none is recorded),
    snr_db, max_abs_err, ms, plain_ms, bound_ms, bound_by, gflop, rows,
    n, nf, up, down, K, body, form and plan (the general body's tile and
    its plan, as a dict); with ``tiles`` also tiles: name -> dict of ms
    and equal, one entry a ``tile_plans`` tile."""
    from real_time_sdr_tpu_torch.ops.cuda import fir_bank
    from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (fir_bank_plain,
                                                           general_plan,
                                                           kernel_body)
    from real_time_sdr_tpu_torch.utils.logging import (launch_cost,
                                                       roofline_ms)
    rec = recorded()
    res = {}
    for case in cases():
        if select is not None and not select(case["name"]):
            continue
        bank, xx, n = case_inputs(case, device)
        g, taps = bank.geometry, bank.ptaps
        y = fir_bank.launch(xx, taps, g)
        yp = fir_bank_plain(xx, bank.w, g)
        torch.cuda.synchronize()
        d = digest(y)
        want = rec.get(case["name"], {}).get("digest")
        nbytes, flops = launch_cost(bank.cost(n), case["rows"])
        b_ms, b_by = roofline_ms(nbytes, flops)
        gp = (general_plan(g, case["rows"], y.shape[-1], bank.nf)
              if kernel_body(g) == "general" else None)
        plan = dataclasses.asdict(gp) if gp else None
        r = dict(digest=d, equal=None if want is None else d == want,
                 snr_db=_snr_db(yp, y),
                 max_abs_err=(y - yp).abs().max().item(),
                 rows=case["rows"], n=n, plan=plan,
                 nf=bank.nf, up=g.up, down=g.down, K=g.num_taps,
                 body=kernel_body(g), form=gp.form if gp else None,
                 shift=case["shift"],
                 ms=_device_ms(lambda: fir_bank.launch(xx, taps, g)),
                 plain_ms=(_device_ms(lambda: fir_bank_plain(xx, bank.w, g))
                           if plain else None),
                 bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9)
        if tiles and gp is not None:
            r["tiles"] = {}
            for name, pl in tile_plans(g, case["rows"], y.shape[-1],
                                       bank.nf).items():
                yt = launch_plan(xx, taps, g, pl)
                r["tiles"][name] = dict(
                    equal=None if want is None else digest(yt) == want,
                    ms=_device_ms(lambda pl=pl: launch_plan(xx, taps, g,
                                                            pl)))
        res[case["name"]] = r
        print(f"fir_bank general [{case['name']}]: {case['rows']} x "
              f"{xx.shape[1]} -> {tuple(y.shape)}, {g.up}/{g.down} K "
              f"{g.num_taps}: body {r['body']} ({r['form']} tile), kernel "
              f"{r['ms']:.4f} ms ({r['gflop'] / r['ms']:.2f} TFLOP/s "
              "useful), plain "
              + (f"{r['plain_ms']:.4f} ms" if plain else "not timed")
              + f", bound {b_ms:.4f} ms ({b_by}, "
              f"{100 * b_ms / r['ms']:.0f} %), SNR {r['snr_db']:.1f} dB, "
              f"digest {d[:16]} "
              + ("(none recorded)" if want is None else
                 f"equal {r['equal']}"), file=out, flush=True)
        if "tiles" in r:
            print(f"fir_bank general [{case['name']}] tiles: " + "; ".join(
                f"{k} {v['ms']:.4f} ms, digest equal {v['equal']}"
                for k, v in r["tiles"].items()), file=out, flush=True)
        del bank, xx, y, yp
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", metavar="FILE",
                    help="write the cases' digests and times here")
    ap.add_argument("--no-plain", action="store_true",
                    help="do not time the plain version")
    ap.add_argument("--tiles", action="store_true",
                    help="also time every tile that can take each case")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fir_digest: needs a CUDA card", file=sys.stderr)
        return 2
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    res = run_cases("cuda", plain=not args.no_plain, tiles=args.tiles)
    if args.json:
        Path(args.json).write_text(json.dumps(
            dict(card=card, cases=res), indent=1, sort_keys=True) + "\n")
    bad = [k for k, v in res.items() if v["equal"] is False or any(
        t["equal"] is False for t in v.get("tiles", {}).values())]
    low = [k for k, v in res.items() if not v["snr_db"] > 110.0]
    if bad or low:
        print(f"fir_digest: digests differ at {bad}; under 110 dB at {low}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
