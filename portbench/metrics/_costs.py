"""Frozen cost arithmetic of the band cells' kernels: the operations and
bytes each launch of a segment needs, from the configuration's shapes and
the filters' designs, whatever implements them.

A FIR site of ``nf`` filters sharing one input of ``n`` samples a row
(resampling up/down, K taps, carried tail T-1 = ceil(K/up) - 1; the
decimating FIR's tail K - 1): 2 operations per nonzero tap an output
touches, bytes of the input and its tail read once, every output written
once, the taps read once a launch. The fold product of the fused wideband
frontend: 2 M N K operations for (M, K) @ (K, N), the rails and their
tails read once, the weights once, the product written once. A floor is
the larger of the operations at the f32 peak and the bytes at the HBM
rate of an NVIDIA H100 SXM (data sheet, 700 W).
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference import filters

H100_F32_FLOPS = 67e12
H100_HBM_BPS = 3.35e12
FOLD_R = 8          # outputs per fold frame before the tone period's lcm


def floor_s(flops: float, nbytes: float) -> float:
    return max(flops / H100_F32_FLOPS, nbytes / H100_HBM_BPS)


def fir_launch(taps: list[np.ndarray], up: int, down: int, n: int,
               rows: int, tail: int) -> dict:
    """Operations and bytes of one launch over ``rows`` rows."""
    n_out = n * up // down
    per_phase = np.bincount((np.arange(n_out, dtype=np.int64) * down) % up,
                            minlength=up)
    nz = sum(np.array([np.count_nonzero(h[p::up]) for p in range(up)])
             for h in taps)
    nf, k = len(taps), taps[0].shape[0]
    w = 4 * nf * k
    row_bytes = 4 * (n + tail) + 4 * nf * n_out
    return dict(flops=rows * 2 * int(per_phase @ nz),
                bytes=rows * row_bytes + w)


def band_fir_sites(cfg: dict, rds: bool) -> dict[str, list[dict]]:
    """{kernel: [launch cost, ...]} of one segment of the band cells: the
    IF band bank (pilot and stereo band, and the RDS band with RDS), the
    audio resampler's two rails (``fir_decimate``), and with RDS the
    squared-pilot band-pass, the 247/640 baseband low-pass and the RRC
    (one row per station and block)."""
    rx, band = cfg["receiver"], cfg["band"]
    s, b = band["stations"], cfg["cli"]["segment"]
    k, fs = rx["rf_taps"], rx["if_fs"]
    n_if = rx["block_size_iq"] // rx["rf_decim"]
    bpf = filters.design_bpf
    if_bank = [bpf(fs, *rx["pilot_band"], k), bpf(fs, *rx["stereo_band"], k)]
    if rds:
        if_bank.append(bpf(fs, *rx["rds_band"], k))
    sites = {"fir_bank": [fir_launch(if_bank, 1, 1, b * n_if, s, k - 1)]}
    audio = filters.design_lpf(fs * rx["audio_up"], rx["audio_fc"],
                               k * rx["audio_up"], gain=rx["audio_up"])
    sites["fir_decimate"] = [fir_launch([audio], 1, rx["audio_down"],
                                        b * n_if, 2 * s, k - 1)]
    if rds:
        rds_fs = int(rx["rds_symbol_rate"] * rx["rds_sps"])
        g = math.gcd(rds_fs, fs)
        up, down = rds_fs // g, fs // g
        pilot = bpf(fs, *rx["rds_squared_band"], k)
        base = filters.design_lpf(fs * up, 3000.0, k * up, gain=up)
        rrc = filters.design_rrc(rds_fs, k)
        n_rds = n_if * up // down
        sites["fir_bank"] += [
            fir_launch([pilot], 1, 1, b * n_if, s, k - 1),
            fir_launch([base], up, down, n_if, s * b, k - 1),
            fir_launch([rrc], 1, 1, n_rds, s * b, k - 1)]
    return sites


def fold_product(cfg: dict) -> dict:
    """Operations and bytes of one segment's fold product."""
    rx, band = cfg["receiver"], cfg["band"]
    wide_fs, s = band["wide_fs"], band["stations"]
    d = wide_fs // rx["rf_fs"]
    dt = d * rx["rf_decim"]
    k_eq = rx["rf_taps"] * band["taps_factor"] + 1 + d * (rx["rf_taps"] - 1)
    lo = tone_lcm(cfg)
    r_n = FOLD_R * lo // math.gcd(FOLD_R, lo)
    j_w = k_eq + (r_n - 1) * dt
    n = cfg["cli"]["segment"] * rx["block_size_iq"] * d
    m, kk, nn = -(-(n // dt) // r_n), 2 * j_w, r_n * 2 * s
    return dict(flops=2 * m * kk * nn,
                bytes=4 * (2 * (n + k_eq - 1) + kk * nn + m * nn),
                dims=(m, kk, nn))


def tone_lcm(cfg: dict) -> int:
    """lcm over the grid's stations of their IF-rate tone periods."""
    rx, band = cfg["receiver"], cfg["band"]
    p = band["wide_fs"]
    dt = (p // rx["rf_fs"]) * rx["rf_decim"]
    lo = 1
    n = band["stations"]
    for k in range(n):
        f = int((k - (n - 1) / 2) * band["raster_hz"])
        fd = (f * dt) % p
        per = p // math.gcd(fd, p) if fd else 1
        lo = lo * per // math.gcd(lo, per)
    return lo
