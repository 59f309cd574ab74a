"""Frozen cost arithmetic of the tuner bank's front end: one
``frontend_fused`` launch a segment at the tuner cell's shape, T tuners'
rows of G blocks each, whatever implements it.

Per row: the staged operand's bytes (the segment and the 2K - 2 bytes of
its carried tail) read once, the IF demod (float32) written once, and 2
operations for each nonzero tap of the RF low-pass, for the I and for the
Q rail of every decimated output; the taps (float32) read once a launch.
A floor is the larger of the operations at the f32 peak and the bytes at
the HBM rate of an NVIDIA H100 SXM (``_costs.floor_s``).
"""

from __future__ import annotations

import numpy as np

from portbench.reference import filters


def frontend_launch(cfg: dict) -> dict:
    """Operations and bytes of one segment's ``frontend_fused`` launch."""
    rx = cfg["receiver"]
    rows, g, k = cfg["tuners"], cfg["cli"]["segment"], rx["rf_taps"]
    nz = int(np.count_nonzero(filters.design_lpf(rx["rf_fs"], rx["rf_fc"],
                                                 k)))
    n2 = g * 2 * rx["block_size_iq"]
    n_out = (n2 // 2) // rx["rf_decim"]
    return dict(flops=rows * 2 * 2 * nz * n_out,
                bytes=rows * ((2 * k - 2) + n2 + 4 * n_out) + 4 * k)
