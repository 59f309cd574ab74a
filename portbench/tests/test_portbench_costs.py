"""The frozen cost arithmetic (``portbench/metrics/_costs.py``) against
what the port's own ``cost()`` / ``stage_costs`` give on this tree at the
band cells' shapes: a record of their agreement, not a dependency."""

from __future__ import annotations

import functools
import json
import os

import pytest
import torch

from portbench.core.manifest import PKG
from portbench.metrics import _costs
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend
from real_time_sdr_tpu_torch.utils.logging import speed_of_light_report

Receiver = functools.partial(_Receiver, device="cpu")

with open(os.path.join(PKG, "configs", "fm_band_64st.json")) as f:
    CFG = json.load(f)
S, B = CFG["band"]["stations"], CFG["cli"]["segment"]


@pytest.mark.parametrize("rds", [True, False])
def test_fir_floors_match_the_ports_report(rds):
    rx = Receiver(0, stereo=True, rds=rds, pll_tier=CFG["cli"]["pll_tier"])
    with open(os.devnull, "w") as sink:
        rep = speed_of_light_report(rx, file=sink, channels=S, blocks=B)
    sites = _costs.band_fir_sites(CFG, rds)
    for kernel in ("fir_bank", "fir_decimate"):
        mine = sum(_costs.floor_s(c["flops"], c["bytes"])
                   for c in sites[kernel]) * 1e3
        assert mine == pytest.approx(rep["kernels"][kernel]["floor_ms"],
                                     rel=1e-9), kernel


def test_fold_product_matches_the_frontends_cost():
    from portbench.traffic.generator import band_offsets
    band = CFG["band"]
    fe = FusedWidebandFrontend(mode_config(0), band["wide_fs"],
                               band_offsets(S, band["raster_hz"]),
                               taps_factor=band["taps_factor"], device="cpu")
    d = band["wide_fs"] // CFG["receiver"]["rf_fs"]
    c = fe.cost(B * CFG["receiver"]["block_size_iq"] * d)
    mine = _costs.fold_product(CFG)
    assert mine["dims"] == tuple(c["dims"])
    assert mine["flops"] == c["flops"]
    assert _costs.tone_lcm(CFG) == fe.lo


def test_floors_are_flop_and_byte_bound_where_expected():
    p = _costs.fold_product(CFG)
    assert p["flops"] / _costs.H100_F32_FLOPS > p["bytes"] / \
        _costs.H100_HBM_BPS
    dec = _costs.band_fir_sites(CFG, False)["fir_decimate"][0]
    assert dec["bytes"] / _costs.H100_HBM_BPS > dec["flops"] / \
        _costs.H100_F32_FLOPS
    assert torch.get_default_dtype() == torch.float32
