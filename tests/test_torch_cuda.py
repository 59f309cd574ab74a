"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no jax, so it also runs where jax is not installed; there, skip the repo's
conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m cuda

Bounds: frontend demod > 90 dB (the JAX package's streaming bound), FIR
bank > 110 dB at every site of the mode-0 slice, and the receiver on the
card against its own CPU run: audio > 60 dB, RDS bits equal.
"""

import math

import numpy as np
import pytest
import torch

from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.ops.cuda import fir_bank, frontend_fused
from real_time_sdr_tpu_torch.ops.cuda.fir_bank import fir_bank_plain
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import frontend_plain
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.state import map_state

pytestmark = pytest.mark.cuda

# the FIR-bank sites of the stereo + RDS receiver: attribute path -> rows
SITES = {
    "if_bank": 2, "audio.sync.bank": 2, "audio.resamp_bank": 4,
    "rds_path.pilot_bank": 2, "rds_path.sync.bank": 2,
    "rds_path.baseband_bank": 6, "rds_path.rrc_bank": 6,
}


def _snr(ref, y):
    ref, y = ref.double().cpu(), y.double().cpu()
    err = (y - ref).pow(2).sum().item()
    return 10 * math.log10(ref.pow(2).sum().item() / max(err, 1e-300))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cuda")
    iq, _ = synth.station_iq(rx.cfg, 12, ps_name="CARDTEST")
    return rx, torch.from_numpy(iq)


def test_frontend_kernel_matches_plain(card):
    rx, iq = card
    fe = rx.frontend
    x = iq[: 2 * 2 * rx.cfg.block_size_iq].cuda()
    xx = torch.cat([fe.init_state(2).iq_tail, torch.stack([x, x.flip(0)])],
                   dim=-1)
    pi = torch.tensor([0.1, -0.3], device="cuda")
    pq = torch.tensor([0.2, 0.4], device="cuda")
    before = frontend_fused.launches
    dk, ik, qk = frontend_fused(xx, fe.rf_fir, pi, pq)
    assert frontend_fused.launches == before + 1
    dp, ip, qp = frontend_plain(xx, fe.rf_fir, pi, pq)
    assert dk.shape == dp.shape == (2, 2 * rx.cfg.if_block)
    assert _snr(dp, dk) > 90.0
    assert (ik - ip).abs().max().item() < 1e-4
    assert (qk - qp).abs().max().item() < 1e-4


@pytest.mark.parametrize("site", sorted(SITES))
def test_fir_bank_kernel_matches_plain(card, site):
    rx, _ = card
    bank = rx
    for name in site.split("."):
        bank = getattr(bank, name)
    n = 2 * rx.cfg.if_block if "rrc" not in site else rx.cfg.rds_block
    rng = np.random.default_rng(len(site))
    xx = torch.from_numpy(rng.standard_normal(
        (SITES[site], bank.tail_len + n)).astype(np.float32)).cuda()
    before = fir_bank.launches
    yk = fir_bank(xx, bank.taps, bank.w, bank.geometry)
    assert fir_bank.launches == before + 1
    yp = fir_bank_plain(xx, bank.w, bank.geometry)
    assert yk.shape == yp.shape
    assert _snr(yp, yk) > 110.0


def test_receiver_on_card_matches_cpu(card):
    """Two 6-block segments: the first from a cold start (audio only: the
    cold-start RDS carrier sign is set by rounding at ~1e-31 magnitudes,
    see tests/test_torch_receiver.py), the second from the card's state
    moved to the CPU (audio and RDS bits)."""
    rx, iq = card
    half = iq.shape[0] // 2
    batch = torch.stack([iq, iq.roll(2 * 7919)])
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3)
    st, out = rx.run_segment(rx.init_state(2), batch[:, :half].cuda())
    _, rout = ref.run_segment(ref.init_state(2), batch[:, :half])
    for c in range(2):
        assert _snr(rout.left[c], out.left[c]) > 60.0
        assert _snr(rout.right[c], out.right[c]) > 60.0
    _, out = rx.run_segment(st, batch[:, half:].cuda())
    _, rout = ref.run_segment(map_state(st, lambda t: t.cpu()),
                              batch[:, half:])
    for c in range(2):
        assert _snr(rout.left[c], out.left[c]) > 60.0
        assert _snr(rout.right[c], out.right[c]) > 60.0
    assert torch.equal(rout.rds_nbits, out.rds_nbits.cpu())
    assert torch.equal(rout.rds_bits, out.rds_bits.cpu())
