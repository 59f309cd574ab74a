"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no jax, so it also runs where jax is not installed; there, skip the repo's
conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m cuda

Bounds: frontend demod > 90 dB (the JAX package's streaming bound), FIR
bank > 110 dB at every site of the mode-0 slice and at the tiled body's
edge geometries (f32 sums in another order than the plain SGEMM's), the
channelizer epilogue byte-equal (it rounds every product and sum as torch
eager does), the direct-form decimating FIR > 110 dB, and the receiver on
the card against its own CPU run: audio > 60 dB, RDS bits equal. The
two-stage wideband path's u8 station streams agree with the CPU run within
1 LSB on < 1 % of bytes (the fold matmul sums in another order on the
card). The sequential PLL against its plain version run on the same card
tensors: carrier > 80 dB, counter exact, float carry within 1e-4 (the
kernel rounds every step as torch's separate elementwise kernels do, so
it is expected bit-identical; the bound leaves room for a math library
that differs by an ulp). Modes 1-3: the mode-3 frontend (down 3) > 90 dB
and the six FIR-bank geometries modes 1-3 add > 110 dB.
"""

import math

import numpy as np
import pytest
import torch

from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.ops.cuda import (chan_epilogue, fir_bank,
                                              fir_decimate, frontend_fused)
from real_time_sdr_tpu_torch.ops.cuda.chan_epilogue import chan_epilogue_plain
from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (TILED_TILE,
                                                       fir_bank_plain,
                                                       kernel_body)
from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import fir_decimate_plain
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import frontend_plain
from real_time_sdr_tpu_torch.ops.fir import PolyFIR, make_bank
from real_time_sdr_tpu_torch.ops.cuda import pll_scan_kernel
from real_time_sdr_tpu_torch.ops.pll import (PllCarry, PllParams, pll_init,
                                             pll_scan_plain)
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
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
    body = kernel_body(bank.geometry)
    rng = np.random.default_rng(len(site))
    xx = torch.from_numpy(rng.standard_normal(
        (SITES[site], bank.tail_len + n)).astype(np.float32)).cuda()
    before = fir_bank.launches, fir_bank.body_launches[body]
    yk = fir_bank(xx, bank.taps, bank.w, bank.geometry)
    assert (fir_bank.launches, fir_bank.body_launches[body]) == tuple(
        v + 1 for v in before)
    yp = fir_bank_plain(xx, bank.w, bank.geometry)
    assert yk.shape == yp.shape
    assert _snr(yp, yk) > 110.0


def _bank_case(nf, k_taps, rows, n, down=1, shift=0, seed=0):
    """A random nf-filter bank and tail-prefixed rows on the card; with
    ``shift`` the rows start that many floats past an aligned address."""
    rng = np.random.default_rng(seed)
    bank = make_bank([PolyFIR(rng.standard_normal(k_taps), down=down)
                      for _ in range(nf)]).cuda()
    length = bank.tail_len + n
    store = torch.from_numpy(rng.standard_normal(
        rows * length + shift).astype(np.float32)).cuda()
    return bank, store[shift:].view(rows, length)


# (nf, K, rows, n, shift): n at 1, the tiled body's tile edges and the
# main path's 88,200; K from 2 to the RDS sync pair's 191; one row; rows
# whose starts are not 16-byte aligned (4*L % 16 != 0, or a shifted start)
TILED_CASES = [
    (1, 2, 3, 1, 0), (2, 101, 2, TILED_TILE - 1, 0),
    (3, 127, 2, TILED_TILE, 0), (4, 191, 2, TILED_TILE + 1, 0),
    (1, 101, 1, 88_200, 0), (3, 101, 2, 88_200, 0), (2, 127, 2, 88_200, 0),
    (2, 191, 2, 88_200, 1), (4, 101, 3, 2 * TILED_TILE + 5, 3),
    (1, 127, 4, TILED_TILE + 1, 2), (3, 2, 2, 3, 1), (4, 191, 1, 1, 0),
]


@pytest.mark.parametrize("nf, k_taps, rows, n, shift", TILED_CASES)
def test_fir_bank_tiled_body_matches_plain(card, nf, k_taps, rows, n, shift):
    bank, xx = _bank_case(nf, k_taps, rows, n, shift=shift,
                          seed=nf * 1000 + k_taps + n)
    assert kernel_body(bank.geometry) == "tiled"
    before = fir_bank.body_launches["tiled"]
    yk = fir_bank(xx, bank.taps, bank.w, bank.geometry)
    assert fir_bank.body_launches["tiled"] == before + 1
    yp = fir_bank_plain(xx, bank.w, bank.geometry)
    assert yk.shape == yp.shape == (rows, nf, n)
    assert _snr(yp, yk) > 110.0


@pytest.mark.parametrize("down", [1, 2])
def test_fir_bank_runs_more_than_65535_rows(card, down):
    """70,000 short rows (K 101, n 16) on the flat grid, through each
    body."""
    bank, xx = _bank_case(1, 101, 70_000, 16, down=down, seed=down)
    yk = fir_bank(xx, bank.taps, bank.w, bank.geometry)
    yp = fir_bank_plain(xx, bank.w, bank.geometry)
    assert yk.shape == yp.shape == (70_000, 1, 16 // down)
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


@pytest.mark.parametrize("s_ch, r_n, c, short", [(64, 16, 512, 37),
                                                  (64, 16, 512, 0),
                                                  (5, 3, 41, 1), (3, 8, 7, 0)])
def test_chan_epilogue_kernel_byte_equal(card, s_ch, r_n, c, short):
    """Byte-equal to the plain version on the card, at the 64-station
    geometry, with an odd n_out (byte stores) and with odd S and R."""
    rng = np.random.default_rng(s_ch * 100 + r_n)
    y = torch.from_numpy(rng.standard_normal(
        (c, r_n * 2 * s_ch)).astype(np.float32)).cuda()
    pc = torch.from_numpy(np.cos(rng.uniform(0, 7, s_ch)).astype(
        np.float32)).cuda()
    ps = torch.from_numpy(np.sin(rng.uniform(0, 7, s_ch)).astype(
        np.float32)).cuda()
    n_out = c * r_n - short
    before = chan_epilogue.launches
    got = chan_epilogue(y, pc, ps, r_n, s_ch, n_out)
    assert chan_epilogue.launches == before + 1
    ref = chan_epilogue_plain(y, pc, ps, r_n, s_ch, n_out)
    assert got.shape == ref.shape == (s_ch, 2 * n_out)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("down", [2, 5, 10])
def test_fir_decimate_kernel_matches_plain(card, down):
    rx, _ = card
    h = rx.audio.resamp_bank.taps[0]
    rng = np.random.default_rng(down)
    n = 2 * rx.cfg.if_block
    xx = torch.from_numpy(rng.standard_normal(
        (6, h.shape[0] - 1 + n)).astype(np.float32)).cuda()
    before = fir_decimate.launches
    got = fir_decimate(xx, h, down)
    assert fir_decimate.launches == before + 1
    ref = fir_decimate_plain(xx, h, down)
    assert got.shape == ref.shape == (6, n // down)
    assert _snr(ref, got) > 110.0


def test_two_stage_wideband_on_card_matches_cpu(card):
    """Four stations on the 300 kHz raster at 9.6 MS/s, two chained
    one-block segments through ChannelBank.run_wideband_u8: the card's u8
    station streams against the CPU's within 1 LSB on < 1 % of bytes, and
    the card's audio against the CPU bank fed the card's own u8 > 60 dB."""
    rx, _ = card
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-450_000, -150_000, 150_000, 450_000]
    scene = [dict(offset_hz=f, ps_name=f"CARD-{k}  ", pi=0x5100 + k)
             for k, f in enumerate(offs)]
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, 2)
    x = np.empty(2 * len(iw), np.float32)
    x[0::2], x[1::2] = iw, qw
    raw = torch.from_numpy(np.clip(np.round(128 + 127 * x), 0,
                                   255).astype(np.uint8))
    ch_gpu = Channelizer(cfg, wide_fs, offs).cuda()
    ch_cpu = Channelizer(cfg, wide_fs, offs)
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3)
    bank, bank_cpu = ChannelBank(rx, 4), ChannelBank(ref, 4)
    cs, cs_cpu = ch_gpu.init_state(), ch_cpu.init_state()
    bs = bank.init_state()
    half = raw.shape[0] // 2
    before = (chan_epilogue.launches, frontend_fused.launches)
    for k in range(2):
        seg = raw[k * half:(k + 1) * half]
        i_g, q_g = (t.cuda() for t in (seg[0::2], seg[1::2]))
        u8_g, _ = ch_gpu.call_u8((i_g.float() - 128) / 128,
                                 (q_g.float() - 128) / 128, cs)
        u8_c, cs_cpu = ch_cpu.call_u8((seg[0::2].float() - 128) / 128,
                                      (seg[1::2].float() - 128) / 128,
                                      cs_cpu)
        diff = (u8_g.cpu().int() - u8_c.int()).abs()
        assert diff.max().item() <= 1
        assert (diff != 0).float().mean().item() < 0.01
        bs_before = map_state(bs, lambda t: t.cpu())
        bs, out, cs = bank.run_wideband_u8(bs, ch_gpu, seg.cuda(), cs)
        _, rout = bank_cpu.run_segment(bs_before, u8_g.cpu())
        for c in range(4):
            assert _snr(rout.left[c], out.left[c]) > 60.0
    assert chan_epilogue.launches > before[0]
    assert frontend_fused.launches > before[1]


@pytest.mark.parametrize("n", [1, 7, 7350])
@pytest.mark.parametrize("rows", [1, 32, 1000])
def test_pll_scan_kernel_matches_plain(card, rows, n):
    """Random pilots (row 0 all zeros: the signed-zero detector) from a
    carry with random phases, counters and feedback signs."""
    rng = np.random.default_rng(rows * 10 + n)
    p = PllParams(freq=19_000, fs=240_000, nco_scale=2.0, norm_bw=0.01)
    t = np.arange(n) / p.fs
    x = np.cos(2 * np.pi * 19_030.0 * t + rng.uniform(0, 6, (rows, 1)))
    x = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    x[0] = 0.0
    ang = rng.uniform(-np.pi, np.pi, rows)
    carry = PllCarry(*(torch.from_numpy(a).cuda() for a in (
        np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
        rng.uniform(-1e-3, 1e-3, rows).astype(np.float32),
        rng.uniform(0, 12, rows).astype(np.float32),
        rng.integers(0, p.period, rows).astype(np.int32),
        rng.uniform(-1, 1, rows).astype(np.float32))))
    xc = torch.from_numpy(x).cuda()
    before = pll_scan_kernel.launches
    got, gc = pll_scan_kernel(xc, carry, p)
    assert pll_scan_kernel.launches == before + 1
    ref, rc = pll_scan_plain(xc, carry, p)
    assert got.shape == ref.shape == (rows, n)
    assert _snr(ref, got) > 80.0
    assert torch.equal(gc.trig, rc.trig)
    for a, b in zip(gc, rc):
        assert (a.double() - b.double()).abs().max().item() < 1e-4


def test_pll_tier1_receiver_on_card_matches_cpu(card):
    """The default-tier receiver launches the PLL kernel; 2 blocks against
    the CPU run from the same state: audio > 60 dB."""
    _, iq = card
    rx = Receiver(0, stereo=True, rds=True, device="cuda")
    ref = Receiver(0, stereo=True, rds=True)
    x = iq[: 2 * 2 * rx.cfg.block_size_iq][None]
    before = pll_scan_kernel.launches
    _, out = rx.run_segment(rx.init_state(1), x.cuda())
    assert pll_scan_kernel.launches == before + 2        # stereo + RDS
    _, rout = ref.run_segment(ref.init_state(1), x)
    assert _snr(rout.left[0], out.left[0]) > 60.0
    assert _snr(rout.right[0], out.right[0]) > 60.0


def test_mode3_frontend_matches_plain(card):
    rx = Receiver(3, device="cuda")
    fe = rx.frontend
    assert fe.rf_fir.down == 3
    iq, _ = synth.station_iq(rx.cfg, 2)
    x = torch.from_numpy(iq).cuda()
    xx = torch.cat([fe.init_state(2).iq_tail, torch.stack([x, x.flip(0)])],
                   dim=-1)
    pi = torch.tensor([0.1, -0.3], device="cuda")
    pq = torch.tensor([0.2, 0.4], device="cuda")
    dk, ik, qk = frontend_fused(xx, fe.rf_fir, pi, pq)
    dp, ip, qp = frontend_plain(xx, fe.rf_fir, pi, pq)
    assert dk.shape == dp.shape == (2, 2 * rx.cfg.if_block)
    assert _snr(dp, dk) > 90.0
    assert (ik - ip).abs().max().item() < 1e-4


# the audio and RDS baseband resamplers of modes 1-3: (mode, site)
MODE_SITES = [(m, s) for m in (1, 2, 3)
              for s in ("audio.resamp_bank", "rds_path.baseband_bank")]


@pytest.mark.parametrize("mode, site", MODE_SITES)
def test_fir_bank_mode_sites_match_plain(card, mode, site):
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=3, device="cuda")
    bank = rx
    for name in site.split("."):
        bank = getattr(bank, name)
    g = bank.geometry
    assert kernel_body(g) == "general"
    rng = np.random.default_rng(mode)
    rows = 4 if "audio" in site else 6
    xx = torch.from_numpy(rng.standard_normal(
        (rows, bank.tail_len + 2 * rx.cfg.if_block)).astype(
            np.float32)).cuda()
    yk = fir_bank(xx, bank.taps, bank.w, g)
    yp = fir_bank_plain(xx, bank.w, g)
    assert yk.shape == yp.shape
    assert _snr(yp, yk) > 110.0
