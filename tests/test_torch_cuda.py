"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no jax, so it also runs where jax is not installed; there, skip the repo's
conftest (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m cuda

Bounds: frontend demod > 90 dB (the JAX package's streaming bound; the
kernel sums plane by plane, the plain version one dot product per output),
at all four modes, at 1, 32 and 70,000 rows, at 1 output and around one
block's 1,151 outputs, from unaligned row starts, and through the kernel's
two bodies (the receiver's geometries, any other); FIR
bank > 110 dB at every site of the mode-0 slice and at the tiled body's
edge geometries (f32 sums in another order than the plain SGEMM's), the
channelizer epilogue byte-equal (it rounds every product and sum as torch
eager does), the direct-form decimating FIR > 110 dB (through its static
bodies at the two audio geometries and its general body, K 2-191, 1 to
17,640 outputs and around a block's edge, 1 / 32 / 70,000 rows, unaligned
and odd row starts), and the receiver on
the card against its own CPU run: audio > 60 dB, RDS bits equal. The
two-stage wideband path's u8 station streams agree with the CPU run within
1 LSB on < 1 % of bytes (the fold matmul sums in another order on the
card). The sequential PLL against its plain version run on the same card
tensors: carrier > 80 dB, counter exact, float carry within 1e-4 with the
phase compared modulo 4*pi (the kernel's detector is the exact reduction
of pi*[x<0] - arg where the plain version's runs through sin, cos and
atan2, so the two agree to rounding, 110-140 dB, and not bit for bit);
rows of zeros and rows with a NaN take the literal detector and give the
plain version's NaN pattern. Modes 1-3: the six FIR-bank geometries modes
1-3 add > 110 dB at the path's rows (64 audio rails, 384 RDS rows). The
FIR bank's general body: the FIR property test's 12 random geometries at
1, 2 and 33 rows, nf 1-4, shifted row starts, > 110 dB; and bit-identical
to the recorded digests of the body it replaced at every case of
``utils/fir_digest.py``, each counted under the tile (lines or direct)
its shape picked; T 2,001 through the direct tile. The wideband precisions (bf16 two-stage, bf16 and
bf16x2 fused) on the card against the same frontend on the CPU: f32
results of the tensor-core fold product > 90 dB from its plain version
(exact products, f32 sums in another order), fused demod > 90 dB,
two-stage u8 within 1 LSB on < 1 % of bytes.
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
                                                       general_plan,
                                                       kernel_body,
                                                       lines_plan)
from real_time_sdr_tpu_torch.ops.cuda import _build, fir_kernels
from real_time_sdr_tpu_torch.ops.cuda.fir_kernels import (STATIC_TILE,
                                                          fir_decimate_plain)
from real_time_sdr_tpu_torch.ops.cuda.frontend_fused import (TILE,
                                                            frontend_plain)
from real_time_sdr_tpu_torch.ops.fir import (DecimatingFIR, DualPhaseFIR,
                                             PolyFIR, make_bank)
from real_time_sdr_tpu_torch.ops.cuda import pll_scan_kernel
from real_time_sdr_tpu_torch.ops.pll import (PllCarry, PllParams, pll_init,
                                             pll_scan_plain)
from real_time_sdr_tpu_torch.utils import fir_digest, synth
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils.state import map_state

pytestmark = pytest.mark.cuda

# the FIR sites of the stereo + RDS receiver: attribute path -> rows (the
# audio resampler is the decimating FIR at modes 0-1, a bank at modes 2-3)
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


def _check_decimating_site(site, xx):
    """A DecimatingFIR site's kernel against its plain version on
    tail-prefixed rows: one launch of the static body, > 110 dB."""
    body = fir_kernels.kernel_body(site.num_taps, site.down)
    assert body == "static"
    before = fir_decimate.launches, fir_decimate.body_launches[body]
    yk = fir_decimate(xx, site.taps, site.down)
    assert (fir_decimate.launches, fir_decimate.body_launches[body]) == tuple(
        v + 1 for v in before)
    yp = fir_decimate_plain(xx, site.taps, site.down)
    assert yk.shape == yp.shape
    assert _snr(yp, yk) > 110.0


def _check_frontend(xx, dual, seed=0):
    """Kernel against plain on tail-prefixed rows xx: > 90 dB, prev 1e-4."""
    rng = np.random.default_rng(seed)
    rows = xx.shape[0]
    pi, pq = (torch.from_numpy(rng.uniform(-0.5, 0.5, rows).astype(
        np.float32)).cuda() for _ in range(2))
    before = frontend_fused.launches
    dk, ik, qk = frontend_fused(xx, dual, pi, pq)
    assert frontend_fused.launches == before + 1
    dp, ip, qp = frontend_plain(xx, dual, pi, pq)
    torch.cuda.synchronize()
    assert dk.shape == dp.shape
    assert torch.isfinite(dk).all()
    assert _snr(dp, dk) > 90.0, _snr(dp, dk)
    assert (ik - ip).abs().max().item() < 1e-4
    assert (qk - qp).abs().max().item() < 1e-4
    return dk


def _fm_rows(rows, length, shift=0, seed=0):
    """(rows, length) u8 interleaved I/Q of a constant-envelope carrier
    with a slow random phase walk (in band at every mode, so the
    discriminator's divisor stays far from 0), on the card; with ``shift``
    the rows start that many bytes past an aligned address."""
    rng = np.random.default_rng(seed)
    n = rows * length // 2 + 1
    phase = np.cumsum(rng.uniform(-0.05, 0.05, n))
    iq = np.empty(2 * n, np.float64)
    iq[0::2], iq[1::2] = np.cos(phase), np.sin(phase)
    store = np.zeros(rows * length + shift, np.uint8)
    store[shift:] = np.round(128 + 100 * iq)[:rows * length]
    return torch.from_numpy(store).cuda()[shift:].view(rows, length)


def test_frontend_kernel_matches_plain(card):
    rx, iq = card
    fe = rx.frontend
    x = iq[: 2 * 2 * rx.cfg.block_size_iq].cuda()
    xx = torch.cat([fe.init_state(2).iq_tail, torch.stack([x, x.flip(0)])],
                   dim=-1)
    dk = _check_frontend(xx, fe.rf_fir)
    assert dk.shape == (2, 2 * rx.cfg.if_block)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_frontend_kernel_all_modes(card, mode):
    """Two blocks of a synthetic station at each mode's geometry (down 10,
    4, 10, 3; K 101: the static-taps body), 2 channels."""
    rx = Receiver(mode, device="cuda")
    fe = rx.frontend
    iq, _ = synth.station_iq(rx.cfg, 2)
    x = torch.from_numpy(iq).cuda()
    xx = torch.cat([fe.init_state(2).iq_tail, torch.stack([x, x.flip(0)])],
                   dim=-1)
    dk = _check_frontend(xx, fe.rf_fir, seed=mode)
    assert dk.shape == (2, 2 * rx.cfg.if_block)


# (rows, n_out, shift): one output, one block's outputs minus 1, exactly,
# plus 1 and two blocks plus a few; 1 and 32 rows; rows that start 1, 3 or
# 8 bytes past a 16-byte boundary (and, with L % 16 != 0, anywhere)
FRONTEND_EDGES = [(1, 1, 0), (32, 1, 1), (1, TILE - 1, 0), (32, TILE - 1, 3),
                  (1, TILE, 1), (32, TILE, 0), (1, TILE + 1, 3),
                  (32, TILE + 1, 8), (3, 2 * TILE + 5, 1)]


@pytest.mark.parametrize("rows, n_out, shift", FRONTEND_EDGES)
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_frontend_kernel_edges(card, mode, rows, n_out, shift):
    fe = Receiver(mode, device="cuda").frontend
    down = fe.rf_fir.down
    # a few pairs more than n_out needs: the kernel must ignore them
    length = fe.tail_len + 2 * (down * n_out + down - 1)
    xx = _fm_rows(rows, length, shift=shift, seed=mode * 100 + n_out)
    dk = _check_frontend(xx, fe.rf_fir, seed=rows + shift)
    assert dk.shape == (rows, n_out)


@pytest.mark.parametrize("k_taps, down", [(101, 10), (91, 10), (64, 4),
                                          (33, 3), (33, 7), (3, 5),
                                          (101, 1)])
def test_frontend_kernel_bodies(card, k_taps, down):
    """The static body (K 101 at down 10) and the any-geometry body
    (another K at down 10, 4, 3; down 7; 5 > K; 1), 3 rows of a block's
    outputs plus 9 and a ragged end, from an odd address."""
    rng = np.random.default_rng(k_taps * 10 + down)
    h = rng.standard_normal(k_taps) * np.hanning(k_taps + 2)[1:-1]
    dual = DualPhaseFIR(h / np.abs(h).sum(), down).cuda()
    length = dual.tail_len + 2 * (down * (TILE + 9) + down - 1)
    xx = _fm_rows(3, length, shift=1, seed=down)
    dk = _check_frontend(xx, dual, seed=k_taps)
    assert dk.shape == (3, TILE + 9)


@pytest.mark.parametrize("mode", [0, 1])
def test_frontend_runs_more_than_65535_rows(card, mode):
    """70,000 short rows (3 outputs each) on the flat grid."""
    fe = Receiver(mode, device="cuda").frontend
    length = fe.tail_len + 2 * fe.rf_fir.down * 3
    xx = _fm_rows(70_000, length, seed=mode)
    dk = _check_frontend(xx, fe.rf_fir, seed=mode)
    assert dk.shape == (70_000, 3)


def test_frontend_kernel_rejects_what_it_does_not_take(card):
    rx, _ = card
    fe = rx.frontend
    z = torch.zeros(2, device="cuda")
    good = torch.zeros((2, fe.tail_len + 40), dtype=torch.uint8,
                       device="cuda")
    with pytest.raises(ValueError):         # odd length
        frontend_fused(good[:, :-1].contiguous(), fe.rf_fir, z, z)
    with pytest.raises(ValueError):         # not contiguous
        frontend_fused(good[:, ::2], fe.rf_fir, z, z)
    with pytest.raises(TypeError):
        frontend_fused(good.float(), fe.rf_fir, z, z)
    wide = torch.zeros((2, fe.tail_len + 2 * 200 * 3), dtype=torch.uint8,
                       device="cuda")
    with pytest.raises(RuntimeError):       # planes beyond shared memory
        frontend_fused.launch(wide, fe.rf_fir.taps, 200, z, z)
    with pytest.raises(ValueError):
        frontend_fused.launch(good, fe.rf_fir.taps, 0, z, z)
    dk, ik, qk = frontend_fused(good[:, :fe.tail_len + 2].contiguous(),
                                fe.rf_fir, z, z)
    assert dk.shape == (2, 0) and torch.equal(ik, z)    # no output: no launch


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
    if isinstance(bank, DecimatingFIR):
        return _check_decimating_site(bank, xx)
    body = kernel_body(bank.geometry)
    before = fir_bank.launches, fir_bank.body_launches[body]
    yk = fir_bank(xx, bank.ptaps, bank.w, bank.geometry)
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
    yk = fir_bank(xx, bank.ptaps, bank.w, bank.geometry)
    assert fir_bank.body_launches["tiled"] == before + 1
    yp = fir_bank_plain(xx, bank.w, bank.geometry)
    assert yk.shape == yp.shape == (rows, nf, n)
    assert _snr(yp, yk) > 110.0


@pytest.mark.parametrize("down", [1, 2])
def test_fir_bank_runs_more_than_65535_rows(card, down):
    """70,000 short rows (K 101, n 16) on the flat grid, through each
    body."""
    bank, xx = _bank_case(1, 101, 70_000, 16, down=down, seed=down)
    yk = fir_bank(xx, bank.ptaps, bank.w, bank.geometry)
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
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cpu")
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
    h = rx.audio.resamp_bank.taps
    assert h.shape == (101,)
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


def _decimate_case(k_taps, rows, n, shift=0, seed=0):
    """Random taps and tail-prefixed rows on the card; with ``shift`` the
    rows start that many floats past an aligned address."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal(k_taps).astype(
        np.float32) / k_taps).cuda()
    length = k_taps - 1 + n
    store = torch.from_numpy(rng.standard_normal(
        rows * length + shift).astype(np.float32)).cuda()
    return h, store[shift:].view(rows, length)


# (K, down, rows, n_out, shift): both static bodies and the general one; K
# from 2 to 191; n_out at 1, around the static body's block edge and at the
# main path's 17,640; 1, 32 and 70,000 rows; rows whose starts are not
# 16-byte aligned (an odd row length, or a shifted start)
DECIMATE_CASES = [
    (101, 5, 64, 17_640, 0), (101, 9, 64, 17_640, 0),
    (101, 5, 1, 17_640, 1), (101, 9, 1, 17_640, 3),
    (101, 5, 32, 1, 0), (101, 9, 32, 1, 2),
    (101, 5, 3, STATIC_TILE - 1, 1), (101, 5, 3, STATIC_TILE, 2),
    (101, 5, 3, STATIC_TILE + 1, 3), (101, 9, 3, STATIC_TILE - 1, 0),
    (101, 9, 5, STATIC_TILE + 1, 1), (101, 9, 2, 2 * STATIC_TILE + 7, 2),
    (101, 5, 70_000, 3, 0), (101, 9, 70_000, 2, 1),
    (101, 4, 32, 17_640, 0), (101, 10, 3, 257, 1), (2, 1, 3, 1, 0),
    (191, 8, 2, 255, 3), (65, 5, 70_000, 2, 0), (33, 3, 1, 17_640, 1),
]


@pytest.mark.parametrize("k_taps, down, rows, n_out, shift", DECIMATE_CASES)
def test_fir_decimate_bodies_match_plain(card, k_taps, down, rows, n_out,
                                         shift):
    h, xx = _decimate_case(k_taps, rows, n_out * down, shift=shift,
                           seed=k_taps * 1000 + down + n_out)
    body = fir_kernels.kernel_body(k_taps, down)
    assert body == ("static" if k_taps == 101 and down in (5, 9)
                    else "general")
    before = fir_decimate.body_launches[body]
    yk = fir_decimate(xx, h, down)
    assert fir_decimate.body_launches[body] == before + 1
    yp = fir_decimate_plain(xx, h, down)
    torch.cuda.synchronize()
    assert yk.shape == yp.shape == (rows, n_out)
    assert torch.isfinite(yk).all()
    assert _snr(yp, yk) > 110.0, _snr(yp, yk)


def test_fir_decimate_refused_request_leaves_no_stale_error(card):
    """A block that would need more shared memory than the card has: the
    wrapper refuses it with a ValueError; the C entry, called past the
    wrapper, returns the error and leaves none behind for the next
    launch."""
    h, xx = _decimate_case(191, 2, 4000, seed=5)
    with pytest.raises(ValueError, match="shared memory"):
        fir_decimate(xx, h, 400)
    lib = _build.library()
    y = torch.empty((2, 10), device="cuda")
    err = lib.sdr_fir_decimate(xx.data_ptr(), h.data_ptr(), y.data_ptr(), 2,
                               xx.shape[1], 191, 400, 10,
                               _build.stream_ptr(xx.device))
    assert err != 0
    torch.cuda.synchronize()
    good = fir_decimate(xx, h, 8)
    torch.cuda.synchronize()
    assert _snr(fir_decimate_plain(xx, h, 8), good) > 110.0
    with pytest.raises(ValueError):
        fir_decimate(xx[:, :-1].contiguous(), h, 8)     # down | N
    with pytest.raises(ValueError):
        fir_decimate(xx[:, ::2], h, 1)                  # not contiguous
    with pytest.raises(TypeError):
        fir_decimate(xx.double(), h, 8)


@pytest.mark.parametrize("mode", [0, 1])
def test_audio_site_on_card_matches_cpu(card, mode):
    """Modes 0 and 1 resample their audio through the decimating FIR (one
    static-body launch per segment, the FIR bank one fewer): audio against
    the CPU run > 60 dB over two chained 3-block segments."""
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=3, device="cuda")
    ref = Receiver(mode, stereo=True, rds=True, pll_tier=3,
                   device="cpu")
    assert isinstance(rx.audio.resamp_bank, DecimatingFIR)
    iq, _ = synth.station_iq(rx.cfg, 6, ps_name="AUDIOFIR")
    x = torch.from_numpy(iq)
    batch = torch.stack([x, x.roll(2 * 4099)])
    half = batch.shape[1] // 2
    st, rst = rx.init_state(2), ref.init_state(2)
    for seg in (batch[:, :half], batch[:, half:]):
        before = (fir_decimate.body_launches["static"], fir_bank.launches)
        st, out = rx.run_segment(st, seg.cuda())
        assert fir_decimate.body_launches["static"] == before[0] + 1
        assert fir_bank.launches == before[1] + 6
        rst, rout = ref.run_segment(rst, seg)
        for c in range(2):
            assert _snr(rout.left[c], out.left[c]) > 60.0
            assert _snr(rout.right[c], out.right[c]) > 60.0


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
    ch_gpu = Channelizer(cfg, wide_fs, offs, device="cuda")
    ch_cpu = Channelizer(cfg, wide_fs, offs, device="cpu")
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3, device="cpu")
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


def _pll_case(rows, n, seed):
    """Random pilots from a carry with random phases, counters and feedback
    signs, on the card."""
    rng = np.random.default_rng(seed)
    p = PllParams(freq=19_000, fs=240_000, nco_scale=2.0, norm_bw=0.01)
    t = np.arange(n) / p.fs
    x = np.cos(2 * np.pi * 19_030.0 * t + rng.uniform(0, 6, (rows, 1)))
    x = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, rows)
    carry = PllCarry(*(torch.from_numpy(a).cuda() for a in (
        np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32),
        rng.uniform(-1e-3, 1e-3, rows).astype(np.float32),
        rng.uniform(0, 12, rows).astype(np.float32),
        rng.integers(0, p.period, rows).astype(np.int32),
        rng.uniform(-1, 1, rows).astype(np.float32))))
    return p, x, carry


def _check_pll(p, x, carry):
    """Kernel against plain on the same card tensors: the same NaN pattern;
    over the rows that stay finite carrier > 80 dB, trig equal, float carry
    within 1e-4 (phase modulo 4*pi)."""
    xc = torch.from_numpy(x).cuda()
    before = pll_scan_kernel.launches
    got, gc = pll_scan_kernel(xc, carry, p)
    assert pll_scan_kernel.launches == before + 1
    ref, rc = pll_scan_plain(xc, carry, p)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == x.shape
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref).any(dim=1) & ~torch.isnan(rc.phase)
    assert _snr(ref[ok], got[ok]) > 80.0, _snr(ref[ok], got[ok])
    assert torch.equal(gc.trig, rc.trig)
    for name, a, b in zip(gc._fields, gc, rc):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        d = (a.double() - b.double()).abs()[ok]
        if name == "phase":
            d = torch.minimum(d, (d - 4.0 * math.pi).abs())
        assert d.max().item() < 1e-4, name
    return got, gc, ref, rc


@pytest.mark.parametrize("n", [1, 7, 7350])
@pytest.mark.parametrize("rows", [1, 32, 1000])
def test_pll_scan_kernel_matches_plain(card, rows, n):
    """Random pilots (row 0 all zeros: the signed-zero detector) from a
    carry with random phases, counters and feedback signs."""
    p, x, carry = _pll_case(rows, n, rows * 10 + n)
    x[0] = 0.0
    _check_pll(p, x, carry)


@pytest.mark.parametrize("rows, n", [(70_000, 64), (5, 255), (5, 256),
                                     (5, 257), (3, 600), (9, 32), (2, 33)])
def test_pll_scan_kernel_shapes(card, rows, n):
    """More rows than any grid dimension but x holds, and lengths around
    the kernel's chunk of 256 samples and its groups of 32; rows not a
    multiple of the four a block holds."""
    _check_pll(*_pll_case(rows, n, rows + n))


def test_pll_scan_kernel_zero_and_nan_rows(card):
    """Rows of zeros are all literal detector: bit-equal to the plain
    version. A row whose tone stops, a zero in a tone, a NaN and an Inf
    mid-row follow the plain version (the NaN pattern exactly) and leave
    their block-mates alone."""
    p, x, carry = _pll_case(8, 700, 5)
    x[0] = 0.0
    x[1, 300:] = 0.0
    x[2, 411] = 0.0
    x[3, 120] = np.nan
    x[4, 333] = np.inf
    x[5] = 0.0
    got, gc, ref, rc = _check_pll(p, x, carry)
    assert torch.equal(got[[0, 5]], ref[[0, 5]])
    for a, b in zip(gc, rc):
        assert torch.equal(a[[0, 5]], b[[0, 5]])
    assert torch.isnan(got[3, 122:]).all() and torch.isnan(gc.integ[3])
    assert not torch.isnan(got[[0, 1, 2, 4, 5, 6, 7]]).any()


def test_pll_scan_kernel_takes_strided_rows(card):
    """Rows of a wider tensor (row stride > N), as a receiver slices them."""
    p, x, carry = _pll_case(6, 500, 11)
    wide = torch.from_numpy(np.pad(x, ((0, 0), (3, 9)))).cuda()
    got, gc = pll_scan_kernel(wide[:, 3:503], carry, p)
    ref, rc = pll_scan_kernel(torch.from_numpy(x).cuda(), carry, p)
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(gc, rc))


def test_pll_tier1_receiver_on_card_matches_cpu(card):
    """The default-tier receiver launches the PLL kernel; 2 blocks against
    the CPU run from the same state: audio > 60 dB."""
    _, iq = card
    rx = Receiver(0, stereo=True, rds=True, device="cuda")
    ref = Receiver(0, stereo=True, rds=True, device="cpu")
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
    dk = _check_frontend(xx, fe.rf_fir)
    assert dk.shape == (2, 2 * rx.cfg.if_block)


# the audio and RDS baseband resamplers of modes 1-3: (mode, site)
MODE_SITES = [(m, s) for m in (1, 2, 3)
              for s in ("audio.resamp_bank", "rds_path.baseband_bank")]


@pytest.mark.parametrize("mode, site", MODE_SITES)
def test_fir_bank_mode_sites_match_plain(card, mode, site):
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=3, device="cuda")
    bank = rx
    for name in site.split("."):
        bank = getattr(bank, name)
    rng = np.random.default_rng(mode)
    # the path's rows: 64 audio rails over 12 blocks, 32 channels x 12
    # blocks of RDS baseband, one block each
    rows, n = (64, 12 * rx.cfg.if_block) if "audio" in site else (
        384, rx.cfg.if_block)
    xx = torch.from_numpy(rng.standard_normal(
        (rows, bank.tail_len + n)).astype(np.float32)).cuda()
    if isinstance(bank, DecimatingFIR):         # mode 1's audio, down 9
        return _check_decimating_site(bank, xx)
    g = bank.geometry
    assert kernel_body(g) == "general"
    yk = fir_bank(xx, bank.ptaps, bank.w, g)
    yp = fir_bank_plain(xx, bank.w, g)
    assert yk.shape == yp.shape
    assert _snr(yp, yk) > 110.0


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("rows", [1, 2, 33])
def test_fir_bank_sweep_geometries_match_plain(card, seed, rows):
    """The FIR property test's random geometries through the kernel (the
    general body, or the tiled one at up = down = 1), nf 1-4 and row starts
    shifted off 16-byte boundaries, > 110 dB against the plain version."""
    up, down, k_taps, n = fir_digest.random_geometry(
        np.random.default_rng(1000 + seed))
    nf = 1 + (seed + rows + 1) % 4
    shift = (seed + 2 * rows) % 4
    rng = np.random.default_rng(seed * 10 + rows)
    bank = make_bank([PolyFIR(rng.standard_normal(k_taps), up=up, down=down)
                      for _ in range(nf)]).cuda()
    length = bank.tail_len + n
    store = torch.from_numpy(rng.standard_normal(
        rows * length + shift).astype(np.float32)).cuda()
    xx = store[shift:].view(rows, length)
    body = kernel_body(bank.geometry)
    before = fir_bank.body_launches[body]
    yk = fir_bank(xx, bank.ptaps, bank.w, bank.geometry)
    assert fir_bank.body_launches[body] == before + 1
    yp = fir_bank_plain(xx, bank.w, bank.geometry)
    assert yk.shape == yp.shape == (rows, nf, n * up // down)
    assert _snr(yp, yk) > 110.0


@pytest.mark.parametrize("name", [c["name"] for c in fir_digest.cases()])
def test_fir_bank_general_body_digests(card, name):
    """Bit-identical to the recorded digests of the body the general body
    replaced (utils/fir_digest.py, fir_bank_digests.json): the serving
    path's sites at their shapes, the random geometries at 1, 2 and 33
    rows; one launch of the general body each, counted under the tile
    its shape picked."""
    case = next(c for c in fir_digest.cases() if c["name"] == name)
    bank, xx, n = fir_digest.case_inputs(case, "cuda")
    g = bank.geometry
    assert kernel_body(g) == "general"
    tile = "general." + general_plan(g, xx.shape[0], g.n_out(n),
                                     bank.nf).form
    counts = fir_bank.body_launches
    before = fir_bank.launches, counts["general"], counts[tile]
    y = fir_bank(xx, bank.ptaps, bank.w, g)
    assert (fir_bank.launches, counts["general"], counts[tile]) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert fir_digest.digest(y) == fir_digest.recorded()[name]["digest"]


@pytest.mark.parametrize("nf", [1, 4])
def test_fir_bank_long_taps_run_the_direct_tile(card, nf):
    """T 2,001 (up 1, down 2, K 2,001), where no lines tile fits shared
    memory: the direct tile runs it, > 110 dB against the plain version."""
    rng = np.random.default_rng(nf)
    bank = make_bank([PolyFIR(rng.standard_normal(2001), up=1, down=2)
                      for _ in range(nf)]).cuda()
    g = bank.geometry
    assert lines_plan(g, 3, 1000, nf) is None
    xx = torch.from_numpy(rng.standard_normal(
        (3, bank.tail_len + 2000)).astype(np.float32)).cuda()
    before = fir_bank.body_launches["general.direct"]
    yk = fir_bank(xx, bank.ptaps, bank.w, g)
    assert fir_bank.body_launches["general.direct"] == before + 1
    yp = fir_bank_plain(xx, bank.w, g)
    assert yk.shape == yp.shape == (3, nf, 1000)
    assert _snr(yp, yk) > 110.0


# -- parallel paths on the card ---------------------------------------------

@pytest.mark.parametrize("timing", ["comb", "tracked"])
def test_time_sharding_exact_on_card(card, timing):
    """16 blocks as 4 shards (4 batch rows) against the sequential
    ``run_blocks`` on one row, both on the card: audio > 100 dB on every
    block, RDS bits equal; the kernels run at the 4-row shapes."""
    from real_time_sdr_tpu_torch.parallel.time_shard import time_sharded_run
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3, rds_timing=timing,
                  device="cuda")
    iq, _ = synth.station_iq(rx.cfg, 16, ps_name="CARDSHRD")
    blocks = torch.from_numpy(iq.reshape(16, -1))
    before = (frontend_fused.launches, fir_bank.launches,
              fir_decimate.launches)
    out = time_sharded_run(rx, blocks, 4)         # devices: the visible card
    assert out.left.device.type == "cuda"
    after = (frontend_fused.launches, fir_bank.launches,
             fir_decimate.launches)
    assert all(a > b for a, b in zip(after, before))
    assert after[0] - before[0] == 5                  # 1 halo + 4 blocks
    _, seq = rx.run_blocks(rx.init_state(1), blocks[None].cuda())
    for b in range(16):
        assert _snr(seq.left[0, b], out.left[b]) > 100.0, b
        assert _snr(seq.right[0, b], out.right[b]) > 100.0, b
    assert int(seq.rds_nbits.sum()) > 0
    assert torch.equal(out.rds_nbits, seq.rds_nbits[0])
    assert torch.equal(out.rds_bits, seq.rds_bits[0])


def test_sharded_wideband_on_card(card):
    """Both sharded wideband classes on ``[cuda, cuda]`` (two replicas on
    one card), 4 stations, two chained 4-block segments, against the
    unsharded paths: audio > 70 dB, RDS bits equal; one ``chan_epilogue``
    launch per shard and segment; a retune reaches only its shard."""
    from real_time_sdr_tpu_torch.models.wideband_frontend import (
        FusedWidebandFrontend, u8_to_rails)
    from real_time_sdr_tpu_torch.parallel.channel import gather
    from real_time_sdr_tpu_torch.parallel.wideband import (
        ShardedFusedWideband, ShardedWideband)
    rx, _ = card
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-450_000, -150_000, 150_000, 450_000]
    scene = [dict(offset_hz=f, ps_name=f"CARD-{k}  ", pi=0x5100 + k)
             for k, f in enumerate(offs)]
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, 8)
    x = np.empty(2 * len(iw), np.float32)
    x[0::2], x[1::2] = iw, qw
    raw = torch.from_numpy(np.clip(np.round(128 + 127 * x), 0,
                                   255).astype(np.uint8)).cuda()
    devs = ["cuda", "cuda"]
    bank = ChannelBank(rx, 4)
    for fe, cls in ((Channelizer(cfg, wide_fs, offs, device="cuda"),
                     ShardedWideband),
                    (FusedWidebandFrontend(cfg, wide_fs, offs, device="cuda"),
                     ShardedFusedWideband)):
        sw = cls(fe, rx, devices=devs)
        fs, bs = sw.init_state()
        fs_u, bs_u = fe.init_state(), bank.init_state()
        before = chan_epilogue.launches
        half = raw.shape[0] // 2
        for k in range(2):
            i_w, q_w = u8_to_rails(raw[k * half:(k + 1) * half])
            fs, bs, out = sw.step(fs, bs, i_w, q_w)
            bs_u, out_u, fs_u = bank.run_wideband(bs_u, fe, i_w, q_w, fs_u)
            got = gather(out, "cuda")
            assert _snr(out_u.left, got.left) > 70.0
            assert _snr(out_u.right, got.right) > 70.0
            assert torch.equal(got.rds_bits, out_u.rds_bits)
            assert torch.equal(got.rds_nbits, out_u.rds_nbits)
        assert int(got.rds_nbits.sum()) > 0
        if cls is ShardedWideband:
            # 2 shards + the unsharded reference, per segment
            assert chan_epilogue.launches - before == 2 * 3
        else:
            w0 = sw.shards[0].w.clone()
            w1 = sw.shards[1].w.clone()
            sw.retune(3, offs[2])
            assert torch.equal(sw.shards[0].w, w0)
            assert not torch.equal(sw.shards[1].w, w1)
            assert sw.offsets == offs[:3] + [offs[2]]


def test_staged_segment_bit_identical_on_card(card):
    """32 channels x 12 blocks at mode 0 (tier 3): two chained segments,
    the second host-staged into pinned memory and uploaded asynchronously,
    against two unstaged calls: every output leaf and the state equal, and
    the frontend, FIR-bank and decimating-FIR kernels launch on the staged
    call."""
    rx, iq = card
    n2 = 6 * 2 * rx.cfg.block_size_iq
    pairs = iq.numpy().reshape(-1, 2)
    rows = np.stack([np.roll(pairs, -997 * c, axis=0).reshape(-1)
                     for c in range(32)])
    segs = [np.ascontiguousarray(rows[:, k * n2:(k + 1) * n2])
            for k in range(2)]
    st0, out0 = rx.run_segment(rx.init_state(32),
                               torch.from_numpy(segs[0]).cuda())
    _, ref = rx.run_segment(st0, torch.from_numpy(segs[1]).cuda())
    buf = torch.empty((32, rx.frontend.staged_len(n2)), dtype=torch.uint8,
                      pin_memory=True)
    rx.frontend.stage_segment(segs[0][:, n2 - rx.frontend.tail_len:],
                              segs[1], out=buf.numpy())
    before = [k.launches for k in (frontend_fused, fir_bank, fir_decimate)]
    st1, out = rx.run_segment_staged(st0, buf.cuda(non_blocking=True), n2)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in
               zip((frontend_fused, fir_bank, fir_decimate), before))
    st_ref, _ = rx.run_segment(st0, torch.from_numpy(segs[1]).cuda())
    for a, b in zip(out, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    def leaves(tree):
        if isinstance(tree, tuple):
            return [x for t in tree for x in leaves(t)]
        return [] if tree is None else [tree]
    assert all(torch.equal(a, b)
               for a, b in zip(leaves(st1), leaves(st_ref)))


def test_wideband_frontends_default_to_the_card(card):
    """Channelizer() and FusedWidebandFrontend() without a device build
    every buffer on the current card."""
    from real_time_sdr_tpu_torch.models.wideband_frontend import \
        FusedWidebandFrontend
    rx, _ = card
    offs = [-450_000, -150_000, 150_000, 450_000]
    for cls in (Channelizer, FusedWidebandFrontend):
        fe = cls(rx.cfg, 4 * rx.cfg.rf_fs, offs)
        assert {b.device for b in fe.buffers()} == {torch.device("cuda", 0)}


def _alt_station(n_blocks=32):
    return synth.station_iq(Receiver(0, device="cpu").cfg, n_blocks,
                            ps_name="ALT-PATH", pi=0x2ABC,
                            pilot_freq=19_000.0 * (1 + 200e-6))[0]


def test_mm_timing_kernel_matches_plain(card):
    """The alternative path's unit-RMS baseband (32 blocks) and a stream
    from 3 samples up: n_valid equal and symbols > 100 dB against the plain
    loop on the same card tensors (every f32 step separately rounded in
    both, so they should agree bit for bit), the count left on the card,
    one launch each."""
    from real_time_sdr_tpu_torch.models.rds_alt import AltRdsReceiver
    from real_time_sdr_tpu_torch.ops.cuda import mm_timing_kernel
    from real_time_sdr_tpu_torch.ops.symbol_timing import (comb_acquire,
                                                           mm_timing_plain)
    alt = AltRdsReceiver(0, device="cuda")
    iq = torch.from_numpy(_alt_station()).cuda()[None]
    demod = alt.frontend(iq, alt.frontend.init_state(1))[0][0]
    bb = alt.baseband(demod)
    rng = np.random.default_rng(4)
    cases = [(bb, comb_acquire(bb, 16), 0.01)]
    for n, mu0 in ((3, 0.0), (40, 3.7), (5000, 0.5), (70_000, 0.0)):
        z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
            np.complex64)
        cases.append((torch.from_numpy(z).cuda(),
                      torch.tensor(mu0, device="cuda"), 0.05))
    for z, mu0, gain in cases:
        before = mm_timing_kernel.launches
        sk, nk = mm_timing_kernel(z, 16.0, gain, mu0)
        assert mm_timing_kernel.launches == before + 1
        assert nk.device.type == "cuda" and nk.dtype == torch.int32
        sp, npl = mm_timing_plain(z, 16.0, gain, mu0)
        assert int(nk) == int(npl)
        assert _snr(torch.view_as_real(sp), torch.view_as_real(sk)) > 100.0
        assert not sk[int(nk):].any()


def test_costas_scan_kernel_matches_plain(card):
    """Two rows of noisy BPSK with residual carriers, from a cold and from a
    carried carry, and a batch of 3 x 2 rows of 9 samples: derotated
    > 80 dB, freq_log and the carry within 1e-5 of the plain loop run on the
    same card tensors."""
    from real_time_sdr_tpu_torch.ops.costas import (CostasCarry,
                                                    costas_scan_plain)
    from real_time_sdr_tpu_torch.ops.cuda import costas_kernel
    rng = np.random.default_rng(5)
    for shape, f in (((2, 1200), 0.06), ((2, 1200), -0.02), ((3, 2, 9), 0.1),
                     ((1, 1), 0.0)):
        n = shape[-1]
        s = rng.choice([-1.0, 1.0], size=shape)
        z = s * np.exp(1j * (f * np.arange(n) + 0.7))
        z = torch.from_numpy((z + 0.05 * rng.standard_normal(shape)).astype(
            np.complex64)).cuda()
        carry = CostasCarry(
            torch.from_numpy(rng.uniform(0, 6.28, shape[:-1]).astype(
                np.float32)).cuda(),
            torch.full(shape[:-1], f, device="cuda"))
        before = costas_kernel.launches
        dk, fk, ck = costas_kernel(z, carry, 0.02, 1e-4)
        assert costas_kernel.launches == before + 1
        dp, fp, cp = costas_scan_plain(z, carry, 0.02, 1e-4)
        assert _snr(torch.view_as_real(dp), torch.view_as_real(dk)) > 80.0
        assert (fk - fp).abs().max().item() < 1e-5
        dph = (ck.phase - cp.phase).abs()
        assert torch.minimum(dph, 2 * math.pi - dph).max().item() < 1e-5
        assert (ck.freq - cp.freq).abs().max().item() < 1e-5


def test_alt_receiver_on_card_matches_cpu(card):
    """The alternative receiver on the card: the four kernels of its path
    launch once each, and its bits, PS and PI equal its CPU run's."""
    from real_time_sdr_tpu_torch.models.rds_alt import AltRdsReceiver
    from real_time_sdr_tpu_torch.ops.cuda import (costas_kernel,
                                                  mm_timing_kernel)
    iq = _alt_station()
    ks = (frontend_fused, fir_bank, mm_timing_kernel, costas_kernel)
    before = [k.launches for k in ks]
    dec, diag = AltRdsReceiver(0, device="cuda").decode(iq)
    assert [k.launches - b for k, b in zip(ks, before)] == [1, 1, 1, 1]
    ref, rdiag = AltRdsReceiver(0, device="cpu").decode(iq)
    assert dec.events.ps_name == ref.events.ps_name == "ALT-PATH"
    assert dec.events.pi == 0x2ABC
    np.testing.assert_array_equal(diag.bits, rdiag.bits)


@pytest.mark.parametrize("path, dtype", [("two_stage", "bf16"),
                                         ("fused", "bf16"),
                                         ("fused", "bf16x2")])
def test_wideband_precision_on_card_matches_cpu(card, path, dtype):
    """A bf16 / bf16x2 frontend on the card against the same frontend on
    the CPU, four FM stations at 9.6 MS/s (a constant-envelope multiplex:
    on noise the discriminator divides by an envelope near zero, and two
    summation orders part by more than rounding) over two chained
    one-block segments:
    the card's fold product (one tensor-core GEMM with an f32 result)
    returns float32 and agrees with the CPU's plain version (both operands
    upcast to f32) to > 90 dB; the fused demod > 90 dB, the two-stage u8
    within 1 LSB on < 1 % of bytes; the state stays f32 / int32."""
    from real_time_sdr_tpu_torch.models.channelizer import (
        fold_product, fold_product_plain)
    from real_time_sdr_tpu_torch.models.wideband_frontend import (
        FusedWidebandFrontend, u8_to_rails)
    rx, _ = card
    cfg = rx.cfg
    wide_fs = 4 * cfg.rf_fs
    offs = [-450_000, -150_000, 150_000, 450_000]
    cls = Channelizer if path == "two_stage" else FusedWidebandFrontend
    fe_gpu = cls(cfg, wide_fs, offs, compute_dtype=dtype, device="cuda")
    fe_cpu = cls(cfg, wide_fs, offs, compute_dtype=dtype, device="cpu")
    scene = [dict(offset_hz=f, ps_name=f"CARD-{k}  ", pi=0x5100 + k)
             for k, f in enumerate(offs)]
    iw, qw, _ = synth.wideband_iq(cfg, wide_fs, scene, 2)
    x = np.empty(2 * len(iw), np.float32)
    x[0::2], x[1::2] = iw, qw
    raw = torch.from_numpy(np.clip(np.round(128 + 127 * x), 0, 255).astype(
        np.uint8)).reshape(2, -1)                     # two one-block segments
    gen = torch.Generator().manual_seed(12)
    sg, sc = fe_gpu.init_state(), fe_cpu.init_state()
    for k in range(2):
        rails = u8_to_rails(raw[k])
        if path == "fused":
            yg, sg = fe_gpu(*(r.cuda() for r in rails), sg)
            yc, sc = fe_cpu(*rails, sc)
            assert yg.dtype == torch.float32 and _snr(yc, yg) > 90.0
        else:
            yg, sg = fe_gpu.call_u8(*(r.cuda() for r in rails), sg)
            yc, sc = fe_cpu.call_u8(*rails, sc)
            d = (yg.cpu().int() - yc.int()).abs()
            assert d.max() <= 1 and (d != 0).float().mean() < 0.01
        assert {t.dtype for t in sg} <= {torch.float32, torch.int32}
    w = fe_gpu.fold_W if path == "two_stage" else fe_gpu.w
    fr = torch.randn((300, w.shape[0]), generator=gen).to(torch.bfloat16)
    y = fold_product(fr.cuda(), w)
    assert y.dtype == torch.float32
    assert _snr(fold_product_plain(fr, w.cpu()), y) > 90.0


def _mm_against_plain(z, mu0, gain):
    """mm_timing's kernel against the plain loop on the same card tensors:
    n_valid equal, symbols > 100 dB and bit-identical, one launch."""
    from real_time_sdr_tpu_torch.ops.cuda import mm_timing_kernel
    from real_time_sdr_tpu_torch.ops.symbol_timing import mm_timing_plain
    z = torch.from_numpy(np.asarray(z, np.complex64)).cuda()
    mu0 = torch.tensor(mu0, dtype=torch.float32, device="cuda")
    before = mm_timing_kernel.launches
    sk, nk = mm_timing_kernel(z, 16.0, gain, mu0)
    assert mm_timing_kernel.launches == before + 1
    sp, npl = mm_timing_plain(z, 16.0, gain, mu0)
    assert int(nk) == int(npl)
    assert _snr(torch.view_as_real(sp), torch.view_as_real(sk)) > 100.0
    assert torch.equal(sk, sp)
    return int(nk), sk.shape[0]


@pytest.mark.parametrize("case", ["noise_gain_0.5", "mu0_-3.2", "mu0_37.9",
                                  "tile_edges", "tile_edges_long",
                                  "n_max_cap"])
def test_mm_timing_kernel_general_steps(card, case):
    """The redesigned kernel's general step, where the advance leaves the
    fast step's window of three candidate pairs: noise at gain 0.5, a first
    step from mu0 = -3.2 (clamped reads) and 37.9, walks over n = 3*2048 + 5
    and 3*8192 + 5 samples (3 and 12 edges of the kernel's 2,048-sample
    staged tiles), and a falling ramp whose negative error
    shortens every advance until the walk fills its n_max buffer; each
    against the plain loop (n_valid equal, > 100 dB, bit-identical, and
    zeros after the last symbol)."""
    rng = np.random.default_rng(6)

    def noise(n):
        return rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z, mu0, gain = {
        "noise_gain_0.5": (noise(20_000), 0.5, 0.5),
        "mu0_-3.2": (noise(5_000), -3.2, 0.05),
        "mu0_37.9": (noise(5_000), 37.9, 0.05),
        "tile_edges": (noise(3 * 2048 + 5), 0.3, 0.05),
        "tile_edges_long": (noise(3 * 8192 + 5), 0.3, 0.05),
        "n_max_cap": (1000.0 - 0.05 * np.arange(20_000) + 0j, 0.0, 0.5),
    }[case]
    n_valid, n_max = _mm_against_plain(z, mu0, gain)
    if case == "n_max_cap":
        assert n_valid == n_max


def test_costas_scan_kernel_phases_near_0_and_2pi(card):
    """Carried phases next to 0 and 2*pi (and -0.0, 2*pi itself, outside
    [0, 2*pi]) with frequencies that send x below 0, past 2*pi, inside the
    range and out of (-2*pi, 4*pi): every branch of the modulo and the
    general step's regroup; derotated > 80 dB, freq_log and the carry within
    1e-5 of the plain loop, and bit-identical."""
    from real_time_sdr_tpu_torch.ops.costas import (CostasCarry,
                                                    costas_scan_plain)
    from real_time_sdr_tpu_torch.ops.cuda import costas_kernel
    m = np.float32(2 * np.pi)
    phase = np.array([0.0, -0.0, 1e-30, 1e-7, np.nextafter(m, 0), m,
                      np.nextafter(m, 7), -0.3, 7.0, 100.0, 3.0],
                     np.float32)
    freq = np.array([0.0, -1e-7, -1e-6, -0.01, 1e-6, 0.0, 0.01, 0.05, -0.05,
                     0.0, 9.0], np.float32)
    rng = np.random.default_rng(7)
    z = (np.exp(1j * rng.uniform(0, 6.3, (len(phase), 43)))
         * rng.choice([0.5, 1.0, 2.0], (len(phase), 43))).astype(np.complex64)
    z = torch.from_numpy(z).cuda()
    carry = CostasCarry(torch.from_numpy(phase).cuda(),
                        torch.from_numpy(freq).cuda())
    dk, fk, ck = costas_kernel(z, carry, 0.02, 1e-4)
    dp, fp, cp = costas_scan_plain(z, carry, 0.02, 1e-4)
    assert _snr(torch.view_as_real(dp), torch.view_as_real(dk)) > 80.0
    assert (fk - fp).abs().max().item() < 1e-5
    dph = (ck.phase - cp.phase).abs()
    assert torch.minimum(dph, 2 * math.pi - dph).max().item() < 1e-5
    assert torch.equal(dk, dp) and torch.equal(fk, fp)
    assert torch.equal(ck.phase, cp.phase) and torch.equal(ck.freq, cp.freq)


def test_costas_scan_kernel_4096_rows(card):
    """A batch of 4,096 rows x 1,200 samples (64 blocks of 64 threads):
    derotated > 80 dB, freq_log and the carry within 1e-5 of the plain
    loop."""
    from real_time_sdr_tpu_torch.ops.costas import (CostasCarry,
                                                    costas_scan_plain)
    from real_time_sdr_tpu_torch.ops.cuda import costas_kernel
    rng = np.random.default_rng(8)
    f = rng.uniform(-0.05, 0.05, (4096, 1))
    z = (rng.choice([-1.0, 1.0], (4096, 1200))
         * np.exp(1j * (f * np.arange(1200) + 0.7))
         + 0.05 * rng.standard_normal((4096, 1200)))
    z = torch.from_numpy(z.astype(np.complex64)).cuda()
    carry = CostasCarry(
        torch.from_numpy(rng.uniform(0, 6.28, 4096).astype(np.float32)).cuda(),
        torch.from_numpy(f[:, 0].astype(np.float32)).cuda())
    dk, fk, ck = costas_kernel(z, carry, 0.02, 1e-4)
    dp, fp, cp = costas_scan_plain(z, carry, 0.02, 1e-4)
    assert _snr(torch.view_as_real(dp), torch.view_as_real(dk)) > 80.0
    assert (fk - fp).abs().max().item() < 1e-5
    dph = (ck.phase - cp.phase).abs()
    assert torch.minimum(dph, 2 * math.pi - dph).max().item() < 1e-5
    assert (ck.freq - cp.freq).abs().max().item() < 1e-5


def test_costas_sincos_matches_sincosf_everywhere(card):
    """The kernel's sine and cosine of the carried phase equal the
    library's accurate sincosf(-p) for every f32 p in [0, 2*pi]
    (1,086,918,620 values): 0 ulp."""
    from real_time_sdr_tpu_torch.ops.cuda.costas_scan import sincos_max_ulp
    res = sincos_max_ulp()
    assert res["values"] == 1_086_918_620
    assert res["max_ulp_sin"] == res["max_ulp_cos"] == 0
    assert res["values_differing"] == 0


# the wideband frontends on noise, card against CPU: what each stage must
# hold. Before the discriminator (the fused fold product y, the two-stage
# rails) every precision holds 90 dB; the discriminator then divides by
# envelopes near zero, so the demod keeps what y has less ~36 dB
# (chip_smoke.py phase 3b, NVIDIA H100 80GB HBM3, 700 W: f32 y 128.7 dB ->
# demod 92.6 dB; bf16 122.4 -> 86.8; bf16x2 122.4 -> 86.1)
NOISE_DEMOD_DB = {"f32": 90.0, "bf16": 80.0, "bf16x2": 80.0}


@pytest.mark.parametrize("path, dtype", [("two_stage", "f32"),
                                         ("two_stage", "bf16"),
                                         ("fused", "f32"), ("fused", "bf16"),
                                         ("fused", "bf16x2")])
def test_wideband_precision_on_noise_card_matches_cpu(card, path, dtype):
    """Seeded random u8 bytes (4 stations at 9.6 MS/s, two chained
    one-block segments) through a wideband frontend on the card and on the
    CPU: the stages before the discriminator agree to > 90 dB at every
    precision (the fused fold product's f32 result y; the two-stage complex
    station rails of ``forward``), where a fault in the bf16 operands (the
    K padding, the hi/lo split) would cost tens of dB; the fused demod to
    NOISE_DEMOD_DB. On noise the bf16 forms' y sits ~6 dB further from the
    CPU's than f32's (the tensor-core product sums its exact products in
    another way than the CPU's f32 matmul), and the discriminator carries
    that gap to the demod."""
    from real_time_sdr_tpu_torch.models.channelizer import fold_product
    from real_time_sdr_tpu_torch.models.wideband_frontend import (
        FusedWidebandFrontend, u8_to_rails)
    rx, _ = card
    cfg = rx.cfg
    offs = [-450_000, -150_000, 150_000, 450_000]
    cls = Channelizer if path == "two_stage" else FusedWidebandFrontend
    fes = [cls(cfg, 4 * cfg.rf_fs, offs, compute_dtype=dtype, device=d)
           for d in ("cuda", "cpu")]
    raw = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (2, 8 * cfg.block_size_iq), dtype=np.uint8))
    states = [fe.init_state() for fe in fes]
    for seg in raw:
        outs = []
        for k, (fe, d) in enumerate(zip(fes, ("cuda", "cpu"))):
            i, q = u8_to_rails(seg.to(d))
            st = states[k]
            if path == "fused":
                y = fold_product(fe.frames(torch.cat([st.i_tail, i]),
                                           torch.cat([st.q_tail, q])), fe.w)
                demod, states[k] = fe(i, q, st)
                outs.append((y, demod))
            else:
                (i_ds, q_ds), states[k] = fe(i, q, st)
                outs.append((torch.stack([i_ds, q_ds]),))
        (g, c) = outs
        assert _snr(c[0], g[0]) > 90.0
        if path == "fused":
            assert _snr(c[1], g[1]) > NOISE_DEMOD_DB[dtype]


# -- the serving entries as captured CUDA graphs ------------------------------

def _tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _tree_leaves(t)]


def _trees_equal(a, b):
    la, lb = _tree_leaves(a), _tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _graph_rows(rx, channels, n_blocks, seed):
    """(channels, n_blocks blocks) u8 of one station with shifts, on the
    card."""
    iq, _ = synth.station_iq(rx.cfg, n_blocks + 2, ps_name="GRAPHCRD")
    pairs = iq.reshape(-1, 2)
    n = n_blocks * 2 * rx.cfg.block_size_iq
    rows = np.stack([np.roll(pairs, -(seed + 811 * c), axis=0).reshape(-1)[:n]
                     for c in range(channels)])
    return torch.from_numpy(rows).cuda()


@pytest.mark.parametrize("tier", [1, 2, 3])
def test_graphed_receiver_entries_equal_eager(card, tier):
    """jit_step, jit_run_segment_staged and jit_run_blocks replay captured
    graphs: three chained calls of each (4 channels x 2 blocks) equal the
    eager functions in every output leaf and the state, the kernels'
    launch counts rise as eagerly, and what a call returned is unchanged
    after the later calls."""
    from real_time_sdr_tpu_torch.utils import graphs
    rx = Receiver(0, stereo=True, rds=True, pll_tier=tier, device="cuda")
    blk = 2 * rx.cfg.block_size_iq
    x = _graph_rows(rx, 4, 6, seed=tier)
    segs = [x[:, k * 2 * blk:(k + 1) * 2 * blk].contiguous()
            for k in range(3)]
    tl = rx.frontend.tail_len
    n2 = 2 * blk

    def staged_cells(st0):
        prev, cells = st0.frontend.iq_tail, []
        for s in segs:
            cells.append(torch.cat([prev, s], 1).contiguous())
            prev = s[:, n2 - tl:]
        return cells

    s0 = rx.init_state(4)
    cases = {
        "step": (rx.step, rx.jit_step, [(s,) for s in segs]),
        "staged": (rx.run_segment_staged, rx.jit_run_segment_staged,
                   [(c, n2) for c in staged_cells(s0)]),
        "blocks": (rx.run_blocks, rx.jit_run_blocks,
                   [(s.reshape(4, 2, blk),) for s in segs]),
    }
    for name, (eager, jit, args) in cases.items():
        c0 = graphs.launch_counts()
        st, ref = s0, []
        for a in args:
            st, out = eager(st, *a)
            ref.append((st, out))
        c1 = graphs.launch_counts()
        st, got = s0, []
        for a in args:
            st, out = jit(st, *a)
            got.append((st, out, [t.clone() for t in _tree_leaves((st,
                                                                   out))]))
        c2 = graphs.launch_counts()
        torch.cuda.synchronize()
        for (st_e, out_e), (st_g, out_g, _) in zip(ref, got):
            assert _trees_equal((st_e, out_e), (st_g, out_g)), name
        for st_g, out_g, kept in got:
            assert all(torch.equal(a, b) for a, b in
                       zip(_tree_leaves((st_g, out_g)), kept)), name
        assert {k: c1[k] - c0[k] for k in c0} == {
            k: c2[k] - c1[k] for k in c0}, name
        assert c2[("frontend_fused", None)] > c1[("frontend_fused", None)]
    assert len(rx.graphs) == 3


def test_graphed_bank_entries_equal_eager(card):
    """run_segment_grouped (8 channels, group 4) equals its eager form bit
    for bit and run_segment to > 100 dB with the RDS bits equal (a
    reduction's split over the rows may follow the batch on the card);
    run_wideband_u8_jit through both frontends (4 stations at 9.6 MS/s,
    two chained one-block segments) equals its eager function."""
    from real_time_sdr_tpu_torch.models.wideband_frontend import \
        FusedWidebandFrontend
    from real_time_sdr_tpu_torch.parallel.channel import grouped_step
    rx, _ = card
    bank = ChannelBank(rx, 8)
    x = _graph_rows(rx, 8, 2, seed=5)
    s0 = bank.init_state()
    eager = grouped_step(rx, 4, s0, x)
    for _ in range(2):
        assert _trees_equal(bank.run_segment_grouped(s0, x, group=4), eager)
    _, whole = bank.run_segment(s0, x)
    for rail in ("left", "right"):
        for c in range(8):
            assert _snr(getattr(whole, rail)[c],
                        getattr(eager[1], rail)[c]) > 100.0
    assert torch.equal(whole.rds_bits, eager[1].rds_bits)
    assert torch.equal(whole.rds_nbits, eager[1].rds_nbits)
    offs = [-450_000, -150_000, 150_000, 450_000]
    scene = [dict(offset_hz=o, ps_name=f"GR-{k}    ", pi=0x7200 + k)
             for k, o in enumerate(offs)]
    wide_fs = 4 * rx.cfg.rf_fs
    iw, qw, _ = synth.wideband_iq(rx.cfg, wide_fs, scene, 2)
    raw = np.empty(2 * len(iw), np.float32)
    raw[0::2], raw[1::2] = iw, qw
    raw = torch.from_numpy(np.clip(np.round(128 + 127 * raw), 0, 255)
                           .astype(np.uint8)).cuda()
    half = raw.shape[0] // 2
    wb = ChannelBank(rx, 4)
    for fe in (Channelizer(rx.cfg, wide_fs, offs),
               FusedWidebandFrontend(rx.cfg, wide_fs, offs)):
        se, fse = wb.init_state(), fe.init_state()
        sg, fsg = se, fse
        for seg in (raw[:half], raw[half:]):
            se, oe, fse = wb.run_wideband_u8(se, fe, seg, fse)
            sg, og, fsg = wb.run_wideband_u8_jit(sg, fe, seg, fsg)
            assert _trees_equal((se, oe, fse), (sg, og, fsg)), type(fe)



def test_graphed_parallel_entries_equal_eager(card):
    """The entries graphed last, each twice against its eager form bit for
    bit, with the kernels' launch counts rising as eagerly: the bank's
    own step / run_segment / run / run_segment_demod (4 channels), the
    digest steps, time sharding (exact with both timings, approximate at
    tier 1, joint), each shard's wideband step over two replicas of the
    card, and the alternative decode's device half."""
    from real_time_sdr_tpu_torch.models.rds_alt import AltRdsReceiver
    from real_time_sdr_tpu_torch.models.wideband_frontend import \
        FusedWidebandFrontend
    from real_time_sdr_tpu_torch.parallel import time_shard as tts
    from real_time_sdr_tpu_torch.parallel.wideband import (
        ShardedFusedWideband, ShardedWideband)
    from real_time_sdr_tpu_torch.utils import benchkit, graphs
    rx, _ = card
    blk = 2 * rx.cfg.block_size_iq
    x = _graph_rows(rx, 4, 8, seed=7)
    bank, s0 = ChannelBank(rx, 4), rx.init_state(4)
    demod, _ = rx.frontend(x[:, :2 * blk], s0.frontend)
    xp = torch.cat([s0.frontend.iq_tail, x[:, :2 * blk]], 1).contiguous()
    sharded = {}
    for tier, timing in ((3, "comb"), (3, "tracked"), (1, "comb")):
        r = Receiver(0, stereo=True, rds=True, pll_tier=tier,
                     rds_timing=timing, device="cuda")
        sharded[tier, timing] = (
            lambda r=r: tts._sharded_run(r, x[:1].reshape(1, 8, blk), 4, 1,
                                         None, [[r.device]], None),
            lambda r=r: tts._sharded_run(r, x[:1].reshape(1, 8, blk), 4, 1,
                                         None, [[r.device]], None,
                                         graphed=True))
    cases = {
        "step": (lambda: bank._step(s0, x[:, :blk].contiguous()),
                 lambda: bank.step(s0, x[:, :blk].contiguous())),
        "run_segment": (lambda: bank._step(s0, x[:, :2 * blk]),
                        lambda: bank.run_segment(s0, x[:, :2 * blk])),
        "run": (lambda: bank._run(s0, x.reshape(4, 8, blk)[:, :3]
                                  .transpose(0, 1).contiguous()),
                lambda: bank.run(s0, x.reshape(4, 8, blk)[:, :3]
                                 .transpose(0, 1).contiguous())),
        "run_segment_demod": (lambda: bank._run_segment_demod(s0, demod),
                              lambda: bank.run_segment_demod(s0, demod)),
        "digest": (lambda: benchkit._digest_fn(rx, s0, x[:, :2 * blk]),
                   lambda: benchkit.digest_step(rx)(s0, x[:, :2 * blk])),
        "digest_staged": (
            lambda: benchkit._digest_staged_fn(rx, 2 * blk, s0, xp),
            lambda: benchkit.digest_step_staged(rx, 2 * blk)(s0, xp)),
        "time_sharded_bank": (
            lambda: tts._sharded_run(rx, x[:2].reshape(2, 8, blk), 4, 1,
                                     True, [[rx.device]], None),
            lambda: tts.time_sharded_run_bank(rx, x[:2].reshape(2, 8, blk),
                                              4)),
        **{f"time_sharded_tier{t}_{m}": f for (t, m), f in sharded.items()},
    }
    wide_fs = 4 * rx.cfg.rf_fs
    offs = [-450_000, -150_000, 150_000, 450_000]
    iw, qw, _ = synth.wideband_iq(rx.cfg, wide_fs, [
        dict(offset_hz=o, ps_name=f"CRD-{k}   ") for k, o in enumerate(offs)],
        1)
    iw, qw = torch.from_numpy(iw).cuda(), torch.from_numpy(qw).cuda()
    for cls, fe in ((ShardedWideband, Channelizer(rx.cfg, wide_fs, offs)),
                    (ShardedFusedWideband,
                     FusedWidebandFrontend(rx.cfg, wide_fs, offs))):
        sw = cls(fe, rx, devices=["cuda", "cuda"])
        fs, bs = sw.init_state()
        cases[cls.__name__] = (
            lambda sw=sw, fs=fs, bs=bs: tuple(zip(*(
                sw._step_one(k, fs[k], bs[k], iw, qw) for k in range(2)))),
            lambda sw=sw, fs=fs, bs=bs: sw.step(fs, bs, iw, qw))
    alt = AltRdsReceiver(0, device="cuda")
    aiq = torch.from_numpy(synth.station_iq(rx.cfg, 8)[0]).cuda()[None]
    cases["alt_decode"] = (
        lambda: alt._device_half(aiq),
        lambda: alt.graphs(alt._device_half, ("decode",), aiq))
    for name, (eager, graphed) in cases.items():
        c0 = graphs.launch_counts()
        ref = eager()
        c1 = graphs.launch_counts()
        for _ in range(2):
            assert _trees_equal(graphed(), ref), name
        c2 = graphs.launch_counts()
        assert {k: 2 * (c1[k] - c0[k]) for k in c0} == {
            k: c2[k] - c1[k] for k in c0}, name

@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16x2"])
def test_retune_between_replays_takes_effect(card, dtype):
    """A retune of the fused frontend between two replays rewrites the
    weight buffers the graph reads: the next replay equals the eager run
    on the retuned grid, and differs from a replay on the old grid."""
    from real_time_sdr_tpu_torch.models.wideband_frontend import \
        FusedWidebandFrontend
    rx, _ = card
    offs = [-450_000, -150_000, 150_000, 450_000]
    wide_fs = 4 * rx.cfg.rf_fs
    scene = [dict(offset_hz=150_000, ps_name="RETUNE  ", pi=0x7300)]
    iw, qw, _ = synth.wideband_iq(rx.cfg, wide_fs, scene, 2)
    raw = np.empty(2 * len(iw), np.float32)
    raw[0::2], raw[1::2] = iw, qw
    raw = torch.from_numpy(np.clip(np.round(128 + 127 * raw), 0, 255)
                           .astype(np.uint8)).cuda()
    half = raw.shape[0] // 2
    wb = ChannelBank(rx, 4)
    fe = FusedWidebandFrontend(rx.cfg, wide_fs, offs, compute_dtype=dtype)
    ptrs = [fe.w.data_ptr(), fe.pc.data_ptr(), fe.ps.data_ptr()]
    st, o0, fst = wb.run_wideband_u8_jit(wb.init_state(), fe, raw[:half],
                                         fe.init_state())
    _, old, _ = wb.run_wideband_u8_jit(st, fe, raw[half:], fst)
    fe.retune(0, 150_000)
    assert [fe.w.data_ptr(), fe.pc.data_ptr(), fe.ps.data_ptr()] == ptrs
    _, got, _ = wb.run_wideband_u8_jit(st, fe, raw[half:], fst)
    _, want, _ = wb.run_wideband_u8(st, fe, raw[half:], fst)
    assert _trees_equal(got, want)
    assert not torch.equal(got.left[0], old.left[0])
    assert torch.equal(got.left[1:], old.left[1:])


def test_capture_of_a_host_sync_raises(card):
    """A function that reads a value back on the host (.item()) cannot be
    captured: the cache raises GraphCaptureError, keeps no graph, and does
    not run the function eagerly in its place; the card works on."""
    from real_time_sdr_tpu_torch.utils.graphs import (GraphCache,
                                                      GraphCaptureError)
    cache, runs = GraphCache(), []

    def reads_back(x):
        runs.append(1)
        return x * float((x * 2).sum().item())

    x = torch.ones(4, device="cuda")
    with pytest.raises(GraphCaptureError, match="item"):
        cache(reads_back, ("reads_back",), x)
    assert len(cache) == 0 and len(runs) == 2     # warm-up, capture
    assert torch.ones(2, device="cuda").sum().item() == 2.0
