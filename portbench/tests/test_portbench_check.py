"""The check's parts on the CPU: the reference chain against the port's
receiver (what the limits rest on), the bf16 control's distance from it,
the RDS verdict on made-up event streams, and the sampling's seeding."""

from __future__ import annotations

import functools
import json
import os

import numpy as np
import pytest
import torch

from portbench.core import check
from portbench.core.manifest import PKG
from portbench.reference.chain import WARM_BLOCKS, ReferenceChain, rel_err
from portbench.traffic import generator

with open(os.path.join(PKG, "configs", "listener_mode0.json")) as f:
    CFG = json.load(f)
RX = CFG["receiver"]
N_BLOCKS = WARM_BLOCKS + 2


@pytest.fixture(scope="module")
def served():
    """The port's one-station receiver (tier 1, stereo + RDS) on the CPU
    over a seeded station: (capture, PCM per block)."""
    from real_time_sdr_tpu_torch.models.receiver import Receiver
    from real_time_sdr_tpu_torch.utils.audio import stereo_pcm
    st = generator.draw_stations(2**31 + 11, 1, 8)
    cap = generator.capture(st, [0], RX["rf_fs"], 38, 0.99, "cpu")
    rx = Receiver(0, stereo=True, rds=True, pll_tier=1, device="cpu")
    state, blk, pcms = rx.init_state(1), 2 * RX["block_size_iq"], []
    for b in range(N_BLOCKS):
        state, out = rx.step(state, torch.from_numpy(
            cap[None, b * blk:(b + 1) * blk]))
        pcms.append(stereo_pcm(out.left, out.right)[0].numpy())
    return cap, pcms


def _items(cap, pcms):
    return [(0, j, pcms[j].tobytes()) for j in range(WARM_BLOCKS, N_BLOCKS)]


def test_reference_agrees_with_the_port(served):
    cap, pcms = served
    num = check.pcm_numbers(RX, _items(cap, pcms),
                            check.listener_demod_of(CFG, [cap]))
    assert num["compared"] == N_BLOCKS - WARM_BLOCKS
    assert num["pcm_rel_err"] < 3e-5


def test_bf16_control_is_far_from_the_reference(served):
    cap, pcms = served
    num = check.pcm_numbers(RX, _items(cap, pcms),
                            check.listener_demod_of(CFG, [cap]),
                            control=True)
    assert num["pcm_rel_err"] > 1e-3


def test_median_is_steady_against_one_block():
    """One block far off moves the worst block's error, not the median
    over the compared blocks, which the band cell compares."""
    fm = np.random.default_rng(5).normal(0.0, 0.3, (4, 3 * 7350))
    items = [(0, j, b"") for j in range(4)]
    ref = check.reference_pcm(RX, items, lambda ch, it: fm[it[1]])
    off = ref.copy()
    off[2, 500:520] += 90
    prog = [(0, j, off[j].tobytes()) for j in range(4)]
    num = check.pcm_numbers(RX, prog, lambda ch, it: fm[it[1]])
    assert num["pcm_rel_err_median"] == 0.0
    assert num["pcm_rel_err"] > 1e-3 and num["worst"] == [0, 2]


def test_pilot_sign_at_a_zero_crossing_moves_the_carrier():
    """The phase detector turns by pi with the pilot's sign: one sample
    that lies within rounding of zero, read with the other sign, jolts
    the locked loop (why one block in several hundred reads ~4e-4 in a
    sound float32 program; PERF.md)."""
    from portbench.reference.chain import pll
    fs, f = RX["if_fs"], RX["pilot_freq"]
    x = 0.05 * np.cos(2 * np.pi * f / fs * np.arange(4000) + 0.3)
    i = 3000 + int(np.argmin(np.abs(x[3000:3100])))
    a, b = x.copy(), x.copy()
    a[i], b[i] = 1e-9, -1e-9
    ca, cb = (pll(v, f, fs, 2.0, RX["pll_bw_stereo"])[0] for v in (a, b))
    assert np.array_equal(ca[:i + 1], cb[:i + 1])
    assert np.abs(ca - cb).max() > 0.05
    assert np.abs(ca - cb)[-200:].max() < 1e-3


def test_bf16_round():
    from portbench.reference.chain import bf16_round
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 3.14159])
    assert list(bf16_round(x)) == [1.0, 1.0, 1.0 + 4 * 2**-8, 3.140625]
    t = torch.tensor(x, dtype=torch.float64)
    assert np.array_equal(bf16_round(x),
                          t.to(torch.bfloat16).double().numpy())


def test_rel_err():
    a = np.array([3, -4], dtype=np.int16)
    assert rel_err(a, a) == 0.0
    assert rel_err(np.array([3, -3]), a) == pytest.approx(1 / 5)


def test_rds_wrong_reasons():
    truths = [dict(pi=0x1234, ps="ABCDEFGH"), dict(pi=0x4321, ps="ZZZZZZZZ"),
              dict(pi=0x1111, ps="QQQQQQQQ"), dict(pi=0x2222, ps="WWWWWWWW")]
    groups = {0: [(1.0, 0x1234), (8.0, 0x1235), (9.0, 0x1234)],
              1: [(1.0, 0x4322), (9.0, 0x4322)],
              2: [(1.0, 0x1111)],
              3: [(9.0, 0x2222)]}
    names = {0: ["  CD    ", "ABCDEFGH", "ABCDEFGH", "ABCXEFGH"],
             1: ["ZZZZZZZZ"], 2: ["QQQQQQQQ"], 3: ["WWWWWWWX"]}
    n, bad, share = check.rds_wrong(truths, groups, names, t_half=5.0)
    assert n == 3 and [b[0] for b in bad] == [1, 2, 3]
    assert bad[0][1]["pi"] == 0x4322 and bad[1][1]["after_half"] == 0
    assert bad[2][1]["ps"] == "WWWWWWWX"
    assert share == pytest.approx(100 * 3 / 7)


def test_verdict():
    ok, checks = check.verdict(dict(pcm_rel_err=1e-5, rds_wrong=0),
                               dict(pcm_rel_err=5e-5, rds_wrong=0))
    assert ok and list(checks) == ["pcm_rel_err", "rds_wrong"]
    assert not check.verdict(dict(pcm_rel_err=None), dict(pcm_rel_err=1))[0]
    assert not check.verdict(dict(rds_wrong=1), dict(rds_wrong=0))[0]


def test_sampling_is_seeded():
    a = check.sample_plan(2**33 + 5, 64, [0, 63], 8, 37)
    assert a == check.sample_plan(2**33 + 5, 64, [0, 63], 8, 37)
    assert set(a) >= {0, 63} and len(a) == 8
    assert all(m == 37 and 0 <= r < 37 for m, r in a.values())
    kept = [{j: b"x" for j in range(40)} for _ in range(3)]
    pick = functools.partial(check.choose, 9, kept)
    assert pick(lambda s, j: True) == pick(lambda s, j: True)
    assert all(j >= WARM_BLOCKS for _, j, _ in pick(lambda s, j: True))


def test_capture_is_one_period():
    """Whole RDS groups, tones, pilot and offsets in one capture: 38
    groups are 3.328 s at any of the cells' rates."""
    for fs in (2_400_000, 4_800_000, 19_200_000):
        n = generator.cycle_samples(fs, 38)
        assert n * 2375 == 38 * 104 * 2 * fs
        assert (125 * n) % fs == 0 and (150_000 * n) % fs == 0
    with pytest.raises(ValueError):
        generator.cycle_samples(2_400_000, 37)


def test_generator_same_sizes_every_seed():
    a = generator.draw_stations(1, 5, 16)
    b = generator.draw_stations(2**31 + 99, 5, 16)
    assert [len(s["ps"]) for s in a] == [len(s["ps"]) for s in b]
    assert a != b and a == generator.draw_stations(1, 5, 16)
    bits = generator.group_bits([0x1234, 0, 0, 0])
    assert len(bits) == 104
    ch = ReferenceChain(RX)
    assert ch.audio_h.shape == (RX["rf_taps"],)
