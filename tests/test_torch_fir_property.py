"""The port's polyphase FIRs over random geometries, and the general FIR-bank
body's host-side plan.

Twin of tests/test_fir_property.py: the same 12 seeds and the same
``_random_geometry`` generator, two carried blocks each. The port's
``PolyFIR`` and a one-filter ``FIRBank`` (on the CPU: the kernel wrapper's
plain version) against the golden loop oracle (``golden.dsp.fir_block`` /
``fir_resample_block``, float64) at > 100 dB, the JAX test's bound, and
against the JAX package's ``PolyFIR`` on the same numpy input at > 110 dB
(f32 against f32 in another summation order), the carried tails equal.

The general body of ``csrc/fir_bank.cu`` reads the taps phase-major
(``phase_major``) and runs on a tile that ``general_plan`` picks on the
host (the lines tile or the direct one); both are checked here: the table
read back through the phase formula, and each plan's windows, tap streams
or tap rows walked block by block as the kernel walks them, covering every
output once inside the plan's shared memory. A float64 walk of those
blocks reproduces the plain version's outputs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden import dsp
from real_time_sdr_tpu.ops.fir import PolyFIR as JPolyFIR
from real_time_sdr_tpu.ops.fir import init_state as j_init_state
from real_time_sdr_tpu_torch.ops import fir as tfir
from real_time_sdr_tpu_torch.ops.cuda.fir_bank import (GEN_COLS,
                                                       BankGeometry,
                                                       blocks_per_sm,
                                                       check_geometry,
                                                       direct_plan,
                                                       fir_bank_plain,
                                                       general_plan,
                                                       kernel_body,
                                                       lines_plan,
                                                       outputs_per_group,
                                                       phase_major,
                                                       window_bound)
from real_time_sdr_tpu_torch.utils import fir_bank_phases, fir_digest
from test_fir_property import _random_geometry


def _snr(ref, y) -> float:
    ref, y = np.asarray(ref, np.float64), np.asarray(y, np.float64)
    err = np.sqrt(np.mean((y - ref) ** 2))
    scale = np.sqrt(np.mean(ref ** 2)) or 1.0
    return 20 * math.log10(scale / max(err, 1e-300))


@pytest.mark.parametrize("seed", range(12))
def test_port_polyfir_matches_golden_and_jax_random_geometry(seed):
    rng = np.random.default_rng(1000 + seed)
    up, down, taps, n = _random_geometry(rng)
    h = rng.standard_normal(taps) / np.sqrt(taps)
    fir = tfir.PolyFIR(h, up=up, down=down)
    bank = tfir.make_bank([fir])
    jfir = JPolyFIR(h, up=up, down=down)
    tail = torch.zeros((fir.tail_len,))
    btail = torch.zeros((fir.tail_len,))
    jtail = j_init_state(taps, up)
    g_state = np.zeros(fir.tail_len)

    for block in range(2):  # the second block reads the carried tail
        x = rng.standard_normal(n)
        x32 = x.astype(np.float32)
        y, tail = fir(torch.from_numpy(x32), tail)
        (yb,), btail = bank(torch.from_numpy(x32), btail)
        yj, jtail = jfir(jnp.asarray(x32), jtail)
        if up == 1:
            y_ref, g_state = dsp.fir_block(x, h, g_state, down)
        else:
            y_ref, g_state = dsp.fir_resample_block(x, h, g_state, up, down)
        case = (up, down, taps, n, block)
        assert y.shape == yb.shape == y_ref.shape == np.shape(yj), case
        assert _snr(y_ref, y.numpy()) > 100, case
        assert _snr(y_ref, yb.numpy()) > 100, case
        assert _snr(np.asarray(yj), y.numpy()) > 110, case
        assert _snr(np.asarray(yj), yb.numpy()) > 110, case
        np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
        np.testing.assert_array_equal(btail.numpy(), np.asarray(jtail))


@pytest.mark.parametrize("seed", range(12))
def test_phase_major_reads_back_through_the_phase_formula(seed):
    rng = np.random.default_rng(1000 + seed)
    up, down, k_taps, _ = _random_geometry(rng)
    nf = 1 + seed % 4
    k_taps += seed % up if up > 1 else 0    # phases of T-1 taps too
    taps = rng.standard_normal((nf, k_taps)).astype(np.float32)
    pt = phase_major(taps, up)
    T = -(-k_taps // up)
    assert pt.shape == (nf, up, T) and pt.flags.c_contiguous
    for f in range(nf):
        for p in range(up):
            for m in range(T):
                k = p + up * m
                assert pt[f, p, m] == (taps[f, k] if k < k_taps else 0.0)
    bank = tfir.make_bank([tfir.PolyFIR(h, up=up, down=down) for h in taps])
    assert torch.equal(bank.ptaps, torch.from_numpy(
        phase_major(bank.taps.numpy(), up)))
    assert "ptaps" not in bank.state_dict()


def _walk(plan, geom, rows, n_out, nf, xx=None, ptaps=None):
    """The plan's blocks, lines or direct tile."""
    walk = _walk_lines if plan.form == "lines" else _walk_direct
    return walk(plan, geom, rows, n_out, nf, xx, ptaps)


def _walk_direct(plan, geom, rows, n_out, nf, xx=None, ptaps=None):
    """The direct tile's blocks as csrc/fir_bank.cu walks them: checks
    each block's window and staged tap rows against the plan and returns
    how often each (row, filter, output) is written; with xx and ptaps
    also the outputs, summed in float64 over the block's window."""
    up, down, T = geom.up, geom.down, geom.T
    bo, g = plan.bo, math.gcd(up, down)
    assert bo in (32, 64, 128) and plan.ws % 4 == 0
    tiles = -(-n_out // bo)
    assert plan.grid == rows * tiles
    if plan.staged:
        assert plan.ts % 8 == 4 and plan.ts >= T
        assert plan.rows == up // g or plan.rows == bo < up // g
        assert plan.smem == 4 * (plan.ws + nf * plan.rows * plan.ts)
    else:
        assert plan.smem == 4 * plan.ws
    assert blocks_per_sm(plan.smem) >= 1
    writes = np.zeros((rows, nf, n_out), np.int64)
    y = None if xx is None else np.zeros((rows, nf, n_out))
    for blk in range(plan.grid):
        b, tile = divmod(blk, tiles)
        n0 = tile * bo
        cnt = min(bo, n_out - n0)
        q0 = n0 * down // up
        wsz = (n0 + cnt - 1) * down // up - q0 + T
        assert 0 < wsz <= plan.ws
        for t in range(cnt):
            n = n0 + t
            p, q = n * down % up, n * down // up
            if plan.staged:              # the row the thread reads
                r = p // g if plan.rows == up // g else t
                assert r < plan.rows
                if plan.rows != up // g:     # staged from its own phase
                    assert (n0 + r) * down % up == p
            writes[b, :, n] += 1
            if y is None:
                continue
            j = q - q0 + T - 1 - np.arange(T)       # window index of step m
            assert j.min() >= 0 and j.max() < wsz
            y[b, :, n] = ptaps[:, p, :] @ xx[b, q0 + j]
    return writes, y


def _walk_lines(plan, geom, rows, n_out, nf, xx=None, ptaps=None):
    """The lines tile's blocks as csrc/fir_bank.cu walks them: checks
    each block's window and tap streams against the plan and returns how
    often each (row, filter, output) is written; with xx and ptaps also
    the outputs, summed in float64 from the tap streams."""
    up, down, T = geom.up, geom.down, geom.T
    ko, gb, U, V, lb = plan.ko, plan.gb, plan.U, plan.V, plan.lb
    assert U >= n_out or U % (up // math.gcd(up, down)) == 0
    assert plan.ws % 8 == 4 and plan.span % 4 == 0
    assert plan.smem == 4 * max(lb * plan.ws + gb * GEN_COLS * plan.span,
                                lb * (gb * GEN_COLS + 1))
    assert blocks_per_sm(plan.smem) >= 1
    assert V == -(-n_out // U) and plan.lines == rows * V
    assert ko <= outputs_per_group(nf) and ko * nf <= GEN_COLS
    writes = np.zeros((rows, nf, n_out), np.int64)
    y = None if xx is None else np.zeros((rows, nf, n_out))
    vs = U * down // up
    L = None if xx is None else xx.shape[1]
    for blk in range(plan.grid):
        lg, tile = divmod(blk, plan.tiles)
        n0 = tile * gb * ko
        nb = min(gb * ko, U - n0)
        assert nb > 0
        j0 = (n0 * down // up) & ~3
        wsz = (((n0 + nb - 1) * down // up + T + 3) & ~3) - j0
        assert 0 < wsz <= plan.ws and wsz % 4 == 0
        line_ids = [lg * lb + li for li in range(lb)
                    if lg * lb + li < plan.lines]
        for g in range(gb):
            t0 = g * ko
            cnt = min(ko, nb - t0)
            if cnt <= 0:
                continue
            qf = (n0 + t0) * down // up
            ql = (n0 + t0 + cnt - 1) * down // up
            jt = ((ql + T + 3) & ~3) - 1 - j0
            jb = (qf & ~3) - j0
            nq = (jt + 1 - jb) // 4
            assert jt % 4 == 3 and jt < wsz and jb >= 0
            assert 4 * nq <= plan.span
            for line in line_ids:
                b, v = divmod(line, V)
                for i in range(cnt):
                    n = v * U + n0 + t0 + i
                    if n >= n_out:
                        continue
                    writes[b, :, n] += 1
                    if y is None:
                        continue
                    nd = (n0 + t0 + i) * down
                    p, q = nd % up, nd // up - j0
                    off = jt - (q + T - 1)
                    steps = np.arange(4 * nq)
                    m = steps - off
                    ok = (m >= 0) & (m < T)
                    j = v * vs + j0 + jt - steps     # row sample of step
                    x = np.where(j < L, xx[b, np.minimum(j, L - 1)], 0.0)
                    for f in range(nf):
                        h = np.where(ok, ptaps[f, p, np.clip(m, 0, T - 1)],
                                     0.0)
                        y[b, f, n] = np.dot(h, x)
    return writes, y


CASES = {c["name"]: c for c in fir_digest.cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_general_plan_covers_every_output_once(name):
    """Every recorded case's shape (utils/fir_digest.py): the serving
    path's sites and the random geometries at 1, 2 and 33 rows."""
    case = CASES[name]
    bank, _, n = fir_digest.case_inputs(dict(case, rows=1, shift=0), "cpu")
    g, rows, n_out = bank.geometry, case["rows"], bank.geometry.n_out(n)
    assert kernel_body(g) == "general"
    plan = general_plan(g, rows, n_out, bank.nf)
    writes, _ = _walk(plan, g, rows, n_out, bank.nf)
    assert (writes == 1).all(), name
    if not name.startswith("sweep"):      # the serving path's sites
        assert blocks_per_sm(plan.smem) >= 2
        if plan.form == "lines":
            assert plan.ko == outputs_per_group(1)


# (up, down, K, rows, n, nf, shift): few rows (lines of U outputs), a ragged
# last line, rows past a line group, nf 3's six columns, shifted starts
WALK_CASES = [(247, 640, 247 * 7, 1, 6400, 1, 0), (19, 240, 19 * 9, 2, 2400,
                                                   2, 1),
              (3, 8, 20, 33, 300, 3, 2), (2, 5, 14, 70, 200, 4, 3),
              (147, 800, 147 * 5, 5, 8000, 1, 1), (1, 10, 31, 3, 1000, 2, 0)]


@pytest.mark.parametrize("form", ["lines", "direct"])
@pytest.mark.parametrize("up, down, k_taps, rows, n, nf, shift", WALK_CASES)
def test_general_body_walk_matches_plain(up, down, k_taps, rows, n, nf,
                                         shift, form):
    rng = np.random.default_rng(up * 1000 + down)
    bank = tfir.make_bank([tfir.PolyFIR(rng.standard_normal(k_taps), up=up,
                                        down=down) for _ in range(nf)])
    g = bank.geometry
    length = bank.tail_len + n
    store = rng.standard_normal(rows * length + shift).astype(np.float32)
    xx = store[shift:].reshape(rows, length)
    n_out = g.n_out(n)
    plan = (lines_plan if form == "lines" else direct_plan)(g, rows, n_out,
                                                            nf)
    writes, y = _walk(plan, g, rows, n_out, nf, xx.astype(np.float64),
                      bank.ptaps.double().numpy())
    assert (writes == 1).all()
    yp = fir_bank_plain(torch.from_numpy(xx), bank.w, g).numpy()
    assert _snr(y, yp) > 120


def test_long_taps_take_the_direct_tile():
    """T 2,001: no lines tile's window of 32 lines fits one block an SM;
    the direct tile runs it, every output once, as the plain version."""
    rng = np.random.default_rng(5)
    bank = tfir.make_bank([tfir.PolyFIR(rng.standard_normal(2001), up=1,
                                        down=2)])
    g = bank.geometry
    assert lines_plan(g, 4, 1000, 1) is None
    assert blocks_per_sm(4 * 32 * window_bound(1, 1, 2, g.T)) == 0
    plan = general_plan(g, 4, 1000, 1)
    assert plan.form == "direct"
    xx = rng.standard_normal((4, bank.tail_len + 2000)).astype(np.float32)
    writes, y = _walk(plan, g, 4, 1000, 1, xx.astype(np.float64),
                      bank.ptaps.double().numpy())
    assert (writes == 1).all()
    yp = fir_bank_plain(torch.from_numpy(xx), bank.w, g).numpy()
    assert _snr(y, yp) > 120


def test_a_bank_no_window_holds_is_refused_when_made():
    """A window of 32 outputs past 227 KB of shared memory: refused when
    the bank is made, not at its first launch."""
    geom = BankGeometry(up=1, down=2000, num_taps=101, R=1, stride=2000,
                        J=2100, s_over=2)
    with pytest.raises(ValueError):
        check_geometry(geom)
    with pytest.raises(ValueError):
        tfir.make_bank([tfir.PolyFIR(np.ones(101), up=1, down=2000)])
    check_geometry(BankGeometry(up=1, down=1280, num_taps=101, R=1,
                                stride=1280, J=1380, s_over=2))


@pytest.mark.parametrize("seed", fir_digest.SWEEP_SEEDS)
def test_digest_cases_draw_the_property_test_geometries(seed):
    """fir_digest's copy of ``_random_geometry`` draws what the JAX
    package's property test draws."""
    a = fir_digest.random_geometry(np.random.default_rng(1000 + seed))
    assert a == _random_geometry(np.random.default_rng(1000 + seed))


@pytest.mark.parametrize("ablation", [None, *fir_bank_phases.ABLATIONS])
def test_phase_probe_anchors_are_in_the_source(ablation):
    """utils/fir_bank_phases.py edits csrc/fir_bank.cu at text anchors; a
    change to the source that drops one fails here, not on the card."""
    src = fir_bank_phases.instrumented_source(ablation)
    assert src.count("MARK(") == 6


SMALL_CASES = [name for name, c in CASES.items() if c["rows"] <= 2]


@pytest.mark.parametrize("name", SMALL_CASES)
def test_every_tile_covers_every_output_once(name):
    """Each tile ``fir_digest.tile_plans`` times on the card (lines,
    direct with staged taps, direct through L1) is a plan the kernel can
    walk, every output once, at the recorded cases of 1-2 rows."""
    case = CASES[name]
    bank, _, n = fir_digest.case_inputs(dict(case, rows=1, shift=0), "cpu")
    g, rows, n_out = bank.geometry, case["rows"], bank.geometry.n_out(n)
    plans = fir_digest.tile_plans(g, rows, n_out, bank.nf)
    assert "direct_l1" in plans
    for plan in plans.values():
        writes, _ = _walk(plan, g, rows, n_out, bank.nf)
        assert (writes == 1).all(), (name, plan)
