"""The port's compiled serving entries (``utils.graphs``, ``Receiver.jit_*``,
``ChannelBank.run_segment_grouped`` and ``run_*_jit``) on the CPU.

On the CPU an entry runs its eager function; ``GraphCache(HostGraph)``
runs the card's bookkeeping (keys, static buffers, packed outputs, the
copies, the launch accounting) with an eager re-run in place of the graph
replay, so these tests hold everything but the capture.

Bounds: each entry against the JAX package's entry of the same name on the
same seeded input, from one carried state (the JAX receiver's after two
blocks, its RDS decoder past the warm-up gate), mode 0 type r, 2 channels:
audio > 60 dB and RDS bits equal (the twins' chain gate);
``run_segment_grouped`` on 8 channels, ``group=4``, against the JAX bank's
(the twin of ``tests/test_parallel.py``'s grouped test) with the same
bounds; ``run_wideband_u8_jit`` on a 4-station 9.6 MS/s capture through both
frontends against the JAX bank's: the fused path's audio > 60 dB, the
two-stage path's u8 stations within 1 LSB on < 1 % of bytes (its fold
product sums in another order) and its audio > 60 dB, RDS bits equal on
both. Each entry, graphed through ``HostGraph`` and eager, is
``torch.equal`` to its eager function in every leaf and the state.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import mk_channelizer
from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.parallel.channel import ChannelBank as JBank
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend
from real_time_sdr_tpu_torch.ops.cuda import fir_bank, frontend_fused
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils import graphs, synth
from real_time_sdr_tpu_torch.utils.graphs import (GraphCache,
                                                  GraphCaptureError,
                                                  HostGraph)
from real_time_sdr_tpu_torch.utils.state import (load_state, map_state,
                                                 save_state,
                                                 state_from_numpy)

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

CFG = mode_config(0)
JCFG = jmode_config(0)
BLK = 2 * CFG.block_size_iq
WIDE_FS = 4 * CFG.rf_fs
RASTER4 = [-450_000, -150_000, 150_000, 450_000]


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _leaves(tree):
    """Tensor leaves of a state or output tree (NamedTuples, None)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _graphed(rx):
    """``rx`` with the card's bookkeeping on the CPU."""
    rx.graphs = GraphCache(HostGraph)
    return rx


def _channels(n_ch, n_blocks, seed=0):
    """One station tiled to ``n_ch`` channels with distinct time shifts."""
    iq, _ = synth.station_iq(CFG, n_blocks, ps_name="GRAPHS  ", pi=0x6A7B)
    pairs = iq.reshape(-1, 2)
    shifts = [0] + [int(s) for s in np.random.default_rng(seed).integers(
        1, len(pairs), n_ch - 1)]
    return np.stack([np.roll(pairs, -s, axis=0).reshape(-1)
                     for s in shifts])


@pytest.fixture(scope="module")
def carried():
    """The JAX receiver (Pallas frontend, interpret mode) and its state
    after two blocks of each of 2 channels, past the RDS warm-up gate, with
    the 2 more blocks both packages then run; the port's copy of the
    state."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    iq = _channels(2, 4, seed=1)
    run = jax.jit(jrx.run_segment)
    mids = []
    for c in range(2):
        jst, _ = run(jrx.init_state(), jnp.asarray(iq[c, :2 * BLK]))
        mids.append(jst._replace(rds=jst.rds._replace(
            block_count=jnp.int32(6))))
    state = state_from_numpy(jax.tree_util.tree_map(
        lambda *a: np.stack([np.asarray(x) for x in a]), *mids), "cpu")
    return jrx, mids, np.ascontiguousarray(iq[:, 2 * BLK:]), state


def _assert_matches_jax(jouts, out, block_axis=False):
    """Per channel: audio > 60 dB, RDS bits and counts equal."""
    for c, jo in enumerate(jouts):
        for rail in ("left", "right"):
            assert _snr(getattr(jo, rail), getattr(out, rail)[c]) > 60.0
        np.testing.assert_array_equal(out.rds_nbits[c].numpy(),
                                      np.asarray(jo.rds_nbits))
        np.testing.assert_array_equal(out.rds_bits[c].numpy(),
                                      np.asarray(jo.rds_bits))
    assert int(out.rds_nbits.sum()) > 0


def _both(rx_entry, *args):
    """The entry eager (the CPU's route) and through HostGraph: equal in
    every leaf; returns the graphed result."""
    eager = rx_entry(Receiver(0, stereo=True, rds=True, pll_tier=3), *args)
    graphed = rx_entry(_graphed(Receiver(0, stereo=True, rds=True,
                                         pll_tier=3)), *args)
    assert _equal(eager, graphed)
    return graphed


def test_jit_step_matches_jax(carried):
    jrx, mids, seg, state = carried
    jouts = [jrx.jit_step(m, jnp.asarray(seg[c]))[1]
             for c, m in enumerate(mids)]
    st, out = _both(lambda rx, s, x: rx.jit_step(s, x), state,
                    torch.from_numpy(seg))
    _assert_matches_jax(jouts, out)
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3).step(
        state, torch.from_numpy(seg))
    assert _equal((st, out), ref)


def test_jit_run_blocks_matches_jax(carried):
    jrx, mids, seg, state = carried
    blocks = seg.reshape(2, 2, BLK)
    jouts = [jrx.jit_run_blocks(m, jnp.asarray(blocks[c]))[1]
             for c, m in enumerate(mids)]
    st, out = _both(lambda rx, s, x: rx.jit_run_blocks(s, x), state,
                    torch.from_numpy(blocks))
    assert out.left.shape == (2, 2, CFG.audio_block)
    _assert_matches_jax(jouts, out)
    ref = Receiver(0, stereo=True, rds=True, pll_tier=3).run_blocks(
        state, torch.from_numpy(blocks))
    assert _equal((st, out), ref)


def test_jit_run_segment_staged_matches_jax(carried):
    jrx, mids, seg, state = carried
    n2 = seg.shape[1]
    jouts = []
    for c, m in enumerate(mids):
        xp = jrx.frontend.stage_segment_full(np.asarray(m.frontend.iq_tail),
                                             seg[c])
        jouts.append(jrx.jit_run_segment_staged(m, jax.device_put(xp),
                                                n2)[1])
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    xp = torch.from_numpy(rx.frontend.stage_segment(
        state.frontend.iq_tail.numpy(), seg))
    st, out = _both(lambda r, s, x: r.jit_run_segment_staged(s, x, n2),
                    state, xp)
    _assert_matches_jax(jouts, out)
    assert _equal((st, out), rx.run_segment_staged(state, xp, n2))
    assert _equal((st, out), rx.step(state, torch.from_numpy(seg)))


def test_run_segment_grouped_matches_jax_and_run_segment():
    """8 channels, group=4 (the twin of the JAX package's grouped test):
    the JAX bank's run_segment_grouped and the port's against each other
    from one carried state, and the port's equal to its run_segment."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    jbank = JBank(jrx, 8)
    iq = _channels(8, 3, seed=11)
    jst, _ = jbank.run_segment(jbank.init_state(), jnp.asarray(iq[:, :BLK]))
    jst = jst._replace(rds=jst.rds._replace(
        block_count=jnp.full((8,), 6, jnp.int32)))
    seg = np.ascontiguousarray(iq[:, BLK:])
    _, jout = jbank.run_segment_grouped(jst, jnp.asarray(seg), group=4)
    state = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    bank = ChannelBank(rx, 8)
    got = bank.run_segment_grouped(state, torch.from_numpy(seg), group=4)
    graphed = ChannelBank(_graphed(Receiver(0, stereo=True, rds=True,
                                            pll_tier=3)), 8)
    assert _equal(got, graphed.run_segment_grouped(
        state, torch.from_numpy(seg), group=4))
    assert _equal(got, bank.run_segment(state, torch.from_numpy(seg)))
    out = got[1]
    for c in range(8):
        for rail in ("left", "right"):
            assert _snr(np.asarray(getattr(jout, rail))[c],
                        getattr(out, rail)[c]) > 60.0
    np.testing.assert_array_equal(out.rds_nbits.numpy(),
                                  np.asarray(jout.rds_nbits))
    np.testing.assert_array_equal(out.rds_bits.numpy(),
                                  np.asarray(jout.rds_bits))
    assert int(out.rds_nbits.sum()) > 0
    # a group of at least C is one step; one that does not divide C raises
    assert _equal(got, bank.run_segment_grouped(
        state, torch.from_numpy(seg), group=8))
    with pytest.raises(ValueError, match="does not divide"):
        bank.run_segment_grouped(state, torch.from_numpy(seg), group=3)
    with pytest.raises(ValueError):
        bank.run_segment_grouped(state, torch.from_numpy(seg), group=0)


@pytest.mark.parametrize("path", ["fused", "two_stage"])
def test_run_wideband_u8_jit_matches_jax(path):
    """4 stations at 9.6 MS/s, raw u8 bytes: the JAX bank's
    run_wideband_u8_jit over 2 blocks, then from its carried state (RDS
    past the warm-up gate) 2 more blocks through both packages' entry."""
    scene = [dict(offset_hz=o, ps_name=f"JIT-{k}   ", pi=0x7100 + k, pty=k,
                  tone_left=500.0 + 100 * k, tone_right=1300.0)
             for k, o in enumerate(RASTER4)]
    iw, qw, _ = jsynth.wideband_iq(JCFG, WIDE_FS, scene, 4)
    x = np.empty(2 * len(iw), np.float32)
    x[0::2], x[1::2] = iw, qw
    raw = np.clip(np.round(128.0 + 127.0 * x), 0, 255).astype(np.uint8)
    half = raw.shape[0] // 2
    if path == "fused":
        jfe = JFused(JCFG, WIDE_FS, RASTER4)
        fe = FusedWidebandFrontend(CFG, WIDE_FS, RASTER4, device="cpu")
    else:
        jfe = mk_channelizer(JCFG, WIDE_FS, RASTER4, fold=True)
        fe = Channelizer(CFG, WIDE_FS, RASTER4, device="cpu")
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    jbank = JBank(jrx, 4)
    jst, _, jfs = jbank.run_wideband_u8_jit(
        jbank.init_state(), jfe, jnp.asarray(raw[:half]), jfe.init_state())
    jst = jst._replace(rds=jst.rds._replace(
        block_count=jnp.full((4,), 6, jnp.int32)))
    _, jout, _ = jbank.run_wideband_u8_jit(jst, jfe, jnp.asarray(raw[half:]),
                                           jfs)
    state, fstate = (state_from_numpy(jax.tree_util.tree_map(np.asarray, t),
                                      "cpu") for t in (jst, jfs))
    seg = torch.from_numpy(raw[half:].copy())
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    got = ChannelBank(rx, 4).run_wideband_u8_jit(state, fe, seg, fstate)
    graphed = ChannelBank(_graphed(Receiver(0, stereo=True, rds=True,
                                            pll_tier=3)), 4)
    assert _equal(got, graphed.run_wideband_u8_jit(state, fe, seg, fstate))
    assert _equal(got, ChannelBank(rx, 4).run_wideband_u8(state, fe, seg,
                                                          fstate))
    if path == "two_stage":
        from real_time_sdr_tpu_torch.models.wideband_frontend import \
            u8_to_rails
        ju8, _ = jfe.call_u8(*(jnp.asarray(np.asarray(r)) for r in
                               u8_to_rails(seg)), jfs)
        u8, _ = fe.call_u8(*u8_to_rails(seg), fstate)
        diff = np.abs(u8.numpy().astype(np.int32)
                      - np.asarray(ju8).astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 0.01
    out = got[1]
    for s in range(4):
        for rail in ("left", "right"):
            assert _snr(np.asarray(getattr(jout, rail))[s],
                        getattr(out, rail)[s]) > 60.0
    np.testing.assert_array_equal(out.rds_nbits.numpy(),
                                  np.asarray(jout.rds_nbits))
    np.testing.assert_array_equal(out.rds_bits.numpy(),
                                  np.asarray(jout.rds_bits))
    assert int(out.rds_nbits.sum()) > 0


# -- the cache's bookkeeping (HostGraph) -------------------------------------

@pytest.fixture(scope="module")
def chain():
    """4 chained one-block segments of 2 channels, and the eager chain's
    states and outputs."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    iq = _channels(2, 4, seed=3)
    segs = [torch.from_numpy(np.ascontiguousarray(iq[:, k * BLK:
                                                      (k + 1) * BLK]))
            for k in range(4)]
    st, states, outs = rx.init_state(2), [], []
    for seg in segs:
        st, out = rx.step(st, seg)
        states.append(st)
        outs.append(out)
    return segs, states, outs


def test_graphed_chain_equals_eager_and_keeps_what_it_returned(chain):
    """A chain of jit_step calls equals the eager chain; what call k
    returned is unchanged after calls k+1 ... k+4; the returned state is
    one buffer per dtype, so it goes back in as one copy each."""
    segs, states, outs = chain
    rx = _graphed(Receiver(0, stereo=True, rds=True, pll_tier=3))
    st, kept = rx.init_state(2), []
    for k in range(8):
        st, out = rx.jit_step(st, segs[k % 4])
        kept.append((st, out, map_state((st, out), torch.clone)))
        if k < 4:
            assert _equal((st, out), (states[k], outs[k]))
    for st_k, out_k, copy_k in kept:
        assert _equal((st_k, out_k), copy_k)
    assert len(rx.graphs) == 1
    f32 = [t for t in _leaves(st) if t.dtype == torch.float32]
    assert len({t.untyped_storage().data_ptr() for t in f32}) == 1
    outs_f32 = [t for t in _leaves(out) if t.dtype == torch.float32]
    assert {t.untyped_storage().data_ptr() for t in outs_f32} == {
        f32[0].untyped_storage().data_ptr()}


def test_graphed_restarts_from_init_and_loaded_state(chain, tmp_path):
    """A fresh init_state and a load_state result passed in mid-stream
    restart the graphed chain as they restart the eager one."""
    segs, states, outs = chain
    rx = _graphed(Receiver(0, stereo=True, rds=True, pll_tier=3))
    eager = Receiver(0, stereo=True, rds=True, pll_tier=3)
    st = rx.init_state(2)
    for seg in segs[:2]:
        st, _ = rx.jit_step(st, seg)
    st, out = rx.jit_step(rx.init_state(2), segs[0])
    assert _equal((st, out), (states[0], outs[0]))
    save_state(str(tmp_path / "ck"), states[1])
    loaded = load_state(str(tmp_path / "ck"), eager.init_state(2))
    st, out = rx.jit_step(loaded, segs[2])
    assert _equal((st, out), (states[2], outs[2]))
    st, out = rx.jit_step(states[0], segs[1])    # an older state again
    assert _equal((st, out), (states[1], outs[1]))


def _counting_step(state, x):
    """Stands for an entry that launches fir_bank's tiled body twice and
    the frontend kernel once per call (the CPU launches no kernel)."""
    fir_bank.launches += 2
    fir_bank.body_launches["tiled"] += 2
    frontend_fused.launches += 1
    return state + x.sum(), (x * 2.0, None)


def test_launch_accounting_under_replay():
    """N calls through the graph count what N eager calls count: the
    warm-up and the capture add nothing, each replay adds the capture's
    delta, and no other count moves."""
    cache = GraphCache(HostGraph)
    x, s = torch.arange(6.0).reshape(2, 3), torch.zeros(())
    start = graphs.launch_counts()
    for n in range(1, 6):
        s, (y, none) = cache(_counting_step, ("count",), s, x)
        now = graphs.launch_counts()
        moved = {k: now[k] - start[k] for k in now if now[k] != start[k]}
        assert moved == {("fir_bank", None): 2 * n,
                         ("fir_bank", "tiled"): 2 * n,
                         ("frontend_fused", None): n}
        assert none is None and torch.equal(y, 2.0 * x)
    assert float(s) == 5 * float(x.sum())
    eager_s = torch.zeros(())
    for _ in range(5):
        eager_s, _ = _counting_step(eager_s, x)
    now = graphs.launch_counts()
    assert now[("fir_bank", None)] - start[("fir_bank", None)] == 20
    assert torch.equal(eager_s, s)
    graphs.set_launch_counts(start)


def test_capture_failure_raises_and_keeps_no_graph():
    """A function that fails while it is captured raises GraphCaptureError
    (no eager fallback) and leaves no graph behind; one whose outputs
    change structure between the warm-up and the capture too."""
    calls = []

    def breaks_in_capture(x):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1.0

    cache = GraphCache(HostGraph)
    x = torch.ones(3)
    with pytest.raises(GraphCaptureError, match="not permitted"):
        cache(breaks_in_capture, ("breaks",), x)
    assert len(cache) == 0 and len(calls) == 2
    shapes = iter([(x,), (x, x)])
    with pytest.raises(GraphCaptureError, match="structure changed"):
        cache(lambda t: next(shapes), ("shape",), x)
    assert len(cache) == 0
    with pytest.raises(ValueError, match="one device"):
        cache(lambda a, b: a, ("two",), x, torch.ones(3, device="meta"))
    with pytest.raises(TypeError, match="trees of tensors"):
        cache(lambda a: a, ("bad",), 3)


def test_cpu_entries_are_eager_and_replicas_hold_their_own_graphs():
    """On the CPU the default cache runs the eager function and keeps no
    graph; a deep copy (a replica) starts an empty cache of its own; a new
    shape or n2 is a new graph, as a new shape recompiles in JAX."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    iq = torch.from_numpy(_channels(2, 2, seed=4))
    st, _ = rx.jit_step(rx.init_state(2), iq)
    assert len(rx.graphs) == 0
    twin = copy.deepcopy(_graphed(rx))
    assert twin.graphs is not rx.graphs and twin.graphs.graph_cls is HostGraph
    rx.jit_step(rx.init_state(2), iq[:, :BLK])
    rx.jit_step(rx.init_state(2), iq)
    rx.jit_step(rx.init_state(1), iq[:1])
    n2 = BLK
    xp = torch.from_numpy(rx.frontend.stage_segment(
        st.frontend.iq_tail.numpy(), iq[:, :n2].numpy()))
    rx.jit_run_segment_staged(st, xp, n2)
    assert len(rx.graphs) == 4 and len(twin.graphs) == 0
