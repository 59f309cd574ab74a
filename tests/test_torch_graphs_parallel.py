"""The port's last graphed entries on the CPU: the channel bank's own
entries (``ChannelBank.step`` / ``run`` / ``run_segment`` /
``run_segment_demod``), time sharding (exact, approximate and joint), the
sharded wideband steps, the alternative decode and the bench digest steps,
plus the +20 dB adjacent-channel interferer through the graphed bank.

As in ``tests/test_torch_graphs.py``: on the CPU each entry runs its eager
function, and ``GraphCache(HostGraph)`` runs the card's bookkeeping (keys,
static buffers, packed outputs, the copies, the launch accounting) with an
eager re-run in place of the replay. Each entry is held, through
``HostGraph``, ``torch.equal`` to its eager form in every leaf, with one
graph per key and launch counts equal to eager (the kernel wrappers made to
count their plain route), and against the JAX package's compiled entry on
the same seeded input.

Bounds against JAX (those of the files these entries come from): the bank
from one carried state (the JAX bank's after two blocks, its RDS decoder
past the warm-up gate), audio > 60 dB and RDS bits equal; time sharding on
JAX's virtual CPU devices as ``tests/test_torch_parallel.py`` holds it
(audio and ``rds_clean`` > 60 dB, the latter up to one global carrier sign,
the decoded stream equal from its second bit; the approximate mode > 40 dB,
a shard's first block > 25 dB); the sharded wideband steps on a 2-device
mesh, audio > 60 dB (the two-stage path past its cold first block); the
alternative decode's bits, PS, PI and ``n_valid`` equal; the digest within
f32 rounding (relative 1e-5) of the sum of JAX's per-channel digests; the
interferer's two stations from a carried state, audio > 60 dB and bits
equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from real_time_sdr_tpu.config import mode_config as jmode_config
from real_time_sdr_tpu.models.channelizer import Channelizer as JChannelizer
from real_time_sdr_tpu.models.rds_alt import AltRdsReceiver as JAlt
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.parallel import time_shard as jts
from real_time_sdr_tpu.parallel import wideband as jwb
from real_time_sdr_tpu.parallel.channel import ChannelBank as JBank
from real_time_sdr_tpu.utils import benchkit as jbenchkit
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.channelizer import \
    Channelizer as _Channelizer
from real_time_sdr_tpu_torch.models.rds_alt import \
    AltRdsReceiver as _AltRdsReceiver
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend as _FusedWidebandFrontend
from real_time_sdr_tpu_torch.ops.cuda import KERNELS
from real_time_sdr_tpu_torch.parallel import time_shard as tts
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank, gather
from real_time_sdr_tpu_torch.parallel.wideband import (ShardedFusedWideband,
                                                       ShardedWideband)
from real_time_sdr_tpu_torch.utils import benchkit, graphs, synth
from real_time_sdr_tpu_torch.utils.graphs import GraphCache, HostGraph
from real_time_sdr_tpu_torch.utils.state import map_state, state_from_numpy

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")
Channelizer = functools.partial(_Channelizer, device="cpu")
FusedWidebandFrontend = functools.partial(_FusedWidebandFrontend,
                                          device="cpu")
AltRdsReceiver = functools.partial(_AltRdsReceiver, device="cpu")

CFG = mode_config(0)
JCFG = jmode_config(0)
BLK = 2 * CFG.block_size_iq
WIDE_FS = 4 * CFG.rf_fs
RASTER4 = [-450_000, -150_000, 150_000, 450_000]
TIER3 = dict(stereo=True, rds=True, pll_tier=3)


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


def _leaves(tree):
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


def _to_port(jtree):
    return state_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _blocks(n_blocks, **kw):
    iq, _ = synth.station_iq(CFG, n_blocks, **kw)
    return iq.reshape(n_blocks, BLK)


@pytest.fixture
def counting(monkeypatch):
    """Every kernel wrapper counts its calls on the plain route too, so
    that eager and graphed runs on the CPU have launch counts to compare;
    the counts start at 0."""
    for k in KERNELS:
        def call(self, *a, __orig=type(k).__call__, **kw):
            self.launches += 1
            return __orig(self, *a, **kw)
        monkeypatch.setattr(type(k), "__call__", call)
    saved = graphs.launch_counts()
    graphs.set_launch_counts(dict.fromkeys(saved, 0))
    yield
    graphs.set_launch_counts(saved)


def _counted(fn):
    """(fn(), the launch counts it added)."""
    before = graphs.launch_counts()
    res = fn()
    after = graphs.launch_counts()
    return res, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _eager_and_graphed(run, make_rx):
    """``run(rx)`` on an eager receiver and on one with HostGraph: equal in
    every leaf and launch count; returns (the result, the graphed
    receiver)."""
    eager, n_eager = _counted(lambda: run(make_rx()))
    g_rx = _graphed(make_rx())
    graphed, n_graphed = _counted(lambda: run(g_rx))
    assert n_eager and n_graphed == n_eager
    assert _equal(eager, graphed)
    return graphed, g_rx


# -- the channel bank's own entries -----------------------------------------

@pytest.fixture(scope="module")
def bank2():
    """The JAX bank of 2 channels (Pallas frontend, interpret mode) after
    two one-block steps, past the RDS warm-up gate; the 5 blocks both
    packages then run; the port's copy of the state."""
    jrx = JReceiver(0, frontend_impl="pallas_interpret", **TIER3)
    jbank = JBank(jrx, 2)
    iq = np.stack([np.roll(_blocks(7, ps_name="BANKGRPH", pi=0x6B7C),
                           2 * 997 * c) for c in range(2)])   # (2, 7, blk)
    jst = jbank.init_state()
    for b in range(2):
        jst, _ = jbank.step(jst, jnp.asarray(iq[:, b]))
    jst = jst._replace(rds=jst.rds._replace(
        block_count=jnp.full((2,), 6, jnp.int32)))
    return jbank, jst, np.ascontiguousarray(iq[:, 2:]), _to_port(jst)


def _bank_chain(rx, state, blocks):
    """step (block 0), run_segment (block 1), run (blocks 2-3) and
    run_segment_demod (block 4's demod) through a 2-channel bank, chained;
    the demod is the port's frontend's on block 4."""
    bank = ChannelBank(rx, 2)
    x = torch.from_numpy(blocks)
    s1, o1 = bank.step(state, x[:, 0])
    kept = map_state((s1, o1), torch.clone)
    s2, o2 = bank.run_segment(s1, x[:, 1])
    s3, o3 = bank.run(s2, x[:, 2:4].transpose(0, 1).contiguous())
    demod, _ = rx.frontend(x[:, 4], s3.frontend)
    s4, o4 = bank.run_segment_demod(s3, demod)
    again = bank.step(state, x[:, 0])        # an older state passed back
    assert _equal((s1, o1), kept) and _equal(again, kept)
    return (s1, o1), (s2, o2), (s3, o3), (demod, s4, o4)


def test_bank_entries_match_jax(bank2, counting):
    jbank, jst, blocks, state = bank2
    chain, g_rx = _eager_and_graphed(
        lambda rx: _bank_chain(rx, state, blocks),
        lambda: Receiver(0, **TIER3))
    # step and run_segment share the receiver's jit_step graph
    assert len(g_rx.graphs) == 3
    (s1, o1), (s2, o2), (s3, o3), (demod, s4, o4) = chain
    js1, jo1 = jbank.step(jst, jnp.asarray(blocks[:, 0]))
    js2, jo2 = jbank.run_segment(js1, jnp.asarray(blocks[:, 1]))
    js3, jo3 = jbank.run(js2, jnp.asarray(blocks[:, 2:4].transpose(1, 0, 2)))
    _, jo4 = jbank._step_demod(js3, jnp.asarray(demod.numpy()))
    assert o3.left.shape == (2, 2, CFG.audio_block)
    for jo, o in ((jo1, o1), (jo2, o2), (jo4, o4)):
        for rail in ("left", "right"):
            for c in range(2):
                assert _snr(np.asarray(getattr(jo, rail))[c],
                            getattr(o, rail)[c]) > 60.0
        np.testing.assert_array_equal(o.rds_bits.numpy(),
                                      np.asarray(jo.rds_bits))
        np.testing.assert_array_equal(o.rds_nbits.numpy(),
                                      np.asarray(jo.rds_nbits))
    for rail in ("left", "right"):
        assert _snr(np.asarray(getattr(jo3, rail)), getattr(o3, rail)) > 60
    np.testing.assert_array_equal(o3.rds_bits.numpy(),
                                  np.asarray(jo3.rds_bits))
    assert int(o3.rds_nbits.sum()) > 0
    # the demod entry passes the frontend state through, as JAX's
    assert _equal(s4.frontend, s3.frontend)


def test_bank_entries_over_two_replicas(counting):
    """``[cpu, cpu]``: one graph per key in the shared replica's cache,
    each device's rows through it; equal to the eager forms."""
    rows = torch.from_numpy(np.stack([np.roll(_blocks(2), 2 * 997 * c)
                                      for c in range(4)]))   # (4, 2, blk)

    def run(rx):
        bank = ChannelBank(rx, 4, devices=["cpu", "cpu"])
        st, out = bank.run_segment(bank.init_state(), rows[:, 0])
        return bank.run(st, rows[:, 1:].transpose(0, 1)), gather(out)

    (ran, _), g_rx = _eager_and_graphed(run, lambda: Receiver(0, **TIER3))
    assert len(g_rx.graphs) == 2 and type(ran[0]) is tuple
    bank = ChannelBank(Receiver(0, **TIER3), 4, devices=["cpu", "cpu"])
    eager = bank._run(bank._step(bank.init_state(), rows[:, 0])[0],
                      rows[:, 1:].transpose(0, 1))
    assert _equal(eager, ran)


# -- time sharding ----------------------------------------------------------

def _sharded_forms(rx_kw, blocks, shards, bank=False, **kw):
    """The graphed entry through HostGraph against the eager form: equal
    in every leaf and launch count; the same geometry again is no new
    graph. Returns the output."""
    run = tts.time_sharded_run_bank if bank else tts.time_sharded_run
    x = torch.from_numpy(blocks)
    out, g_rx = _eager_and_graphed(
        lambda rx: run(rx, x, shards, devices=["cpu"], **kw),
        lambda: Receiver(0, **rx_kw))
    assert len(g_rx.graphs) == 1
    assert _equal(run(g_rx, x, shards, devices=["cpu"], **kw), out)
    assert len(g_rx.graphs) == 1
    rx = Receiver(0, **rx_kw)
    eager = tts._sharded_run(rx, x if bank else x[None], shards,
                             kw.get("overlap", 1), kw.get("exact"),
                             [[torch.device("cpu")]], None)
    assert _equal(eager if bank else map_state(eager, lambda t: t[0]), out)
    return out


def _check_against_jax(jout, out):
    """As ``tests/test_torch_parallel.py``: audio and ``rds_clean`` > 60 dB
    (the latter up to one global sign), the decoded stream equal from its
    second bit on."""
    assert _snr(jout.left, out.left) > 60.0
    assert _snr(jout.right, out.right) > 60.0
    jclean, clean = np.asarray(jout.rds_clean), out.rds_clean.numpy()
    assert _snr(jclean, np.sign(np.sum(jclean * clean)) * clean) > 60.0
    np.testing.assert_array_equal(np.asarray(jout.rds_nbits),
                                  out.rds_nbits.numpy())
    stream = lambda b, n: np.concatenate(
        [np.asarray(b)[k][:np.asarray(n)[k]] for k in range(len(n))])
    js = stream(jout.rds_bits, jout.rds_nbits)
    ts = stream(out.rds_bits.numpy(), out.rds_nbits.numpy())
    assert len(ts) > 40
    np.testing.assert_array_equal(js[1:], ts[1:])


def _mesh(shape):
    return Mesh(np.array(jax.devices()[:np.prod(shape)]).reshape(shape),
                ("ch", "time"))


def test_time_sharded_run_exact_matches_jax(counting):
    blocks = _blocks(8, ps_name="SHARDGRF")
    out = _sharded_forms(TIER3, blocks, 4)
    jout = jts.time_sharded_run(JReceiver(0, **TIER3), _mesh((1, 4)),
                                jnp.asarray(blocks), overlap=1)
    _check_against_jax(jout, out)


def test_time_sharded_run_approx_matches_jax(counting):
    kw = dict(stereo=True, pll_tier=1)
    blocks = _blocks(8)
    out = _sharded_forms(kw, blocks, 4)
    jout = jts.time_sharded_run(JReceiver(0, **kw), _mesh((1, 4)),
                                jnp.asarray(blocks), exact=False)
    for name in ("left", "right"):
        jref, got = np.asarray(getattr(jout, name)), getattr(out, name)
        for b in range(8):
            assert _snr(jref[b], got[b]) > (40.0 if b % 2 else 25.0)


def test_time_sharded_run_bank_matches_jax(counting):
    blocks = np.stack([_blocks(8, ps_name="JOINTG-A", tone_left=440.0),
                       _blocks(8, ps_name="JOINTG-B", tone_left=600.0)])
    out = _sharded_forms(TIER3, blocks, 4, bank=True)
    jout = jts.time_sharded_run_bank(JReceiver(0, **TIER3), _mesh((2, 4)),
                                     jnp.asarray(blocks))
    for c in range(2):
        _check_against_jax(jax.tree_util.tree_map(lambda x: x[c], jout),
                           map_state(out, lambda x: x[c]))


def test_time_sharding_leaves_the_receivers_bits_on():
    """The exact DSP pass runs on a copy whose slicer is off: after a
    time-sharded run the receiver still emits bits, and its own
    ``jit_run_blocks`` graph at the DSP pass's shapes (4 rows of 2 blocks,
    and of the 1-block halo) decodes as the eager receiver does."""
    rx = _graphed(Receiver(0, **TIER3))
    blocks = torch.from_numpy(_blocks(8))
    tts.time_sharded_run(rx, blocks, 4, devices=["cpu"])
    assert rx.rds_path.emit_bits and len(rx.graphs) == 1
    assert not rx.without_bits().rds_path.emit_bits
    assert rx.without_bits() is rx.without_bits()
    st, _ = rx.run_blocks(rx.init_state(4), blocks.reshape(4, 2, BLK))
    st = st._replace(rds=st.rds._replace(
        block_count=torch.full((4,), 6, dtype=torch.int32)))
    for x in (blocks.reshape(4, 2, BLK), blocks[:4, None]):
        got = rx.jit_run_blocks(st, x)
        assert int(got[1].rds_nbits.sum()) > 0
        assert _equal(got, Receiver(0, **TIER3).run_blocks(st, x))
    assert len(rx.graphs) == 3


# -- the sharded wideband steps ----------------------------------------------

@pytest.fixture(scope="module")
def wide():
    scene = [dict(offset_hz=o, ps_name=f"WGRAPH-{k}", pi=0x5C00 + k,
                  pty=k + 1, tone_left=500.0 + 100 * k, tone_right=1300.0)
             for k, o in enumerate(RASTER4)]
    iw, qw, _ = synth.wideband_iq(CFG, WIDE_FS, scene, 4)
    half = len(iw) // 2
    return (iw[:half], qw[:half]), (iw[half:], qw[half:])


@pytest.mark.parametrize("path", ["fused", "two_stage"])
def test_sharded_wideband_step_matches_jax(wide, path, counting):
    """Two segments over two replicas with a ``retune`` of station 2 (the
    second shard's first) between the replays: the graphed steps equal the
    eager ones, the retune reaches the next replay (station 2's output
    moves, no graph is added), and the first step is JAX's."""
    if path == "fused":
        fe = FusedWidebandFrontend(CFG, WIDE_FS, RASTER4)
        cls = ShardedFusedWideband
    else:
        fe = Channelizer(CFG, WIDE_FS, RASTER4)
        cls = ShardedWideband

    def run(rx, retune=True):
        sw = cls(fe, rx, devices=["cpu", "cpu"])
        fs, bs = sw.init_state()
        fs, bs, first = sw.step(fs, bs, *wide[0])
        if retune and path == "fused":
            sw.retune(2, RASTER4[3])
        return first, sw.step(fs, bs, *wide[1])

    (first, (_, _, out)), g_rx = _eager_and_graphed(
        run, lambda: Receiver(0, **TIER3))
    assert len(g_rx.graphs) == 2
    if path == "fused":
        _, (_, _, unmoved) = run(Receiver(0, **TIER3), retune=False)
        assert _snr(gather(unmoved).left[2], gather(out).left[2]) < 20.0
        assert torch.equal(gather(unmoved).left[:2], gather(out).left[:2])
        jfe = JFused(JCFG, WIDE_FS, RASTER4, compute_dtype="f32")
        jsw = jwb.ShardedFusedWideband(jfe, JReceiver(0, **TIER3),
                                       Mesh(np.array(jax.devices()[:2]),
                                            ("ch",)))
    else:
        jfe = JChannelizer(JCFG, WIDE_FS, RASTER4)
        jsw = jwb.ShardedWideband(jfe, JReceiver(0, **TIER3),
                                  Mesh(np.array(jax.devices()[:2]),
                                       ("ch",)))
    _, _, jout = jsw.step(*jsw.init_state(), *wide[0])
    # a cold two-stage segment opens on the channelizer's filter ramp
    skip = CFG.audio_block if path == "two_stage" else 0
    got = gather(first)
    for rail in ("left", "right"):
        assert _snr(np.asarray(getattr(jout, rail))[:, skip:],
                    getattr(got, rail)[:, skip:]) > 60.0


# -- the alternative decode ---------------------------------------------------

def test_alt_decode_matches_jax(counting):
    iq, _ = synth.station_iq(CFG, 24, ps_name="ALTGRAPH", pi=0x2ABD)
    rx = AltRdsReceiver(0)
    eager, n_eager = _counted(lambda: rx._decode(iq, rx._device_half))
    g_rx = _graphed(AltRdsReceiver(0))
    (dec, diag), n_graphed = _counted(lambda: g_rx.decode(iq))
    assert n_graphed == n_eager and n_eager
    assert len(g_rx.graphs) == 1
    g_rx.decode(iq)
    assert len(g_rx.graphs) == 1
    for a, b in zip(eager[1], diag):
        np.testing.assert_array_equal(a, b)
    jdec, jdiag = JAlt(JCFG).decode(iq)
    assert dec.events.ps_name == jdec.events.ps_name == "ALTGRAPH"
    assert dec.events.pi == jdec.events.pi == 0x2ABD
    assert len(diag.symbols) == len(jdiag.symbols)
    np.testing.assert_array_equal(diag.bits, jdiag.bits)


# -- the bench digest steps --------------------------------------------------

def test_digest_steps_match_jax(bank2, counting):
    """From the carried state: the graphed digest equal to the eager one
    and within f32 rounding of the sum of JAX's per-channel digests; the
    staged digest equal to the unstaged one."""
    jbank, jst, blocks, state = bank2
    seg = np.ascontiguousarray(blocks[:, :2].reshape(2, -1))
    x = torch.from_numpy(seg)
    rx = Receiver(0, **TIER3)
    eager, n_eager = _counted(lambda: benchkit._digest_fn(rx, state, x))
    g_rx = _graphed(Receiver(0, **TIER3))
    (st, d), n_graphed = _counted(
        lambda: benchkit.digest_step(g_rx)(state, x))
    assert n_graphed == n_eager and _equal((st, d), eager)
    assert d.ndim == 0
    n2 = seg.shape[1]
    xp = torch.from_numpy(g_rx.frontend.stage_segment(
        state.frontend.iq_tail.numpy(), seg))
    st_s, d_s = benchkit.digest_step_staged(g_rx, n2)(state, xp)
    assert torch.equal(d_s, d) and _equal(st_s, st)
    assert _equal((st_s, d_s), benchkit._digest_staged_fn(rx, n2, state, xp))
    assert len(g_rx.graphs) == 2
    _, jd = jbenchkit.digest_step(jbank.rx)(jst, jnp.asarray(seg))
    assert jd.shape == (2,)
    np.testing.assert_allclose(float(d), float(np.sum(jd)), rtol=1e-5)


# -- the +20 dB adjacent-channel interferer ------------------------------------

def test_adjacent_channel_interferer_through_the_graphed_bank():
    """The JAX package's case (``tests/test_channelizer.py``, a weak
    station at -400 kHz beside one +20 dB louder 200 kHz away) at tier 3:
    the JAX channelizer and bank over 2 blocks, then from their carried
    states 2 more through both packages' two-stage paths (the port's into
    the graphed ``ChannelBank.run_segment``): both stations' audio > 60 dB
    and RDS bits equal."""
    stations = [
        dict(offset_hz=-400_000, ps_name="WEAK-OK ", pi=0x3E3E, pty=4,
             tone_left=700.0, tone_right=700.0, amp=1.0),
        dict(offset_hz=-200_000, ps_name="LOUD-ADJ", pi=0x4F4F, pty=8,
             tone_left=1800.0, tone_right=1800.0, amp=10.0)]
    offs = [s["offset_hz"] for s in stations]
    iw, qw, _ = synth.wideband_iq(CFG, WIDE_FS, stations, 4)
    half = len(iw) // 2
    jch = JChannelizer(JCFG, WIDE_FS, offs)
    jbank = JBank(JReceiver(0, frontend_impl="pallas_interpret", **TIER3), 2)
    (i_ds, q_ds), jcs = jch(jnp.asarray(iw[:half]), jnp.asarray(qw[:half]),
                            jch.init_state())
    jst, _ = jbank.run_segment(jbank.init_state(), jch.to_uint8(i_ds, q_ds))
    jst = jst._replace(rds=jst.rds._replace(
        block_count=jnp.full((2,), 6, jnp.int32)))
    (i_ds, q_ds), _ = jch(jnp.asarray(iw[half:]), jnp.asarray(qw[half:]),
                          jcs)
    _, jout = jbank.run_segment(jst, jch.to_uint8(i_ds, q_ds))
    ch = Channelizer(CFG, WIDE_FS, offs)
    rx = _graphed(Receiver(0, **TIER3))
    u8, _ = ch.call_u8(torch.from_numpy(iw[half:]),
                       torch.from_numpy(qw[half:]), _to_port(jcs))
    state = _to_port(jst)
    _, out = ChannelBank(rx, 2).run_segment(state, u8)
    assert len(rx.graphs) == 1
    assert _equal(out, Receiver(0, **TIER3).step(state, u8)[1])
    for s in range(2):
        for rail in ("left", "right"):
            assert _snr(np.asarray(getattr(jout, rail))[s],
                        getattr(out, rail)[s]) > 60.0, (s, rail)
    np.testing.assert_array_equal(out.rds_nbits.numpy(),
                                  np.asarray(jout.rds_nbits))
    np.testing.assert_array_equal(out.rds_bits.numpy(),
                                  np.asarray(jout.rds_bits))
    assert int(out.rds_nbits[0].sum()) > 0
