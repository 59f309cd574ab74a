"""Checkpoints that cross between the packages: the port's ``save_state`` /
``load_state`` and its CLI's ``--checkpoint`` against the JAX package's
``utils/state.py`` and CLI.

- A JAX state saved after 4 blocks resumes in the port's CLI, whose blocks
  5-8 match JAX's own blocks 5-8 (> 60 dB, the chain gate).
- A state the port's CLI saved loads with JAX's ``load_state(path,
  rx.init_state())`` and continues as an uninterrupted JAX run (> 60 dB).
- The ``.rds.json`` framer sidecar round-trips both ways, and the file's
  keys, shapes and dtypes equal those of a JAX file of the same receiver.
- A file whose leaves do not fit the receiver raises ``ValueError`` (the
  CLI then warns and starts fresh).
- Plain tuples and lists of states (the wideband CLI saves the pair
  ``(frontend state, bank state)``) walk in ``jax.tree_util``'s flatten
  order through ``map_state``, ``save_state`` and ``load_state``; a JAX
  wideband checkpoint loads into the port and the port's back into JAX,
  leaf for leaf, for both wideband frontends.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import mk_channelizer
from real_time_sdr_tpu.models.rds_framing import RdsFramer as JRdsFramer
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu.models.wideband_frontend import \
    FusedWidebandFrontend as JFused
from real_time_sdr_tpu.parallel.channel import ChannelBank as JBank
from real_time_sdr_tpu.utils import state as jstate
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu.utils.audio import stereo_pcm as jstereo_pcm
from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.models.channelizer import \
    Channelizer as _Channelizer
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend as _FusedWidebandFrontend
from real_time_sdr_tpu_torch.parallel.channel import ChannelBank
from real_time_sdr_tpu_torch.utils import state as tstate

# every test here runs on the CPU: the receiver's and the wideband
# frontends' own default is the card
Receiver = functools.partial(_Receiver, device="cpu")
Channelizer = functools.partial(_Channelizer, device="cpu")
FusedWidebandFrontend = functools.partial(_FusedWidebandFrontend,
                                          device="cpu")


def _snr(ref, y):
    ref = np.asarray(ref, np.float64)
    e = np.asarray(y, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-30))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """8 blocks of one station, and the two 4-block halves as files."""
    cfg = JReceiver(0).cfg
    iq, _ = jsynth.station_iq(cfg, 8, ps_name="CKPT-RUN", pi=0x4321, pty=7)
    d = tmp_path_factory.mktemp("ckpt")
    half = 4 * 2 * cfg.block_size_iq
    iq[:half].tofile(d / "first.raw")
    iq[half:].tofile(d / "second.raw")
    return iq, half, d


def _jax_blocks(jrx, state, iq):
    """JAX per-block run (the CLI's serving shape): (state, stereo PCM)."""
    step = jax.jit(jrx.step)
    blocks = iq.reshape(-1, 2 * jrx.cfg.block_size_iq)
    pcm = []
    for blk in blocks:
        state, out = step(state, jnp.asarray(blk))
        pcm.append(np.asarray(jstereo_pcm(out.left, out.right)))
    return state, np.concatenate(pcm)


def _cli(args, inp, out):
    return cli.main(["--cpu", *args, "--input", str(inp), "--output",
                     str(out)])


def test_jax_checkpoint_resumes_in_port_cli(capture, tmp_path, capsys):
    iq, half, d = capture
    jrx = JReceiver(0, stereo=True, pll_tier=1)
    st, _ = _jax_blocks(jrx, jrx.init_state(), iq[:half])
    path = str(tmp_path / "jax_state.npz")
    jstate.save_state(path, st)
    _, ref = _jax_blocks(jrx, st, iq[half:])
    assert _cli(["0", "s", "--checkpoint", path], d / "second.raw",
                tmp_path / "out.pcm") == 0
    assert "resumed state from" in capsys.readouterr().err
    got = np.fromfile(tmp_path / "out.pcm", "<i2")
    assert got.shape == ref.shape
    assert _snr(ref, got) > 60.0


def test_port_checkpoint_resumes_in_jax(capture, tmp_path, capsys):
    iq, half, d = capture
    path = str(tmp_path / "port_state")       # the .npz suffix is added
    assert _cli(["0", "s", "--checkpoint", path], d / "first.raw",
                tmp_path / "a.pcm") == 0
    assert "saved state to" in capsys.readouterr().err
    jrx = JReceiver(0, stereo=True, pll_tier=1)
    like = jrx.init_state()
    st = jstate.load_state(path, like)
    _, got = _jax_blocks(jrx, st, iq[half:])
    _, ref = _jax_blocks(jrx, jrx.init_state(), iq)
    assert _snr(ref[ref.shape[0] // 2:], got) > 60.0
    # keys, shapes and dtypes equal a JAX file of the same receiver
    jpath = str(tmp_path / "jax.npz")
    jstate.save_state(jpath, st)
    with np.load(path + ".npz") as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__treedef__":
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype


def test_rds_sidecar_round_trips(capture, tmp_path, capsys):
    """A JAX state + framer sidecar resume in the port's CLI; what the port
    writes back loads into JAX's framer unchanged."""
    iq, half, d = capture
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    st, out = jax.jit(jrx.run_segment)(jrx.init_state(),
                                       jnp.asarray(iq[:half]))
    path = str(tmp_path / "r.npz")
    jstate.save_state(path, st)
    jfr = JRdsFramer()
    jfr.feed((np.arange(300) % 3 == 0).astype(np.int32))  # any bits
    with open(path + ".rds.json", "w") as f:
        json.dump({"kind": "single", "framer": jfr.state_dict()}, f)
    assert _cli(["0", "r", "--pll-tier", "3", "--checkpoint", path],
                d / "second.raw", tmp_path / "r.pcm") == 0
    err = capsys.readouterr().err
    assert "resumed state from" in err
    assert "resumed RDS framer from" in err
    with open(path + ".rds.json") as f:
        back = json.load(f)
    assert back["kind"] == "single"
    fr2 = JRdsFramer()
    fr2.load_state_dict(back["framer"])
    assert json.loads(json.dumps(fr2.state_dict())) == back["framer"]
    st2 = jstate.load_state(path, jrx.init_state())
    assert int(st2.rds.block_count) == 8


def test_save_load_round_trip_and_mismatch(tmp_path, capsys):
    rx = Receiver(0, stereo=True, rds=True, rds_timing="tracked")
    state = rx.init_state(2)
    path = str(tmp_path / "s.npz")
    tstate.save_state(path, state)
    back = tstate.load_state(path, rx.init_state(2))
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert type(back.rds.track).__name__ == "TimingTrack"
    with pytest.raises(ValueError, match="shape"):
        tstate.load_state(path, rx.init_state(1))
    with pytest.raises(ValueError, match="leaves"):   # comb: no track
        tstate.load_state(path, Receiver(0, stereo=True, rds=True)
                          .init_state(2))
    # a float64 phase or an int64 counter is not the JAX layout
    for field, dtype in (("phase", torch.float64), ("trig", torch.int64)):
        pll = state.audio.pll
        wrong = state._replace(audio=state.audio._replace(pll=pll._replace(
            **{field: getattr(pll, field).to(dtype)})))
        bad = str(tmp_path / f"bad_{field}.npz")
        tstate.save_state(bad, wrong)
        with pytest.raises(ValueError, match="dtype"):
            tstate.load_state(bad, rx.init_state(2))
    # the CLI never dies on an incompatible checkpoint: it starts fresh
    raw = tmp_path / "one.raw"
    np.full(2 * JReceiver(0).cfg.block_size_iq, 128, np.uint8).tofile(raw)
    assert _cli(["0", "m", "--checkpoint", path], raw,
                tmp_path / "m.pcm") == 0
    assert "could not resume DSP state" in capsys.readouterr().err


def _filled(tree, seed):
    """The tree with every leaf replaced by seeded values of its shape and
    dtype (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def fill(leaf):
        a = np.asarray(leaf)
        if a.dtype == np.bool_:
            return rng.integers(0, 2, a.shape).astype(np.bool_)
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(0, 100, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree_util.tree_map(fill, tree)


@pytest.mark.parametrize("kind", ["tuple", "list", "nested"])
def test_tuple_and_list_trees(kind, tmp_path):
    """A plain tuple or list of states is a tree: ``map_state`` rebuilds the
    same container, the leaves come in ``jax.tree_util``'s order (None
    dropped), and ``save_state`` / ``load_state`` round-trip it."""
    rx = Receiver(0, stereo=True, rds=True)
    a = tstate.state_from_numpy(_filled(tstate.state_to_numpy(
        rx.init_state(2)), 1), "cpu")
    b = tstate.state_from_numpy(_filled(tstate.state_to_numpy(
        Receiver(0).init_state(1)), 2), "cpu")
    tree = {"tuple": (a, b), "list": [a, b], "nested": (a, [b, None])}[kind]
    want = jax.tree_util.tree_leaves(tree)
    got = tstate._leaves(tree)
    assert len(got) == len(want) and all(x is y for x, y in zip(got, want))
    mapped = tstate.map_state(tree, lambda t: t.clone())
    assert type(mapped) is type(tree) and len(mapped) == len(tree)
    assert type(mapped[0]).__name__ == "ReceiverState"
    if kind == "nested":
        assert type(mapped[1]) is list and mapped[1][1] is None
    for x, y in zip(jax.tree_util.tree_leaves(mapped), want):
        assert x is not y and x.dtype == y.dtype and torch.equal(x, y)
    path = str(tmp_path / "pair.npz")
    tstate.save_state(path, tree)
    like = tstate.map_state(tree, torch.zeros_like)
    back = tstate.load_state(path, like)
    assert type(back) is type(tree)
    for x, y in zip(jax.tree_util.tree_leaves(back), want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="leaves"):
        tstate.load_state(path, tree[0])


@pytest.mark.parametrize("frontend", ["fused", "two_stage"])
def test_wideband_checkpoint_cross_loads(frontend, tmp_path):
    """The wideband CLI's checkpoint, ``(frontend state, bank state)``: a
    file JAX's ``save_state`` wrote loads into the port with leaf i equal to
    ``jax.tree_util.tree_flatten``'s leaf i, and the file the port writes
    back loads with JAX's ``load_state``, exactly, for both frontends."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3)
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    offs = [-450_000, 150_000, 450_000]
    wide_fs = 4 * rx.cfg.rf_fs
    if frontend == "fused":
        jfe = JFused(jrx.cfg, wide_fs, offs)
        fe = FusedWidebandFrontend(rx.cfg, wide_fs, offs)
    else:
        jfe = mk_channelizer(jrx.cfg, wide_fs, offs, fold=True)
        fe = Channelizer(rx.cfg, wide_fs, offs)
    jlike = (jfe.init_state(), JBank(jrx, 3).init_state())
    like = (fe.init_state(), ChannelBank(rx, 3).init_state())
    jpair = _filled(jlike, 7)
    jpath = str(tmp_path / "jax_wb.npz")
    jstate.save_state(jpath, jpair)
    pair = tstate.load_state(jpath, like)
    assert type(pair) is tuple and len(pair) == 2
    assert type(pair[0]).__name__ == type(jlike[0]).__name__
    jleaves = jax.tree_util.tree_leaves(jpair)
    leaves = tstate._leaves(pair)
    assert len(leaves) == len(jleaves)
    for t, a in zip(leaves, jleaves):
        np.testing.assert_array_equal(t.numpy(), a)
        assert t.numpy().dtype == a.dtype
    ppath = str(tmp_path / "port_wb")          # the .npz suffix is added
    tstate.save_state(ppath, pair)
    back = jstate.load_state(ppath, jlike)
    for a, b in zip(jax.tree_util.tree_leaves(back), jleaves):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(ppath + ".npz") as x, np.load(jpath) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            if k != "__treedef__":
                assert x[k].shape == y[k].shape and x[k].dtype == y[k].dtype
