"""Host-staged ingest in the port: ``Frontend.stage_segment`` /
``call_staged`` and ``Receiver.run_segment_staged``, and the CLI's
``--staged``, on the CPU.

Bounds: staged and unstaged runs of the port are bit-identical (every
output leaf and the carried state ``torch.equal``, three chained segments
with an unstaged one in the middle) at mode 0 and at fractional mode 2;
the staged operand is the first ``tail_len + n2`` bytes of the JAX
package's flat staged operand; the port's staged frontend against the JAX
package's Pallas frontend (interpret mode) on its own ``stage_segment_full``
operand > 90 dB (the frontend kernel gate) with the tail equal; the staged
receiver against the JAX package's ``run_segment_staged`` from one carried
state: audio > 60 dB and RDS bits equal. The CLI's ``--staged 1`` and
``--staged 0`` write byte-identical PCM and equal RDS lines (groups of 5
blocks with an EOF partial group), and a ``--checkpoint`` pair joins to
the PCM of one uninterrupted staged run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_sdr_tpu.models.frontend import Frontend as JFrontend
from real_time_sdr_tpu.models.receiver import Receiver as JReceiver
from real_time_sdr_tpu_torch import cli
from real_time_sdr_tpu_torch.config import mode_config
from real_time_sdr_tpu_torch.models.frontend import Frontend
from real_time_sdr_tpu_torch.models.receiver import Receiver as _Receiver
from real_time_sdr_tpu_torch.utils import synth
from real_time_sdr_tpu_torch.utils.state import state_from_numpy

# every test here runs on the CPU: the receiver's own default is the card
Receiver = functools.partial(_Receiver, device="cpu")

CFG = mode_config(0)
RDS_PREFIXES = ("PI:", "PTY:", "Program Service:", "RadioText:",
                "RDS summary:")


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


def _two_channels(cfg, n_blocks):
    iq, _ = synth.station_iq(cfg, n_blocks, ps_name="STAGED  ", pi=0x51A6)
    pairs = iq.reshape(-1, 2)
    return np.stack([iq, np.roll(pairs, -4321, axis=0).reshape(-1)])


@pytest.mark.parametrize("mode", [0, 2])
def test_staged_bit_identical_to_unstaged(mode):
    """Three chained one-block segments: staged, unstaged, staged against
    three unstaged calls; every output leaf and the final state equal."""
    rx = Receiver(mode, stereo=True, rds=True, pll_tier=3)
    n2 = 2 * rx.cfg.block_size_iq
    iq = _two_channels(rx.cfg, 3)
    segs = [np.ascontiguousarray(iq[:, k * n2:(k + 1) * n2]) for k in range(3)]
    ref_st, refs = rx.init_state(2), []
    for seg in segs:
        ref_st, out = rx.run_segment(ref_st, torch.from_numpy(seg))
        refs.append(out)
    st, tail, outs = rx.init_state(2), None, []
    for k, seg in enumerate(segs):
        if k == 1:
            st, out = rx.run_segment(st, torch.from_numpy(seg))
        else:
            tail = st.frontend.iq_tail.numpy()
            xp = rx.frontend.stage_segment(tail, seg)
            assert xp.shape == (2, rx.frontend.staged_len(n2))
            st, out = rx.run_segment_staged(st, torch.from_numpy(xp), n2)
        outs.append(out)
    for ref, out in zip(refs, outs):
        got, want = _leaves(out), _leaves(ref)
        assert len(got) == len(want) == 5
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(st), _leaves(ref_st)))


def test_stage_segment_is_the_jax_operand_prefix():
    """The staged operand is [tail | segment]: the first tail_len + n2
    bytes of the JAX package's flat staged operand (whose rest is its 0x80
    pad), for batched rows and into a caller's buffer."""
    jfe = JFrontend(CFG, impl="pallas_interpret")
    fe = Frontend(CFG)
    rng = np.random.default_rng(3)
    n2 = 2 * CFG.block_size_iq
    tail = rng.integers(0, 256, (2, fe.tail_len), dtype=np.uint8)
    seg = rng.integers(0, 256, (2, n2), dtype=np.uint8)
    want = jfe.stage_segment(tail, seg)[..., :fe.tail_len + n2]
    np.testing.assert_array_equal(fe.stage_segment(tail, seg), want)
    out = np.zeros((2, fe.staged_len(n2)), np.uint8)
    assert fe.stage_segment(tail, seg, out=out) is out
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(fe.stage_segment(tail[0], seg[0]), want[0])


def test_staged_entry_errors():
    """Bad operands raise and say why; a one-row staged call's state does
    not alias the operand."""
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    fe, st = rx.frontend, rx.init_state(1)
    n2 = 2 * CFG.block_size_iq
    tail, seg = np.full((1, fe.tail_len), 128, np.uint8), np.zeros(
        (1, n2), np.uint8)
    with pytest.raises(ValueError, match="tail"):
        fe.stage_segment(tail[:, 1:], seg)
    with pytest.raises(ValueError, match="out"):
        fe.stage_segment(tail, seg, out=np.zeros((1, n2), np.uint8))
    with pytest.raises(TypeError):
        fe.stage_segment(tail.astype(np.int16), seg)
    xp = torch.from_numpy(fe.stage_segment(tail, seg))
    # the caller may reuse its operand buffer: the state owns its tail
    st2, _ = rx.run_segment_staged(st, xp, n2)
    kept = st2.frontend.iq_tail.clone()
    xp_again = xp.clone()
    xp.fill_(7)
    assert torch.equal(st2.frontend.iq_tail, kept)
    xp = xp_again
    with pytest.raises(TypeError, match="not ported"):
        rx.run_segment_staged(st, (xp, xp, xp), n2)
    with pytest.raises(TypeError):
        rx.run_segment_staged(st, xp.to(torch.int8), n2)
    with pytest.raises(ValueError, match="staged_len|bytes long"):
        rx.run_segment_staged(st, xp[:, :-2], n2)
    with pytest.raises(ValueError, match="whole number"):
        rx.run_segment_staged(st, xp[:, :-2], n2 - 2)


def test_staged_frontend_matches_jax_pallas():
    """The port's call_staged against the JAX package's Pallas frontend
    (interpret mode) on its stage_segment_full operand, from a random tail
    and carried discriminator samples, per channel: > 90 dB, tail equal,
    carried samples within 1e-4."""
    jfe = JFrontend(CFG, impl="pallas_interpret")
    fe = Frontend(CFG)
    rng = np.random.default_rng(5)
    n2 = 2 * 2 * CFG.block_size_iq
    iq = _two_channels(CFG, 3)
    tails = [iq[c, :fe.tail_len] for c in range(2)]
    segs = [iq[c, fe.tail_len:fe.tail_len + n2] for c in range(2)]
    prev = rng.uniform(-0.5, 0.5, (2, 2)).astype(np.float32)
    st = fe.init_state(2)._replace(prev_i=torch.from_numpy(prev[:, 0]),
                                   prev_q=torch.from_numpy(prev[:, 1]))
    xp = torch.from_numpy(fe.stage_segment(np.stack(tails), np.stack(segs)))
    demod, new = fe.call_staged(xp, n2, st)
    call = jax.jit(functools.partial(jfe.call_staged, n2=n2))
    for c in range(2):
        rows, bnd, tail_b = jfe.stage_segment_full(tails[c], segs[c])
        jst = jfe.init_state()._replace(prev_i=jnp.float32(prev[c, 0]),
                                        prev_q=jnp.float32(prev[c, 1]))
        jd, jnew = call(xp_u8=jnp.asarray(rows), state=jst,
                        aux=(jnp.asarray(bnd), jnp.asarray(tail_b)))
        assert _snr(jd, demod[c]) > 90.0, _snr(jd, demod[c])
        np.testing.assert_array_equal(new.iq_tail[c].numpy(),
                                      np.asarray(jnew.iq_tail))
        assert abs(float(new.prev_i[c]) - float(jnew.prev_i)) < 1e-4
        assert abs(float(new.prev_q[c]) - float(jnew.prev_q)) < 1e-4


def test_run_segment_staged_matches_jax():
    """One carried state (the JAX receiver's after two blocks, its RDS
    decoder past the warm-up gate) into both packages' staged segment
    mode over two blocks: audio > 60 dB, RDS bits equal."""
    jrx = JReceiver(0, stereo=True, rds=True, pll_tier=3,
                    frontend_impl="pallas_interpret")
    n2 = 2 * 2 * CFG.block_size_iq
    iq = _two_channels(CFG, 4)
    run = jax.jit(jrx.run_segment)
    staged = jax.jit(functools.partial(jrx.run_segment_staged, n2=n2))
    mids, jouts = [], []
    for c in range(2):
        jst, _ = run(jrx.init_state(), jnp.asarray(iq[c, :n2]))
        jst = jst._replace(rds=jst.rds._replace(
            block_count=jnp.int32(6)))
        mids.append(jax.tree_util.tree_map(np.asarray, jst))
        xp = jrx.frontend.stage_segment_full(np.asarray(jst.frontend.iq_tail),
                                             iq[c, n2:])
        jouts.append(staged(jst, jax.device_put(xp))[1])
    rx = Receiver(0, stereo=True, rds=True, pll_tier=3)
    st = state_from_numpy(jax.tree_util.tree_map(
        lambda *a: np.stack(a), *mids), "cpu")
    xp = rx.frontend.stage_segment(st.frontend.iq_tail.numpy(), iq[:, n2:])
    _, out = rx.run_segment_staged(st, torch.from_numpy(xp), n2)
    for c, jo in enumerate(jouts):
        assert _snr(jo.left, out.left[c]) > 60.0
        assert _snr(jo.right, out.right[c]) > 60.0
        np.testing.assert_array_equal(out.rds_nbits[c].numpy(),
                                      np.asarray(jo.rds_nbits))
        np.testing.assert_array_equal(out.rds_bits[c].numpy(),
                                      np.asarray(jo.rds_bits))
    assert int(out.rds_nbits.sum()) > 0


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    iq, _ = synth.station_iq(CFG, 24, ps_name="STAGECLI", pi=0x2E61, pty=7)
    d = tmp_path_factory.mktemp("staged")
    n_head = 10 * 2 * CFG.block_size_iq
    for name, part in (("whole", iq), ("head", iq[:n_head]),
                       ("rest", iq[n_head:])):
        part.tofile(d / f"{name}.raw")
    return d


def _run(args, inp, out, capsys):
    rc = cli.main(["0", "r", "--cpu", "--pll-tier", "3", "--segment", "5",
                   *args, "--input", str(inp), "--output", str(out)])
    assert rc == 0
    err = capsys.readouterr().err
    return ([ln for ln in err.splitlines() if ln.startswith(RDS_PREFIXES)],
            out.read_bytes())


def test_cli_staged_serves_the_staged_path(capture, tmp_path, capsys,
                                           monkeypatch):
    """24 blocks in groups of 5 (the last holds 4, at its exact length):
    ``--staged 1`` serves every group through ``run_segment_staged``,
    ``--staged 0`` none, and both write identical PCM and RDS lines."""
    calls = []
    staged = _Receiver.run_segment_staged

    def counted(self, state, xp_u8, n2):
        calls.append(n2)
        return staged(self, state, xp_u8, n2)
    monkeypatch.setattr(_Receiver, "run_segment_staged", counted)
    blk = 2 * CFG.block_size_iq
    lines1, pcm1 = _run(["--staged", "1"], capture / "whole.raw",
                        tmp_path / "s1.pcm", capsys)
    assert calls == [5 * blk] * 4 + [4 * blk]
    lines0, pcm0 = _run(["--staged", "0"], capture / "whole.raw",
                        tmp_path / "s0.pcm", capsys)
    assert len(calls) == 5
    assert pcm1 == pcm0 and len(pcm1) == 24 * CFG.audio_block * 2 * 2
    assert lines1 == lines0 and "Program Service: STAGECLI" in lines1


def test_cli_staged_checkpoint_resume(capture, tmp_path, capsys):
    """A staged run of the first 10 blocks saves its state; a staged run of
    the other 14 resumes it (its host tail seeded from the checkpoint):
    the joined PCM is the uninterrupted staged run's, byte for byte."""
    ck = str(tmp_path / "ck")
    _, whole = _run(["--staged", "1"], capture / "whole.raw",
                    tmp_path / "w.pcm", capsys)
    lines_a, a = _run(["--staged", "1", "--checkpoint", ck],
                      capture / "head.raw", tmp_path / "a.pcm", capsys)
    lines_b, b = _run(["--staged", "1", "--checkpoint", ck],
                      capture / "rest.raw", tmp_path / "b.pcm", capsys)
    assert a + b == whole
    assert "Program Service: STAGECLI" in lines_a + lines_b
