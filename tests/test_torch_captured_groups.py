"""The port's framers on the 56 off-air RDS group registers of
``tests/test_captured_groups.py``, beside the JAX package's framers.

Twin of ``tests/test_captured_groups.py``: the same captured registers (PI
0xC27A, PTY Rock, dynamic PS '  Love  '/'  Dies  ', RadioText 'Foo
Fighters - Love Dies Young') through ``RdsFramer`` and
``SyncByOffsetDecoder`` of ``real_time_sdr_tpu_torch.models.rds_framing``
with the same frozen expectations, and the JAX framers run on the same
streams: every event field equal, and every event callback in the same
order. The bit streams come from the port's ``utils.synth`` and equal the
JAX package's.
"""

import dataclasses

import numpy as np
import pytest

from real_time_sdr_tpu.models import rds_framing as jfr
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.models.rds_framing import (RdsFramer,
                                                        SyncByOffsetDecoder)
from real_time_sdr_tpu_torch.utils import synth
from tests.test_captured_groups import (CAPTURED_REGS, EXPECT_PI,
                                        EXPECT_PS_TAIL, EXPECT_PTY, EXPECT_RT,
                                        _reg_words)

TWINS = {RdsFramer: jfr.RdsFramer, SyncByOffsetDecoder: jfr.SyncByOffsetDecoder}


def _stream() -> np.ndarray:
    bits = []
    for g in CAPTURED_REGS:
        words = _reg_words(g)
        b = synth.group_to_bits(words)
        assert b == jsynth.group_to_bits(words)
        bits.extend(b)
    return np.array(bits, dtype=np.int8)


def _run(cls, stream, **kw):
    """Feed ``stream`` to the port's framer and its JAX twin; returns the
    port's framer after checking both agree field by field and in the
    order of their event callbacks."""
    logs = ([], [])
    fr = cls(on_event=lambda k, v: logs[0].append((k, v)), **kw)
    ref = TWINS[cls](on_event=lambda k, v: logs[1].append((k, v)), **kw)
    fr.feed(stream)
    ref.feed(stream)
    assert dataclasses.asdict(fr.events) == dataclasses.asdict(ref.events)
    assert logs[0] == logs[1]
    return fr


def test_captured_registers_direct_parse():
    """Group-register layer: the 56 real groups through the port's parser,
    beside the JAX parser's."""
    events, ref_events = [], []
    fr = RdsFramer(on_event=lambda k, v: events.append((k, v)))
    ref = jfr.RdsFramer(on_event=lambda k, v: ref_events.append((k, v)))
    for g in CAPTURED_REGS:
        fr._group(g)
        ref._group(g)
    assert fr.events.pi == EXPECT_PI
    assert fr.events.pty == EXPECT_PTY
    assert fr.events.radiotext.strip() == EXPECT_RT
    ps = [v for k, v in events if k == "ps"]
    assert ps[-4:] == EXPECT_PS_TAIL
    assert fr.events.groups_decoded == len(CAPTURED_REGS)
    assert dataclasses.asdict(fr.events) == dataclasses.asdict(ref.events)
    assert events == ref_events


@pytest.mark.parametrize("cls", [RdsFramer, SyncByOffsetDecoder])
def test_captured_registers_bitstream_both_framers(cls):
    """Bit layer: each captured group's 104 transmitted bits through the
    full sync walk of each framer, against its JAX twin."""
    fr = _run(cls, _stream())
    assert fr.events.pi == EXPECT_PI
    assert fr.events.pty == EXPECT_PTY
    assert fr.events.radiotext.strip() == EXPECT_RT
    assert fr.events.ps_name == EXPECT_PS_TAIL[-1]
    if cls is RdsFramer:
        assert fr.events.groups_decoded == len(CAPTURED_REGS)


def test_captured_registers_survive_bit_errors():
    """A corrupted block is rejected by CRC (or burst-corrected), the rest
    still decodes, as in the JAX framer on the same bits."""
    stream = _stream()
    rng = np.random.default_rng(3)
    bad = rng.choice(len(stream), size=6, replace=False)
    stream[bad] ^= 1
    fr = _run(RdsFramer, stream)
    assert fr.events.pi == EXPECT_PI
    assert "Foo Fighters" in fr.events.radiotext
    assert "Dies Young" in fr.events.radiotext
    _run(SyncByOffsetDecoder, stream)
