"""The port's framers on the group types beyond PS, beside the JAX
package's framers.

Twin of ``tests/test_rds_groups.py``: version-B layouts (0B/2B under the
C' offset word), 4A clock-time/date, 10A PTYN, type-0 flags and AF lists,
Meggitt burst correction, A/B toggles, fuzzed streams and JSON state,
through ``RdsFramer`` and ``SyncByOffsetDecoder`` of
``real_time_sdr_tpu_torch.models.rds_framing`` with the JAX tests'
expectations. Every stream also goes through the JAX framer of the same
class: the events agree field by field, and so do the event callbacks, in
order. Groups and bits come from the port's ``utils.synth``; where a test
builds them, they equal the JAX package's.
"""

import dataclasses
import datetime
import json

import numpy as np

from real_time_sdr_tpu.models import rds_framing as jfr
from real_time_sdr_tpu.utils import synth as jsynth
from real_time_sdr_tpu_torch.models.rds_framing import (RdsFramer,
                                                        SyncByOffsetDecoder,
                                                        burst_error_table,
                                                        mjd_to_date)
from real_time_sdr_tpu_torch.ops.rds_codes import _crc_remainder
from real_time_sdr_tpu_torch.utils import synth

_MJD_EPOCH_ORDINAL = datetime.date(1858, 11, 17).toordinal()
TWINS = {RdsFramer: jfr.RdsFramer, SyncByOffsetDecoder: jfr.SyncByOffsetDecoder}


class _Pair:
    """A port framer and its JAX twin, fed the same bits; ``events`` and
    ``blocks`` are the port's, checked against the twin's on every feed."""

    def __init__(self, cls, **kw):
        self.logs = ([], [])
        self.fr = cls(on_event=lambda k, v: self.logs[0].append((k, v)),
                      **kw)
        self.ref = TWINS[cls](
            on_event=lambda k, v: self.logs[1].append((k, v)), **kw)
        self.name = cls.__name__

    @property
    def events(self):
        return self.fr.events

    def feed(self, bits) -> None:
        bits = np.asarray(bits, dtype=np.int8)
        self.fr.feed(bits)
        self.ref.feed(bits)
        assert (dataclasses.asdict(self.fr.events)
                == dataclasses.asdict(self.ref.events)), self.name
        assert self.logs[0] == self.logs[1], self.name


def _bits(groups, repeats=1) -> list[int]:
    out = []
    for _ in range(repeats):
        for g in groups:
            b = synth.group_to_bits(g)
            assert b == jsynth.group_to_bits(g)
            out.extend(b)
    return out


def _feed(pair, groups, repeats=2):
    rng = np.random.default_rng(7)
    pair.feed(list(rng.integers(0, 2, 31)) + _bits(groups, repeats))
    return pair


def _both():
    return [_Pair(RdsFramer), _Pair(SyncByOffsetDecoder)]


def test_mjd_conversion_round_trips_against_datetime():
    for ordinal in range(datetime.date(1990, 1, 1).toordinal(),
                         datetime.date(2035, 1, 1).toordinal(), 97):
        day = datetime.date.fromordinal(ordinal)
        mjd = synth.date_to_mjd(day.year, day.month, day.day)
        assert mjd == ordinal - _MJD_EPOCH_ORDINAL
        assert mjd == jsynth.date_to_mjd(day.year, day.month, day.day)
        assert mjd_to_date(mjd) == (day.year, day.month, day.day)
        assert mjd_to_date(mjd) == jfr.mjd_to_date(mjd)


def test_clocktime_group_decodes_in_both_framers():
    g = synth.clocktime_group(0x54A8, 5, 2026, 8, 18, 14, 37,
                              offset_half_hours=-9)
    assert g == jsynth.clocktime_group(0x54A8, 5, 2026, 8, 18, 14, 37,
                                       offset_half_hours=-9)
    for pair in _both():
        _feed(pair, [g], repeats=4)
        assert pair.events.clock_utc == "2026-08-18 14:37 UTC-4.5", pair.name
        assert pair.events.pi == 0x54A8


def test_clocktime_rejects_invalid_fields():
    g = synth.clocktime_group(0x54A8, 5, 2026, 8, 18, 14, 37)
    g[3] = (g[3] & ~(0x3F << 6)) | (61 << 6)  # minute = 61: invalid
    pair = _feed(_Pair(RdsFramer), [g], repeats=4)
    assert pair.events.clock_utc is None
    assert pair.events.groups_decoded > 0  # the group itself was assembled


def test_radiotext_2b_decodes_in_both_framers():
    groups = synth.radiotext_2b_groups(0x3100, 1, "SHORT 2B MESSAGE")
    assert groups == jsynth.radiotext_2b_groups(0x3100, 1,
                                                "SHORT 2B MESSAGE")
    for pair in _both():
        _feed(pair, groups)
        assert pair.events.radiotext.startswith("SHORT 2B MESSAGE"), \
            pair.name


def test_version_b_groups_use_c_prime_offset():
    """Block 3 of a version-B group carries the C' offset word, and both
    framers take it as C'."""
    g = synth.encode_group(0x1000, 2, 0, 0, 0x1000, 0x4142, version_b=True)
    assert g == jsynth.encode_group(0x1000, 2, 0, 0, 0x1000, 0x4142,
                                    version_b=True)
    bits = synth.group_to_bits(g)
    block3 = 0
    for b in bits[52:78]:
        block3 = (block3 << 1) | b
    assert block3 & 0x3FF == (_crc_remainder(0x1000, 16) ^ 0x350)  # C'
    for pair in _both():
        _feed(pair, [g], repeats=4)
        assert pair.events.pi == 0x1000, pair.name


def test_type0_flags_af_and_di_decode():
    kw = dict(af_mhz=(98.1, 101.5, 87.6), tp=True, ta=True, music=True,
              di=0b1010)
    groups = synth.ps_groups(0x54A8, 5, "FLAGTEST", **kw)
    assert groups == jsynth.ps_groups(0x54A8, 5, "FLAGTEST", **kw)
    for pair in _both():
        _feed(pair, groups, repeats=2)
        ev = pair.events
        assert ev.ps_name == "FLAGTEST", pair.name
        assert ev.traffic_program is True
        assert ev.traffic_announcement is True
        assert ev.music is True
        assert ev.di == 0b1010
        assert ev.alt_freqs_mhz == (87.6, 98.1, 101.5)


def test_type0_defaults_leave_flags_off_and_af_empty():
    pair = _feed(_Pair(RdsFramer), synth.ps_groups(0x54A8, 5, "PLAINPSN"),
                 repeats=2)
    ev = pair.events
    assert ev.ps_name == "PLAINPSN"
    assert ev.traffic_program is False and ev.traffic_announcement is False
    assert ev.music is False and ev.di == 0
    assert ev.alt_freqs_mhz == ()


def test_burst_error_table_is_collision_free():
    table = burst_error_table()
    assert table == jfr.burst_error_table()
    # bursts spanning <=5 bits in 26 positions: 26+25+2*24+4*23+8*22
    assert len(table) == 26 + 25 + 2 * 24 + 4 * 23 + 8 * 22  # 367, no alias
    for syn, (pattern, length) in list(table.items())[::17]:
        assert _crc_remainder(pattern, 26) == syn
        span = pattern.bit_length() - (pattern & -pattern).bit_length() + 1
        assert span == length <= 5


def _bits_with_burst(groups, repeats, block_idx, burst, offset_in_block=4):
    out = np.asarray(_bits(groups, repeats), dtype=np.int8)
    pos = block_idx * 26 + offset_in_block
    out[pos:pos + len(burst)] ^= np.asarray(burst, dtype=np.int8)
    return out


def test_burst_correction_recovers_groups_in_both_framers():
    groups = synth.ps_groups(0x54A8, 5, "FIXEDPSN")
    # corrupt 2 adjacent bits inside block 6 (a data block mid-stream)
    dirty = _bits_with_burst(groups, 3, block_idx=6, burst=[1, 1])
    for pair in _both():
        pair.feed(dirty)
        assert pair.events.blocks_corrected >= 1, pair.name
        assert pair.events.ps_name == "FIXEDPSN", pair.name


def test_burst_correction_respects_max_span():
    groups = synth.ps_groups(0x54A8, 5, "SPANSPAN")
    # a 5-bit burst: beyond the default <=2 limit, within the code's 5
    dirty = _bits_with_burst(groups, 3, block_idx=6, burst=[1, 0, 1, 0, 1])
    fr = _Pair(RdsFramer)  # default correct_bursts=2
    fr.feed(dirty)
    assert fr.events.blocks_corrected == 0
    fr5 = _Pair(RdsFramer, correct_bursts=5)
    fr5.feed(dirty)
    assert fr5.events.blocks_corrected >= 1
    assert fr5.events.ps_name == "SPANSPAN"
    off = _Pair(RdsFramer, correct_bursts=0)
    off.feed(dirty)
    assert off.events.blocks_corrected == 0


def test_burst_correction_improves_group_survival_at_ber():
    """At BER 3e-3 most failures are single-bit: correction should roughly
    triple group survival (analytically 73% -> 99% for 4-block groups)."""
    rng = np.random.default_rng(3)
    groups = synth.ps_groups(0x54A8, 5, "SURVIVAL") * 60  # 240 groups
    bits = np.asarray([b for g in groups for b in synth.group_to_bits(g)],
                      dtype=np.int8)
    noisy = bits ^ (rng.random(len(bits)) < 3e-3).astype(np.int8)
    plain = _Pair(RdsFramer, correct_bursts=0)
    plain.feed(noisy)
    corr = _Pair(RdsFramer)
    corr.feed(noisy)
    assert corr.events.blocks_corrected > 10
    assert corr.events.groups_decoded > plain.events.groups_decoded * 1.2
    assert corr.events.groups_decoded > 0.9 * len(groups)


def test_framers_survive_random_streams_and_recover():
    """Fuzz: arbitrary bit garbage must never raise, corrupt parser state,
    or prevent re-acquisition once a clean signal returns."""
    rng = np.random.default_rng(42)
    clean = _bits(synth.ps_groups(0x54A8, 5, "RECOVERY"), 3)
    for pair in _both():
        # phase 1: pure noise in awkward chunk sizes (incl. empty)
        for size in (0, 1, 7, 25, 26, 27, 104, 1000):
            pair.feed(rng.integers(0, 2, size))
        # phase 2: clean groups with bit errors sprinkled in
        noisy = np.asarray(clean, dtype=np.int8)
        flip = rng.integers(0, len(noisy), 12)
        noisy[flip] ^= 1
        pair.feed(noisy)
        # phase 3: clean signal again -> must decode
        pair.feed(clean)
        assert pair.events.ps_name == "RECOVERY", pair.name


def test_radiotext_ab_flag_toggle_clears_old_message():
    """Toggling the type-2 text A/B flag announces a NEW message: the
    previous text is cleared, not interleaved."""
    long_msg = "NOW PLAYING: A VERY LONG SONG TITLE HERE"
    short_msg = "SONG TWO"
    for pair in _both():
        _feed(pair, synth.radiotext_groups(0x3100, 1, long_msg, ab_flag=0))
        assert pair.events.radiotext.rstrip() == long_msg
        # the new message on the SAME contiguous bit stream
        pair.feed(_bits(synth.radiotext_groups(0x3100, 1, short_msg,
                                               ab_flag=1) * 2))
        assert pair.events.radiotext.rstrip() == short_msg, pair.name


def test_framer_state_roundtrips_through_json():
    """Checkpoint/resume: a stream split mid-group, the state through real
    JSON, gives the uninterrupted decode's events; the port's state dict
    equals the JAX framer's at the cut and loads into it."""
    pi, pty = 0x2B1C, 9
    groups = (synth.ps_groups(pi, pty, "RESUMED!", af_mhz=(99.9,))
              + synth.radiotext_groups(pi, pty, "SPLIT ACROSS RUNS")
              + [synth.clocktime_group(pi, pty, 2026, 8, 18, 3, 7)])
    rng = np.random.default_rng(5)
    stream = np.asarray(list(rng.integers(0, 2, 31)) + _bits(groups, 3),
                        dtype=np.int8)
    cut = len(stream) // 2 + 13  # mid-block, mid-group

    for cls in (RdsFramer, SyncByOffsetDecoder):
        whole = _Pair(cls)
        whole.feed(stream)

        first = _Pair(cls)
        first.feed(stream[:cut])
        blob = json.dumps(first.fr.state_dict())  # through real JSON
        assert json.loads(blob) == json.loads(
            json.dumps(first.ref.state_dict())), cls.__name__
        resumed = _Pair(cls)
        resumed.fr.load_state_dict(json.loads(blob))
        resumed.ref.load_state_dict(json.loads(blob))
        resumed.feed(stream[cut:])

        assert resumed.events == whole.events, cls.__name__
        resumed.feed(np.zeros(0, dtype=np.int8))


def test_mixed_group_schedule_full_station_metadata():
    """A realistic schedule: PS + 2A RadioText + CT interleaved."""
    pi, pty = 0x2B1C, 9
    groups = (synth.ps_groups(pi, pty, "TPU SDR ")
              + synth.radiotext_groups(pi, pty, "ALL GROUP TYPES AT ONCE")
              + [synth.clocktime_group(pi, pty, 2031, 12, 31, 23, 59,
                                       offset_half_hours=2)])
    pair = _feed(_Pair(RdsFramer), groups, repeats=2)
    assert pair.events.ps_name == "TPU SDR "
    assert pair.events.radiotext.startswith("ALL GROUP TYPES AT ONCE")
    assert pair.events.clock_utc == "2031-12-31 23:59 UTC+1.0"


def test_ptyn_10a_decodes_in_both_framers():
    groups = synth.ptyn_groups(0x6F01, 10, "FOOTBALL")
    assert groups == jsynth.ptyn_groups(0x6F01, 10, "FOOTBALL")
    for pair in _both():
        _feed(pair, groups, repeats=3)
        assert pair.events.ptyn == "FOOTBALL", pair.name
        assert pair.events.pi == 0x6F01


def test_ptyn_ab_flag_toggle_clears_previous_name():
    pair = _Pair(RdsFramer)
    _feed(pair, synth.ptyn_groups(0x6F01, 10, "FOOTBALL", ab_flag=0),
          repeats=2)
    assert pair.events.ptyn == "FOOTBALL"
    # new message under the toggled flag: only segment 1 arrives first,
    # so the stale "FOOT" chars must have been cleared, not kept
    seg1_only = synth.ptyn_groups(0x6F01, 10, "NEWS    ", ab_flag=1)[1:]
    _feed(pair, seg1_only, repeats=2)
    assert pair.events.ptyn == "        "  # segment 0 not yet received


def test_ptyn_state_survives_checkpoint():
    pair = _Pair(RdsFramer)
    _feed(pair, synth.ptyn_groups(0x6F01, 10, "FOOTBALL")[:1], repeats=1)
    blob = pair.fr.state_dict()
    resumed = _Pair(RdsFramer)
    resumed.fr.load_state_dict(blob)
    resumed.ref.load_state_dict(pair.ref.state_dict())
    _feed(resumed, synth.ptyn_groups(0x6F01, 10, "FOOTBALL")[1:], repeats=1)
    assert resumed.events.ptyn == "FOOTBALL"
