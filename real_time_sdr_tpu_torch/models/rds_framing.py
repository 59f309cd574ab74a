"""Host-side RBDS framing: sliding-window sync, group assembly, parsing.

A jax-free copy of ``RdsFramer`` and its group parser from
``real_time_sdr_tpu/models/rds_framing.py`` (which reaches jax through
``ops/rds_bits.py``), importing its code constants from
``ops/rds_codes.py``. The device produces differential-decoded bits
(1187.5 bps per channel); the data-dependent 26-bit window walk runs here
on the host, with the syndromes of all windows in one vectorized mod-2
matmul. Blocks that fail the syndrome check where the next offset word is
known get one Meggitt burst-correction attempt. ``SyncByOffsetDecoder`` is
the copy of the alternative, GNU-Radio-style sync-by-offset state machine
(the alternative RDS receiver's framer); both framers share one group
parser.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from real_time_sdr_tpu_torch.ops.rds_codes import (OFFSET_SYNDROMES,
                                                   OFFSET_WORDS,
                                                   _crc_remainder,
                                                   parity_matrix_np)

__all__ = ["PTY_NAMES", "RdsEvents", "RdsFramer", "SyncByOffsetDecoder",
           "burst_error_table", "correct_block", "mjd_to_date"]

_H = parity_matrix_np()  # (26, 10)
_SYN_TO_NAME = {v: k for k, v in OFFSET_SYNDROMES.items()}
_SYNDROME_VALUES = np.array(
    [OFFSET_SYNDROMES[k] for k in ("A", "B", "C", "Cp", "D")], dtype=np.int64)
_OFFSET_NAMES = ("A", "B", "C", "Cp", "D")
_NEXT_OFFSET = {"A": "B", "B": "C", "C": "D", "Cp": "D", "D": "A"}

PTY_NAMES = [
    "Undefined", "News", "Information", "Sports", "Talk", "Rock",
    "Classic Rock", "Adult Hits", "Soft Rock", "Top 40", "Country", "Oldies",
    "Soft", "Nostalgia", "Jazz", "Classical", "Rhythm & Blues",
    "Soft Rhythm & Blues", "Language", "Religious Music", "Religious Talk",
    "Personality", "Public", "College", "Spanish Talk", "Spanish Music",
    "Hip Hop", "Unassigned", "Unassigned", "Weather", "Emergency Test",
    "Emergency",
]


@dataclasses.dataclass
class RdsEvents:
    """Decoded protocol outputs (the reference prints these to stderr,
    src/rds_utilities.cpp:180-196)."""
    pi: int | None = None
    pty: str | None = None
    ps_name: str | None = None
    radiotext: str = " " * 64
    ptyn: str | None = None                # Program Type Name (10A)
    clock_utc: str | None = None
    traffic_program: bool | None = None    # TP (block B bit 10)
    traffic_announcement: bool | None = None  # TA (0A/0B block B bit 4)
    music: bool | None = None              # M/S flag (0A/0B block B bit 3)
    di: int | None = None                  # decoder-identification, 4 bits
    alt_freqs_mhz: tuple[float, ...] = ()  # AF list (0A block C)
    groups_decoded: int = 0
    blocks_corrected: int = 0  # blocks recovered by burst-error correction


class _GroupParsing:
    """Shared group-field parsing for both framers.

    The reference's ``parse`` (src/rds_utilities.cpp:172-199) handles group
    type 0 (Program Service); its models add type 2A RadioText
    (model/OurRDSOurDSP.py:486-528). Both are here, plus two RBDS-standard
    extensions the reference lacks: the B-version layouts (0B PS, 2B 32-char
    RadioText carried in block D only) and type 4A clock-time/date (CT:
    17-bit Modified Julian Date + UTC hour/minute + half-hour local offset).

    Subclasses provide ``events``, ``_ps_chars``, ``_rt`` and ``_on_event``.
    """

    def _parse_group_words(self, a: int, b: int, c: int, d: int) -> None:
        ev = self.events
        ev.pi = a
        group_type = (b >> 12) & 0xF
        version_b = (b >> 11) & 1
        ev.pty = PTY_NAMES[(b >> 5) & 0x1F]
        ev.traffic_program = bool((b >> 10) & 1)
        ev.groups_decoded += 1
        self._on_event("group", (ev.pi, group_type, ev.pty))
        if group_type == 0:
            # 0A and 0B both carry the PS segment in block D
            placement = b & 0x3
            ev.traffic_announcement = bool((b >> 4) & 1)
            ev.music = bool((b >> 3) & 1)
            di_bit = (b >> 2) & 1  # one DI bit per group, MSB at segment 0
            shift = 3 - placement
            ev.di = ((ev.di or 0) & ~(1 << shift)) | (di_bit << shift)
            if not version_b:
                for code in ((c >> 8) & 0xFF, c & 0xFF):
                    if 1 <= code <= 204:   # AF: 87.5 + 0.1*code MHz
                        mhz = round(87.5 + 0.1 * code, 1)
                        if mhz not in ev.alt_freqs_mhz:
                            ev.alt_freqs_mhz = tuple(sorted(
                                ev.alt_freqs_mhz + (mhz,)))
                            self._on_event("af", ev.alt_freqs_mhz)
            mask = ~(0xFFFF << (48 - 16 * placement)) & ((1 << 64) - 1)
            self._ps_chars = (self._ps_chars & mask) | (
                d << (16 * (3 - placement)))
            if placement == 3:
                name = "".join(chr((self._ps_chars >> (8 * (7 - i))) & 0xFF)
                               for i in range(8))
                ev.ps_name = name
                self._on_event("ps", name)
        elif group_type == 2:
            seg = b & 0xF
            ab_flag = (b >> 4) & 1  # text A/B flag: toggle = new message,
            if getattr(self, "_rt_flag", None) not in (None, ab_flag):
                self._rt = [" "] * 64   # receiver must clear the old text
            self._rt_flag = ab_flag
            if version_b:           # 2B: 2 chars per group from block D
                pairs = ((d >> 8) & 0xFF, d & 0xFF)
                base = seg * 2
            else:                   # 2A: 4 chars per group from C + D
                pairs = ((c >> 8) & 0xFF, c & 0xFF, (d >> 8) & 0xFF, d & 0xFF)
                base = seg * 4
            for j, ch in enumerate(pairs):
                self._rt[base + j] = chr(ch) if 32 <= ch < 127 else " "
            ev.radiotext = "".join(self._rt)
            self._on_event("radiotext", ev.radiotext)
        elif group_type == 4 and not version_b:
            ct = _parse_clocktime(b, c, d)
            if ct is not None:
                ev.clock_utc = ct
                self._on_event("clock", ct)
        elif group_type == 10 and not version_b:
            # 10A Program Type Name: 8 chars over 2 segments (block B bit 0),
            # 4 chars per group from blocks C+D; A/B flag toggle clears
            seg = b & 1
            ab_flag = (b >> 4) & 1
            if getattr(self, "_ptyn_flag", None) not in (None, ab_flag):
                self._ptyn = [" "] * 8
            self._ptyn_flag = ab_flag
            chars = ((c >> 8) & 0xFF, c & 0xFF, (d >> 8) & 0xFF, d & 0xFF)
            for j, ch in enumerate(chars):
                self._ptyn[seg * 4 + j] = chr(ch) if 32 <= ch < 127 else " "
            if seg == 1:
                ev.ptyn = "".join(self._ptyn)
                self._on_event("ptyn", ev.ptyn)


_BURST_TABLE: dict[int, tuple[int, int]] | None = None


def burst_error_table() -> dict[int, tuple[int, int]]:
    """error-syndrome -> (26-bit error pattern, burst length), length <= 5.

    The RBDS shortened cyclic code is designed to correct any single error
    burst spanning <= 5 bits per 26-bit block; the reference only DETECTS
    errors (check_block, src/rds_utilities.cpp:352-381). Meggitt decoding
    reduces to this lookup: syndromes are linear, so for received
    r = codeword + offset + e, syndrome(e) = syndrome(r) XOR the expected
    offset's syndrome, and each correctable burst has a unique syndrome
    within the design distance (shorter bursts enumerate first and claim
    any alias)."""
    global _BURST_TABLE
    if _BURST_TABLE is None:
        weights = 1 << np.arange(9, -1, -1, dtype=np.int64)
        table: dict[int, tuple[int, int]] = {}
        for length in range(1, 6):
            n_free = max(0, length - 2)
            for start in range(0, 27 - length):
                for mid in range(1 << n_free):
                    bits = np.zeros(26, dtype=np.int64)
                    bits[start] = 1
                    bits[start + length - 1] = 1
                    for j in range(n_free):
                        if (mid >> j) & 1:
                            bits[start + 1 + j] = 1
                    syn = int(((bits @ _H) % 2) @ weights)
                    pattern = 0
                    for i in range(26):
                        pattern = (pattern << 1) | int(bits[i])
                    table.setdefault(syn, (pattern, length))
        _BURST_TABLE = table
    return _BURST_TABLE


def correct_block(word26: int, syndrome: int, expect: str,
                  max_burst: int) -> int | None:
    """Try burst correction of a received 26-bit block against the offset
    expected at its position. Returns the corrected word, or None.

    max_burst bounds the accepted burst span: the code corrects up to 5,
    but a random garbage block aliases to SOME <=5 burst ~36% of the time
    vs ~5% for <=2, so short limits keep false corrections rare."""
    err_syn = syndrome ^ OFFSET_SYNDROMES[expect]
    hit = burst_error_table().get(err_syn)
    if hit is None or hit[1] > max_burst:
        return None
    return word26 ^ hit[0]


def mjd_to_date(mjd: int) -> tuple[int, int, int]:
    """Modified Julian Date -> (year, month, day), per the RDS spec annex."""
    yp = int((mjd - 15078.2) / 365.25)
    mp = int((mjd - 14956.1 - int(yp * 365.25)) / 30.6001)
    day = mjd - 14956 - int(yp * 365.25) - int(mp * 30.6001)
    k = 1 if mp in (14, 15) else 0
    return 1900 + yp + k, mp - 1 - 12 * k, day


def _parse_clocktime(b: int, c: int, d: int) -> str | None:
    """Decode a 4A group's CT fields; None if the timestamp is invalid."""
    mjd = ((b & 0x3) << 15) | (c >> 1)
    hour = ((c & 1) << 4) | ((d >> 12) & 0xF)
    minute = (d >> 6) & 0x3F
    if hour > 23 or minute > 59 or mjd < 15079:
        return None
    off = (d & 0x1F) * (-0.5 if (d >> 5) & 1 else 0.5)
    year, month, day = mjd_to_date(mjd)
    return (f"{year:04d}-{month:02d}-{day:02d} "
            f"{hour:02d}:{minute:02d} UTC{off:+.1f}")


class RdsFramer(_GroupParsing):
    """Streaming frame sync + group assembly for one channel.

    Beyond the reference's detect-only walk, blocks that fail the syndrome
    check at a position where the expected offset is known get one Meggitt
    burst-correction attempt (``correct_bursts``, see correct_block)."""

    def __init__(self, on_event: Callable[[str, object], None] | None = None,
                 correct_bursts: int = 2):
        self._tail = np.zeros(0, dtype=np.int8)
        self._reg = 0            # 64-bit group register (uint_copy twin)
        self._window: list[str] = []
        self._ps_chars = 0
        self._rt = [" "] * 64
        self._ptyn = [" "] * 8
        self.events = RdsEvents()
        self._on_event = on_event or (lambda kind, val: None)
        # correct_bursts = max burst span to repair (0 disables, code limit
        # 5). Correction is attempted ONLY at the position 26 bits after
        # >=2 consecutively accepted blocks (where the next offset word is
        # known), at most 2 corrections in a row — never while hunting
        self.correct_bursts = int(correct_bursts)
        self._expect: str | None = None
        self._run = 0          # consecutive accepted blocks
        self._corr_streak = 0  # consecutive corrected blocks

    # -- syndrome machinery ------------------------------------------------

    @staticmethod
    def syndromes(stream: np.ndarray) -> np.ndarray:
        """Syndrome value of every sliding 26-bit window (vectorized)."""
        n = len(stream) - 25
        if n <= 0:
            return np.zeros(0, dtype=np.int64)
        win = np.lib.stride_tricks.sliding_window_view(stream, 26)
        planes = (win.astype(np.int64) @ _H.astype(np.int64)) % 2  # (n, 10)
        weights = 1 << np.arange(9, -1, -1, dtype=np.int64)
        return planes @ weights

    def feed(self, bits: np.ndarray) -> None:
        """Consume differential-decoded bits; advance sync and parse groups.

        Implements the step-26-on-hit / step-1-on-miss walk
        (src/rds_utilities.cpp:384-400) over precomputed window syndromes.
        """
        stream = np.concatenate([self._tail, np.asarray(bits, dtype=np.int8)])
        synd = self.syndromes(stream)
        match = synd[:, None] == _SYNDROME_VALUES[None, :]  # (nwin, 5)
        hit_any = match.any(axis=1)
        hit_idx = np.argmax(match, axis=1)

        idx = 0
        nwin = len(synd)
        while idx < nwin:
            if hit_any[idx]:
                name = _OFFSET_NAMES[hit_idx[idx]]
                window = stream[idx:idx + 26]
                data16 = 0
                for b in window[:16]:
                    data16 = (data16 << 1) | int(b)
                self._block(name, data16)
                self._expect = _NEXT_OFFSET[name]
                self._run += 1
                self._corr_streak = 0
                idx += 26
                continue
            if (self.correct_bursts and self._expect is not None
                    and self._run >= 2 and self._corr_streak < 2):
                # exactly one block after a run of accepted ones: try
                # Meggitt correction against the expected offset (C' at C)
                word = 0
                for b in stream[idx:idx + 26]:
                    word = (word << 1) | int(b)
                fixed = None
                for name in (("C", "Cp") if self._expect == "C"
                             else (self._expect,)):
                    fixed = correct_block(word, int(synd[idx]), name,
                                          self.correct_bursts)
                    if fixed is not None:
                        break
                if fixed is not None:
                    self.events.blocks_corrected += 1
                    self._block(name, fixed >> 10)
                    self._expect = _NEXT_OFFSET[name]
                    self._run += 1
                    self._corr_streak += 1
                    idx += 26
                    continue
            self._expect = None
            self._run = 0
            self._corr_streak = 0
            idx += 1
        self._tail = stream[idx:].copy()

    # -- group assembly ----------------------------------------------------

    def _block(self, name: str, data16: int) -> None:
        slot = {"A": 0, "B": 1, "C": 2, "Cp": 2, "D": 3}[name]
        mask = ~(0xFFFF << (48 - 16 * slot)) & ((1 << 64) - 1)
        self._reg = (self._reg & mask) | (data16 << (48 - 16 * slot))
        self._window.append("C" if name == "Cp" else name)
        if len(self._window) > 4:
            self._window.pop(0)
        if self._window == ["A", "B", "C", "D"]:
            self._group(self._reg)

    def _group(self, g: int) -> None:
        self._parse_group_words((g >> 48) & 0xFFFF, (g >> 32) & 0xFFFF,
                                (g >> 16) & 0xFFFF, g & 0xFFFF)

    # -- checkpoint/resume ---------------------------------------------------
    # The device DSP state is a pytree (utils/state.py); this is its host
    # twin, so a resumed decode continues mid-group with no re-sync.

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of sync + parser + events state."""
        return {
            "tail": [int(b) for b in self._tail],
            "reg": self._reg,
            "window": list(self._window),
            "ps_chars": self._ps_chars,
            "rt": "".join(self._rt),
            "expect": self._expect,
            "run": self._run,
            "corr_streak": self._corr_streak,
            "rt_flag": getattr(self, "_rt_flag", None),
            "ptyn": "".join(self._ptyn),
            "ptyn_flag": getattr(self, "_ptyn_flag", None),
            "events": dataclasses.asdict(self.events),
        }

    def load_state_dict(self, d: dict) -> None:
        self._tail = np.asarray(d["tail"], dtype=np.int8)
        self._reg = int(d["reg"])
        self._window = list(d["window"])
        self._ps_chars = int(d["ps_chars"])
        self._rt = list(d["rt"])
        self._expect = d["expect"]
        self._run = int(d["run"])
        self._corr_streak = int(d["corr_streak"])
        self._rt_flag = d.get("rt_flag")
        self._ptyn = list(d.get("ptyn", " " * 8))
        self._ptyn_flag = d.get("ptyn_flag")
        ev = dict(d["events"])
        ev["alt_freqs_mhz"] = tuple(ev.get("alt_freqs_mhz", ()))
        self.events = RdsEvents(**ev)


class SyncByOffsetDecoder(_GroupParsing):
    """Alternative framer: GNU-Radio-style sync-by-offset state machine.

    The reference ships this decoder dormant (``error_detection``,
    src/rds_utilities.cpp:202-311, a port of model/OurRDS.py:405-509) beside
    its active sliding-window framer. Semantics: hunt until two syndrome
    hits land exactly 26*k bits apart (presync -> sync), then step in
    26-bit blocks checking each block's CRC against the offset word
    expected at its position (with the C' fallback at position 2), assemble
    groups from runs of good blocks, and drop sync when more than
    ``lose_threshold`` of ``window_blocks`` consecutive blocks are bad.

    The reference's group-assembly register is reset every bit (a bug noted
    in SURVEY.md); this implementation assembles correctly.
    """

    _POS = {"A": 0, "B": 1, "C": 2, "Cp": 2, "D": 3}
    _BY_POS = ["A", "B", "C", "D"]

    def __init__(self, on_event: Callable[[str, object], None] | None = None,
                 lose_threshold: int = 40, window_blocks: int = 50,
                 correct_bursts: int = 2):
        self._on_event = on_event or (lambda kind, val: None)
        self.lose_threshold = lose_threshold
        self.window_blocks = window_blocks
        # in synced mode the expected offset word is known per position, so
        # failed blocks get one Meggitt burst-correction attempt spanning
        # <= correct_bursts bits (0 disables, code limit 5); corrected
        # blocks do not count toward sync loss
        self.correct_bursts = int(correct_bursts)
        self._reg = 0
        self._bit_count = 0
        self.synced = False
        self._presync: tuple[int, int] | None = None  # (pos, bit_count)
        self._block_bits = 0
        self._block_pos = 0
        self._blocks_seen = 0
        self._wrong_blocks = 0
        self._group = [None] * 4
        self.events = RdsEvents()
        self._ps_chars = 0
        self._rt = [" "] * 64
        self._ptyn = [" "] * 8
        self._crc_cache: dict[int, int] = {}

    def _syndrome(self, word26: int) -> int:
        return _crc_remainder(word26, 26)

    def _crc16(self, data: int) -> int:
        if data not in self._crc_cache:
            self._crc_cache[data] = _crc_remainder(data, 16)
        return self._crc_cache[data]

    def feed(self, bits) -> None:
        syn_to_name = _SYN_TO_NAME
        offset_words = OFFSET_WORDS
        for b in np.asarray(bits, dtype=np.int64):
            self._reg = ((self._reg << 1) | int(b)) & ((1 << 26) - 1)
            self._bit_count += 1
            if not self.synced:
                s = self._syndrome(self._reg)
                name = syn_to_name.get(s)
                if name is None:
                    continue
                pos = self._POS[name]
                if self._presync is None:
                    self._presync = (pos, self._bit_count)
                    continue
                last_pos, last_count = self._presync
                dist = (pos - last_pos) % 4
                if dist == 0:
                    dist = 4
                if dist * 26 == self._bit_count - last_count:
                    self.synced = True
                    self._on_event("sync", self._bit_count)
                    self._block_pos = (pos + 1) % 4
                    self._block_bits = 0
                    self._blocks_seen = 0
                    self._wrong_blocks = 0
                    self._group = [None] * 4
                else:
                    self._presync = (pos, self._bit_count)
                continue
            # synced: consume 26-bit blocks
            self._block_bits += 1
            if self._block_bits < 26:
                continue
            self._block_bits = 0
            data = (self._reg >> 10) & 0xFFFF
            checkword = self._reg & 0x3FF
            expect = self._BY_POS[self._block_pos]
            good = (checkword ^ offset_words[expect]) == self._crc16(data)
            if not good and self._block_pos == 2:  # C' fallback
                good = (checkword ^ offset_words["Cp"]) == self._crc16(data)
            if not good and self.correct_bursts:
                syn = self._syndrome(self._reg)
                for name in ((expect, "Cp") if self._block_pos == 2
                             else (expect,)):
                    fixed = correct_block(self._reg, syn, name,
                                          self.correct_bursts)
                    if fixed is not None:
                        data = (fixed >> 10) & 0xFFFF
                        self.events.blocks_corrected += 1
                        good = True
                        break
            if good:
                self._group[self._block_pos] = data
                if self._block_pos == 3 and all(
                        g is not None for g in self._group):
                    self._parse_group()
            else:
                self._wrong_blocks += 1
                self._group[self._block_pos] = None
            if self._block_pos == 3:
                self._group = [None] * 4
            self._block_pos = (self._block_pos + 1) % 4
            self._blocks_seen += 1
            if self._blocks_seen >= self.window_blocks:
                if self._wrong_blocks > self.lose_threshold:
                    self.synced = False
                    self._presync = None
                    self._on_event("sync_lost", self._wrong_blocks)
                self._blocks_seen = 0
                self._wrong_blocks = 0

    def _parse_group(self) -> None:
        a, bw, c, d = self._group
        self._parse_group_words(a, bw, c, d)

    def state_dict(self) -> dict:
        """JSON-serializable snapshot (checkpoint twin of RdsFramer's)."""
        return {
            "reg": self._reg,
            "bit_count": self._bit_count,
            "synced": self.synced,
            "presync": list(self._presync) if self._presync else None,
            "block_bits": self._block_bits,
            "block_pos": self._block_pos,
            "blocks_seen": self._blocks_seen,
            "wrong_blocks": self._wrong_blocks,
            "group": list(self._group),
            "ps_chars": self._ps_chars,
            "rt": "".join(self._rt),
            "rt_flag": getattr(self, "_rt_flag", None),
            "ptyn": "".join(self._ptyn),
            "ptyn_flag": getattr(self, "_ptyn_flag", None),
            "events": dataclasses.asdict(self.events),
        }

    def load_state_dict(self, d: dict) -> None:
        self._reg = int(d["reg"])
        self._bit_count = int(d["bit_count"])
        self.synced = bool(d["synced"])
        self._presync = tuple(d["presync"]) if d["presync"] else None
        self._block_bits = int(d["block_bits"])
        self._block_pos = int(d["block_pos"])
        self._blocks_seen = int(d["blocks_seen"])
        self._wrong_blocks = int(d["wrong_blocks"])
        self._group = list(d["group"])
        self._ps_chars = int(d["ps_chars"])
        self._rt = list(d["rt"])
        self._rt_flag = d.get("rt_flag")
        self._ptyn = list(d.get("ptyn", " " * 8))
        self._ptyn_flag = d.get("ptyn_flag")
        ev = dict(d["events"])
        ev["alt_freqs_mhz"] = tuple(ev.get("alt_freqs_mhz", ()))
        self.events = RdsEvents(**ev)
