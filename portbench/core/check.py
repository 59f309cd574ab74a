"""How ``correct`` is decided: the program's answers against the plain
reference (``portbench/reference``) and against the traffic's own truth.

- PCM: a sample of (stream, block) pairs drawn from the seed, among the
  blocks the program delivered inside the measured window. The reader
  keeps every ``keep_every``-th block of the sampled streams (the
  traffic's, from a seeded residue); ``PER_STREAM`` of those are
  compared. For each, the
  reference runs the ``WARM_BLOCKS`` stream blocks before it and the
  block itself (the capture played in a loop, as the stream carried it) from zero
  history and the block's PCM is held against the program's, each block
  by ||program - reference|| / ||reference||: ``pcm_rel_err_median``,
  the median over the compared blocks, is what the cells' limits hold;
  ``pcm_rel_err``, the largest, is reported. A sound float32 program
  reads ~4e-4 in one block in several hundred: where the pilot passes
  within rounding of zero on one sample, the tier-1 loop's phase detector
  may read it with the other sign and turn by pi, a transient of some
  twenty audio samples.
- RDS: the groups and names the program's framers reported, against the
  PI and PS the generator encoded for each station (exact): ``rds_wrong``
  counts streams whose PI or PS (the one decoded most) is not theirs, or
  that decoded no group in the window's second half.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.chain import WARM_BLOCKS, ReferenceChain, rel_err

PER_STREAM = 3


def sample_plan(seed: int, n_streams: int, must: list[int],
                n_total: int, every: int) -> dict[int, tuple[int, int]]:
    """{stream: (every, residue)} for the sampled streams: ``must`` and,
    drawn from the seed, the rest up to ``n_total``."""
    rng = np.random.default_rng([int(seed), 1])
    others = [k for k in range(n_streams) if k not in must]
    extra = min(len(others), max(0, n_total - len(must)))
    picks = list(must) + [int(k) for k in rng.choice(others, extra,
                                                     replace=False)]
    return {k: (every, int(rng.integers(0, every))) for k in picks}


def choose(seed: int, kept: list[dict], ok) -> list[tuple]:
    """Up to ``PER_STREAM`` kept blocks a stream with ``ok(stream, j)``,
    drawn from the seed: [(stream, j, pcm bytes)]. ``kept[s]``: the
    reader's {block: bytes} of stream s."""
    rng = np.random.default_rng([int(seed), 2])
    out = []
    for s, blocks in enumerate(kept):
        js = sorted(j for j in blocks if j >= WARM_BLOCKS and ok(s, j))
        if js:
            pick = rng.choice(js, min(PER_STREAM, len(js)), replace=False)
            out.extend((s, int(j), blocks[int(j)]) for j in sorted(pick))
    return out


def _spans(capture: np.ndarray, block_bytes: int, j: int) -> np.ndarray:
    """Blocks j - WARM_BLOCKS .. j of the stream, the capture played in a
    loop (the capture need not hold a whole number of blocks)."""
    start = (j - WARM_BLOCKS) * block_bytes
    idx = np.arange(start, start + (WARM_BLOCKS + 1) * block_bytes,
                    dtype=np.int64) % capture.shape[0]
    return capture[idx]


def reference_pcm(rx: dict, items: list[tuple], demod_of,
                  precision: str = "f64") -> np.ndarray:
    """(len(items), 2 * audio_block) int16 reference PCM of each item's
    block; ``demod_of(chain, item)`` gives its (n_if,) demod span."""
    ch = ReferenceChain(rx, precision)
    fm = np.stack([demod_of(ch, it) for it in items])
    left, right = ch.stereo(fm)
    pcm = ch.pcm(left, right)
    n_audio = rx["block_size_iq"] // rx["rf_decim"] * rx["audio_up"] \
        // rx["audio_down"]
    return pcm[:, -2 * n_audio:]


def band_demod_of(cfg: dict, capture: np.ndarray):
    rx, band = cfg["receiver"], cfg["band"]
    from portbench.traffic.generator import band_offsets
    offs = band_offsets(band["stations"], band["raster_hz"])
    wide_fs = band["wide_fs"]
    bb = 2 * rx["block_size_iq"] * (wide_fs // rx["rf_fs"])
    taps = {}

    def demod(ch: ReferenceChain, it) -> np.ndarray:
        if ch.precision not in taps:
            taps[ch.precision] = ch.band_taps(wide_fs, band["taps_factor"],
                                              band["channel_fc_share"])
        return ch.band_demod(_spans(capture, bb, it[1]), [offs[it[0]]],
                             wide_fs, taps[ch.precision])[0]
    return demod


def listener_demod_of(cfg: dict, captures: list[np.ndarray]):
    bb = 2 * cfg["receiver"]["block_size_iq"]

    def demod(ch: ReferenceChain, it) -> np.ndarray:
        return ch.listener_demod(_spans(captures[it[0]], bb, it[1])[None])[0]
    return demod


def pcm_numbers(rx: dict, items: list[tuple], demod_of,
                control: bool = False) -> dict:
    """``pcm_rel_err`` (the worst block) and ``pcm_rel_err_median`` over
    the items (the bf16 reference in the program's place when
    ``control``), and how many were compared."""
    if not items:
        return dict(pcm_rel_err=None, pcm_rel_err_median=None, compared=0)
    ref = reference_pcm(rx, items, demod_of)
    if control:
        prog = reference_pcm(rx, items, demod_of, precision="bf16")
    else:
        prog = np.stack([np.frombuffer(it[2], dtype="<i2") for it in items])
    errs = [rel_err(p, r) for p, r in zip(prog, ref)]
    worst = int(np.argmax(errs))
    return dict(pcm_rel_err=float(errs[worst]),
                pcm_rel_err_median=float(np.median(errs)),
                compared=len(items), worst=[items[worst][0], items[worst][1]])


def rds_wrong(truths: list[dict], groups: dict, names: dict,
              t_half: float) -> tuple[int, list, float]:
    """(count, [[stream, what], ...], share) of streams whose RDS is wrong:
    the PI their decoded groups carry most, or the PS name their framer
    named most, is not the one encoded, or no group was decoded after
    ``t_half``. ``groups[s]``: [(time, pi)]; ``names[s]``: [ps, ...].
    ``share`` is the percentage of all decoded groups whose PI is not
    their station's: blocks that the burst correction repaired wrongly
    after a bit error, which a correct decoder also makes and which no
    lower precision moves, so they are reported and not compared."""
    bad, n_groups, n_other = [], 0, 0
    for s, tr in enumerate(truths):
        g, ps = groups.get(s, []), names.get(s, [])
        pis = [pi for _, pi in g]
        other = sum(pi != tr["pi"] for pi in pis)
        n_groups += len(pis)
        n_other += other
        late = sum(t >= t_half for t, _ in g)
        pi = max(set(pis), key=pis.count) if pis else None
        name = max(set(ps), key=ps.count) if ps else None
        if pi != tr["pi"] or name != tr["ps"] or not late:
            bad.append([s, dict(groups=len(g), other_pi=other,
                                after_half=late, pi=pi, ps=name,
                                true_ps=tr["ps"])])
    return len(bad), bad, 100.0 * n_other / max(1, n_groups)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    present and at or under it."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": lim}
        ok = ok and v is not None and v <= lim
    return ok, checks
