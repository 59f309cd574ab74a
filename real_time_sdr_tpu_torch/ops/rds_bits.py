"""RDS symbol slicing and Manchester/differential bit decoding, batched over
channels.

Port of ``real_time_sdr_tpu/ops/rds_bits.py``: the comb CDR
(``BitSyncState``, ``bit_sync_init``, ``cdr_offset``, ``decode_block_bits``,
``decode_segment_bits``) and the tracking CDR (``TimingTrack``,
``timing_init``, ``comb_peak_phase``, ``cdr_tracked``,
``decode_block_bits_tracked``). Every state leaf carries a leading channel
axis (the JAX functions take scalar leaves and leave channels to vmap).
``decode_segment_bits`` keeps the JAX package's closed-form cross-block
chains (prefix-XOR of the Manchester parity, fill-forwards of the half
symbol and the last bit), with gathers for the indexed reads, and is
bit-identical to decoding block by block with the 5-block warm-up gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BitSyncState", "bit_sync_init", "cdr_offset",
           "decode_block_bits", "decode_segment_bits", "TimingTrack",
           "timing_init", "comb_peak_phase", "cdr_tracked",
           "decode_block_bits_tracked"]

_I32 = torch.int32


class BitSyncState(NamedTuple):
    """Carried Manchester/differential state, one entry per channel."""
    first: torch.Tensor        # (C,) bool: no block decoded yet
    start: torch.Tensor        # (C,) int32 0/1: alignment / prepend flag
    half_symbol: torch.Tensor  # (C,) int32: carried trailing symbol
    last_bit: torch.Tensor     # (C,) int32: last pre-differential bit


def bit_sync_init(batch: int, device=None) -> BitSyncState:
    z = torch.zeros((batch,), dtype=_I32, device=device)
    return BitSyncState(first=torch.ones((batch,), dtype=torch.bool,
                                         device=device),
                        start=z, half_symbol=z.clone(), last_bit=z.clone())


def cdr_offset(signal: torch.Tensor, sps: int) -> torch.Tensor:
    """Clock/data recovery: the max-|energy| comb phase. signal (..., L) ->
    int32 offset in [0, sps); ties go to the lowest index."""
    n = signal.shape[-1] // sps
    comb = torch.abs(signal[..., :n * sps].reshape(
        signal.shape[:-1] + (n, sps)))
    return torch.argmax(comb.sum(dim=-2), dim=-1).to(_I32)


def _pick(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """One entry per row: values (..., n), index (...,) -> (...,)."""
    return torch.gather(values, -1, index[..., None].to(torch.int64))[..., 0]


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Row-wise gather: values (C, n), index (C, m) -> (C, m)."""
    return torch.gather(values, -1, index.to(torch.int64))


def _exclusive(x: torch.Tensor) -> torch.Tensor:
    """Shift right by one along the last axis, zero first."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def decode_segment_bits(clean: torch.Tensor, state: BitSyncState,
                        block_count: torch.Tensor, sps: int,
                        max_symbols: int, max_bits: int,
                        warm_after: int = 5):
    """Slice + decode nb blocks per channel with no per-block loop.

    clean (C, nb, L) f32; state leaves (C,); block_count (C,) int32.
    Returns (bits (C, nb, max_bits) int32, n_bits (C, nb) int32, state).
    Blocks with block_count + b <= warm_after emit no bits and leave the
    carried state alone (the reference's warm-up gate).
    """
    if clean.ndim != 3:
        raise ValueError(f"clean must be (C, nb, L), got {tuple(clean.shape)}")
    C, nb, L = clean.shape
    S = max_symbols
    if S * sps < L:
        raise ValueError(f"max_symbols*sps = {S * sps} < block length {L}")

    # --- per-block half: comb CDR + slice --------------------------------
    offset = cdr_offset(clean, sps)                          # (C, nb)
    padded = torch.nn.functional.pad(clean, (0, S * sps - L))
    frames = padded.reshape(C, nb, S, sps)
    soft = torch.gather(frames, -1, offset[..., None, None].to(torch.int64)
                        .expand(C, nb, S, 1))[..., 0]
    sym = (soft > 0).to(_I32)                                # (C, nb, S)
    idx_s = torch.arange(S, dtype=_I32, device=clean.device)
    n_sym = (L - offset + sps - 1) // sps                    # (C, nb)
    sym = torch.where(idx_s < n_sym[..., None], sym, 0)
    return _symbols_to_bits(sym, n_sym, state, block_count, max_bits,
                            warm_after)


def _symbols_to_bits(sym: torch.Tensor, n_sym: torch.Tensor,
                     state: BitSyncState, block_count: torch.Tensor,
                     max_bits: int, warm_after: int):
    """Manchester-align + differential-decode sliced symbols, shared by the
    comb and the tracking CDR: sym (C, nb, S) int32 in {0, 1} with the
    first n_sym (C, nb) valid, the rest 0. The cross-block chains and the
    warm-up gate are ``decode_segment_bits``'s."""
    C, nb, S = sym.shape
    dev = sym.device
    idx_s = torch.arange(S, dtype=_I32, device=dev)

    # block-0 alignment score: pairs starting even minus pairs starting odd
    x = sym ^ torch.roll(sym, -1, dims=-1)
    in_range = idx_s < (n_sym[..., None] - 1)
    even = (idx_s % 2 == 0) & in_range
    odd = (idx_s % 2 == 1) & in_range
    score = (torch.where(even, x, 0).sum(-1, dtype=_I32)
             - torch.where(odd, x, 0).sum(-1, dtype=_I32))  # (C, nb)

    # --- warm-up geometry: frozen prefix [0, k), warm suffix [k, nb) ------
    b_idx = torch.arange(nb, dtype=_I32, device=dev)
    bc = block_count.to(_I32)[:, None]
    is_warm = (bc + b_idx) > warm_after                      # (C, nb)
    k = torch.clamp(warm_after + 1 - bc, 0, nb)              # (C, 1)
    first = state.first[:, None]
    st0 = state.start.to(_I32)[:, None]

    # --- start chain: exclusive prefix-XOR of the warm parities ----------
    par = n_sym % 2
    cum_par = torch.cumsum(torch.where(is_warm, par, 0), -1, dtype=_I32) % 2
    ex_par = _exclusive(cum_par)
    init_start = torch.where(first, (score < 0).to(_I32), st0)
    anchor_start = _pick(init_start, torch.clamp(k[:, 0], 0, nb - 1))[:, None]
    start_slice = torch.where(b_idx < k, init_start, anchor_start ^ ex_par)
    prepend = torch.where(b_idx <= k, st0, start_slice)

    # --- half-symbol fill-forward -----------------------------------------
    odd_tail = par ^ start_slice
    last_sym = _pick(sym, torch.clamp(n_sym - 1, 0, S - 1))
    tag_h = torch.where(is_warm & (odd_tail > 0), b_idx + 1, 0)
    cm_h = torch.cummax(tag_h, dim=-1).values
    ex_h = _exclusive(cm_h)
    half0 = state.half_symbol.to(_I32)[:, None]
    half_enter = torch.where(
        ex_h > 0, _take(last_sym, torch.clamp(ex_h - 1, 0, nb - 1)), half0)

    # --- per-block bit counts + final bit ---------------------------------
    n_main = torch.clamp(n_sym - start_slice, min=0) // 2
    n_bits = n_main + prepend
    fin_idx = start_slice + 2 * (n_bits - 1 - prepend)
    fin_sym = _pick(sym, torch.clamp(fin_idx, 0, S - 1))
    final_bit = torch.where((prepend > 0) & (n_bits == 1), half_enter,
                            fin_sym)

    # --- last-bit fill-forward (differential-decode seed) ------------------
    tag_b = torch.where(is_warm & (n_bits > 0), b_idx + 1, 0)
    cm_b = torch.cummax(tag_b, dim=-1).values
    ex_b = _exclusive(cm_b)
    last0 = state.last_bit.to(_I32)[:, None]
    prev0 = torch.where(
        ex_b > 0, _take(final_bit, torch.clamp(ex_b - 1, 0, nb - 1)), last0)
    prev0 = torch.where(first & (b_idx <= k), 0, prev0)

    # --- assemble bits + differential decode ------------------------------
    j = torch.arange(max_bits, dtype=_I32, device=dev)
    sym_p = torch.nn.functional.pad(sym, (0, max(2 * max_bits + 2 - S, 0)))
    even_bits = sym_p[..., 0::2][..., :max_bits]
    odd_bits = sym_p[..., 1::2][..., :max_bits]
    main_bits = torch.where(start_slice[..., None] == 0, even_bits, odd_bits)
    shifted = torch.roll(main_bits, 1, dims=-1)
    bits = torch.where(prepend[..., None] > 0,
                       torch.where(j == 0, half_enter[..., None], shifted),
                       main_bits)
    live = j < n_bits[..., None]
    bits = torch.where(live, bits, 0)
    prev = torch.cat([prev0[..., None], bits[..., :-1]], dim=-1)
    decoded = torch.where(live, bits ^ prev, 0)
    n_out = torch.where(is_warm, n_bits, 0)

    # --- exit state --------------------------------------------------------
    any_warm = is_warm[:, -1]                # warm blocks are a suffix
    new_first = state.first & ~any_warm
    new_start = torch.where(any_warm, odd_tail[:, -1], st0[:, 0])
    half_exit = torch.where(odd_tail[:, -1] > 0, last_sym[:, -1],
                            half_enter[:, -1])
    new_half = torch.where(any_warm, half_exit, half0[:, 0])
    new_last = torch.where(
        cm_b[:, -1] > 0,
        _pick(final_bit, torch.clamp(cm_b[:, -1] - 1, 0, nb - 1)), last0[:, 0])
    new_state = BitSyncState(first=new_first, start=new_start.to(_I32),
                             half_symbol=new_half.to(_I32),
                             last_bit=new_last.to(_I32))
    return decoded.to(_I32), n_out.to(_I32), new_state


def decode_block_bits(rds_clean: torch.Tensor, state: BitSyncState,
                      sps: int, max_symbols: int, max_bits: int):
    """Slice symbols at the CDR phase, Manchester- and differentially decode
    one block per channel, with no warm-up gate (the caller gates).

    rds_clean (C, L). Returns (bits (C, max_bits), n_bits (C,), state)."""
    count = torch.zeros(rds_clean.shape[:1], dtype=_I32,
                        device=rds_clean.device)
    bits, n_bits, new_state = decode_segment_bits(
        rds_clean[:, None], state, count, sps, max_symbols, max_bits,
        warm_after=-1)
    return bits[:, 0], n_bits[:, 0], new_state


class TimingTrack(NamedTuple):
    """Tracking-CDR carry, one entry per channel: the fractional
    next-symbol position, the per-symbol period deviation, and the previous
    block's final sample for interpolation across the block seam."""
    offset: torch.Tensor  # (C,) f32 next-symbol position from block start
    rate: torch.Tensor    # (C,) f32 samples-per-symbol deviation from sps
    last: torch.Tensor    # (C,) f32 previous block's final RRC sample
    locked: torch.Tensor  # (C,) int32: 0 until the first block sets phase


def timing_init(batch: int, device=None) -> TimingTrack:
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return TimingTrack(offset=z, rate=z.clone(), last=z.clone(),
                       locked=torch.zeros((batch,), dtype=_I32,
                                          device=device))


def comb_peak_phase(energy: torch.Tensor, sps: int) -> torch.Tensor:
    """Fractional comb phase in [0, sps): cyclic argmax of the per-phase
    energy (..., sps), refined by a parabola through the peak and its two
    neighbours. Ties go to the lowest index, as in jnp.argmax."""
    m = torch.argmax(energy, dim=-1)
    em = _pick(energy, m)
    el = _pick(energy, torch.remainder(m - 1, sps))
    er = _pick(energy, torch.remainder(m + 1, sps))
    denom = el - 2.0 * em + er
    delta = torch.where(
        torch.abs(denom) > 1e-9,
        0.5 * (el - er) / torch.where(denom == 0, 1.0, denom), 0.0)
    return torch.remainder(m.to(torch.float32)
                           + torch.clamp(delta, -0.5, 0.5), float(sps))


def cdr_tracked(rds_clean: torch.Tensor, track: TimingTrack, sps: int,
                max_symbols: int, phase_gain: float = 0.3,
                rate_gain: float = 0.08):
    """Polyphase-interpolating CDR with a drift accumulator, one block per
    channel: (1) the block's comb |energy| peak, refined to a fractional
    phase; (2) a PI update of the carried prediction (phase_gain on the
    wrapped innovation, rate_gain/symbols into the period deviation);
    (3) linear interpolation at the drifting positions
    p_k = offset + k*(sps + rate).

    rds_clean (C, L). Returns (sym (C, max_symbols) int32, soft
    (C, max_symbols) f32, n_sym (C,) int32, new_track)."""
    L = rds_clean.shape[-1]
    a = torch.abs(rds_clean)
    n_comb = L // sps
    energy = a[..., :n_comb * sps].reshape(
        a.shape[:-1] + (n_comb, sps)).sum(dim=-2)           # (C, sps)
    o_meas = comb_peak_phase(energy, sps)

    def wrap_half(d):
        return torch.remainder(d + 0.5 * sps, sps) - 0.5 * sps

    cold = track.locked == 0
    o_pred = track.offset
    e = wrap_half(o_meas - o_pred)
    o0 = torch.where(cold, o_meas, o_pred + phase_gain * e)
    nom_syms = float(L) / sps
    rate = torch.where(cold, 0.0, track.rate + rate_gain * e / nom_syms)
    # +-2000 ppm capture range; keeps the symbol count per block within the
    # static max_symbols = ceil(L/sps)
    rate = torch.clamp(rate, -0.002 * sps, 0.002 * sps)
    # keep the slice start in [-1, sps+rate): the Manchester parity carry
    # absorbs a dropped or added boundary symbol
    period = sps + rate
    o0 = o0 - period * torch.floor((o0 + 1.0) / period)

    k = torch.arange(max_symbols, dtype=torch.float32,
                     device=rds_clean.device)
    p = o0[..., None] + k * period[..., None]
    valid = p < L - 1
    pp = torch.clamp(p + 1.0, 0.0, float(L) - 1e-3)
    i0 = torch.floor(pp).to(_I32)
    frac = pp - i0.to(torch.float32)
    # the carried boundary sample lets p in [-1, 0) interpolate across the
    # seam; the gather is per channel row
    padded = torch.cat([track.last[..., None], rds_clean], dim=-1)
    y0 = _take(padded, i0)
    y1 = _take(padded, torch.clamp(i0 + 1, max=L))
    soft = torch.where(valid, y0 * (1.0 - frac) + y1 * frac, 0.0)
    sym = (soft > 0).to(_I32)
    n_sym = valid.sum(dim=-1, dtype=_I32)

    next_off = o0 + n_sym.to(torch.float32) * period - L
    new_track = TimingTrack(offset=next_off, rate=rate,
                            last=rds_clean[..., -1].contiguous(),
                            locked=torch.ones_like(track.locked))
    return sym, soft, n_sym, new_track


def decode_block_bits_tracked(rds_clean: torch.Tensor, state: BitSyncState,
                              track: TimingTrack, sps: int, max_symbols: int,
                              max_bits: int):
    """``decode_block_bits`` with the tracking CDR in place of the comb, one
    block per channel, no warm-up gate. rds_clean (C, L). Returns
    (bits (C, max_bits), n_bits (C,), state, track)."""
    sym, _soft, n_sym, track = cdr_tracked(rds_clean, track, sps,
                                           max_symbols)
    count = torch.zeros_like(n_sym)
    bits, n_bits, state = _symbols_to_bits(sym[:, None], n_sym[:, None],
                                           state, count, max_bits,
                                           warm_after=-1)
    return bits[:, 0], n_bits[:, 0], state, track
