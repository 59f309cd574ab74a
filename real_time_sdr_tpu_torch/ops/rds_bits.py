"""RDS symbol slicing and Manchester/differential bit decoding, batched over
channels.

Port of the comb-CDR half of ``real_time_sdr_tpu/ops/rds_bits.py``:
``BitSyncState``, ``bit_sync_init``, ``cdr_offset``, ``decode_block_bits``
and ``decode_segment_bits``. Every state leaf carries a leading channel
axis (the JAX functions take scalar leaves and leave channels to vmap).
``decode_segment_bits`` keeps the JAX package's closed-form cross-block
chains (prefix-XOR of the Manchester parity, fill-forwards of the half
symbol and the last bit), with gathers for the indexed reads, and is
bit-identical to decoding block by block with the 5-block warm-up gate.
The tracking CDR is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BitSyncState", "bit_sync_init", "cdr_offset",
           "decode_block_bits", "decode_segment_bits"]

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
    dev = clean.device

    # --- per-block half: comb CDR + slice --------------------------------
    offset = cdr_offset(clean, sps)                          # (C, nb)
    padded = torch.nn.functional.pad(clean, (0, S * sps - L))
    frames = padded.reshape(C, nb, S, sps)
    soft = torch.gather(frames, -1, offset[..., None, None].to(torch.int64)
                        .expand(C, nb, S, 1))[..., 0]
    sym = (soft > 0).to(_I32)                                # (C, nb, S)
    idx_s = torch.arange(S, dtype=_I32, device=dev)
    n_sym = (L - offset + sps - 1) // sps                    # (C, nb)
    sym = torch.where(idx_s < n_sym[..., None], sym, 0)

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
