"""Time-axis sharding of one long capture: exact (tier 3) and
halo re-acquisition (tiers 1-2).

Port of ``real_time_sdr_tpu/parallel/time_shard.py``. The receiver scales
an endless sample stream by strictly sequential block processing with
carried state. To shard *time* we use the structure of that state:

- FIR tails, the discriminator's previous sample and the feedforward
  synchronizer's delay lines are pure INPUT HISTORY: a shard that also sees
  the last ``overlap`` blocks of its left neighbour (its halo) reproduces
  them exactly.
- The tier-3 feedforward synchronizer (``ops.sync``) carries no loop
  recurrence, only a residual-phase LEVEL. Starting a shard with level 0
  shifts its unwrapped residual by a constant 2*pi*k against the sequential
  run; the nominal ramp's counter offset cancels (the ramp and the residual
  shift by opposite amounts). A 2*pi*k shift leaves the stereo carrier
  (nco_scale 2) untouched and flips the 57 kHz RDS carrier (nco_scale 0.5)
  by a constant per-shard SIGN when k is odd. Each shard therefore reports
  its phase level after the warm-up and at its end; neighbours' levels at
  the shared boundary sample give k's parity, and the signs chain left to
  right, so every shard's RDS baseband matches shard 0's, which IS the
  sequential receiver (shard 0 starts from the true initial state).
- The RDS bit-sync state machine is a real sequential recurrence, but it
  runs on 3.9 % of the input rate. Exact mode gathers the (float-exact) RRC
  output stream and decodes all blocks in order, once, so the bits are
  BIT-IDENTICAL to the sequential receiver. The wideband DSP, where the
  work is, stays parallel.

Tiers 1-2 carry a nonlinear per-sample PLL recurrence that cannot be
sharded exactly; for them the halo is a warm-up region in which each
shard's loop re-acquires (bounded divergence). ``exact=None`` picks exact
mode whenever every carrier stage is tier 3.

Where JAX maps shards onto a device mesh, the port makes them ROWS OF THE
BATCH: the receiver is batched natively, so ``t`` shards (times C channels
in the joint form) are ``t`` rows of one ``run_blocks`` call, and one card
runs them side by side. The halo is a ``torch.roll`` on the shard axis of
the caller's array. Several devices split the rows between them; several
processes (``group=``) each hold a contiguous run of shards and pass their
last blocks to the next rank.

    blocks = torch.from_numpy(np.fromfile("capture.raw", np.uint8)).reshape(
        -1, 2 * rx.cfg.block_size_iq)[:384]
    out = time_sharded_run(rx, blocks, shards=32)      # (384, ...) leaves

JAX compiles the whole run once per mesh and geometry; on the card the port
replays captured CUDA graphs (``utils.graphs``, in the caches of the
receiver's replicas), one per geometry: on one device and in one process a
single graph of the whole run (halo, the DSP rows, the join, the sign chain
and the global decode); over several devices or processes one graph per
device for its rows and one on the first device for the sign chain and the
decode, with the copies between devices, the halo's send and receive and
the gathers between the replays. The DSP pass of exact mode runs on each
replica's ``without_bits()`` copy (JAX's ``dsp_rx``). On the CPU the run is
eager.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from real_time_sdr_tpu_torch.device import on_device, resolve_devices
from real_time_sdr_tpu_torch.models.rds import WARM_AFTER
from real_time_sdr_tpu_torch.models.receiver import Receiver, ReceiverOutput
from real_time_sdr_tpu_torch.ops.rds_bits import (bit_sync_init,
                                                  decode_segment_bits,
                                                  timing_init)
from real_time_sdr_tpu_torch.ops.sync import FeedforwardSync
from real_time_sdr_tpu_torch.parallel.channel import split_rows
from real_time_sdr_tpu_torch.parallel.distributed import rank_and_size
from real_time_sdr_tpu_torch.utils.state import map_state

__all__ = ["time_sharded_run", "time_sharded_run_bank"]

_TWO_PI = 2.0 * math.pi


def _all_feedforward(rx: Receiver) -> bool:
    """True when every carrier-recovery stage of rx is tier-3 feedforward
    (``MonoPath`` has none; ``StereoPath`` / ``RdsPath`` hold ``sync``)."""
    for path in (rx.audio, rx.rds_path):
        if path is None or not hasattr(path, "pll_params"):
            continue
        if not isinstance(getattr(path, "sync", None), FeedforwardSync):
            return False
    return True


def time_sharded_run(rx: Receiver, blocks: torch.Tensor, shards: int,
                     overlap: int = 1, exact: bool | None = None,
                     devices=None, group=None) -> ReceiverOutput:
    """Run ``blocks`` (B, 2*block_size_iq) uint8, one station's capture in
    time order, as ``shards`` time shards. Returns the stacked
    ``ReceiverOutput`` of all B blocks (leading axis B, time-ordered) on
    the first device.

    exact=True (the default for all-tier-3 receivers): RDS bits match the
    sequential ``rx.run_blocks`` bit for bit; audio matches to float32
    summation order. exact=False: per-shard warm-up re-acquisition;
    steady-state audio matches within SNR bounds, RDS bits are re-aligned
    per shard.

    ``devices`` (default: every visible CUDA device) split the shard rows
    in contiguous groups. With ``group`` (a ``torch.distributed`` process
    group, ranks in time order) ``blocks`` holds this rank's contiguous
    part of the timeline, ``shards`` counts the shards of all ranks, the
    halo crosses the rank boundary, and the result covers this rank's
    blocks."""
    if blocks.ndim != 2:
        raise ValueError(f"blocks must be (B, n), got {tuple(blocks.shape)}")
    out = _sharded_run(rx, blocks[None], shards, overlap, exact,
                       [resolve_devices(devices)], group, graphed=True)
    return ReceiverOutput(*(None if leaf is None else leaf[0]
                            for leaf in out))


def time_sharded_run_bank(rx: Receiver, blocks: torch.Tensor, shards: int,
                          overlap: int = 1, devices=None,
                          group=None) -> ReceiverOutput:
    """JOINT channel x time sharding (exact mode, tier 3).

    blocks: (C, B, 2*block_size_iq) uint8, C independent stations of B
    blocks each. Every (channel, shard) pair is one batch row; the halo,
    the sign chain and the global decode run per channel as in
    ``time_sharded_run``. RDS bits are BIT-IDENTICAL to each channel's
    sequential receiver. Returns (C, B, ...) leaves on the first device.

    ``devices``: a list splits the channels over the devices, a list of
    lists (``distributed.channel_time_grid``) is a grid of channel groups
    by time groups. ``group`` as in ``time_sharded_run`` (ranks split the
    time axis; channels split over processes need no group at all)."""
    if not _all_feedforward(rx):
        raise ValueError("joint channel x time sharding is exact-mode only: "
                         "build the receiver with pll_tier=3")
    if blocks.ndim != 3:
        raise ValueError(f"blocks must be (C, B, n), got "
                         f"{tuple(blocks.shape)}")
    if devices is not None and len(devices) and isinstance(
            devices[0], (list, tuple)):
        grid = [resolve_devices(row) for row in devices]
        if len({len(row) for row in grid}) != 1:
            raise ValueError("the device grid's rows differ in length")
    else:
        grid = [[d] for d in resolve_devices(devices)]
    return _sharded_run(rx, blocks, shards, overlap, True, grid, group,
                        graphed=True)


def _level(rx: Receiver, state) -> torch.Tensor:
    """Total RDS carrier phase (nominal ramp + residual) mod 4*pi at the
    carried sample, per row. The residual alone does not compare across
    shards: each shard's residual absorbs its local ramp offset."""
    p = rx.rds_path.pll_params
    c = state.rds.pll
    return torch.remainder(p.trig_angle(c.trig) + c.resid, 2.0 * _TWO_PI)


def _run_rows(rx: Receiver, local: torch.Tensor, halo: torch.Tensor, *,
              t_per: int, head: bool, want_levels: bool):
    """One device's rows: warm up on the halo from the initial state, keep
    the initial state on the rows that are the true head of a stream (with
    ``head``, every ``t_per``-th row from the first), run the local blocks.
    local (R, Bl, n), halo (R, overlap, n). Returns (outs with (R, Bl, ...)
    leaves, levels (R, 2) or None): the phase level after the warm-up and
    at the end."""
    init = rx.init_state(local.shape[0])
    state0, _ = rx.run_blocks(init, halo)
    if head:
        first = torch.arange(local.shape[0], device=local.device) % t_per == 0
        state0 = map_state(init, lambda a, b: torch.where(
            first.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), state0)
    final, outs = rx.run_blocks(state0, local)
    levels = (torch.stack([_level(rx, state0), _level(rx, final)], dim=-1)
              if want_levels else None)
    return outs, levels


def _decode(rx: Receiver, clean: torch.Tensor):
    """ONE sequential decode per channel over the signed, time-ordered RRC
    stream clean (C, B, rds_block), from the initial slicer state and block
    count 0: (bits (C, B, max_bits), n_bits (C, B))."""
    rds, cfg = rx.rds_path, rx.cfg
    n_ch, n_blocks = clean.shape[:2]
    dev = clean.device
    bit_state = bit_sync_init(n_ch, device=dev)
    count = torch.zeros((n_ch,), dtype=torch.int32, device=dev)
    if rds.timing == "comb":
        bits, n_bits, _ = decode_segment_bits(
            clean, bit_state, count, cfg.sps, cfg.max_symbols, cfg.max_bits,
            warm_after=WARM_AFTER)
        return bits, n_bits
    track, out = timing_init(n_ch, device=dev), []
    for b in range(n_blocks):
        bits_b, n_b, bit_state, track = rds._decode_one(
            clean[:, b], bit_state, track, count + b)
        out.append((bits_b, n_b))
    return (torch.stack([o[0] for o in out], dim=1),
            torch.stack([o[1] for o in out], dim=1))


def _sign_and_decode(rx: Receiver, out: ReceiverOutput, levels: torch.Tensor,
                     clean: torch.Tensor, *, bl: int, first: int,
                     n_blocks: int):
    """The per-shard RDS carrier signs chained across the boundaries, then
    one decode of the whole signed stream. levels (C, t, 2) and clean
    (C, B, rds_block) cover every shard of every process; this process's
    blocks are the ``n_blocks`` from ``first``. Returns ``out`` with its bits, counts and signed RRC
    stream."""
    # Shard k+1's level after its warm-up and shard k's level at its end
    # describe the SAME boundary sample; both are wrapped mod 4*pi and agree
    # mod 2*pi, so their difference is (nearly) a whole multiple of 2*pi
    # whose parity is k's relative carrier sign.
    starts = levels[:, 1:, 0]
    ends = levels[:, :-1, 1]
    m = torch.round((starts - ends) / _TWO_PI).to(torch.int32)
    parity = torch.cat([torch.zeros_like(m[:, :1]),
                        torch.cumsum(m, dim=1) % 2], dim=1)
    sign = torch.where(parity == 0, 1.0, -1.0).to(torch.float32)
    clean = clean * sign[..., None].expand(-1, -1, bl).reshape(
        sign.shape[0], -1)[..., None]
    bits, n_bits = _decode(rx, clean)
    mine = slice(first, first + n_blocks)
    return out._replace(rds_bits=bits[:, mine], rds_nbits=n_bits[:, mine],
                        rds_clean=clean[:, mine])


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _sharded_run(rx: Receiver, blocks: torch.Tensor, shards: int,
                 overlap: int, exact: bool | None, grid: list, group,
                 graphed: bool = False):
    """blocks (C, B, n) -> ReceiverOutput with (C, B, ...) leaves on
    grid[0][0]. grid: channel groups x time groups of devices. ``graphed``
    replays the graphs of the module docstring (on the card; on the CPU the
    graph cache runs the functions eagerly); without it the run is eager."""
    if exact is None:
        exact = _all_feedforward(rx)
    elif exact and not _all_feedforward(rx):
        raise ValueError(
            "exact time sharding requires every carrier-recovery stage at "
            "tier 3 (feedforward); this receiver carries a sequential PLL "
            "recurrence that cannot be sharded exactly. Use exact=False "
            "(warm-up re-acquisition) or build the receiver with pll_tier=3")
    rank, world = rank_and_size(group) if group is not None else (0, 1)
    n_ch, n_blocks = blocks.shape[:2]
    if shards < 1 or shards % world:
        raise ValueError(f"{shards} time shards do not split over {world} "
                         "processes")
    t = shards // world                       # this process's shards
    if n_blocks == 0 or n_blocks % t:
        raise ValueError(f"blocks {n_blocks} not divisible by time shards "
                         f"{t}")
    bl = n_blocks // t
    if not 1 <= overlap <= bl:
        raise ValueError(f"overlap must be 1..{bl} (the blocks of one "
                         f"shard), got {overlap}")
    c_per = split_rows(n_ch, grid, "channels")
    t_per = split_rows(t, grid[0], "time shards")
    dev0 = grid[0][0]
    reps = {dev: rx.replica(dev) for row in grid for dev in row}
    # the graphs take the capture on the first device, as JAX a device array
    blocks = blocks.to(dev0)
    if shards == 1:
        r0 = reps[dev0]
        run = r0.jit_run_blocks if graphed else r0.run_blocks
        with on_device(dev0):
            return run(r0.init_state(n_ch), blocks)[1]

    signed = exact and rx.rds_path is not None
    # in exact mode the DSP pass skips the slicer: one decode follows
    dsp = {dev: r.without_bits() if signed else r
           for dev, r in reps.items()}
    staged = graphed and (group is not None or len(reps) > 1)
    geometry = (shards, overlap, exact, len(grid), len(grid[0]), rank,
                world)

    def stage(dev, name, fn, *args, **static):
        """``fn(*args, **static)``; run stage by stage, through the graph
        of ``dev``'s replica keyed by its static arguments."""
        if not staged:
            return fn(*args, **static)
        return reps[dev].graphs(functools.partial(fn, **static),
                                (name, *geometry, *sorted(static.items())),
                                *args)

    def run(blocks):
        xs = blocks.reshape(n_ch, t, bl, blocks.shape[-1])
        tails = xs[:, :, bl - overlap:]
        # shard k's halo is shard k-1's tail; the ring closes on shard 0,
        # whose warm-up is discarded by the head select
        halo = torch.roll(tails, 1, dims=1)
        if world > 1:
            send = tails[:, -1].contiguous()
            recv = torch.empty_like(send)
            ranks = dist.get_process_group_ranks(group)
            reqs = [dist.isend(send, ranks[(rank + 1) % world], group=group),
                    dist.irecv(recv, ranks[(rank - 1) % world], group=group)]
            for r in reqs:
                r.wait()
            halo[:, 0] = recv
        parts = []
        for i, row in enumerate(grid):
            for j, dev in enumerate(row):
                ci = slice(i * c_per, (i + 1) * c_per)
                tj = slice(j * t_per, (j + 1) * t_per)
                rows = (c_per * t_per,)
                with on_device(dev):
                    parts.append(stage(
                        dev, "time_shard_rows",
                        functools.partial(_run_rows, dsp[dev]),
                        xs[ci, tj].reshape(rows + xs.shape[2:]).to(
                            dev, non_blocking=True),
                        halo[ci, tj].reshape(rows + halo.shape[2:]).to(
                            dev, non_blocking=True),
                        t_per=t_per, head=rank == 0 and j == 0,
                        want_levels=signed))

        def join(leaves, tail_of):
            """Per-device (c_per*t_per, ...) leaves -> (C, t*..., ...) on
            the first device: time groups join on axis 1, channel groups
            on 0."""
            it = iter(leaves)
            return torch.cat([torch.cat([
                tail_of(next(it)).to(dev0) for _ in row], dim=1)
                for row in grid], dim=0)

        with on_device(dev0):
            out = ReceiverOutput(*(
                None if leaves[0] is None else join(
                    leaves, lambda x: x.reshape((c_per, t_per * bl)
                                                + x.shape[2:]))
                for leaves in zip(*(p[0] for p in parts))))
            if not signed:
                return out
            levels = join([p[1] for p in parts],
                          lambda x: x.reshape(c_per, t_per, 2))  # (C, t, 2)
            clean = out.rds_clean
            if world > 1:
                levels = _all_gather(levels, group, dim=1)
                clean = _all_gather(clean, group, dim=1)
            return stage(dev0, "time_shard_decode",
                         functools.partial(_sign_and_decode, reps[dev0]),
                         out, levels, clean, bl=bl, first=rank * n_blocks,
                         n_blocks=n_blocks)

    if graphed and not staged:
        return reps[dev0].graphs(run, ("time_sharded_run", *geometry),
                                 blocks)
    return run(blocks)
