"""Multi-process deployment helpers on ``torch.distributed``.

Port of ``real_time_sdr_tpu/parallel/distributed.py``. The channel axis
shards freely over processes (zero coupling: each process decodes its own
rows and no collective runs), and the time axis rides the halo exchange of
``parallel.time_shard`` (``group=``).

    initialize("127.0.0.1:29500", num_processes=2, process_id=rank)
    rows = all_rows[host_channel_slice(n_channels)]   # this process's rows
    bank = ChannelBank(rx, len(rows), devices=channel_devices())

The backend follows the device the receivers run on and nothing else:
``nccl`` on the card, ``gloo`` when the caller asked for the CPU. Nothing
falls back from one to the other.

JAX assembles one global array from the processes' rows
(``make_global_channel_array``); torch has no global array, so that
function has no counterpart here: each process keeps its rows, runs them,
and owns their outputs. In place of the device meshes stand a list of
devices (``channel_devices``) and a list of lists (``channel_time_grid``),
which the parallel entry points take as ``devices``.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from real_time_sdr_tpu_torch.device import resolve_device, resolve_devices

__all__ = ["initialize", "rank_and_size", "host_channel_slice",
           "channel_devices", "channel_time_grid"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device | None = None,
               timeout_s: float = 300.0) -> None:
    """Join the job's default process group (no-op for a single process).

    ``coordinator_address`` is ``host:port`` of rank 0; ``device`` is where
    this process's receivers run (``None``: the card) and picks the
    backend, ``nccl`` for CUDA and ``gloo`` for the CPU."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process job needs coordinator_address "
                         "and process_id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def rank_and_size(group=None) -> tuple[int, int]:
    """(rank, world size) of ``group``; (0, 1) outside a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def host_channel_slice(n_channels: int) -> slice:
    """Which channel rows this process feeds (an even split is required)."""
    rank, count = rank_and_size()
    if n_channels % count:
        raise ValueError(
            f"n_channels={n_channels} does not divide evenly over "
            f"{count} processes; the remainder channels would silently "
            "be fed by no host")
    per = n_channels // count
    return slice(rank * per, (rank + 1) * per)


def channel_devices(devices=None) -> list[torch.device]:
    """The devices of this process for a channel-sharded bank: every
    visible CUDA device (raising without one), or the caller's list."""
    return resolve_devices(devices)


def channel_time_grid(n_ch_shards: int,
                      devices=None) -> list[list[torch.device]]:
    """This process's devices as ``n_ch_shards`` rows (channel groups) of
    equal length (time groups), for ``time_sharded_run_bank``."""
    devs = resolve_devices(devices)
    if n_ch_shards < 1 or len(devs) % n_ch_shards:
        raise ValueError(f"{len(devs)} devices do not split into "
                         f"{n_ch_shards} channel groups")
    per = len(devs) // n_ch_shards
    return [devs[k * per:(k + 1) * per] for k in range(n_ch_shards)]
