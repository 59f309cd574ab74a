"""Sharded wideband serving: one capture in, S station decodes out, the
station axis split over devices.

Port of ``real_time_sdr_tpu/parallel/wideband.py``. The layout is JAX's:

- the wideband i/q rails, the raw-rail tails and the tone position are
  replicated: every device gets its own copy of the capture (the small
  array: n_wide against S * n_wide / D of station output) and frames it
  locally;
- the fold weights' columns, the rotation tables, the carried
  discriminator samples, the decimator tails of mix-then-filter mode and
  the whole receiver bank split on stations, in contiguous equal groups.

No collective runs anywhere: the only shared value is the input. Where
JAX partitions one graph over a mesh, the port holds one frontend shard
(``station_subset``: the same geometry, its stations' columns only) and
one receiver replica per device, and the host loop over the devices only
enqueues work. The states and outputs are plain tuples, one tree per
device, also with a single device; ``parallel.channel.gather`` joins them.

    sw = ShardedFusedWideband(wf, rx, devices=["cuda:0", "cuda:1"])
    fstate, bstate = sw.init_state()
    fstate, bstate, out = sw.step(fstate, bstate, i_wide, q_wide)
    left = gather(out).left                        # (S, n_audio), CPU

Each two-stage shard ends in its own ``chan_epilogue`` launch
(``Channelizer.call_u8``); the fused shards run
``FusedWidebandFrontend.core`` on their own columns, the same code as the
unsharded frontend.
"""

from __future__ import annotations

import torch

from real_time_sdr_tpu_torch.device import on_device, resolve_devices
from real_time_sdr_tpu_torch.models.channelizer import Channelizer
from real_time_sdr_tpu_torch.models.receiver import Receiver
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandFrontend
from real_time_sdr_tpu_torch.parallel.channel import split_rows

__all__ = ["ShardedWideband", "ShardedFusedWideband"]


class _ShardedFrontend:
    """A wideband frontend cut into station shards, one per device, each
    feeding a receiver replica. ``devices=None`` is every visible CUDA
    device; a device may be listed twice."""

    def __init__(self, frontend, rx: Receiver, devices=None):
        self.devices = resolve_devices(devices)
        self.per = split_rows(len(frontend.offsets), self.devices,
                              "stations")
        self.rx = rx
        self.replicas = [rx.replica(d) for d in self.devices]
        self.shards = [
            frontend.station_subset(slice(k * self.per,
                                          (k + 1) * self.per)).to(d)
            for k, d in enumerate(self.devices)]

    @property
    def offsets(self) -> list[int]:
        """Every station's offset, in station order."""
        return [f for sh in self.shards for f in sh.offsets]

    def init_state(self):
        """(frontend states, bank states): one tree per device each."""
        return (tuple(sh.init_state() for sh in self.shards),
                tuple(r.init_state(self.per) for r in self.replicas))

    def step(self, fstate, bstate, i_wide, q_wide):
        """i_wide, q_wide: (n,) float32 rails, on the host or any device;
        every device gets its copy. Returns (fstate, bstate, out), tuples
        with one tree per device, station-major leaves split on stations."""
        res = []
        for k, d in enumerate(self.devices):
            with on_device(d):
                i_d = torch.as_tensor(i_wide).to(d, non_blocking=True)
                q_d = torch.as_tensor(q_wide).to(d, non_blocking=True)
                res.append(self._step_one(k, fstate[k], bstate[k], i_d, q_d))
        return tuple(zip(*res))

    def _step_one(self, k: int, fstate, bstate, i_wide, q_wide):
        raise NotImplementedError


class ShardedWideband(_ShardedFrontend):
    """The two-stage path (``Channelizer`` -> u8 station streams ->
    ``run_segment``) over devices, in both channelizer modes (folded-tone
    and mix-then-filter)."""

    def __init__(self, ch: Channelizer, rx: Receiver, devices=None):
        if not isinstance(ch, Channelizer):
            raise TypeError(f"not a Channelizer: {type(ch).__name__}")
        super().__init__(ch, rx, devices)

    def _step_one(self, k, cstate, bstate, i_wide, q_wide):
        u8, cstate = self.shards[k].call_u8(i_wide, q_wide, cstate)
        bstate, out = self.replicas[k].run_segment(bstate, u8)
        return cstate, bstate, out


class ShardedFusedWideband(_ShardedFrontend):
    """The fused one-matmul frontend over devices: each device's matmul
    covers only its stations' columns (1/D of the FLOPs) and feeds
    ``run_segment_demod``."""

    def __init__(self, wf: FusedWidebandFrontend, rx: Receiver,
                 devices=None):
        if not isinstance(wf, FusedWidebandFrontend):
            raise TypeError(f"not a FusedWidebandFrontend: "
                            f"{type(wf).__name__}")
        super().__init__(wf, rx, devices)

    def retune(self, station: int, offset_hz: int) -> None:
        """Re-point one station: only the shard that owns it rewrites its
        columns (in its device's stream order, as
        ``FusedWidebandFrontend.retune``). The frontend this object was
        built from is not touched."""
        n = self.per * len(self.devices)
        if not 0 <= station < n:
            raise ValueError(f"station {station} out of range [0, {n})")
        k, local = divmod(station, self.per)
        with on_device(self.devices[k]):
            self.shards[k].retune(local, offset_hz)

    def _step_one(self, k, wstate, bstate, i_wide, q_wide):
        demod, wstate = self.shards[k](i_wide, q_wide, wstate)
        bstate, out = self.replicas[k].run_segment_demod(bstate, demod)
        return wstate, bstate, out
