"""Carried state across the two packages: numpy <-> the port's tensors.

The port's state classes carry the JAX package's class names, field names,
shapes and dtypes. Receiver states have a leading channel axis on every
leaf (what a vmapped JAX run or ``ChannelBank`` carries); the wideband
frontends' states (``ChannelizerState``, ``FusedWidebandState``) have none:
their rail tails are shared by all stations and ``pos`` is a 0-d int32. So
a JAX state fetched to numpy (``jax.tree_util.tree_map(np.asarray,
state)``) converts field by field:

    state = state_from_numpy(jax_state_np, device="cuda")
    ...
    back = state_to_numpy(state)     # the port's classes, numpy leaves
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_sdr_tpu_torch.models.audio import MonoState, StereoState
from real_time_sdr_tpu_torch.models.channelizer import ChannelizerState
from real_time_sdr_tpu_torch.models.frontend import FrontendState
from real_time_sdr_tpu_torch.models.rds import RdsState
from real_time_sdr_tpu_torch.models.receiver import ReceiverState
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandState
from real_time_sdr_tpu_torch.ops.rds_bits import BitSyncState
from real_time_sdr_tpu_torch.ops.sync import FFSyncCarry

__all__ = ["map_state", "state_from_numpy", "state_to_numpy"]

_CLASSES = {cls.__name__: cls for cls in (
    ReceiverState, FrontendState, MonoState, StereoState, RdsState,
    FFSyncCarry, BitSyncState, ChannelizerState, FusedWidebandState)}


def map_state(tree, leaf_fn):
    """Apply ``leaf_fn`` to every array leaf of a state tree, rebuilding it
    from the port's state classes (matched by class name), e.g.
    ``map_state(state, lambda t: t[:2].cpu())`` for channels 0-1 on the
    CPU."""
    if tree is None:
        return None
    fields = getattr(tree, "_fields", None)
    if fields is None:
        return leaf_fn(tree)
    name = type(tree).__name__
    cls = _CLASSES.get(name)
    if cls is None:
        raise TypeError(f"no port state class for {name}")
    if tuple(fields) != cls._fields:
        raise TypeError(f"{name} fields {fields} != the port's {cls._fields}")
    return cls(*(map_state(getattr(tree, f), leaf_fn) for f in fields))


def state_from_numpy(tree, device: str | torch.device = "cpu"):
    """A state tree with array leaves (numpy, JAX fetched to numpy, or the
    port's own ``state_to_numpy`` output) -> the port's state on
    ``device``. Dtypes are kept."""
    return map_state(tree, lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(device))


def state_to_numpy(state):
    """The port's state -> the same classes with numpy leaves."""
    return map_state(state, lambda t: t.detach().cpu().numpy())
