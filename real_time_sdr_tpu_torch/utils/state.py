"""Carried state across the two packages: numpy <-> the port's tensors,
and checkpoint files that either package resumes from.

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

``save_state`` / ``load_state`` write and read the JAX package's ``.npz``
layout (``real_time_sdr_tpu/utils/state.py``): one array per leaf, keys
``leaf_0 ...`` in ``jax.tree_util`` flatten order (NamedTuple fields in
order, ``None`` leaves dropped), the leaves' own dtypes, and a
``__treedef__`` entry that neither loader reads back. A state saved with
the same shapes as a JAX state (e.g. the single-station CLI's, saved
without its channel axis) loads with JAX's ``load_state`` and vice versa.

A tree is a state class, or a plain tuple or list of trees (walked in
order, as ``jax.tree_util`` does): the wideband CLI's checkpoint is the
pair ``(frontend state, bank state)``.
"""

from __future__ import annotations

import numpy as np
import torch

from real_time_sdr_tpu_torch.models.audio import MonoState, StereoState
from real_time_sdr_tpu_torch.models.channelizer import ChannelizerState
from real_time_sdr_tpu_torch.models.frontend import FrontendState
from real_time_sdr_tpu_torch.models.rds import RdsState
from real_time_sdr_tpu_torch.models.receiver import (ReceiverOutput,
                                                     ReceiverState)
from real_time_sdr_tpu_torch.models.wideband_frontend import \
    FusedWidebandState
from real_time_sdr_tpu_torch.ops.pll import PllCarry
from real_time_sdr_tpu_torch.ops.rds_bits import BitSyncState, TimingTrack
from real_time_sdr_tpu_torch.ops.sync import FFSyncCarry

__all__ = ["map_state", "state_from_numpy", "state_to_numpy", "save_state",
           "load_state"]

_CLASSES = {cls.__name__: cls for cls in (
    ReceiverState, ReceiverOutput, FrontendState, MonoState, StereoState,
    RdsState, FFSyncCarry, PllCarry, BitSyncState, TimingTrack,
    ChannelizerState, FusedWidebandState)}


def map_state(tree, leaf_fn, *others):
    """Apply ``leaf_fn`` to every array leaf of a state tree, rebuilding it
    from the port's state classes (matched by class name), e.g.
    ``map_state(state, lambda t: t[:2].cpu())`` for channels 0-1 on the
    CPU. With further trees of the same structure, ``leaf_fn`` gets one
    leaf of each: ``map_state(a, lambda x, y: x - y, b)`` walks two states leaf
    by leaf (``None`` leaves stay ``None``)."""
    if tree is None:
        return None
    fields = getattr(tree, "_fields", None)
    if fields is None:
        if isinstance(tree, (tuple, list)):
            return type(tree)(
                map_state(child, leaf_fn, *(o[i] for o in others))
                for i, child in enumerate(tree))
        return leaf_fn(tree, *others)
    name = type(tree).__name__
    cls = _CLASSES.get(name)
    if cls is None:
        raise TypeError(f"no port state class for {name}")
    if tuple(fields) != cls._fields:
        raise TypeError(f"{name} fields {fields} != the port's {cls._fields}")
    return cls(*(map_state(getattr(tree, f), leaf_fn,
                           *(getattr(o, f) for o in others))
                 for f in fields))


def state_from_numpy(tree, device: str | torch.device):
    """A state tree with array leaves (numpy, JAX fetched to numpy, or the
    port's own ``state_to_numpy`` output) -> the port's state on
    ``device``. Dtypes are kept."""
    return map_state(tree, lambda a: torch.from_numpy(
        np.array(a, copy=True)).to(device))


def state_to_numpy(state):
    """The port's state -> the same classes with numpy leaves."""
    return map_state(state, lambda t: t.detach().cpu().numpy())


def _leaves(tree) -> list:
    """Array leaves in jax.tree_util flatten order (None dropped)."""
    if tree is None:
        return []
    if not isinstance(tree, (tuple, list)):
        return [tree]
    return [leaf for child in tree for leaf in _leaves(child)]


def _structure(tree) -> str:
    if tree is None:
        return "None"
    if not isinstance(tree, (tuple, list)):
        return "*"
    name = type(tree).__name__ if hasattr(tree, "_fields") else ""
    return f"{name}({','.join(map(_structure, tree))})"


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" to a path without it; both functions agree
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state) -> None:
    """Write a state tree to an ``.npz`` file in the JAX package's layout."""
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(_leaves(state))}
    arrays["__treedef__"] = np.frombuffer(_structure(state).encode(),
                                          dtype=np.uint8)
    np.savez(_npz_path(path), **arrays)


def load_state(path: str, like):
    """Read a state written by either package's ``save_state``. ``like``
    gives the tree, shapes, dtypes and device (e.g. ``rx.init_state(1)``);
    raises ``ValueError`` when the file's leaves do not match it."""
    ref = _leaves(like)
    with np.load(_npz_path(path)) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(ref):
            raise ValueError(f"checkpoint {path} holds {n} state leaves, "
                             f"the receiver's state has {len(ref)}")
        loaded = []
        for i, r in enumerate(ref):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(r.shape):
                raise ValueError(f"state leaf {i}: checkpoint shape "
                                 f"{arr.shape} != {tuple(r.shape)}")
            t = torch.from_numpy(np.array(arr))
            if t.dtype != r.dtype:
                raise ValueError(f"state leaf {i}: checkpoint dtype "
                                 f"{arr.dtype} != {r.dtype}")
            loaded.append(t.to(r.device))
    it = iter(loaded)
    return map_state(like, lambda _: next(it))
