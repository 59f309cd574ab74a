"""Captured CUDA graphs of the serving entries: the port's counterpart of
the JAX package's per-shape ``jax.jit`` caches.

    graphs = GraphCache()
    state, out = graphs(rx.step, ("step",), state, iq)   # one replay

An entry is called with trees of tensors (NamedTuples, tuples, lists,
None); static values (a segment length, a frontend, a group width) belong
in its key, as JAX keeps them static. Each key and input shape gets one
graph:

- **First call:** the inputs are copied into static buffers, the function
  runs once eagerly on a side stream (this builds the kernels and sets up
  the library handles, as ``torch.cuda.graph`` requires), and is then
  captured once, its outputs copied inside the graph into one packed
  buffer per dtype. The graph is then replayed for this call's result.
- **Later calls:** copy the inputs into the static buffers (a run of
  leaves that lie back to back in one buffer, as the state an entry
  returned does, is one copy), replay, and copy each packed output buffer
  out into fresh memory (one copy per dtype).

The contract is JAX's functional one: what a call returns is never
written again, so a caller may keep an old state, pass it back, or hold
several calls' outputs in flight. Each graph keeps its own memory pool.

On the CPU the entry is the eager function: nothing is captured. On the
card nothing falls back: a capture that fails (a host sync, a pageable
copy) raises ``GraphCaptureError`` naming the line that broke it.
``graph_cls=HostGraph`` runs the same bookkeeping (keys, static buffers,
packing, the copies, the launch accounting) on any device, with an eager
re-run in place of the replay; the tests use it on the CPU.

Launch accounting: a replay calls no kernel wrapper, so the counts of
``ops.cuda.KERNELS`` (``launches`` and the per-body ``body_launches``)
would stay still. Each graph records the counts its capture added and
adds them again on every replay; the warm-up and the capture themselves
add nothing, so N calls count what N eager calls count.
"""

from __future__ import annotations

import math
import os
import traceback

import torch

__all__ = ["GraphCache", "GraphCaptureError", "HostGraph", "CudaGraph",
           "launch_counts", "add_launch_counts", "set_launch_counts"]

_LEAF = "*"


class GraphCaptureError(RuntimeError):
    """A graph entry could not be captured on the card."""


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (hashable), its tensors appended to
    ``leaves`` in order."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(c, leaves) for c in tree))
    raise TypeError(f"graph entries take trees of tensors, tuples and None, "
                    f"got {type(tree).__name__}")


def _unflatten(spec, it):
    if spec is None:
        return None
    if spec == _LEAF:
        return next(it)
    cls, children = spec
    vals = [_unflatten(c, it) for c in children]
    return cls(*vals) if hasattr(cls, "_fields") else cls(vals)


def launch_counts() -> dict:
    """Every kernel's launch count, and each body's where it counts them."""
    from real_time_sdr_tpu_torch.ops.cuda import KERNELS
    counts = {}
    for k in KERNELS:
        counts[k.name, None] = k.launches
        for body, n in getattr(k, "body_launches", {}).items():
            counts[k.name, body] = n
    return counts


def set_launch_counts(counts: dict) -> None:
    from real_time_sdr_tpu_torch.ops.cuda import KERNELS
    for k in KERNELS:
        k.launches = counts[k.name, None]
        for body in getattr(k, "body_launches", {}):
            k.body_launches[body] = counts[k.name, body]


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (as ``launch_counts`` keys them) to the counts."""
    now = launch_counts()
    set_launch_counts({key: now[key] + delta.get(key, 0) for key in now})


class _Packed:
    """Tensors of the given shapes and dtypes as views of one flat buffer
    per dtype, in order."""

    def __init__(self, metas, device: torch.device):
        self.slots, sizes = [], {}
        for shape, dt in metas:
            n = math.prod(shape)
            self.slots.append((dt, sizes.get(dt, 0), n, tuple(shape)))
            sizes[dt] = sizes.get(dt, 0) + n
        self.bufs = {dt: torch.empty(n, dtype=dt, device=device)
                     for dt, n in sizes.items()}
        self.views = self.views_of(self.bufs)

    def views_of(self, bufs: dict) -> list:
        return [bufs[dt][off:off + n].view(shape)
                for dt, off, n, shape in self.slots]

    def copy_in(self, leaves: list) -> None:
        """Copy ``leaves`` into the buffers: each run of same-dtype leaves
        that lie back to back in memory, as in the slots, is one copy."""
        by_dtype: dict = {}
        for slot, t in zip(self.slots, leaves):
            by_dtype.setdefault(slot[0], []).append((slot, t))
        for dt, items in by_dtype.items():
            i = 0
            while i < len(items):
                (_, off, n, _), src = items[i]
                j, total = i + 1, n
                if src.is_contiguous():
                    end = src.data_ptr() + n * src.element_size()
                    base = src.untyped_storage().data_ptr()
                    while j < len(items):
                        (_, _, n_j, _), t = items[j]
                        # one storage: two allocations may also abut
                        if not (t.is_contiguous() and t.data_ptr() == end
                                and t.untyped_storage().data_ptr() == base):
                            break
                        end += n_j * t.element_size()
                        total += n_j
                        j += 1
                dst = self.bufs[dt][off:off + total]
                if j == i + 1:
                    dst.view(src.shape).copy_(src)
                else:
                    dst.copy_(src.as_strided((total,), (1,),
                                             src.storage_offset()))
                i = j


class CudaGraph:
    """``torch.cuda.CUDAGraph`` of ``run`` (captured here), replayed on the
    current stream."""

    def __init__(self, run, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(self.graph):
            run()

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


class HostGraph:
    """A stand-in for ``CudaGraph`` on any device: "capture" runs ``run``
    once, a replay runs it again with the launch counts left as they were
    (a replay calls no wrapper), so that only the cache's accounting
    moves them."""

    def __init__(self, run, device: torch.device):
        self._run = run
        run()

    def replay(self) -> None:
        saved = launch_counts()
        self._run()
        set_launch_counts(saved)


def _where(exc: BaseException) -> str:
    """The innermost line of ``exc``'s traceback outside torch and this
    module: the op that broke a capture."""
    skip = (os.path.dirname(os.path.abspath(torch.__file__)),
            os.path.abspath(__file__))
    for fr in reversed(traceback.extract_tb(exc.__traceback__)):
        if not os.path.abspath(fr.filename).startswith(skip):
            return f"{fr.filename}:{fr.lineno} ({(fr.line or '').strip()})"
    return "an unknown line"


class _Entry:
    """One key's static buffers, graph and launch-count delta."""

    def __init__(self, name: str, fn, spec, leaves: list,
                 device: torch.device, graph_cls):
        self.name = name
        self.device = device
        # kept, and with it what the graph reads in place (a frontend's
        # weight buffers): nothing it captured is freed while it lives
        self.fn = fn
        self.inp = _Packed([(t.shape, t.dtype) for t in leaves], device)
        self.inp.copy_in(leaves)     # the warm-up reads real inputs
        static_args = _unflatten(spec, iter(self.inp.views))
        saved = launch_counts()
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.device(device), torch.cuda.stream(side):
                warm = fn(*static_args)
            torch.cuda.current_stream(device).wait_stream(side)
        else:
            warm = fn(*static_args)
        out_leaves: list = []
        self.out_spec = _flatten(warm, out_leaves)
        self.out = _Packed([(t.shape, t.dtype) for t in out_leaves], device)
        del warm, out_leaves
        set_launch_counts(saved)

        broke: list = []    # the first error inside the capture

        def run():
            try:
                got: list = []
                if _flatten(fn(*static_args), got) != self.out_spec:
                    raise GraphCaptureError(
                        f"{name}: the outputs' structure changed between "
                        "the warm-up and the capture")
                for view, t in zip(self.out.views, got):
                    view.copy_(t)
            except Exception as e:
                broke.append(e)
                raise

        try:
            self.graph = graph_cls(run, device)
        except Exception as e:
            cause = broke[0] if broke else e
            if isinstance(cause, GraphCaptureError):
                raise cause
            raise GraphCaptureError(
                f"capturing {name} on {device} failed at {_where(cause)}: "
                f"{type(cause).__name__}: {cause}") from cause
        finally:
            after = launch_counts()
            set_launch_counts(saved)
        self.delta = {k: after[k] - saved[k] for k in saved
                      if after[k] != saved[k]}

    def __call__(self, leaves: list):
        self.inp.copy_in(leaves)
        self.graph.replay()
        fresh = {dt: buf.clone() for dt, buf in self.out.bufs.items()}
        add_launch_counts(self.delta)
        return _unflatten(self.out_spec, iter(self.out.views_of(fresh)))


class GraphCache:
    """Graphs of functions keyed by a static key and the inputs' structure,
    shapes, dtypes and device (module docstring).

    ``graph_cls``: None captures ``CudaGraph``s of card tensors and runs
    CPU tensors eagerly; ``HostGraph`` runs the bookkeeping anywhere. A
    deep copy (a receiver's replica on another device) starts empty: each
    replica holds its own graphs. ``spans``: a ``utils.logging.SpanRecorder``
    that counts each capture as ``graph_captures`` (None: not counted)."""

    def __init__(self, graph_cls=None):
        self.graph_cls = graph_cls
        self._entries: dict = {}
        self.spans = None

    def __deepcopy__(self, memo):
        return GraphCache(self.graph_cls)

    def __len__(self) -> int:
        return len(self._entries)

    def __call__(self, fn, key: tuple, *args):
        """``fn(*args)`` through the graph of ``key`` and these inputs."""
        leaves: list = []
        spec = _flatten(args, leaves)
        devices = {t.device for t in leaves}
        if len(devices) != 1:
            raise ValueError(f"graph entry {key[0]!r} takes tensors on one "
                             f"device, got {sorted(map(str, devices))}")
        device = devices.pop()
        graph_cls = self.graph_cls
        if graph_cls is None:
            if device.type != "cuda":
                return fn(*args)
            graph_cls = CudaGraph
        full = (key, spec, device,
                tuple((tuple(t.shape), t.dtype) for t in leaves))
        entry = self._entries.get(full)
        if entry is None:
            entry = _Entry(str(key[0]), fn, spec, leaves, device, graph_cls)
            self._entries[full] = entry
            if self.spans is not None:
                self.spans.count("graph_captures")
        return entry(leaves)
