"""Device meshes driven by one process (port of ``ocean_perception_tpu.parallel.mesh``).

``jax.shard_map`` is single-controller: one process drives every device of
the mesh. Its counterpart here is a named, shaped array of
``torch.device``\\ s that one process drives. An entry may repeat: a mesh of
``["cuda:0"] * 4`` is four devices played by one card (as the JAX tests play
eight on one CPU), and ``["cpu"] * 4`` four on the CPU. The same code runs
unchanged on ``cuda:0 .. cuda:3``.

A :class:`Sharding` splits a tensor's axes over mesh axes into one piece a
mesh entry and joins the pieces back. A :class:`Queue` runs the work of one
mesh entry in order: on a card a CUDA stream of its own, so repeated
entries of one card run side by side and two entries' work is ordered only
by events; on the CPU a worker thread, whose events are futures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.cuda import entry_device
from ..utils.profiling import annotate


def _device(d) -> torch.device:
    """A mesh entry: a CUDA device gets its index (the current one if none)."""
    d = entry_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A named, shaped array of devices; ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {flat}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(np.shape(np.asarray(devices, dtype=object)))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh of shape "
                             f"{self.devices.shape}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: the
        entries that do the work of a computation split over ``axis`` alone
        (the other axes would hold replicas of it)."""
        k = self.axis_names.index(axis)
        index = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("cam",),
              shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first n devices: ``devices`` (entries may repeat) or
    every card, ``cuda:0 .. cuda:{count-1}``; without a card it raises, and
    CPU callers pass ``devices=["cpu"] * n``. Default: one 'cam' axis over
    all of them. Pass ``shape`` and ``axis_names`` for richer layouts (e.g.
    ('cam', 'strip'))."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} given; repeat an "
                             f"entry (devices=['cuda:0'] * n) to play n devices on one")
        devices = devices[:n_devices]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(devices),)
    if math.prod(shape) != len(devices):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {math.prod(shape)} devices, "
                         f"got {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), axis_names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Tensor axis i split evenly, in order, over mesh axis spec[i] (None or
    past the spec: whole); the mesh axes the spec leaves out hold replicas.
    The counterpart of ``NamedSharding(mesh, PartitionSpec(*spec))``."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def _split_dims(self) -> List[Tuple[int, str]]:
        return [(i, a) for i, a in enumerate(self.spec) if a is not None]

    def split(self, x: torch.Tensor) -> np.ndarray:
        """The piece of ``x`` on each mesh entry, an array of the mesh's
        shape; each piece a copy on its entry's device (or ``x`` itself, if
        on it and whole)."""
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for index in itertools.product(*map(range, self.mesh.devices.shape)):
            piece = x
            for dim, axis in self._split_dims():
                n = self.mesh.shape[axis]
                if x.shape[dim] % n:
                    raise ValueError(f"axis {dim} of {x.shape[dim]} does not split evenly over "
                                     f"{n} devices of mesh axis {axis!r}")
                size = x.shape[dim] // n
                k = index[self.mesh.axis_names.index(axis)]
                piece = piece.narrow(dim, k * size, size)
            out[index] = piece.to(self.mesh.devices[index])
        return out

    def join(self, pieces: np.ndarray, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first entry's by default) from
        the pieces of :meth:`split`, replicas read at index 0."""
        device = self.mesh.devices.reshape(-1)[0] if device is None else device
        axes = self.mesh.axis_names
        split = dict((a, d) for d, a in self._split_dims())
        index = tuple(slice(None) if a in split else 0 for a in axes)
        grid = pieces[index]  # the split axes, in mesh order
        kept = [a for a in axes if a in split]

        def cat(sub, level):
            if level == len(kept):
                return sub.to(device)
            return torch.cat([cat(s, level + 1) for s in sub], dim=split[kept[level]])

        return cat(grid, 0)


def split_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The leading axis of x in equal blocks, block i a copy on devices[i]."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over {n} devices")
    size = x.shape[0] // n
    return [x[i * size:(i + 1) * size].to(d) for i, d in enumerate(devices)]


def join_rows(blocks: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The blocks of :func:`split_rows`, joined on ``device``."""
    return torch.cat([b.to(device) for b in blocks])


def camera_sharding(mesh: Mesh, axis: str = "cam") -> Sharding:
    """Split the leading (camera/batch) axis of a tensor over ``axis``."""
    return Sharding(mesh, (axis,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def tree_map(fn, *trees):
    """fn over the tensors of like trees (dataclasses, tuples, named tuples,
    lists, nested); other leaves come from the first tree."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return dataclasses.replace(t, **{f.name: tree_map(fn, *(getattr(u, f.name) for u in trees))
                                         for f in dataclasses.fields(t)})
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *parts) for parts in zip(*trees))
    return t


def split_tree(tree, devices: Sequence[torch.device]) -> list:
    """One tree a device: each tensor's leading axis split evenly, in order."""
    return [tree_map(lambda x, k=k: split_rows(x, devices)[k], tree) for k in range(len(devices))]


def join_tree(trees: Sequence, device) -> object:
    """The trees' tensors concatenated on their leading axis, on ``device``."""
    return tree_map(lambda *xs: join_rows(xs, device), *trees)


@functools.lru_cache(maxsize=None)
def _entry_stream(device: torch.device, slot: int) -> "torch.cuda.Stream":
    """The CUDA stream of the slot-th entry on a card, made once: the
    caching allocator keeps its free blocks per stream, so a new stream a
    call would allocate (cudaMalloc) anew each call."""
    return torch.cuda.Stream(device)


def _annotated(name: str, fn) -> None:
    with annotate(name):
        fn()


class Queue:
    """The work of one mesh entry, run in order: on a card a CUDA stream of
    its own, on the CPU a worker thread. :meth:`run` enqueues a function,
    :meth:`record` returns an event that completes when the work enqueued so
    far has, and :meth:`wait` holds the work enqueued after it until an
    event of another queue completes. A function that reads a tensor
    another queue wrote must run after a wait on that queue's event, and
    the tensor is then ``use``\\ d here."""

    def __init__(self, device: torch.device, slot: int = 0):
        self.device = device
        self._stream = None
        self._pool = None
        self._error: Optional[BaseException] = None
        if device.type == "cuda":
            self._stream = _entry_stream(device, slot)
            # Work of the caller's stream (the inputs) comes first.
            self._stream.wait_stream(torch.cuda.current_stream(device))
        else:
            self._pool = ThreadPoolExecutor(max_workers=1)

    def _guarded(self, fn):
        if self._error is None:
            try:
                fn()
            except BaseException as e:  # re-raised by close(), once the queue is drained
                self._error = e

    def run(self, fn, name: Optional[str] = None) -> None:
        """Enqueue fn(); ``name`` labels its work in a profiler trace."""
        if name is not None:
            fn = functools.partial(_annotated, name, fn)
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                fn()
        else:
            self._pool.submit(self._guarded, fn)

    def record(self):
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            return event
        return self._pool.submit(lambda: None)

    def wait(self, event) -> None:
        if self._stream is not None:
            self._stream.wait_event(event)
        else:
            self._pool.submit(self._guarded, event.result)

    def use(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Mark a tensor another queue allocated as read here, so that its
        memory is not reused before this queue's reads of it are done."""
        if self._stream is not None and t is not None and t.is_cuda:
            t.record_stream(self._stream)
        return t

    def close(self) -> None:
        """Wait for the queue's work (on a card: the caller's stream waits)
        and raise the first error it met."""
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        else:
            self._pool.shutdown(wait=True)
            if self._error is not None:
                raise self._error


@contextlib.contextmanager
def queues(devices: Sequence[torch.device]) -> Iterator[List[Queue]]:
    """A :class:`Queue` a device entry, closed (drained, errors raised) on
    exit; the i-th entry on a card runs on that card's i-th stream."""
    qs = [Queue(d, i) for i, d in enumerate(devices)]
    try:
        yield qs
    finally:
        errors = []
        for q in qs:
            try:
                q.close()
            except BaseException as e:
                errors.append(e)
        if errors:
            raise errors[0]
