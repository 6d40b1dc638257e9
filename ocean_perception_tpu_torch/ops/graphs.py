"""Replay of a fixed-shape step from a CUDA graph.

A step that launches thousands of small kernels (the VIO smoother's
Gauss-Newton solve, the odometry's LM runs, the filter's predict and
update) costs the host a launch each when it runs by calls.
``GraphedStep`` captures such a step once for each signature of its
inputs (the shapes, dtypes and devices of its tensors) and then replays
it: the inputs are copied into the graph's static buffers and the outputs
cloned out, so a replay equals a call bit for bit. The step must read
nothing back to the host (a capture forbids it); its first two calls for
a signature run by calls on a side stream, which also fills the device
constants it copies there once. Under an enclosing capture the step runs
by calls. The JAX package's counterpart is ``jax.jit``.

A capture may run while another thread launches work on its own stream
(the threaded state estimator captures its smoother graphs mid-mission):
each capture runs on a stream of its own in ``thread_local`` mode, which
forbids only the capturing thread's unsafe calls, and without the device
synchronize that ``torch.cuda.graph`` makes on entry.
"""

from __future__ import annotations

import gc

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


class GraphedStep:
    """``fn`` on CUDA tensors (any pytree of them), replayed from a CUDA graph."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs = {}

    def __call__(self, *args):
        if torch.cuda.is_current_stream_capturing():
            return self.fn(*args)
        flat, spec = tree_flatten(args)
        key = (str(spec), tuple((t.shape, t.dtype, t.device) for t in flat))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(flat, spec)
        graph, static_in, static_out = entry
        for buf, t in zip(static_in, flat):
            buf.copy_(t)
        graph.replay()
        return tree_map(torch.clone, static_out)

    def _capture(self, flat, spec):
        static_in = [t.clone() for t in flat]
        args = tree_unflatten(static_in, spec)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self.fn(*args)
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: freeing a collected
        # tensor that another stream used records an event there, which
        # invalidates the capture (torch.cuda.graph collects before it).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_out = self.fn(*args)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(side)
        return graph, static_in, static_out
