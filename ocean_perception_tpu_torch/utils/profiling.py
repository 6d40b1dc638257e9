"""Device profiling helpers around torch.profiler (port of
``ocean_perception_tpu.utils.profiling``).

The reference profiles with ad-hoc Timer/StatsTracker prints. On a card the
equivalent observability is (a) wall-clock stats on *synchronized* step
boundaries and (b) torch.profiler traces, written as Chrome traces that
Perfetto opens, with named regions (:func:`annotate`) around the work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from .timing import StatsTracker


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the enclosed region (the host, and
    the card if there is one) into ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` hold the region's times."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    return []


def block_until_ready(outputs) -> None:
    """Wait until the devices holding ``outputs`` (tensors, nested in lists,
    tuples and dicts) have finished their queued work."""
    for device in {t.device for t in _tensors(outputs) if t.is_cuda}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(stats: StatsTracker, key: str, *, sync: bool = True) -> Iterator[list]:
    """Time a region; append device outputs to the yielded list to sync on them.

        with timed(stats, "disparity") as outs:
            d = stereo_step(...)
            outs.append(d)
    """
    outputs: list = []
    t0 = time.perf_counter()
    yield outputs
    if sync and outputs:
        block_until_ready(outputs)
    stats.add(key, (time.perf_counter() - t0) * 1e3)


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)
