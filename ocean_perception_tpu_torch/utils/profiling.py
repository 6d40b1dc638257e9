"""Device profiling helpers around torch.profiler (port of
``ocean_perception_tpu.utils.profiling``).

The reference profiles with ad-hoc Timer/StatsTracker prints. On a card the
equivalent observability is (a) torch.profiler traces, written as Chrome
traces that Perfetto opens, with named regions (:func:`annotate`) around the
work, and (b) the same regions timed on the device's own clock on every
call, by a :class:`StageClock`.

A ``record_function`` runs on the host, so under a CUDA graph it runs once,
at capture, and never at replay. A span on a clock leaves a mark in the
work itself: a timing CUDA event recorded at the region's entry and exit.
Captured, each event is an event-record node of the graph, recorded again
on every replay, so the spans of the last replay are read after it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, List, Tuple

import torch

_active = threading.local()


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


class StageClock:
    """The spans that :func:`annotate` opens while the clock is active on
    this thread, on ``device``'s clock: on a card a timing CUDA event
    (``external``, so that stream capture makes it a graph node) recorded
    on the current stream at each span's entry and exit, on the CPU a
    ``perf_counter`` reading. One device's spans a clock.

        with StageClock(device) as clock:
            out = step(...)
        ...  # once the step's work is known to be done
        spans = clock.read()

    Entering the clock starts a new record. A step captured in a CUDA graph
    under the clock is timed on every replay: read the clock after each
    replay's work is done, without entering it again.
    """

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self._spans: list = []   # [name, entry mark, exit mark], in order of entry

    def __enter__(self) -> "StageClock":
        if getattr(_active, "clock", None) is not None:
            raise RuntimeError("a StageClock is already active on this thread")
        self._spans = []
        _active.clock = self
        return self

    def __exit__(self, *exc) -> None:
        _active.clock = None

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
            return event
        return time.perf_counter()

    @contextlib.contextmanager
    def _span(self, name: str) -> Iterator[None]:
        with torch.profiler.record_function(name):
            entry = [name, self._mark(), None]
            self._spans.append(entry)
            try:
                yield
            finally:
                entry[2] = self._mark()

    def read(self) -> List[Tuple[str, float, float]]:
        """(name, start ms, end ms) of each span, in order of entry, from the
        clock's first mark. On a card, call it once the spans' work is known
        to be done: it reads the events and adds no synchronisation."""
        if not self._spans:
            return []
        first = self._spans[0][1]
        if self.device.type == "cuda":
            def ms(mark):
                return 0.0 if mark is first else first.elapsed_time(mark)
        else:
            def ms(mark):
                return (mark - first) * 1e3
        return [(name, ms(a), ms(b)) for name, a, b in self._spans]


def annotate(name: str):
    """Named region that shows up in profiler traces; while a
    :class:`StageClock` is active on this thread, also a span on it."""
    clock = getattr(_active, "clock", None)
    if clock is None:
        return torch.profiler.record_function(name)
    return clock._span(name)
