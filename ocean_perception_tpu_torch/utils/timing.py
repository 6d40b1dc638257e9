"""Timing and profiling statistics.

Reference parity: src/vehicle/core/timer.hpp (steady-clock stopwatch),
stats_tracker.hpp:14-62 (named scalar ring buffers with min/max/mean and
rate-limited printing), data_subsampler.hpp (publish rate limiter).

For device work, ``Timer`` alone lies (CUDA runs async): synchronize before
reading it, or time the device with CUDA events. A copy of
``ocean_perception_tpu.utils.timing``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional


class Timer:
    """Stopwatch (timer.hpp:17-41)."""

    def __init__(self, start: bool = True):
        self._t0: Optional[float] = None
        self._elapsed = 0.0
        if start:
            self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None
        return self._elapsed

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._elapsed = 0.0

    def elapsed(self) -> float:
        """Seconds since start (running total if stopped/resumed)."""
        if self._t0 is None:
            return self._elapsed
        return self._elapsed + (time.perf_counter() - self._t0)

    def tock(self) -> float:
        """Milliseconds since start (timer.hpp Tock)."""
        return self.elapsed() * 1e3


class StatsBuffer:
    """Ring buffer of named scalars (stats_tracker.hpp StatsBuffer)."""

    def __init__(self, maxlen: int = 100):
        self._values: Deque[float] = deque(maxlen=maxlen)

    def add(self, v: float) -> None:
        self._values.append(float(v))

    def min(self) -> float:
        return min(self._values) if self._values else float("nan")

    def max(self) -> float:
        return max(self._values) if self._values else float("nan")

    def mean(self) -> float:
        return sum(self._values) / len(self._values) if self._values else float("nan")

    def count(self) -> int:
        return len(self._values)


class StatsTracker:
    """Named stats with rate-limited printing (stats_tracker.hpp:41-62)."""

    def __init__(self, name: str = "", maxlen: int = 100, print_interval_sec: float = 1.0):
        self.name = name
        self._buffers: Dict[str, StatsBuffer] = {}
        self._maxlen = maxlen
        self._interval = print_interval_sec
        self._last_print: Dict[str, float] = {}

    def add(self, key: str, value: float, print_stats: bool = False) -> None:
        buf = self._buffers.setdefault(key, StatsBuffer(self._maxlen))
        buf.add(value)
        if print_stats:
            now = time.perf_counter()
            if now - self._last_print.get(key, 0.0) >= self._interval:
                self._last_print[key] = now
                print(
                    f"[stats {self.name}/{key}] n={buf.count()} "
                    f"mean={buf.mean():.3f} min={buf.min():.3f} max={buf.max():.3f}"
                )

    def stats(self, key: str) -> StatsBuffer:
        return self._buffers.setdefault(key, StatsBuffer(self._maxlen))


class DataSubsampler:
    """Rate limiter for publishing (data_subsampler.hpp:12-29)."""

    def __init__(self, target_hz: float):
        assert target_hz > 0
        self._min_dt = 1.0 / target_hz
        self._last: Optional[float] = None

    def should_sample(self, t_seconds: float) -> bool:
        if self._last is None or (t_seconds - self._last) >= self._min_dt:
            self._last = t_seconds
            return True
        return False
