"""Monotonic uint64 ids for images / landmarks (reference: core/uid.hpp:9).

On device, ids live as int64 lanes inside fixed-capacity slot arrays; -1 marks
an empty slot (the reference uses unordered_map keys instead).

A copy of ``ocean_perception_tpu.core.uids``.
"""

from __future__ import annotations

import itertools
import threading

INVALID_UID: int = -1


class UidGenerator:
    """Thread-safe monotonic id source for host-side orchestration."""

    def __init__(self, start: int = 0):
        self._counter = itertools.count(start)
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            return next(self._counter)
