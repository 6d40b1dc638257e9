"""Host-side concurrency and history containers.

Reference parity: src/vehicle/core/thread_safe_queue.hpp (bounded queue with
drop-oldest backpressure), data_manager.hpp (timestamped measurement queue:
monotonic Push, PopUntil, DiscardBefore, Newest/Oldest), sliding_buffer.hpp
(fixed-size ring with Get(k_ago)), vio/item_history.hpp (timestamp-keyed
history used for EKF rewind).

These live on the host: they feed batched device steps. Device code never
sees them — windows are materialized to arrays before crossing the boundary.

A copy of ``ocean_perception_tpu.core.buffers``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class ThreadsafeQueue(Generic[T]):
    """Bounded FIFO; pushing onto a full queue drops the oldest item.

    Mirrors thread_safe_queue.hpp:16-117 semantics (drop-oldest policy,
    blocking pop with timeout). max_size=0 means unbounded.
    """

    def __init__(self, max_size: int = 0):
        self._max = max_size
        self._items: Deque[T] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)

    def push(self, item: T) -> bool:
        """Returns False if an old item was dropped to make room."""
        with self._not_empty:
            dropped = False
            if self._max > 0 and len(self._items) >= self._max:
                self._items.popleft()
                dropped = True
            self._items.append(item)
            self._not_empty.notify()
            return not dropped

    def pop(self, timeout: Optional[float] = None) -> Optional[T]:
        with self._not_empty:
            if not self._items:
                self._not_empty.wait(timeout=timeout)
            if not self._items:
                return None
            return self._items.popleft()

    def peek(self) -> Optional[T]:
        with self._lock:
            return self._items[0] if self._items else None

    def size(self) -> int:
        with self._lock:
            return len(self._items)

    def empty(self) -> bool:
        return self.size() == 0

    def clear(self) -> None:
        with self._lock:
            self._items.clear()


class DataManager(Generic[T]):
    """Timestamped measurement queue (data_manager.hpp:14-113).

    Items must expose ``.timestamp`` (ns). Push enforces monotonic time
    (non-monotonic items are rejected with a warning, matching the reference
    CHECK-light behavior used for sensors that may replay).
    """

    def __init__(self, max_size: int = 0, drop_old: bool = True):
        self._queue: Deque[T] = deque()
        self._max = max_size
        self._drop_old = drop_old
        self._lock = threading.Lock()

    def push(self, item: T) -> bool:
        with self._lock:
            if self._queue and item.timestamp <= self._queue[-1].timestamp:
                return False  # non-monotonic
            if self._max > 0 and len(self._queue) >= self._max:
                if not self._drop_old:
                    return False
                self._queue.popleft()
            self._queue.append(item)
            return True

    def newest_timestamp(self) -> Optional[int]:
        with self._lock:
            return self._queue[-1].timestamp if self._queue else None

    def oldest_timestamp(self) -> Optional[int]:
        with self._lock:
            return self._queue[0].timestamp if self._queue else None

    def empty(self) -> bool:
        with self._lock:
            return not self._queue

    def size(self) -> int:
        with self._lock:
            return len(self._queue)

    def pop_until(self, timestamp_ns: int) -> List[T]:
        """Pop and return all items with t <= timestamp (PopUntil)."""
        out: List[T] = []
        with self._lock:
            while self._queue and self._queue[0].timestamp <= timestamp_ns:
                out.append(self._queue.popleft())
        return out

    def discard_before(self, timestamp_ns: int, inclusive: bool = False) -> None:
        """Drop items older than timestamp (DiscardBefore)."""
        with self._lock:
            while self._queue and (
                self._queue[0].timestamp < timestamp_ns
                or (inclusive and self._queue[0].timestamp == timestamp_ns)
            ):
                self._queue.popleft()

    def newest(self) -> Optional[T]:
        with self._lock:
            return self._queue[-1] if self._queue else None

    def snapshot(self) -> List[T]:
        with self._lock:
            return list(self._queue)


class SlidingBuffer(Generic[T]):
    """Fixed-size ring buffer addressed by 'k ago' (sliding_buffer.hpp:14-55)."""

    def __init__(self, size: int):
        assert size > 0
        self._buf: List[Optional[T]] = [None] * size
        self._head = 0  # next write slot
        self._added = 0

    def add(self, item: T) -> None:
        self._buf[self._head] = item
        self._head = (self._head + 1) % len(self._buf)
        self._added += 1

    def get(self, k_ago: int) -> T:
        assert 0 <= k_ago < len(self._buf)
        assert k_ago < self._added
        idx = (self._head - 1 - k_ago) % len(self._buf)
        item = self._buf[idx]
        assert item is not None
        return item

    def head(self) -> T:
        return self.get(0)

    def size(self) -> int:
        return min(self._added, len(self._buf))

    def full(self) -> bool:
        return self._added >= len(self._buf)


class ItemHistory(Generic[T]):
    """Timestamp-keyed history with lag-based eviction (item_history.hpp:11-64).

    Used by the EKF sync logic: ``closest_before(t)`` finds the newest state
    at or before t (the rewind point), then newer items are replayed.
    """

    def __init__(self, lag_seconds: float = 10.0):
        self._lag_ns = int(lag_seconds * 1e9)
        self._times: List[int] = []
        self._items: List[T] = []
        self._lock = threading.Lock()

    def add(self, timestamp_ns: int, item: T) -> None:
        with self._lock:
            self._times.append(timestamp_ns)
            self._items.append(item)
            cutoff = timestamp_ns - self._lag_ns
            drop = 0
            while drop < len(self._times) - 1 and self._times[drop] < cutoff:
                drop += 1
            if drop:
                self._times = self._times[drop:]
                self._items = self._items[drop:]

    def closest_before(self, timestamp_ns: int) -> Optional[Tuple[int, T]]:
        with self._lock:
            best = None
            for t, item in zip(self._times, self._items):
                if t <= timestamp_ns:
                    best = (t, item)
                else:
                    break
            return best

    def newest(self) -> Optional[Tuple[int, T]]:
        with self._lock:
            if not self._times:
                return None
            return self._times[-1], self._items[-1]

    def discard_after(self, timestamp_ns: int) -> None:
        """Drop items strictly newer than timestamp (rewind support)."""
        with self._lock:
            keep = 0
            while keep < len(self._times) and self._times[keep] <= timestamp_ns:
                keep += 1
            self._times = self._times[:keep]
            self._items = self._items[:keep]

    def empty(self) -> bool:
        with self._lock:
            return not self._times
