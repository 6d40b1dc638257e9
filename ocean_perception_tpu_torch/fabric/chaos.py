"""Transport fault injection: a deterministic chaos wrapper for any PubSub
(a copy of ``ocean_perception_tpu.fabric.chaos``).

Production deployments lose datagrams (UDP has no delivery guarantee —
reference lcm_util relies on LCM's best-effort multicast), duplicate them
(multi-homed multicast loops), and reorder them (fragment reassembly races,
wifi retransmits). `ChaosBus` injects all three at the publish boundary of
any `fabric.pubsub.PubSub`, seeded and synchronous, so mission-level
robustness is testable and REPRODUCIBLE:

- drop:    the message never reaches the inner bus;
- dup:     the message is delivered twice back-to-back;
- holdback: the message is stashed and re-injected after `hold_count`
  subsequent publishes on the same channel group — a real reordering (late
  arrival with an old timestamp), delivered on the caller's thread so
  single-threaded consumers stay race-free.

Faults apply only to channels matched by `channels` (None = all), so tests
can corrupt the sensor stream while keeping e.g. the init-pose channel
reliable. `stats` counts what was injected — assertions can require that
chaos actually happened.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Iterable, Optional

from .pubsub import PubSub


class ChaosBus(PubSub):
    """Wraps `inner`; see module docstring. Probabilities are evaluated in
    order drop -> dup -> holdback on one uniform draw, so
    p_drop + p_dup + p_hold must be <= 1.

    Thread-safe: concurrent publishers serialize on an internal lock (the
    fault schedule then depends on arrival interleaving, so REPRODUCIBLE
    runs additionally need a single-threaded publisher)."""

    def __init__(
        self,
        inner: PubSub,
        p_drop: float = 0.0,
        p_dup: float = 0.0,
        p_hold: float = 0.0,
        hold_count: int = 3,
        seed: int = 0,
        channels: Optional[Iterable[str]] = None,
    ):
        assert p_drop + p_dup + p_hold <= 1.0
        self._inner = inner
        self._p_drop, self._p_dup, self._p_hold = p_drop, p_dup, p_hold
        self._hold_count = hold_count
        self._rng = random.Random(seed)
        self._channels = set(channels) if channels is not None else None
        self._held: list = []  # (release_at_publish_index, channel, message)
        self._n = 0
        self._lock = threading.Lock()
        self.stats = {"published": 0, "dropped": 0, "duplicated": 0, "held": 0}

    def publish(self, channel: str, message) -> None:
        if self._channels is not None and channel not in self._channels:
            self._inner.publish(channel, message)
            return
        with self._lock:
            self.stats["published"] += 1
            self._n += 1
            # Release any held messages that have waited out their window
            # (AFTER the current message goes out, so they arrive late).
            due = [h for h in self._held if h[0] <= self._n]
            self._held = [h for h in self._held if h[0] > self._n]

            r = self._rng.random()
            if r < self._p_drop:
                self.stats["dropped"] += 1
            elif r < self._p_drop + self._p_dup:
                self.stats["duplicated"] += 1
                self._inner.publish(channel, message)
                self._inner.publish(channel, message)
            elif r < self._p_drop + self._p_dup + self._p_hold:
                self.stats["held"] += 1
                self._held.append((self._n + self._hold_count, channel, message))
            else:
                self._inner.publish(channel, message)

            for _, ch, m in due:
                self._inner.publish(ch, m)

    def flush(self) -> None:
        """Deliver everything still held (end of stream)."""
        with self._lock:
            held, self._held = self._held, []
        for _, ch, m in held:
            self._inner.publish(ch, m)

    def subscribe(self, channel: str, callback: Callable) -> None:
        self._inner.subscribe(channel, callback)

    def set_tap(self, callback) -> None:
        self._inner.set_tap(callback)

    def close(self) -> None:
        self.flush()
        self._inner.close()
