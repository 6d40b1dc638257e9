"""Timestamps: nanosecond uint64 timeline shared by every sensor stream.

Reference parity: src/vehicle/core/timestamp.hpp:12-35 (``timestamp_t`` = ns
since epoch as uint64, ``seconds_t`` = double, converters, min/max sentinels).
Python ints are arbitrary precision so host code uses plain ``int`` ns; device
code carries timestamps as int64 (ns) or float64 seconds.

A copy of ``ocean_perception_tpu.core.time``.
"""

from __future__ import annotations

TIMESTAMP_MIN: int = 0
TIMESTAMP_MAX: int = 2**63 - 1  # keep inside int64 for device arrays

NS_PER_SECOND: int = 1_000_000_000


def to_seconds(timestamp_ns: int) -> float:
    """ns → float seconds (timestamp.hpp ConvertToSeconds)."""
    return timestamp_ns / NS_PER_SECOND


def to_timestamp(seconds: float) -> int:
    """float seconds → ns (timestamp.hpp ConvertToTimestamp)."""
    return int(round(seconds * NS_PER_SECOND))
