"""Small math helpers (reference: core/math_util.hpp:17-113).

A copy of ``ocean_perception_tpu.core.math_util``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def wrap_int(k: int, n: int) -> int:
    """Wrap k into [0, n) (WrapInt)."""
    return k % n


def deg_to_rad(deg: float) -> float:
    return deg * np.pi / 180.0


def rad_to_deg(rad: float) -> float:
    return rad * 180.0 / np.pi


def next_even_int(x: int) -> int:
    """Round up to an even integer (NextEvenInt; guided-filter radius)."""
    return x if x % 2 == 0 else x + 1


def next_odd_int(x: int) -> int:
    return x if x % 2 == 1 else x + 1


def subset(items: Sequence, indices: Sequence[int]) -> list:
    """Select items by index (Subset)."""
    return [items[i] for i in indices]


def subset_from_mask(items: Sequence, mask: Sequence[bool]) -> list:
    """Select items where mask is True (SubsetFromMask)."""
    return [item for item, keep in zip(items, mask) if keep]


def average(values: Sequence[float]) -> float:
    return float(np.mean(values)) if len(values) else 0.0
