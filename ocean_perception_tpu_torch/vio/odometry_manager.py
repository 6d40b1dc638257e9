"""Pose-history integrator: relative poses between arbitrary timestamps.

Reference parity: vio/odometry_manager.hpp:18-68 (kept though unused in the
reference's main path). Accumulates stamped world poses; ``relative(t0, t1)``
returns T_{b(t0)}^{b(t1)} from the closest stored poses.

A copy of ``ocean_perception_tpu.vio.odometry_manager``, on the port's
``core/buffers.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.buffers import ItemHistory


class OdometryManager:
    def __init__(self, lag_seconds: float = 30.0):
        self._history: ItemHistory = ItemHistory(lag_seconds=lag_seconds)

    def add_pose(self, timestamp_ns: int, world_T_body: np.ndarray) -> None:
        self._history.add(timestamp_ns, np.asarray(world_T_body).copy())

    def pose_at(self, timestamp_ns: int) -> Optional[Tuple[int, np.ndarray]]:
        return self._history.closest_before(timestamp_ns)

    def relative(self, t0_ns: int, t1_ns: int) -> Optional[np.ndarray]:
        """T from body(t0) to body(t1): inv(w_T_b0) @ w_T_b1."""
        a = self._history.closest_before(t0_ns)
        b = self._history.closest_before(t1_ns)
        if a is None or b is None:
            return None
        w_T_0 = a[1]
        w_T_1 = b[1]
        R0 = w_T_0[:3, :3]
        inv0 = np.eye(4)
        inv0[:3, :3] = R0.T
        inv0[:3, 3] = -R0.T @ w_T_0[:3, 3]
        return inv0 @ w_T_1
