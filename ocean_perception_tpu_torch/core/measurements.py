"""Sensor measurement records.

Reference parity: src/vehicle/core/{imu_measurement,depth_measurement,
range_measurement,mag_measurement}.hpp and vision_core/stereo_image.hpp.
Host-side these are light dataclasses carrying numpy payloads; device-side
batches of them are plain arrays (e.g. an IMU window is a (N,7) array of
[t, wx, wy, wz, ax, ay, az]) — the scan-friendly layout the VIO kernels use.

A copy of ``ocean_perception_tpu.core.measurements``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImuMeasurement:
    timestamp: int  # ns
    angular_velocity: np.ndarray  # (3,) rad/s, body frame
    linear_acceleration: np.ndarray  # (3,) m/s^2, body frame (specific force)


@dataclasses.dataclass(frozen=True)
class DepthMeasurement:
    timestamp: int
    depth: float  # meters along the gravity axis


@dataclasses.dataclass(frozen=True)
class RangeMeasurement:
    timestamp: int
    range: float  # meters to beacon
    point: np.ndarray  # (3,) beacon position in world
    beacon_id: int = 0


@dataclasses.dataclass(frozen=True)
class MagMeasurement:
    timestamp: int
    field: np.ndarray  # (3,) measured field in sensor frame


@dataclasses.dataclass(frozen=True)
class StereoImage:
    """Timestamped stereo pair (vision_core/stereo_image.hpp:13-34)."""

    timestamp: int
    camera_id: int
    left: np.ndarray  # (H, W) or (H, W, 3), float32 in [0,1] or uint8
    right: np.ndarray


@dataclasses.dataclass(frozen=True)
class GroundtruthPose:
    timestamp: int
    world_T_body: np.ndarray  # (4, 4)


@dataclasses.dataclass(frozen=True)
class PoseMeasurement:
    """External absolute pose fix (fiducial relocalization, USBL, surface
    GPS). Not a reference type — its only external pose is the one-shot
    initialization message (state_estimator_lcm.cpp:137-176); this carries
    the same payload as a continuous aiding measurement."""

    timestamp: int
    world_T_body: np.ndarray  # (4, 4)
    covariance: "np.ndarray | None" = None  # (6, 6) [t, theta], None = default


def imu_window_to_array(measurements) -> np.ndarray:
    """Pack ImuMeasurements → (N, 7) float64 [t_sec, w(3), a(3)] for the preintegration loop."""
    out = np.zeros((len(measurements), 7), dtype=np.float64)
    for i, m in enumerate(measurements):
        out[i, 0] = m.timestamp * 1e-9
        out[i, 1:4] = m.angular_velocity
        out[i, 4:7] = m.linear_acceleration
    return out
