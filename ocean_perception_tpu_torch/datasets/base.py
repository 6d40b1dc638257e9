"""DataProvider: callback registration + chronological playback.

Reference parity: dataset/data_provider.{hpp,cpp} —
- callbacks per measurement type (stereo/imu/depth/range + groundtruth),
- ``step()`` dispatches the next measurement in time order with tie priority
  IMU > DEPTH > RANGE > STEREO (data_provider.cpp:53-62),
- ``playback(speed)`` sleeps (t_next - t_last)/speed between steps in a
  worker thread; images load lazily at step time,
- SanityCheck limits |a| <= 98.1, |w| <= 20, range <= 100, depth <= 20
  (cpp:13-16).

A copy of ``ocean_perception_tpu.datasets.base``, on the port's
``core/measurements.py``.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..core.measurements import (
    DepthMeasurement,
    GroundtruthPose,
    ImuMeasurement,
    RangeMeasurement,
    StereoImage,
)
from ..utils.image_io import load_image


class DataSource(enum.IntEnum):
    """Tie-break priority: lower value dispatches first (cpp:53-62)."""

    IMU = 0
    DEPTH = 1
    RANGE = 2
    STEREO = 3
    POSE = 4


@dataclasses.dataclass(frozen=True)
class SanityLimits:
    max_accel: float = 98.1
    max_gyro: float = 20.0
    max_range: float = 100.0
    max_depth: float = 20.0


@dataclasses.dataclass(frozen=True)
class StereoDatasetItem:
    timestamp: int
    left_path: str
    right_path: str
    camera_id: int = 0


class DataProvider:
    """Chronological multi-stream player. Subclasses fill the data lists."""

    def __init__(self):
        self.stereo_data: List[StereoDatasetItem] = []
        self.imu_data: List[ImuMeasurement] = []
        self.depth_data: List[DepthMeasurement] = []
        self.range_data: List[RangeMeasurement] = []
        self.pose_data: List[GroundtruthPose] = []

        self._stereo_cbs: List[Callable[[StereoImage], None]] = []
        self._imu_cbs: List[Callable[[ImuMeasurement], None]] = []
        self._depth_cbs: List[Callable[[DepthMeasurement], None]] = []
        self._range_cbs: List[Callable[[RangeMeasurement], None]] = []
        self._pose_cbs: List[Callable[[GroundtruthPose], None]] = []

        self._idx = {s: 0 for s in DataSource}
        self._last_t: Optional[int] = None
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.grayscale = True

    # -- registration ---------------------------------------------------------

    def register_stereo_callback(self, cb) -> None:
        self._stereo_cbs.append(cb)

    def register_imu_callback(self, cb) -> None:
        self._imu_cbs.append(cb)

    def register_depth_callback(self, cb) -> None:
        self._depth_cbs.append(cb)

    def register_range_callback(self, cb) -> None:
        self._range_cbs.append(cb)

    def register_groundtruth_callback(self, cb) -> None:
        self._pose_cbs.append(cb)

    # -- sanity ---------------------------------------------------------------

    def sanity_check(self, limits: SanityLimits = SanityLimits()) -> None:
        for m in self.imu_data:
            assert np.linalg.norm(m.linear_acceleration) <= limits.max_accel, m
            assert np.linalg.norm(m.angular_velocity) <= limits.max_gyro, m
        for d in self.depth_data:
            assert 0 <= d.depth <= limits.max_depth, d
        for r in self.range_data:
            assert 0 <= r.range <= limits.max_range, r

    # -- stepping -------------------------------------------------------------

    def _peek(self, source: DataSource) -> Optional[int]:
        data = {
            DataSource.IMU: self.imu_data,
            DataSource.DEPTH: self.depth_data,
            DataSource.RANGE: self.range_data,
            DataSource.STEREO: self.stereo_data,
            DataSource.POSE: self.pose_data,
        }[source]
        i = self._idx[source]
        return data[i].timestamp if i < len(data) else None

    def next_timestamp(self) -> Optional[int]:
        ts = [t for t in (self._peek(s) for s in DataSource) if t is not None]
        return min(ts) if ts else None

    def step(self) -> bool:
        """Dispatch the next measurement; returns False when exhausted."""
        best: Optional[DataSource] = None
        best_t: Optional[int] = None
        for source in DataSource:  # enumeration order = tie priority
            t = self._peek(source)
            if t is None:
                continue
            if best_t is None or t < best_t:
                best, best_t = source, t
        if best is None:
            return False

        i = self._idx[best]
        self._idx[best] += 1
        self._last_t = best_t

        if best is DataSource.IMU:
            for cb in self._imu_cbs:
                cb(self.imu_data[i])
        elif best is DataSource.DEPTH:
            for cb in self._depth_cbs:
                cb(self.depth_data[i])
        elif best is DataSource.RANGE:
            for cb in self._range_cbs:
                cb(self.range_data[i])
        elif best is DataSource.POSE:
            for cb in self._pose_cbs:
                cb(self.pose_data[i])
        else:
            item = self.stereo_data[i]
            if self._stereo_cbs:
                if hasattr(item, "load"):
                    # Self-loading item (e.g. datasets/lcm_log.py — frames
                    # embedded in a session log instead of image files).
                    img = item.load(self.grayscale)
                else:
                    left = load_image(item.left_path, grayscale=self.grayscale)
                    right = load_image(item.right_path, grayscale=self.grayscale)
                    img = StereoImage(
                        timestamp=item.timestamp,
                        camera_id=item.camera_id,
                        left=left,
                        right=right,
                    )
                for cb in self._stereo_cbs:
                    cb(img)
        return True

    def step_until(self, timestamp_ns: int) -> int:
        n = 0
        while True:
            t = self.next_timestamp()
            if t is None or t > timestamp_ns:
                break
            self.step()
            n += 1
        return n

    def play_all(self) -> int:
        n = 0
        while self.step():
            n += 1
        return n

    # -- real-time playback ---------------------------------------------------

    def playback(
        self, speed: float = 1.0, block: bool = True, max_steps: Optional[int] = None
    ) -> None:
        """Play measurements with real-time pacing (cpp:166-181)."""
        assert speed > 0

        def worker():
            last_t: Optional[int] = None
            n = 0
            while not self._shutdown.is_set():
                if max_steps is not None and n >= max_steps:
                    break
                t = self.next_timestamp()
                if t is None:
                    break
                if last_t is not None:
                    time.sleep(max(0.0, (t - last_t) * 1e-9 / speed))
                if not self.step():
                    break
                last_t = t
                n += 1

        if block:
            worker()
        else:
            self._thread = threading.Thread(target=worker, daemon=True)
            self._thread.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
