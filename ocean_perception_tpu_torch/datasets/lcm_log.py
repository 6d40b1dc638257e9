"""Dataset provider over an LCM session log (record once, replay as data).

The reference's operational loop records missions with ``lcm-logger`` and
re-drives them offline (README.md:63-67). This provider closes that loop on
our side: any log in the standard LCM event format — captured by
fabric/nodes/channel_logger.py from either transport, or by stock
lcm-logger against a reference-era vehicle — loads as a
:class:`~.base.DataProvider`, so the dataset player, the estimator node,
and the evaluation CLI all run straight off a recorded session.

Index-once, decode-lazily: sensor scalars (IMU/depth/range/pose) are decoded
during the single indexing pass; stereo frames only store their file offset
and are decoded on dispatch (a 720p mission log holds gigabytes of frames —
eager decode would not fit memory, exactly why mmf exists on the live wire).

Unmapped events are counted, not fatal: mmf descriptor frames reference a
mapped file that no longer exists after the session, and foreign types have
no decoder; both are reported via ``skipped``.

A copy of ``ocean_perception_tpu.datasets.lcm_log``, on the port's
``fabric/{lcm_types,lcm_wire,lcm_log}.py``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np

from ..core.measurements import (
    DepthMeasurement,
    GroundtruthPose,
    ImuMeasurement,
    RangeMeasurement,
    StereoImage,
)
from ..fabric import lcm_types as lt
from ..fabric.lcm_log import LcmLogReader
from .base import DataProvider


def _quat_to_matrix_np(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Unit-quaternion (w, x, y, z) -> 3x3 rotation, pure numpy (indexing a
    log touches no device)."""
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n < 1e-12:
        return np.eye(3)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _to_frame(arr: np.ndarray, grayscale: bool) -> np.ndarray:
    """Match utils/image_io.load_image conventions: float32 [0,1], (H, W)
    when grayscale (BT.601 weights, what cv2's BGR2GRAY uses) else RGB."""
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if grayscale and arr.ndim == 3:
        arr = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    return np.ascontiguousarray(arr, np.float32)


@dataclasses.dataclass(frozen=True)
class LogStereoItem:
    """Duck-typed StereoDatasetItem whose pixels live in the log file."""

    timestamp: int
    camera_id: int
    offset: int
    reader: LcmLogReader

    def load(self, grayscale: bool) -> StereoImage:
        from ..fabric.lcm_wire import from_lcm

        ev = self.reader.read_at(self.offset)
        sd, values = lt.decode_by_fingerprint(ev.data)
        if sd is not lt.STEREO_IMAGE_T:
            raise ValueError(f"event at {self.offset} is not stereo_image_t")
        msg = from_lcm(sd, values)
        return StereoImage(
            timestamp=self.timestamp,
            camera_id=self.camera_id,
            left=_to_frame(msg.left.to_array(), grayscale),
            right=_to_frame(msg.right.to_array(), grayscale),
        )


class LcmLogDataset(DataProvider):
    """DataProvider over an LCM event log.

    ``groundtruth_pattern`` decides which pose3(_cov)_stamped_t channels
    count as groundtruth (default: init-pose and anything named like
    groundtruth); other pose channels (e.g. the estimator's own output in a
    full-session log) are ignored so a recorded mission replays its INPUTS,
    not its answers.
    """

    def __init__(
        self,
        path: str,
        groundtruth_pattern: str = r".*(groundtruth|init_pose).*",
        channel_pattern: str = ".*",
    ):
        super().__init__()
        self.path = path
        self._reader = LcmLogReader(path)
        self.skipped: Dict[str, int] = {}
        gt_rx = re.compile(groundtruth_pattern)
        ch_rx = re.compile(channel_pattern)

        for off, ev in self._reader.events(with_offsets=True):
            if not ch_rx.fullmatch(ev.channel):
                continue
            sd = lt.FINGERPRINT_REGISTRY.get(ev.data[:8])
            if sd is lt.STEREO_IMAGE_T:
                # Index only: header is at a fixed prefix of the payload but
                # decode_by_fingerprint is cheap enough for headers — decode
                # lazily at dispatch, read the timestamp now.
                _, values = lt.decode_by_fingerprint(ev.data)
                h = values["header"]
                self.stereo_data.append(
                    LogStereoItem(h["timestamp"], max(int(h["seq"]), 0), off, self._reader)
                )
                continue
            if sd is None:
                self.skipped[ev.channel] = self.skipped.get(ev.channel, 0) + 1
                continue
            _, values = lt.decode_by_fingerprint(ev.data)
            if sd is lt.IMU_MEASUREMENT_T:
                self.imu_data.append(
                    ImuMeasurement(
                        values["header"]["timestamp"],
                        angular_velocity=_vec(values["angular_vel"]),
                        linear_acceleration=_vec(values["linear_acc"]),
                    )
                )
            elif sd is lt.DEPTH_MEASUREMENT_T:
                self.depth_data.append(
                    DepthMeasurement(values["header"]["timestamp"], float(values["depth"]))
                )
            elif sd is lt.RANGE_MEASUREMENT_T:
                self.range_data.append(
                    RangeMeasurement(
                        values["header"]["timestamp"],
                        float(values["range"]),
                        _vec(values["point"]),
                        beacon_id=max(int(values["header"]["seq"]), 0),
                    )
                )
            elif sd in (lt.POSE3_STAMPED_T, lt.POSE3_COV_STAMPED_T):
                if gt_rx.fullmatch(ev.channel):
                    q = values["pose"]["orientation"]
                    t = values["pose"]["position"]
                    T = np.eye(4)
                    T[:3, :3] = _quat_to_matrix_np(q["w"], q["x"], q["y"], q["z"])
                    T[:3, 3] = [t["x"], t["y"], t["z"]]
                    self.pose_data.append(
                        GroundtruthPose(values["header"]["timestamp"], T)
                    )
            else:
                # Decodable but not a sensor input (meshes, mono viz frames,
                # mmf descriptors whose mapped file is gone post-session).
                self.skipped[ev.channel] = self.skipped.get(ev.channel, 0) + 1

        # Logs are receive-ordered; a multi-publisher session can interleave
        # slightly out of order. The player's merge assumes sorted streams.
        for lst in (
            self.stereo_data, self.imu_data, self.depth_data,
            self.range_data, self.pose_data,
        ):
            lst.sort(key=lambda m: m.timestamp)

    def shutdown(self) -> None:
        super().shutdown()
        self._reader.close()


def _vec(v: dict) -> np.ndarray:
    return np.array([v["x"], v["y"], v["z"]], np.float64)
