"""EuRoC-MAV folder-layout dataset reader/writer.

Reference parity: dataset/euroc_dataset.{hpp,cpp} and euroc_data_writer.
Layout under <toplevel>/mav0/:
  cam0/data.csv + cam0/data/<ts>.png   (timestamp [ns], filename)
  cam1/...                              (right camera)
  imu0/data.csv                         (ts, wx, wy, wz, ax, ay, az)
  imu0_poses.txt                        (ts, qw, qx, qy, qz, tx, ty, tz)
  depth0/data.csv                       (ts, depth)
  aps0/data.csv, aps1/data.csv          (ts, range, bx, by, bz)
Covers the Unity "FarmSim" exports and ZED recordings the reference uses.

A copy of ``ocean_perception_tpu.datasets.euroc``; its quaternions go
through the port's ``core/quaternion.py`` in float64 on the CPU.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np
import torch

from ..core.measurements import (
    DepthMeasurement,
    GroundtruthPose,
    ImuMeasurement,
    RangeMeasurement,
)
from ..core.quaternion import quat_normalize, quat_to_matrix
from .base import DataProvider, StereoDatasetItem


def _read_csv_rows(path: str) -> List[List[str]]:
    """All data rows: '#'-comment lines and non-numeric headers skipped."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    if rows:
        try:
            int(rows[0][0])
        except ValueError:
            rows = rows[1:]  # plain (uncommented) header line
    return rows


class EurocDataset(DataProvider):
    def __init__(self, toplevel_path: str):
        super().__init__()
        mav0 = os.path.join(toplevel_path, "mav0")
        if not os.path.isdir(mav0):
            raise FileNotFoundError(f"no mav0/ under {toplevel_path}")

        self._parse_stereo(os.path.join(mav0, "cam0"), os.path.join(mav0, "cam1"))

        imu_csv = os.path.join(mav0, "imu0", "data.csv")
        if os.path.exists(imu_csv):
            self._parse_imu(imu_csv)

        pose_txt = os.path.join(mav0, "imu0_poses.txt")
        if os.path.exists(pose_txt):
            self._parse_groundtruth(pose_txt)

        depth_csv = os.path.join(mav0, "depth0", "data.csv")
        if os.path.exists(depth_csv):
            self._parse_depth(depth_csv)

        range_data: List[RangeMeasurement] = []
        for i, aps in enumerate(("aps0", "aps1")):
            p = os.path.join(mav0, aps, "data.csv")
            if os.path.exists(p):
                range_data.extend(self._parse_range(p, beacon_id=i))
        self.range_data = sorted(range_data, key=lambda m: m.timestamp)

        self.sanity_check()

    def _parse_stereo(self, cam0: str, cam1: str) -> None:
        def folder(cam_path):
            out = []
            for row in _read_csv_rows(os.path.join(cam_path, "data.csv")):
                ts = int(row[0])
                out.append((ts, os.path.join(cam_path, "data", f"{ts}.png")))
            return out

        left = folder(cam0)
        right = folder(cam1)
        n = min(len(left), len(right))
        self.stereo_data = [
            StereoDatasetItem(left[i][0], left[i][1], right[i][1]) for i in range(n)
        ]

    def _parse_imu(self, path: str) -> None:
        prev = 0
        for row in _read_csv_rows(path):
            ts = int(row[0])
            assert ts > prev, "Euroc IMU data is not in chronological order!"
            prev = ts
            vals = [float(v) for v in row[1:7]]
            self.imu_data.append(
                ImuMeasurement(ts, np.asarray(vals[0:3]), np.asarray(vals[3:6]))
            )

    def _parse_groundtruth(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                if line.lstrip().startswith("#"):
                    continue
                parts = [p for p in line.strip().split(",") if p != ""]
                if len(parts) < 8:
                    continue
                ts = int(parts[0])
                qw, qx, qy, qz, tx, ty, tz = (float(v) for v in parts[1:8])
                q = quat_normalize(torch.tensor([qw, qx, qy, qz], dtype=torch.float64))
                T = np.eye(4)
                T[:3, :3] = quat_to_matrix(q).numpy()
                T[:3, 3] = [tx, ty, tz]
                self.pose_data.append(GroundtruthPose(ts, T))

    def _parse_depth(self, path: str) -> None:
        prev = 0
        for row in _read_csv_rows(path):
            ts = int(row[0])
            assert ts > prev, "EuRoC depth data is not in chronological order!"
            prev = ts
            self.depth_data.append(DepthMeasurement(ts, float(row[1])))

    def _parse_range(self, path: str, beacon_id: int) -> List[RangeMeasurement]:
        out = []
        for row in _read_csv_rows(path):
            ts = int(row[0])
            out.append(
                RangeMeasurement(
                    ts,
                    float(row[1]),
                    np.asarray([float(row[2]), float(row[3]), float(row[4])]),
                    beacon_id=beacon_id,
                )
            )
        return out


class EurocDataWriter:
    """Writes the same layout (reference euroc_data_writer.{hpp,cpp}; used by
    the zed_recorder tool to persist live captures)."""

    def __init__(self, folder: str):
        self.root = os.path.join(folder, "mav0")
        for sub in ("cam0/data", "cam1/data", "imu0", "depth0", "aps0"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)
        self._imu_rows: List[List] = []
        self._depth_rows: List[List] = []
        self._range_rows: List[List] = []
        self._pose_rows: List[List] = []
        self._cam_rows = {0: [], 1: []}

    def write_stereo(self, timestamp: int, left: np.ndarray, right: np.ndarray) -> None:
        from ..utils.image_io import save_image

        for cam, img in ((0, left), (1, right)):
            path = os.path.join(self.root, f"cam{cam}", "data", f"{timestamp}.png")
            save_image(path, img)
            self._cam_rows[cam].append([timestamp, f"{timestamp}.png"])

    def write_imu(self, m: ImuMeasurement) -> None:
        self._imu_rows.append(
            [m.timestamp, *m.angular_velocity.tolist(), *m.linear_acceleration.tolist()]
        )

    def write_depth(self, m: DepthMeasurement) -> None:
        self._depth_rows.append([m.timestamp, m.depth])

    def write_range(self, m: RangeMeasurement) -> None:
        self._range_rows.append([m.timestamp, m.range, *np.asarray(m.point).tolist()])

    def write_groundtruth(self, m: GroundtruthPose) -> None:
        """Append a groundtruth pose (imu0_poses.txt, the file
        `_parse_groundtruth` reads back: ts, qw, qx, qy, qz, tx, ty, tz)."""
        from ..core.quaternion import matrix_to_quat

        T = np.asarray(m.world_T_body, np.float64)
        q = matrix_to_quat(torch.as_tensor(T[:3, :3])).numpy()
        self._pose_rows.append([m.timestamp, *q.tolist(), *T[:3, 3].tolist()])

    def finish(self) -> None:
        def dump(path, header, rows):
            with open(os.path.join(self.root, path), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(header)
                w.writerows(rows)

        dump("cam0/data.csv", ["#timestamp [ns]", "filename"], self._cam_rows[0])
        dump("cam1/data.csv", ["#timestamp [ns]", "filename"], self._cam_rows[1])
        dump(
            "imu0/data.csv",
            ["#timestamp [ns]", "w_x", "w_y", "w_z", "a_x", "a_y", "a_z"],
            self._imu_rows,
        )
        dump("depth0/data.csv", ["#timestamp [ns]", "depth [m]"], self._depth_rows)
        dump(
            "aps0/data.csv",
            ["#timestamp [ns]", "range [m]", "b_x", "b_y", "b_z"],
            self._range_rows,
        )
        if self._pose_rows:
            dump(
                "imu0_poses.txt",
                ["#timestamp [ns]", "qw", "qx", "qy", "qz", "tx", "ty", "tz"],
                self._pose_rows,
            )
