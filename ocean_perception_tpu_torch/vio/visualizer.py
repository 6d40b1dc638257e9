"""Offline 3D visualization: trajectory/landmark/mesh export + ellipsoids.

Reference parity: vio/visualizer_3d (cv::viz interactive window) and
vio/ellipsoid.hpp (covariance ellipsoid point clouds). Headless hosts
have no GL, so the equivalent is artifact export: PLY point clouds / meshes
and covariance ellipsoid vertices, viewable in any mesh tool, plus a simple
top-down trajectory PNG.

A copy of ``ocean_perception_tpu.vio.visualizer`` (numpy; ``cv2`` only for
the top-down PNG, imported where it is drawn).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np


def covariance_ellipsoid_points(
    cov3: np.ndarray, center: np.ndarray, n_sigma: float = 2.0, n_points: int = 64
) -> np.ndarray:
    """Points on the n-sigma ellipsoid of a 3x3 covariance (ellipsoid.hpp).

    Eigendecomposition scales a precomputed unit sphere (Fibonacci sampling).
    """
    evals, evecs = np.linalg.eigh(np.asarray(cov3))
    evals = np.clip(evals, 1e-12, None)
    # Fibonacci sphere.
    i = np.arange(n_points, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / n_points)
    theta = np.pi * (1 + 5**0.5) * i
    sphere = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1
    )
    radii = n_sigma * np.sqrt(evals)
    return center + (sphere * radii) @ evecs.T


def write_ply(
    path: str,
    points: np.ndarray,
    triangles: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
) -> None:
    """Minimal ASCII PLY writer (points or mesh)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if triangles is not None:
            f.write(f"element face {len(triangles)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i,0]} {points[i,1]} {points[i,2]}"
            if colors is not None:
                c = np.asarray(colors[i]).astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        if triangles is not None:
            for t in np.asarray(triangles, int):
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


class TrajectoryVisualizer:
    """Accumulates poses/landmarks/meshes; dumps PLY artifacts + a top-down
    PNG. The offline stand-in for the reference's live Visualizer3D."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.positions: List[np.ndarray] = []
        self.covariances: List[Optional[np.ndarray]] = []
        self.landmarks: List[np.ndarray] = []

    def add_pose(self, world_T_body: np.ndarray, cov3: Optional[np.ndarray] = None) -> None:
        self.positions.append(np.asarray(world_T_body)[:3, 3].copy())
        self.covariances.append(None if cov3 is None else np.asarray(cov3).copy())

    def add_landmarks(self, points: np.ndarray) -> None:
        self.landmarks.append(np.asarray(points).copy())

    def save(self, prefix: str = "vio") -> List[str]:
        written = []
        if self.positions:
            traj = np.stack(self.positions)
            p = os.path.join(self.out_dir, f"{prefix}_trajectory.ply")
            write_ply(p, traj)
            written.append(p)
            # Covariance ellipsoids (subsampled).
            ell = [
                covariance_ellipsoid_points(c, pos)
                for pos, c in zip(self.positions[::5], self.covariances[::5])
                if c is not None
            ]
            if ell:
                p = os.path.join(self.out_dir, f"{prefix}_covariance.ply")
                write_ply(p, np.concatenate(ell))
                written.append(p)
            written.append(self._topdown_png(traj, prefix))
        if self.landmarks:
            p = os.path.join(self.out_dir, f"{prefix}_landmarks.ply")
            write_ply(p, np.concatenate(self.landmarks))
            written.append(p)
        return written

    def _topdown_png(self, traj: np.ndarray, prefix: str) -> str:
        import cv2

        size = 512
        img = np.full((size, size, 3), 255, np.uint8)
        xy = traj[:, :2]
        lo = xy.min(axis=0) - 0.5
        hi = xy.max(axis=0) + 0.5
        scale = (size - 40) / max(float((hi - lo).max()), 1e-6)
        px = ((xy - lo) * scale + 20).astype(int)
        for a, b in zip(px[:-1], px[1:]):
            cv2.line(img, tuple(a), tuple(b), (180, 60, 20), 2, cv2.LINE_AA)
        if len(px):
            cv2.circle(img, tuple(px[0]), 5, (0, 160, 0), -1)
            cv2.circle(img, tuple(px[-1]), 5, (0, 0, 200), -1)
        path = os.path.join(self.out_dir, f"{prefix}_topdown.png")
        cv2.imwrite(path, img)
        return path
