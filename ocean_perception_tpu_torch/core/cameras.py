"""Camera models (port of ``ocean_perception_tpu.core.cameras``).

Frozen dataclasses of float32-valued intrinsics. The JAX classes hold f32
arrays, so every value here is rounded to float32 when it is created and the
arithmetic on tensors is done in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    fx: float
    fy: float
    cx: float
    cy: float
    height: int = 0
    width: int = 0

    @classmethod
    def create(cls, fx, fy, cx, cy, height=0, width=0) -> "PinholeCamera":
        return cls(_f32(fx), _f32(fy), _f32(cx), _f32(cy), int(height), int(width))

    def rescale(self, scale: float) -> "PinholeCamera":
        """Scale intrinsics for a resized image (pinhole_camera.hpp Rescale)."""
        s = np.float32(scale)
        return PinholeCamera(
            _f32(np.float32(self.fx) * s),
            _f32(np.float32(self.fy) * s),
            _f32(np.float32(self.cx) * s),
            _f32(np.float32(self.cy) * s),
            int(round(self.height * scale)),
            int(round(self.width * scale)),
        )


@dataclasses.dataclass(frozen=True)
class StereoCamera:
    left: PinholeCamera
    right: PinholeCamera
    baseline: float  # meters between optical centers

    @classmethod
    def create(cls, left: PinholeCamera, right: PinholeCamera, baseline) -> "StereoCamera":
        return cls(left, right, _f32(baseline))

    @property
    def fx(self) -> float:
        return self.left.fx

    def disp_to_depth(self, disparity: torch.Tensor) -> torch.Tensor:
        """d [px] -> z [m]; invalid (d <= 0) maps to +inf (stereo_camera.hpp)."""
        fxb = np.float32(self.fx) * np.float32(self.baseline)
        positive = disparity > 0
        safe = torch.where(positive, disparity, 1.0)
        # Tensor / tensor: a Python scalar divided by a tensor becomes
        # reciprocal-then-multiply in torch, which rounds twice.
        depth = torch.full_like(safe, float(fxb)) / safe
        return torch.where(positive, depth, float("inf"))

    def rescale(self, scale: float) -> "StereoCamera":
        return StereoCamera(self.left.rescale(scale), self.right.rescale(scale), self.baseline)
