"""Standalone measurement factors and initialization helpers (port of
``ocean_perception_tpu.vio.factors``).

Reference parity:
- MagPoseFactor (vio/mag_pose_factor.hpp:17-84): residual between the
  measured body-frame magnetic field and the world field rotated into the
  body: r = (R_world_body^T · (scale·local_field) + bias) - measured.
- SingleAxisFactor (vio/single_axis_factor.hpp:11-45): translation prior on
  one axis (the depth factor inside the smoother).
- EstimateAttitude (vio/state_estimator_util.hpp:28-40 +
  attitude_measurement.hpp): roll/pitch from the accelerometer at rest —
  find world_R_body aligning the measured specific force with -gravity.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.se3 import so3_exp


def mag_residual(
    R_world_body: torch.Tensor,   # (3,3)
    measured_field: torch.Tensor,  # (3,) sensor frame (== body by default)
    local_field: torch.Tensor,     # (3,) world-frame unit field direction
    scale: float = 1.0,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    pred = R_world_body.T @ (scale * local_field)
    if bias is not None:
        pred = pred + bias
    return pred - measured_field


def single_axis_residual(p: torch.Tensor, axis_unit: torch.Tensor,
                         measured: torch.Tensor) -> torch.Tensor:
    return torch.dot(axis_unit, p) - measured


def estimate_attitude(accel_body: torch.Tensor, n_gravity: torch.Tensor) -> torch.Tensor:
    """world_R_body from a specific-force measurement at rest.

    At rest the accelerometer reads f = -R^T g (specific force opposing
    gravity); find the smallest rotation mapping the measured direction onto
    -g's direction. Yaw is unobservable and left at zero about the gravity
    axis (EstimateAttitude parity).
    """
    f = accel_body / torch.clamp(torch.linalg.vector_norm(accel_body), min=1e-9)
    g_unit = n_gravity / torch.clamp(torch.linalg.vector_norm(n_gravity), min=1e-9)
    target = -g_unit  # world direction that body-frame f should map to
    # Rotation taking f (in body) to target (in world): axis = f x target.
    axis = torch.linalg.cross(f, target)
    s = torch.linalg.vector_norm(axis)
    c = torch.dot(f, target)
    angle = torch.arctan2(s, c)
    x_axis = torch.eye(3, dtype=f.dtype, device=f.device)[0]
    axis = torch.where(s > 1e-9, axis / torch.clamp(s, min=1e-9), x_axis)
    return so3_exp(axis * angle)
