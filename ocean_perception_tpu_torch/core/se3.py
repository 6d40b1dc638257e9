"""SE(3)/SO(3) Lie-group operations on tensors (port of
``ocean_perception_tpu.core.se3``).

Reference parity: src/vehicle/core/transform_util.{hpp,cpp} — ``skew``,
``expmap_se3`` / ``logmap_se3`` (twist convention x = [t(3), w(3)]),
``inverse_se3``, ``GetGravityAxis``. Every function takes any leading batch
axes (the JAX functions are batched by ``jax.vmap``), runs on its inputs'
device and dtype, and is safe under ``torch.func.jacfwd``: the small-angle
branches are ``torch.where`` selections with the square roots and arc
cosines evaluated on guarded values, never data-dependent Python branches.

Transforms are 4x4 homogeneous matrices (row-major), matching the
reference's Matrix4d.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) vector -> (..., 3, 3) skew-symmetric matrix (transform_util.cpp skew)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def eye3(like: torch.Tensor) -> torch.Tensor:
    """The 3x3 identity in ``like``'s dtype and device."""
    return torch.eye(3, dtype=like.dtype, device=like.device)


# NOTE on AD safety: these helpers are differentiated through by the VIO
# smoother's forward-mode linearization, usually AT the identity (delta = 0).
# norm/arccos have NaN/inf derivatives at 0, so every small-angle branch is
# written in terms of theta^2 = sum(w^2) (smooth everywhere) and the sqrt is
# only evaluated on a where-guarded safe value.


def _sinc_sq(theta_sq: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with t = sqrt(theta_sq); AD-safe at 0."""
    small = theta_sq < 1e-10
    t = torch.sqrt(torch.where(small, 1.0, theta_sq))
    return torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(t) / t)


def _cosc_sq(theta_sq: torch.Tensor) -> torch.Tensor:
    """(1-cos(t))/t^2; AD-safe at 0."""
    small = theta_sq < 1e-10
    t_sq = torch.where(small, 1.0, theta_sq)
    t = torch.sqrt(t_sq)
    return torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(t)) / t_sq)


def _vc_sq(theta_sq: torch.Tensor) -> torch.Tensor:
    """(t - sin(t))/t^3; AD-safe at 0."""
    small = theta_sq < 1e-10
    t_sq = torch.where(small, 1.0, theta_sq)
    t = torch.sqrt(t_sq)
    return torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (t - torch.sin(t)) / (t_sq * t))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> rotation matrix (Rodrigues; fast_skewexp parity)."""
    theta_sq = torch.sum(w * w, dim=-1)
    S = skew(w)
    S2 = S @ S
    a = _sinc_sq(theta_sq)[..., None, None]
    b = _cosc_sq(theta_sq)[..., None, None]
    return eye3(w) + a * S + b * S2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector (skewcoords/logmap parity).

    AD-safe at the identity: the small-angle scale is a polynomial in
    u = 1 - cos(theta) (smooth), never touching arccos'(1).
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    u = 1.0 - cos_theta
    # Antisymmetric part gives axis*sin(theta).
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_sq = torch.clip(1.0 - cos_theta * cos_theta, 0.0, 1.0)
    small = sin_sq < 1e-12
    theta = torch.arccos(torch.where(small, 0.0, cos_theta))  # guarded arccos
    sin_theta = torch.sqrt(torch.where(small, 1.0, sin_sq))
    # Generic: w = theta/(2 sin) * v. Small angle: series in u = 1 - cos:
    # theta/(2 sin) = 1/2 + u/6 + u^2/15 + O(u^3).
    scale = torch.where(small, 0.5 + u / 6.0 + u * u / 15.0, theta / (2.0 * sin_theta))
    w_generic = scale[..., None] * v
    # Near pi the antisymmetric part vanishes: recover the axis from the diagonal.
    near_pi = cos_theta < -0.99
    theta_pi = torch.arccos(torch.clip(cos_theta, -1.0, -0.5))  # smooth in this branch
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clip((diag - cos_theta[..., None])
                         / torch.where(u < 1e-9, 1.0, u)[..., None], min=0.0)
    axis = torch.sqrt(axis_sq + 1e-12)
    # Fix axis signs using off-diagonal sums (R + R^T terms).
    sx = torch.sign(torch.where(torch.abs(v[..., 0]) > 1e-9, v[..., 0], 1.0))
    sy = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0.0, sx, -sx)
    sz = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0.0, sx, -sx)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    w_pi = theta_pi[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V matrix of SE(3) exp (transform_util.cpp expmap_se3 V term)."""
    theta_sq = torch.sum(w * w, dim=-1)
    S = skew(w)
    S2 = S @ S
    b = _cosc_sq(theta_sq)[..., None, None]
    c = _vc_sq(theta_sq)[..., None, None]
    return eye3(w) + b * S + c * S2


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation and (..., 3) translation -> (..., 4, 4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    zeros = torch.zeros(R.shape[:-2] + (1, 3), dtype=R.dtype, device=R.device)
    ones = torch.ones(R.shape[:-2] + (1, 1), dtype=R.dtype, device=R.device)
    return torch.cat([top, torch.cat([zeros, ones], dim=-1)], dim=-2)


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """Twist [t(3), w(3)] -> 4x4 transform (transform_util.cpp expmap_se3)."""
    t, w = x[..., :3], x[..., 3:6]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    return _homogeneous(R, (V @ t[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform -> twist [t(3), w(3)] (transform_util.cpp logmap_se3)."""
    w = so3_log(T[..., :3, :3])
    V = _so3_left_jacobian(w)
    t = torch.linalg.solve_ex(V, T[..., :3, 3:4])[0][..., 0]
    return torch.cat([t, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse (transform_util.cpp inverse_se3)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _homogeneous(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for 4x4 transforms."""
    return A @ B


def se3_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply transform to (..., 3) points."""
    return (T[..., :3, :3] @ points[..., None])[..., 0] + T[..., :3, 3]


def gravity_axis(n_gravity, dtype: torch.dtype = torch.float64,
                 device=None) -> tuple[int, torch.Tensor]:
    """Dominant gravity axis index and signed unit vector.

    Reference parity: transform_util.cpp GetGravityAxis — picks the axis with
    the largest |component| of the configured world gravity vector; the depth
    sensor measures along this axis. Static (config-time), computed with
    numpy on concrete values.
    """
    g = np.asarray(n_gravity, dtype=np.float64)
    axis = int(np.argmax(np.abs(g)))
    if abs(g[axis]) <= 0:
        raise ValueError(f"zero gravity vector: {g}")
    unit = np.zeros(3)
    unit[axis] = np.sign(g[axis])
    return axis, torch.as_tensor(unit, dtype=dtype, device=device)
