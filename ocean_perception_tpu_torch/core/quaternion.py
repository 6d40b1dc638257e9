"""Unit-quaternion utilities for the error-state EKF (port of
``ocean_perception_tpu.core.quaternion``).

Convention: ``q = [w, x, y, z]`` (scalar first), Hamilton product, world-frame
rotation ``p' = R(q) p``. The reference EKF (src/vehicle/vio/state_ekf.cpp)
uses Eigen quaternions with the same Hamilton convention; only the storage
order differs. Every function takes leading batch axes and runs on its
inputs' device and dtype.
"""

from __future__ import annotations

import torch


def quat_identity(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return torch.cat([torch.ones(1, dtype=dtype, device=device),
                      torch.zeros(3, dtype=dtype, device=device)])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion q: R(q) v."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion (exp map).

    Parity: state_ekf.cpp predict step ``q <- exp(dt*w) ⊗ q`` uses the same
    half-angle construction.
    """
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-8
    theta_safe = torch.where(small, 1.0, theta)
    s = torch.where(small, 0.5 - theta**2 / 48.0, torch.sin(half) / theta_safe)
    return torch.cat([torch.cos(half), s * w], dim=-1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (log map)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # shortest arc
    qv = q[..., 1:4]
    sin_half = torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    cos_half = q[..., 0:1]
    half = torch.arctan2(sin_half, cos_half)
    small = sin_half < 1e-8
    scale = torch.where(small, 2.0 / torch.clip(cos_half, min=1e-6),
                        2.0 * half / torch.where(small, 1.0, sin_half))
    return scale * qv


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion [w,x,y,z] (branch-free Shepperd).

    Computes all four candidate quaternions (one per dominant component) and
    selects the numerically best by gather, so it takes no branch on a value.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    sw = torch.sqrt(torch.clip(tw, min=1e-12)) * 0.5
    sx = torch.sqrt(torch.clip(tx, min=1e-12)) * 0.5
    sy = torch.sqrt(torch.clip(ty, min=1e-12)) * 0.5
    sz = torch.sqrt(torch.clip(tz, min=1e-12)) * 0.5

    qw = torch.stack([sw, (m21 - m12) / (4 * sw), (m02 - m20) / (4 * sw), (m10 - m01) / (4 * sw)], dim=-1)
    qx = torch.stack([(m21 - m12) / (4 * sx), sx, (m01 + m10) / (4 * sx), (m02 + m20) / (4 * sx)], dim=-1)
    qy = torch.stack([(m02 - m20) / (4 * sy), (m01 + m10) / (4 * sy), sy, (m12 + m21) / (4 * sy)], dim=-1)
    qz = torch.stack([(m10 - m01) / (4 * sz), (m02 + m20) / (4 * sz), (m12 + m21) / (4 * sz), sz], dim=-1)

    ts = torch.stack([tw, tx, ty, tz], dim=-1)
    best = torch.argmax(ts, dim=-1)
    qs = torch.stack([qw, qx, qy, qz], dim=-2)
    index = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(qs, -2, index)[..., 0, :]
    return quat_normalize(torch.where(q[..., 0:1] < 0, -q, q))
