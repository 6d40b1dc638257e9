"""LM odometry: optimize relative pose T_10 from 3D(frame0)↔2D(frame1) points
(port of ``ocean_perception_tpu.vio.odometry``).

Reference parity: vio/optimize_odometry.cpp —
- residual r_i = |p_obs - project(T_10 · P0)| / sigma with Cauchy weight
  w = 1/(1+r²) applied to residual and Jacobian rows;
- analytic 6-DoF Jacobian in the left-multiplicative convention
  T <- expmap_se3(eps) · T (Blanco SE(3) tech report p.54 form);
- LM with Marquardt diag damping, lambda0 = 8e-2, x2 / ÷3 schedule;
- covariance C = H^{-1};
- two-stage OptimizeOdometryIterative: solve, drop outliers with residual
  > max_err_stdevs·sigma, refine; < 6 inliers -> failure with identity pose.

Fixed-size point arrays with validity masks; outlier removal reweights the
mask. Each LM run takes exactly ``max_iters`` steps, as the JAX
``fori_loop`` does: a step that does not lower the error is rejected by a
``torch.where``, so nothing is read back to the host (a data-dependent early
exit would be a sync a step). The covariance's inverse is
``torch.linalg.inv_ex`` for the same reason. On the card the two runs
(about 10,000 small kernels) replay from a CUDA graph, one per rig and
params (``ops/graphs.py``), as the JAX function is jitted.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from ..core.cameras import StereoCamera
from ..core.se3 import se3_exp
from ..ops.graphs import GraphedStep


@dataclasses.dataclass(frozen=True)
class OdometryParams:
    max_iters: int = 20
    lambda0: float = 8e-2
    lambda_up: float = 2.0
    lambda_down: float = 3.0
    max_error_stdevs: float = 3.0
    min_inliers: int = 6


class OdometryResult(NamedTuple):
    T_10: torch.Tensor        # (4,4) pose of frame0 in frame1
    covariance: torch.Tensor  # (6,6)
    error: torch.Tensor       # mean residual (sigmas)
    n_inliers: torch.Tensor   # int32
    success: torch.Tensor     # bool


def _linearize(P0, p_obs, sigma, mask, fx, fy, cx, cy, T):
    """Residuals/Jacobian for all points; masked rows are zero.

    2-D pixel residuals per point (2N rows) with a Cauchy weight on the
    residual norm: the standard BA Jacobian, well-conditioned in float32
    where the reference's scalar-norm form has a spurious null space
    (see the JAX module).
    """
    P1 = (T[:3, :3] @ P0.T).T + T[:3, 3]
    gz = torch.clamp(P1[:, 2], min=1e-5)
    u = fx * P1[:, 0] / gz + cx
    v = fy * P1[:, 1] / gz + cy
    rx = p_obs[:, 0] - u
    ry = p_obs[:, 1] - v
    r = torch.sqrt(rx * rx + ry * ry)
    r_sigma = r / sigma
    w = torch.sqrt(1.0 / (1.0 + r_sigma * r_sigma)) * mask  # sqrt: applied to rows of a 2-norm
    scale = w / sigma

    gx, gy = P1[:, 0], P1[:, 1]
    gz2 = gz * gz
    zeros = torch.zeros_like(gz)
    # d(u)/d(eps) for the left-multiplicative update T <- exp(eps)·T.
    Ju = torch.stack(
        [fx / gz, zeros, -fx * gx / gz2,
         -fx * gx * gy / gz2, fx * (1.0 + gx * gx / gz2), -fx * gy / gz],
        dim=-1,
    )
    Jv = torch.stack(
        [zeros, fy / gz, -fy * gy / gz2,
         -fy * (1.0 + gy * gy / gz2), fy * gx * gy / gz2, fy * gx / gz],
        dim=-1,
    )
    # Residual rows = scale·(obs - proj); J = d(residual)/d(eps) = -scale·Jproj.
    J = torch.cat([-scale[:, None] * Ju, -scale[:, None] * Jv], dim=0)
    R = torch.cat([scale * rx, scale * ry])
    n = torch.clamp(torch.sum(mask), min=1.0)
    err = torch.sum(r_sigma * mask) / n
    return J, R, err, r_sigma


def _error(P0, p_obs, sigma, mask, fx, fy, cx, cy, T):
    """``_linearize``'s mean error alone, by the same operations."""
    P1 = (T[:3, :3] @ P0.T).T + T[:3, 3]
    gz = torch.clamp(P1[:, 2], min=1e-5)
    rx = p_obs[:, 0] - (fx * P1[:, 0] / gz + cx)
    ry = p_obs[:, 1] - (fy * P1[:, 1] / gz + cy)
    r_sigma = torch.sqrt(rx * rx + ry * ry) / sigma
    return torch.sum(r_sigma * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _lm(P0, p_obs, sigma, mask, rig: StereoCamera, T0, p: OdometryParams):
    fx, fy = rig.left.fx, rig.left.fy
    cx, cy = rig.left.cx, rig.left.cy
    dtype, dev = T0.dtype, T0.device

    def lin(T):
        return _linearize(P0, p_obs, sigma, mask, fx, fy, cx, cy, T)

    err = _error(P0, p_obs, sigma, mask, fx, fy, cx, cy, T0)
    T = T0
    lam = torch.full((), p.lambda0, dtype=dtype, device=dev)
    zeros6 = torch.zeros(6, dtype=dtype, device=dev)
    for _ in range(p.max_iters):
        J, R, _, _ = lin(T)
        # Augmented least squares solved by QR instead of normal equations
        # (cond(J), not cond(JᵀJ)); Marquardt damping rows
        # sqrt(λ)·sqrt(diag(JᵀJ)) appended as pseudo-measurements.
        diag_H = torch.sum(J * J, dim=0)
        damp = torch.sqrt(lam * torch.clamp(diag_H, min=1e-12))
        A = torch.cat([J, torch.diag(damp)], dim=0)
        b = torch.cat([-R, zeros6])
        q, r_mat = torch.linalg.qr(A)
        eps = torch.linalg.solve_triangular(r_mat, (q.T @ b)[:, None], upper=True)[:, 0]
        eps = torch.where(torch.all(torch.isfinite(eps)), eps, zeros6)
        T_test = se3_exp(eps) @ T
        err_new = _error(P0, p_obs, sigma, mask, fx, fy, cx, cy, T_test)
        better = err_new < err
        T = torch.where(better, T_test, T)
        lam = torch.where(better, lam / p.lambda_down, lam * p.lambda_up)
        err = torch.where(better, err_new, err)
    J, R, err, r_sigma = lin(T)
    H = J.T @ J
    cov = torch.linalg.inv_ex(H + 1e-9 * torch.eye(6, dtype=dtype, device=dev))[0]
    return T, cov, err, r_sigma


def optimize_odometry(
    P0: torch.Tensor,       # (N, 3) landmarks in frame-0 camera coordinates
    p_obs: torch.Tensor,    # (N, 2) observed pixels in frame 1
    sigmas: torch.Tensor,   # (N,) pixel noise
    mask: torch.Tensor,     # (N,) valid correspondences
    rig: StereoCamera,
    T_init: Optional[torch.Tensor] = None,
    params: OdometryParams = OdometryParams(),
) -> OdometryResult:
    """Two-stage robust pose solve (OptimizeOdometryIterative parity); on
    the card replayed from a CUDA graph."""
    T0 = torch.eye(4, dtype=P0.dtype, device=P0.device) if T_init is None else T_init
    if P0.is_cuda:
        return _graphed(rig, params)(P0, p_obs, sigmas, mask, T0)
    return _optimize(P0, p_obs, sigmas, mask, T0, rig, params)


@functools.lru_cache(maxsize=16)
def _graphed(rig: StereoCamera, params: OdometryParams) -> GraphedStep:
    return GraphedStep(lambda P0, p_obs, sigmas, mask, T0: _optimize(
        P0, p_obs, sigmas, mask, T0, rig, params))


def _optimize(P0, p_obs, sigmas, mask, T0, rig: StereoCamera,
              params: OdometryParams) -> OdometryResult:
    dtype, dev = P0.dtype, P0.device
    eye = torch.eye(4, dtype=dtype, device=dev)
    maskf = mask.to(dtype)

    T1, _, _, r_sigma = _lm(P0, p_obs, sigmas, maskf, rig, T0, params)
    # Outlier rejection: residual beyond max_err_stdevs sigmas.
    inlier = maskf * (r_sigma <= params.max_error_stdevs).to(dtype)
    T2, cov2, err2, _ = _lm(P0, p_obs, sigmas, inlier, rig, T1, params)

    n_inliers = torch.sum(inlier).to(torch.int32)
    success = n_inliers >= params.min_inliers
    T_final = torch.where(success, T2, eye)
    cov_final = torch.where(success, cov2, torch.eye(6, dtype=dtype, device=dev) * 1e9)
    return OdometryResult(
        T_10=T_final, covariance=cov_final, error=err2, n_inliers=n_inliers, success=success
    )
