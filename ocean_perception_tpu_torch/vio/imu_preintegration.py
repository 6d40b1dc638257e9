"""On-manifold IMU preintegration (Forster et al. RSS'15), port of
``ocean_perception_tpu.vio.imu_preintegration``.

Replaces GTSAM ``PreintegratedCombinedMeasurements`` used by the reference's
ImuManager/FixedLagSmoother (imu_manager.cpp:57-135). Accumulates
bias-corrected relative rotation/velocity/position deltas between keyposes,
their 9x9 covariance, and first-order bias Jacobians over a fixed-size
(..., N, 7) sample window [dt, w(3), a(3)] with a validity mask.

The JAX function scans one window and the smoother vmaps it over the slots;
here the leading axes are the batch (the smoother's slots) and the scan is a
loop over the samples. Whatever depends on a sample alone (its rotation
increment, right Jacobian and accelerometer skew) is computed for every
sample at once before the loop. A masked sample leaves the carry as it is,
so the loop may stop after the last valid sample (``n_steps``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.se3 import eye3, skew, so3_exp, so3_log

_EYE9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class ImuCalibration:
    """Noise densities (continuous-time) — config/shared yaml noise_model.

    body_R_imu / body_t_imu: the /shared/imu0/body_T_imu sensor extrinsic
    (state_estimator.cpp:49; GTSAM pim_params.setBodyPSensor at
    imu_manager.cpp:47). Raw samples are transformed into the body frame
    before integration: gyro rotated, accel rotated minus the centrifugal
    lever-arm term w x (w x arm). Biases are estimated in the BODY frame."""

    accel_noise_sigma: float = 0.001
    gyro_noise_sigma: float = 0.0004
    accel_bias_rw_sigma: float = 0.0001
    gyro_bias_rw_sigma: float = 0.00004
    body_R_imu: tuple = _EYE9
    body_t_imu: tuple = (0.0, 0.0, 0.0)

    def replace(self, **changes) -> "ImuCalibration":
        return dataclasses.replace(self, **changes)


class PreintegratedImu(NamedTuple):
    dR: torch.Tensor        # (..., 3, 3) integrated rotation
    dv: torch.Tensor        # (..., 3)
    dp: torch.Tensor        # (..., 3)
    dt: torch.Tensor        # (...,) total time
    cov: torch.Tensor       # (..., 9, 9) preintegration covariance [theta, v, p]
    dR_dbg: torch.Tensor    # (..., 3, 3) d(theta)/d(gyro bias)
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    bias_gyro: torch.Tensor  # (..., 3) bias used during integration
    bias_accel: torch.Tensor
    n_samples: torch.Tensor  # (...,) int32


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, shape: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A constant of a config on the device, copied there once (a copy in a
    step would be a host sync, and cannot be captured in a CUDA graph)."""
    return torch.tensor(values, dtype=dtype).reshape(shape).to(device)


def _block3(rows) -> torch.Tensor:
    """A (..., 9, 9) matrix from a 3x3 grid of (..., 3, 3) blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def preintegrate(
    samples: torch.Tensor,     # (..., N, 7): [dt, wx, wy, wz, ax, ay, az]
    mask: torch.Tensor,        # (..., N) valid samples
    bias_gyro: torch.Tensor,   # (..., 3)
    bias_accel: torch.Tensor,  # (..., 3)
    calib: ImuCalibration = ImuCalibration(),
    n_steps: Optional[int] = None,
) -> PreintegratedImu:
    """Preintegrate each window of the batch at its bias. ``n_steps``, where
    given, is a bound the caller knows: no window has a valid sample at or
    after it, so the loop stops there (the steps after it are no-ops)."""
    dtype, dev = samples.dtype, samples.device
    batch = samples.shape[:-2]
    N = samples.shape[-2]
    eye = eye3(samples)
    sig_g2 = calib.gyro_noise_sigma**2
    sig_a2 = calib.accel_noise_sigma**2

    # Sensor-to-body correction (static check: free for identity rigs).
    if tuple(calib.body_R_imu) != _EYE9 or tuple(calib.body_t_imu) != (0.0, 0.0, 0.0):
        R_bi = device_const(tuple(calib.body_R_imu), (3, 3), dtype, dev)
        arm = device_const(tuple(calib.body_t_imu), (3,), dtype, dev)
        w_b = samples[..., 1:4] @ R_bi.T
        a_b = samples[..., 4:7] @ R_bi.T - torch.linalg.cross(
            w_b, torch.linalg.cross(w_b, arm.expand_as(w_b)))
        samples = torch.cat([samples[..., :1], w_b, a_b], dim=-1)

    # Per-sample terms, all samples at once: (..., N, ...).
    maskf = mask.to(dtype)
    dts = samples[..., 0] * maskf
    w = samples[..., 1:4] - bias_gyro[..., None, :]
    a = samples[..., 4:7] - bias_accel[..., None, :]
    phi = w * dts[..., None]
    dRks = so3_exp(phi)
    dRks_T = dRks.transpose(-1, -2)
    Jr_dt = _right_jacobian(phi) * dts[..., None, None]
    a_skews = skew(a)
    q_g = eye * (sig_g2 / torch.clamp(dts, min=1e-9))[..., None, None]
    q_a = eye * (sig_a2 / torch.clamp(dts, min=1e-9))[..., None, None]
    live_all = mask

    dR = eye.expand(batch + (3, 3))
    dv = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    dp = torch.zeros(batch + (3,), dtype=dtype, device=dev)
    T = torch.zeros(batch, dtype=dtype, device=dev)
    cov = torch.zeros(batch + (9, 9), dtype=dtype, device=dev)
    zero3 = torch.zeros(batch + (3, 3), dtype=dtype, device=dev)
    dR_dbg = dv_dbg = dv_dba = dp_dbg = dp_dba = zero3
    eyeb = eye.expand(batch + (3, 3))

    steps = N if n_steps is None else min(int(n_steps), N)
    for k in range(steps):
        dt = dts[..., k]
        dt3 = dt[..., None, None]
        dRk = dRks[..., k, :, :]
        a_k = a[..., k, :]
        a_skew = a_skews[..., k, :, :]
        dR_askew = dR @ a_skew

        # Covariance propagation (A state transition on [dtheta, dv, dp]).
        A = _block3([
            [dRks_T[..., k, :, :], zero3, zero3],
            [-dR_askew * dt3, eyeb, zero3],
            [(-0.5 * dR_askew) * dt3 * dt3, eyeb * dt3, eyeb],
        ])
        # Noise: gyro into dtheta, accel into dv/dp (discretized).
        B = _block3([
            [eyeb * dt3, zero3, zero3],
            [zero3, dR * dt3, zero3],
            [zero3, 0.5 * dR * dt3 * dt3, zero3],
        ])
        Q = _block3([
            [q_g[..., k, :, :], zero3, zero3],
            [zero3, q_a[..., k, :, :], zero3],
            [zero3, zero3, zero3],
        ])
        cov_new = A @ cov @ A.transpose(-1, -2) + B @ Q @ B.transpose(-1, -2)

        # Bias Jacobians (first order).
        askew_dbg = dR_askew @ dR_dbg
        dp_dbg_new = dp_dbg + dv_dbg * dt3 - (0.5 * askew_dbg) * dt3 * dt3
        dp_dba_new = dp_dba + dv_dba * dt3 - 0.5 * dR * dt3 * dt3
        dv_dbg_new = dv_dbg - askew_dbg * dt3
        dv_dba_new = dv_dba - dR * dt3
        dR_dbg_new = dRks_T[..., k, :, :] @ dR_dbg - Jr_dt[..., k, :, :]

        dRa = (dR @ a_k[..., None])[..., 0]
        dt1 = dt[..., None]
        dp_new = dp + dv * dt1 + 0.5 * dRa * dt1 * dt1
        dv_new = dv + dRa * dt1
        dR_new = dR @ dRk

        live = live_all[..., k]
        l1, l2 = live[..., None], live[..., None, None]
        dR = torch.where(l2, dR_new, dR)
        dv = torch.where(l1, dv_new, dv)
        dp = torch.where(l1, dp_new, dp)
        T = torch.where(live, T + dt, T)
        cov = torch.where(l2, cov_new, cov)
        dR_dbg = torch.where(l2, dR_dbg_new, dR_dbg)
        dv_dbg = torch.where(l2, dv_dbg_new, dv_dbg)
        dv_dba = torch.where(l2, dv_dba_new, dv_dba)
        dp_dbg = torch.where(l2, dp_dbg_new, dp_dbg)
        dp_dba = torch.where(l2, dp_dba_new, dp_dba)

    return PreintegratedImu(
        dR=dR, dv=dv, dp=dp, dt=T, cov=cov,
        dR_dbg=dR_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba, dp_dbg=dp_dbg, dp_dba=dp_dba,
        bias_gyro=bias_gyro, bias_accel=bias_accel,
        n_samples=mask.to(torch.int32).sum(dim=-1, dtype=torch.int32),
    )


def _right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian Jr(phi); AD-safe at 0 (theta^2-based branches)."""
    theta_sq = torch.sum(phi * phi, dim=-1)[..., None, None]
    S = skew(phi)
    small = theta_sq < 1e-12
    t_sq = torch.where(small, 1.0, theta_sq)
    t = torch.sqrt(t_sq)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(t)) / t_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (t - torch.sin(t)) / (t_sq * t))
    return eye3(phi) - a * S + b * (S @ S)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product."""
    return (A @ x[..., None])[..., 0]


def bias_corrected_deltas(
    pim: PreintegratedImu, bias_gyro: torch.Tensor, bias_accel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order bias update of the deltas (GTSAM biasCorrectedDeltas)."""
    dbg = bias_gyro - pim.bias_gyro
    dba = bias_accel - pim.bias_accel
    dR = pim.dR @ so3_exp(_mv(pim.dR_dbg, dbg))
    dv = pim.dv + _mv(pim.dv_dbg, dbg) + _mv(pim.dv_dba, dba)
    dp = pim.dp + _mv(pim.dp_dbg, dbg) + _mv(pim.dp_dba, dba)
    return dR, dv, dp


def predict_state(
    R_i: torch.Tensor,
    p_i: torch.Tensor,
    v_i: torch.Tensor,
    pim: PreintegratedImu,
    gravity: torch.Tensor,
    bias_gyro: Optional[torch.Tensor] = None,
    bias_accel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Propagate (R, p, v) through the preintegrated window."""
    bg = pim.bias_gyro if bias_gyro is None else bias_gyro
    ba = pim.bias_accel if bias_accel is None else bias_accel
    dR, dv, dp = bias_corrected_deltas(pim, bg, ba)
    dt = pim.dt[..., None]
    R_j = R_i @ dR
    v_j = v_i + gravity * dt + _mv(R_i, dv)
    p_j = p_i + v_i * dt + 0.5 * gravity * dt * dt + _mv(R_i, dp)
    return R_j, p_j, v_j


def imu_factor_residual(
    R_i, p_i, v_i, R_j, p_j, v_j, bias_gyro, bias_accel, pim: PreintegratedImu, gravity
) -> torch.Tensor:
    """(..., 9) preintegration residual [r_theta, r_v, r_p] (Forster eq. 37)."""
    dR, dv, dp = bias_corrected_deltas(pim, bias_gyro, bias_accel)
    dt = pim.dt[..., None]
    Rt = R_i.transpose(-1, -2)
    r_R = so3_log(dR.transpose(-1, -2) @ (Rt @ R_j))
    r_v = _mv(Rt, v_j - v_i - gravity * dt) - dv
    r_p = _mv(Rt, p_j - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p], dim=-1)
