"""Fixed-lag smoother: windowed factor-graph optimization over keyposes
(port of ``ocean_perception_tpu.vio.smoother``).

Reference parity: vio/fixed_lag_smoother.{hpp,cpp} — the reference builds a
GTSAM IncrementalFixedLagSmoother (ISAM2, ~10 s lag) with factors per keypose
(fixed_lag_smoother.cpp:232-468):
  - VO BetweenFactor with Cauchy-robust noise,
  - CombinedImuFactor + bias random-walk Between,
  - depth prior on the gravity-axis translation (SingleAxisFactor),
  - range factors to beacons,
  - a no-motion fallback prior when neither VO nor IMU is available.

As in the JAX package, a fixed-size window of M keyposes is re-solved by
batch Gauss-Newton each update. States are lifted to local coordinates
around the current estimate each iteration ("boxplus" retraction, rotvec for
rotation); residuals are whitened, and the Jacobian is
``torch.func.jacfwd`` of the purely functional ``_residuals`` (the JAX
module's ``jax.jacfwd``). Each damped step is a QR of the stacked system
(cond(J), not cond(JᵀJ), so float32 works too). Sliding the window anchors
the new oldest keypose with its marginal covariance from the previous solve.

The window's dtype is the caller's choice (``make_window``); nothing here
reads a value back to the host except ``slide_window``'s ``eigh``, which
checks its result (one sync a slide). The masked-row substitutions that keep
``jacfwd`` finite (inf·0 = NaN at θ = π) are the JAX module's, unchanged.

Keypose state: rotation R (world_R_body), position p, velocity v, gyro bias
bg, accel bias ba — 15 error DoF in [theta(3), p(3), v(3), bg(3), ba(3)].
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from ..core.se3 import so3_exp, so3_log
from .imu_preintegration import (ImuCalibration, PreintegratedImu, bias_corrected_deltas,
                                 device_const, preintegrate)

_EYE9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
_ZERO3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SmootherConfig:
    window: int = 12
    iterations: int = 6
    damping: float = 1e-6
    vo_rot_sigma: float = 0.02
    vo_trans_sigma: float = 0.05
    depth_sigma: float = 0.05
    range_sigma: float = 0.3
    bias_rw_gyro_sigma: float = 1e-4
    bias_rw_accel_sigma: float = 1e-3
    no_motion_rot_sigma: float = 0.05
    no_motion_trans_sigma: float = 0.1
    mag_sigma: float = 0.1
    mag_scale: float = 1.0
    # World-frame field direction (config/shared mag0.local_field).
    mag_local_field: tuple = (0.0, 0.0, 1.0)
    # Landmark (structureless stereo projection) factors — the reference
    # legacy Smoother's SmartStereoProjectionPoseFactor equivalent
    # (smoother.cpp:455-490). max_landmarks columns track landmark identity
    # across the window (assigned host-side); 0 disables.
    max_landmarks: int = 0
    lmk_sigma_px: float = 2.0
    # Cauchy scale (in sigma units) for the landmark rows, per observation
    # over its [u, v, disp] residual norm; <= 0 disables (plain L2).
    lmk_cauchy_k: float = 3.0
    # Cauchy scale (sigma units) for the range rows; 0 = plain L2
    # (reference parity).
    range_cauchy_k: float = 3.0
    # Left-camera intrinsics for the projection factors.
    cam_fx: float = 300.0
    cam_fy: float = 300.0
    cam_cx: float = 320.0
    cam_cy: float = 240.0
    cam_baseline: float = 0.2
    imu_sigma_floor: float = 1e-5
    max_ranges: int = 4
    # Sensor extrinsics (config/shared/*.yaml; fixed_lag_smoother.cpp:62-68):
    # the left camera in the body frame (the landmark factors observe
    # through it), the range receiver's lever arm, the magnetometer's
    # mounting rotation and hard-iron bias (mag_pose_factor.hpp:32-72).
    body_R_cam: tuple = _EYE9
    body_t_cam: tuple = _ZERO3
    body_t_receiver: tuple = _ZERO3
    mag_body_R_sensor: tuple = _EYE9
    mag_bias: tuple = _ZERO3

    def replace(self, **changes) -> "SmootherConfig":
        return dataclasses.replace(self, **changes)


class KeyposeWindow(NamedTuple):
    """Fixed M-slot state + factor storage. Slot i connects to slot i-1."""

    timestamps: torch.Tensor    # (M,) MISSION-RELATIVE seconds (t - origin)
    R: torch.Tensor             # (M, 3, 3)
    p: torch.Tensor             # (M, 3)
    v: torch.Tensor             # (M, 3)
    bg: torch.Tensor            # (M, 3)
    ba: torch.Tensor            # (M, 3)
    valid: torch.Tensor         # (M,)
    # Factors from slot i-1 to slot i:
    vo_T: torch.Tensor          # (M, 4, 4) relative BODY pose i-1 -> i
    vo_valid: torch.Tensor      # (M,)
    imu_samples: torch.Tensor   # (M, N_IMU, 7) raw windows for re-preintegration
    imu_mask: torch.Tensor      # (M, N_IMU)
    imu_valid: torch.Tensor     # (M,)
    depth: torch.Tensor         # (M,)
    depth_valid: torch.Tensor   # (M,)
    ranges: torch.Tensor        # (M, B)
    range_beacons: torch.Tensor  # (M, B, 3)
    range_valid: torch.Tensor   # (M, B)
    mag: torch.Tensor           # (M, 3) measured field, sensor==body frame
    mag_valid: torch.Tensor     # (M,)
    # Absolute pose fix factors (external aiding).
    fix_R: torch.Tensor         # (M, 3, 3) measured world_R_body
    fix_p: torch.Tensor         # (M, 3) measured world position
    fix_sigma: torch.Tensor     # (M, 6) stdevs [rot(3), trans(3)]
    fix_valid: torch.Tensor     # (M,)
    # Landmark observations: column l holds ONE landmark's pixel track
    # across the window (host keeps the id->column assignment).
    lmk_uv: torch.Tensor        # (M, L, 2)
    lmk_disp: torch.Tensor      # (M, L) stereo disparity (<=0: mono obs)
    lmk_valid: torch.Tensor     # (M, L)
    # Prior on slot 0 (marginalization anchor): mean uses slot-0 state.
    prior_sqrt_info: torch.Tensor  # (15, 15)
    prior_R: torch.Tensor          # (3, 3)
    prior_p: torch.Tensor
    prior_v: torch.Tensor
    prior_bg: torch.Tensor
    prior_ba: torch.Tensor


def make_window(config: SmootherConfig, n_imu: int, dtype: torch.dtype = torch.float64,
                device=None) -> KeyposeWindow:
    """An empty window. The JAX function picks its dtype from
    ``jax_enable_x64``; here it is explicit (float64 by default: the
    H100 has real FP64; float32 works too, see ``_qr_step``)."""
    M, B = config.window, config.max_ranges
    L = max(config.max_landmarks, 1)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    eye3 = torch.eye(3, dtype=dtype, device=device)
    eye = eye3.expand(M, 3, 3).clone()
    return KeyposeWindow(
        timestamps=zeros(M),
        R=eye,
        p=zeros(M, 3),
        v=zeros(M, 3),
        bg=zeros(M, 3),
        ba=zeros(M, 3),
        valid=zeros(M, dt=torch.bool),
        vo_T=torch.eye(4, dtype=dtype, device=device).expand(M, 4, 4).clone(),
        vo_valid=zeros(M, dt=torch.bool),
        imu_samples=zeros(M, n_imu, 7),
        imu_mask=zeros(M, n_imu, dt=torch.bool),
        imu_valid=zeros(M, dt=torch.bool),
        depth=zeros(M),
        depth_valid=zeros(M, dt=torch.bool),
        ranges=zeros(M, B),
        range_beacons=zeros(M, B, 3),
        range_valid=zeros(M, B, dt=torch.bool),
        mag=zeros(M, 3),
        mag_valid=zeros(M, dt=torch.bool),
        fix_R=eye.clone(),
        fix_p=zeros(M, 3),
        fix_sigma=torch.ones((M, 6), dtype=dtype, device=device),
        fix_valid=zeros(M, dt=torch.bool),
        lmk_uv=zeros(M, L, 2),
        lmk_disp=zeros(M, L),
        lmk_valid=zeros(M, L, dt=torch.bool),
        prior_sqrt_info=torch.eye(15, dtype=dtype, device=device) * 10.0,
        prior_R=eye3.clone(),
        prior_p=zeros(3),
        prior_v=zeros(3),
        prior_bg=zeros(3),
        prior_ba=zeros(3),
    )


@functools.lru_cache(maxsize=None)
def _slot_masks(M: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot > 0, slot < M - 1) as boolean tensors on the device."""
    idx = torch.arange(M, device=device)
    return idx > 0, idx < M - 1


def _retract(win: KeyposeWindow, delta: torch.Tensor) -> KeyposeWindow:
    """Apply (M, 15) local increments [theta p v bg ba] to the window states."""
    dR = so3_exp(delta[:, 0:3])
    return win._replace(
        R=win.R @ dR,
        p=win.p + delta[:, 3:6],
        v=win.v + delta[:, 6:9],
        bg=win.bg + delta[:, 9:12],
        ba=win.ba + delta[:, 12:15],
    )


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _tmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Aᵀx, batched."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def _residuals(
    delta: torch.Tensor,
    win: KeyposeWindow,
    pims: PreintegratedImu,          # stacked (M, ...) preintegrations i-1 -> i
    gravity: torch.Tensor,
    gravity_unit: torch.Tensor,
    config: SmootherConfig,
) -> torch.Tensor:
    """Whitened residual vector of every factor, masked rows zeroed (the JAX
    function's rows, in its order)."""
    M = win.valid.shape[0]
    w = _retract(win, delta)
    dtype, dev = delta.dtype, delta.device
    not_first, _ = _slot_masks(M, dev)

    def prev(arr):  # slot i-1 aligned with i
        return torch.roll(arr, 1, dims=0)

    def f(x):
        return x.to(dtype)

    pair_ok = win.valid & prev(win.valid) & not_first

    res = []

    # -- prior on slot 0 ------------------------------------------------------
    # so3_log on a batch of one: under forward-mode AD a 0-dim float32
    # operand's tangent is promoted to float64 by Python-scalar arithmetic.
    r_prior = torch.cat(
        [
            so3_log((w.prior_R.T @ w.R[0])[None])[0],
            w.p[0] - w.prior_p,
            w.v[0] - w.prior_v,
            w.bg[0] - w.prior_bg,
            w.ba[0] - w.prior_ba,
        ]
    )
    # A tight external pose fix in the window provides the absolute gauge:
    # the anchor's pose block is down-weighted by the fix's tightness
    # relative to the anchor's claimed sigma (the JAX module explains the
    # measured failure this avoids).
    s_anchor = 1.0 / (
        torch.linalg.vector_norm(win.prior_sqrt_info[:, 3:6]) / math.sqrt(3.0) + 1e-12
    )
    fix_active = win.fix_valid & win.valid
    s_fix = torch.min(
        torch.where(fix_active, torch.mean(win.fix_sigma[:, 3:6], dim=1), math.inf)
    )
    relax = torch.clip(100.0 * s_anchor / s_fix, 1.0, 100.0)
    gauge = (1.0 / relax).to(dtype)
    col_scale = torch.cat([gauge.expand(6), torch.ones(9, dtype=dtype, device=dev)])
    prior_S = w.prior_sqrt_info * col_scale[None, :]
    res.append((prior_S @ r_prior) * f(win.valid[0]))

    # -- VO between factors ---------------------------------------------------
    # Masked-pair AD safety: invalid pairs (above all the slot-0 wraparound)
    # would feed so3_log an arbitrary relative rotation (θ = π, where
    # arccos' derivative is infinite and the ×0 mask yields NaN under
    # jacfwd). Substitute the slot's own rotation so masked relative
    # rotations are ≈identity, inside the θ² Taylor guard.
    R_prev = torch.where(pair_ok[:, None, None], prev(w.R), w.R)
    p_prev = torch.where(pair_ok[:, None], prev(w.p), w.p)
    R_rel = R_prev.transpose(-1, -2) @ w.R                      # R_{i-1}^T R_i
    p_rel = _tmv(R_prev, w.p - p_prev)
    r_rot = so3_log(win.vo_T[:, :3, :3].transpose(-1, -2) @ R_rel)
    r_trans = p_rel - win.vo_T[:, :3, 3]
    vo_ok = f(win.vo_valid & pair_ok)[:, None]
    # Cauchy robust weight on the combined residual norm (fixed_lag_smoother
    # uses a Cauchy(0.1) noise model on the VO between factor).
    r_vo_raw = torch.cat([r_rot / config.vo_rot_sigma, r_trans / config.vo_trans_sigma], dim=1)
    nrm2 = torch.sum(r_vo_raw * r_vo_raw, dim=1, keepdim=True)
    cauchy = 1.0 / torch.sqrt(1.0 + nrm2 / (0.1 / config.vo_trans_sigma) ** 2)
    res.append((r_vo_raw * cauchy * vo_ok).reshape(-1))

    # -- IMU preintegration factors ------------------------------------------
    # R_prev (pair-masked) for the same θ=π AD-safety as the VO rows.
    R_i, p_i, v_i = R_prev, prev(w.p), prev(w.v)
    dR, dv, dp = bias_corrected_deltas(pims, prev(w.bg), prev(w.ba))
    dt = pims.dt[:, None]
    r_R = so3_log(dR.transpose(-1, -2) @ (R_i.transpose(-1, -2) @ w.R))
    r_v = _tmv(R_i, w.v - v_i - gravity * dt) - dv
    r_p = _tmv(R_i, w.p - p_i - v_i * dt - 0.5 * gravity * dt * dt) - dp
    r_imu = torch.cat([r_R, r_v, r_p], dim=1)  # (M, 9)
    # Whiten with the FULL 9x9 preintegration covariance (Cholesky factor,
    # the reference's CombinedImuFactor noise model); a sigma floor keeps
    # empty windows positive definite.
    cov9 = 0.5 * (pims.cov + pims.cov.transpose(-1, -2))
    cov9 = cov9 + (config.imu_sigma_floor**2) * torch.eye(9, dtype=dtype, device=dev)
    L_imu = torch.linalg.cholesky_ex(cov9)[0]
    r_imu_w = torch.linalg.solve_triangular(L_imu, r_imu[..., None], upper=False)[..., 0]
    imu_ok = f(win.imu_valid & pair_ok)[:, None]
    res.append((r_imu_w * imu_ok).reshape(-1))

    # -- bias random walk between consecutive keyposes ------------------------
    dt_pair = torch.clip(w.timestamps - prev(w.timestamps), min=1e-3)[:, None]
    rw_g = (w.bg - prev(w.bg)) / (config.bias_rw_gyro_sigma * torch.sqrt(dt_pair))
    rw_a = (w.ba - prev(w.ba)) / (config.bias_rw_accel_sigma * torch.sqrt(dt_pair))
    res.append((torch.cat([rw_g, rw_a], dim=1) * imu_ok).reshape(-1))

    # -- depth factors (gravity-axis translation) -----------------------------
    d_pred = w.p @ gravity_unit
    r_depth = (d_pred - win.depth) / config.depth_sigma
    res.append(r_depth * f(win.depth_valid & win.valid))

    # -- range factors (receiver lever arm) ------------------------------------
    t_recv = device_const(tuple(config.body_t_receiver), (3,), dtype, dev)
    p_recv = w.p + _mv(w.R, t_recv)
    delta_b = win.range_beacons - p_recv[:, None, :]
    dist = torch.linalg.vector_norm(delta_b + 1e-12, dim=-1)
    r_range = (dist - win.ranges) / config.range_sigma
    if config.range_cauchy_k > 0:
        r_range = r_range / torch.sqrt(1.0 + (r_range * r_range) / config.range_cauchy_k**2)
    res.append((r_range * f(win.range_valid & win.valid[:, None])).reshape(-1))

    # -- magnetometer heading factors (MagPoseFactor parity) ------------------
    # Field predicted in the SENSOR frame: (R_world_body·R_body_sensor)^T·nM
    # + bias (mag_pose_factor.hpp:68-72).
    local_field = device_const(tuple(config.mag_local_field), (3,), dtype, dev) * config.mag_scale
    R_bs = device_const(tuple(config.mag_body_R_sensor), (3, 3), dtype, dev)
    mag_pred = _tmv(w.R, local_field.expand(M, 3)) @ R_bs
    mag_pred = mag_pred + device_const(tuple(config.mag_bias), (3,), dtype, dev)
    r_mag = (mag_pred - win.mag) / config.mag_sigma
    res.append((r_mag * f(win.mag_valid & win.valid)[:, None]).reshape(-1))

    # -- absolute pose fix factors (external aiding) ---------------------------
    # AD-safety: masked rows must not feed so3_log an arbitrary absolute
    # rotation; substitute the keypose's own rotation.
    fix_ok = f(win.fix_valid & win.valid)[:, None]
    fix_R_eff = torch.where(win.fix_valid[:, None, None], win.fix_R, w.R)
    r_fix_rot = so3_log(fix_R_eff.transpose(-1, -2) @ w.R)
    r_fix = torch.cat([r_fix_rot, w.p - win.fix_p], dim=1)
    res.append((r_fix / torch.clamp(win.fix_sigma, min=1e-9) * fix_ok).reshape(-1))

    # -- landmark projection factors (structureless smart factors) ------------
    if config.max_landmarks > 0:
        fx, fy = config.cam_fx, config.cam_fy
        cx, cy = config.cam_cx, config.cam_cy
        obs_ok = f(win.lmk_valid & win.valid[:, None])                # (M, L)
        # Only landmarks with >= 2 observations constrain anything.
        n_obs = torch.sum(obs_ok, dim=0)                               # (L,)
        lmk_ok = f(n_obs >= 2.0)

        # Observations come through the LEFT CAMERA at body_T_cam.
        R_bc = device_const(tuple(config.body_R_cam), (3, 3), dtype, dev)
        t_bc = device_const(tuple(config.body_t_cam), (3,), dtype, dev)
        R_cam = w.R @ R_bc                                              # (M, 3, 3)
        p_cam = w.p + _mv(w.R, t_bc)                                    # (M, 3)

        # Bearing rays in world frame per (keypose, landmark).
        xn = (win.lmk_uv[..., 0] - cx) / fx
        yn = (win.lmk_uv[..., 1] - cy) / fy
        dirs_cam = torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)  # (M, L, 3)
        dirs_w = dirs_cam @ R_cam.transpose(-1, -2)
        dirs_w = dirs_w / torch.clamp(torch.linalg.vector_norm(dirs_w, dim=-1, keepdim=True),
                                      min=1e-9)

        # Structureless elimination: the landmark is re-estimated in closed
        # form at every linearization (the masked mean of the stereo
        # observations, else the ray midpoint), and the AD flows through it.
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        has_disp = f(win.lmk_disp > 0) * obs_ok                         # (M, L)
        z_meas = fx * config.cam_baseline / torch.clamp(win.lmk_disp, min=1e-3)
        X_cam_meas = torch.stack([xn * z_meas, yn * z_meas, z_meas], dim=-1)
        X_meas = p_cam[:, None, :] + X_cam_meas @ R_cam.transpose(-1, -2)
        n_stereo = torch.sum(has_disp, dim=0)                          # (L,)
        X_stereo = (torch.sum(X_meas * has_disp[..., None], dim=0)
                    / torch.clamp(n_stereo, min=1.0)[:, None])
        # Ray-midpoint fallback (mono tracks).
        Pm = eye3[None, None] - dirs_w[..., :, None] * dirs_w[..., None, :]
        Pm = Pm * obs_ok[..., None, None]
        A = torch.sum(Pm, dim=0) + (1e-6 + (1.0 - lmk_ok))[:, None, None] * eye3[None]
        b = torch.sum((Pm @ p_cam[:, None, :, None])[..., 0], dim=0)
        X_mono = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]    # (L, 3)
        X = torch.where((n_stereo > 0)[:, None], X_stereo, X_mono)

        # Reprojection residuals into every observing keypose.
        X_cam = (X[None] - p_cam[:, None, :]) @ R_cam
        z_cam = X_cam[..., 2]
        behind = z_cam < 0.1
        z_safe = torch.clamp(z_cam, min=0.1)
        u_pred = fx * X_cam[..., 0] / z_safe + cx
        v_pred = fy * X_cam[..., 1] / z_safe + cy
        w_lmk = obs_ok * lmk_ok[None, :] * f(~behind) / config.lmk_sigma_px
        r_u = (u_pred - win.lmk_uv[..., 0]) * w_lmk
        r_v = (v_pred - win.lmk_uv[..., 1]) * w_lmk
        # Stereo row: predicted disparity fx·b/z vs observed — what makes the
        # factor STEREO and pins the scale gauge.
        disp_pred = fx * config.cam_baseline / z_safe
        has_disp = f(win.lmk_disp > 0)
        r_d = (disp_pred - win.lmk_disp) * w_lmk * has_disp
        if config.lmk_cauchy_k > 0:
            n2 = r_u * r_u + r_v * r_v + r_d * r_d
            w_rob = 1.0 / torch.sqrt(1.0 + n2 / config.lmk_cauchy_k**2)
            r_u, r_v, r_d = r_u * w_rob, r_v * w_rob, r_d * w_rob
        res.append(r_u.reshape(-1))
        res.append(r_v.reshape(-1))
        res.append(r_d.reshape(-1))

    # -- no-motion fallback (neither VO nor IMU between a valid pair) ---------
    nm_ok = f(pair_ok & ~win.vo_valid & ~win.imu_valid)[:, None]
    r_nm = torch.cat(
        [so3_log(R_rel) / config.no_motion_rot_sigma, p_rel / config.no_motion_trans_sigma],
        dim=1,
    )
    res.append((r_nm * nm_ok).reshape(-1))

    return torch.cat(res)


def preintegrate_window(win: KeyposeWindow, calib: Optional[ImuCalibration] = None,
                        n_steps: Optional[int] = None) -> PreintegratedImu:
    """Preintegrate each slot's IMU window at the predecessor's bias estimate,
    the slots as the batch. ``n_steps``: no slot has a valid sample at or
    after it (see ``preintegrate``)."""
    calib = calib or ImuCalibration()
    bg_prev = torch.roll(win.bg, 1, dims=0)
    ba_prev = torch.roll(win.ba, 1, dims=0)
    return preintegrate(win.imu_samples, win.imu_mask, bg_prev, ba_prev, calib, n_steps)


class SmootherResult(NamedTuple):
    R: torch.Tensor           # newest keypose rotation
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    timestamp: torch.Tensor   # mission-relative seconds (window convention)
    cov_newest: torch.Tensor  # (15,15) marginal covariance of newest keypose
    cov_slot1: torch.Tensor   # (15,15) marginal of slot 1 — the next anchor
    error: torch.Tensor


def _qr_step(J: torch.Tensor, r: torch.Tensor, config: SmootherConfig):
    """Damped GN step via QR of the stacked system — cond(J) instead of
    cond(JᵀJ), which keeps the solve healthy in float32. Damping rows:
    sqrt(λ·diag(JᵀJ) + floor) (Marquardt + absolute floor so inactive-slot
    columns stay invertible)."""
    n = J.shape[1]
    diag_H = torch.sum(J * J, dim=0)
    damp = torch.sqrt(config.damping * diag_H + (config.damping + 1e-8))
    A = torch.cat([J, torch.diag(damp)], dim=0)
    b = torch.cat([-r, torch.zeros(n, dtype=r.dtype, device=r.device)])
    q, r_mat = torch.linalg.qr(A)
    delta = torch.linalg.solve_triangular(r_mat, (q.T @ b)[:, None], upper=True)[:, 0]
    return torch.where(torch.isfinite(delta), delta, 0.0), r_mat


def _linearize(w: KeyposeWindow, pims, gravity, gravity_unit, config):
    """(J, r) at the window's current estimate: forward-mode AD over the
    M·15 local increments, the residual itself as the auxiliary output."""
    M = w.valid.shape[0]

    def res_of(delta_flat):
        r = _residuals(delta_flat.reshape(M, 15), w, pims, gravity, gravity_unit, config)
        return r, r

    delta0 = torch.zeros(M * 15, dtype=w.p.dtype, device=w.p.device)
    return jacfwd(res_of, has_aux=True)(delta0)


def solve_window(
    win: KeyposeWindow,
    pims: PreintegratedImu,
    gravity: torch.Tensor,
    gravity_unit: torch.Tensor,
    config: SmootherConfig,
    newest_slot: int,
) -> Tuple[KeyposeWindow, SmootherResult]:
    """Batch Gauss-Newton over the whole window, ``config.iterations`` steps."""
    w, r, cov = gauss_newton(win, pims, gravity, gravity_unit, config)
    return w, smoother_result(w, r, cov, newest_slot)


def gauss_newton(win: KeyposeWindow, pims: PreintegratedImu, gravity: torch.Tensor,
                 gravity_unit: torch.Tensor, config: SmootherConfig):
    """``solve_window``'s work: the solved window, the residual at it and
    the full (M·15)² covariance."""
    M = win.valid.shape[0]
    dtype, dev = win.p.dtype, win.p.device
    validf = win.valid.to(dtype)[:, None]

    w = win
    for _ in range(config.iterations):
        J, r = _linearize(w, pims, gravity, gravity_unit, config)
        delta, _ = _qr_step(J, r, config)
        # Freeze invalid slots.
        w = _retract(w, delta.reshape(M, 15) * validf)

    # Final linearization for covariances: cov = (RᵀR)^-1 of the UNDAMPED
    # system (the reference's marginals do too, fixed_lag_smoother.cpp:
    # 430-468); only the absolute floor rows stay, for rank of inactive-slot
    # columns.
    J, r = _linearize(w, pims, gravity, gravity_unit, config)
    n_cols = J.shape[1]
    floor = torch.sqrt(torch.full((), config.damping + 1e-8, dtype=dtype, device=dev))
    A = torch.cat([J, floor * torch.eye(n_cols, dtype=dtype, device=dev)], dim=0)
    r_mat = torch.linalg.qr(A, mode="r")[1]
    rinv = torch.linalg.solve_triangular(
        r_mat, torch.eye(n_cols, dtype=dtype, device=dev), upper=True
    )
    return w, r, rinv @ rinv.T


def smoother_result(w: KeyposeWindow, r: torch.Tensor, cov: torch.Tensor,
                    newest_slot: int) -> SmootherResult:
    sl = int(newest_slot)
    return SmootherResult(
        R=w.R[sl], p=w.p[sl], v=w.v[sl], bg=w.bg[sl], ba=w.ba[sl],
        timestamp=w.timestamps[sl],
        cov_newest=cov[sl * 15:(sl + 1) * 15, sl * 15:(sl + 1) * 15],
        cov_slot1=cov[15:30, 15:30],
        error=torch.sum(r * r),
    )


_SLOT_FIELDS = (
    "timestamps", "R", "p", "v", "bg", "ba", "valid", "vo_T", "vo_valid", "imu_samples",
    "imu_mask", "imu_valid", "depth", "depth_valid", "ranges", "range_beacons", "range_valid",
    "mag", "mag_valid", "fix_R", "fix_p", "fix_sigma", "fix_valid", "lmk_uv", "lmk_disp",
    "lmk_valid",
)
_VALID_FIELDS = ("valid", "vo_valid", "imu_valid", "depth_valid", "range_valid", "mag_valid",
                 "fix_valid", "lmk_valid")


def slide_window(win: KeyposeWindow, cov_slot1: torch.Tensor) -> KeyposeWindow:
    """Drop slot 0, shift everything left, anchor the new slot 0 with its
    marginal covariance (prior anchoring). ``eigh`` checks its result: one
    host sync a slide."""
    M = win.valid.shape[0]
    out = win._replace(**{k: torch.roll(getattr(win, k), -1, dims=0) for k in _SLOT_FIELDS})
    # Invalidate the freed last slot.
    _, not_last = _slot_masks(M, win.valid.device)
    out = out._replace(**{
        k: getattr(out, k) & not_last.reshape((M,) + (1,) * (getattr(out, k).ndim - 1))
        for k in _VALID_FIELDS})
    # New anchor: slot 0's state with sqrt information from its marginal.
    eye15 = torch.eye(15, dtype=cov_slot1.dtype, device=cov_slot1.device)
    info = torch.linalg.inv_ex(cov_slot1 + 1e-9 * eye15)[0]
    info = 0.5 * (info + info.T)
    evals, evecs = torch.linalg.eigh(info)
    sqrt_info = (evecs * torch.sqrt(torch.clip(evals, min=0.0))[None, :]) @ evecs.T
    return out._replace(
        prior_sqrt_info=sqrt_info,
        prior_R=out.R[0],
        prior_p=out.p[0],
        prior_v=out.v[0],
        prior_bg=out.bg[0],
        prior_ba=out.ba[0],
    )
