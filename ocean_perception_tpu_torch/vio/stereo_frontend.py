"""Stereo VO front-end: tracker + LM odometry -> VoResult (port of
``ocean_perception_tpu.vio.stereo_frontend``).

Reference parity: vio/stereo_frontend.{hpp,cpp} — wraps StereoTracker, builds
3D(previous keyframe)↔2D(current) correspondences from tracked landmarks
whose keyframe observation had a stereo match, optimizes the relative pose,
and reports a status bitmask (stereo_frontend.hpp:51-57):
  FEW_DETECTED_FEATURES | ODOM_ESTIMATION_FAILED | NO_FEATURES_FROM_LAST_KF.

``frontend_step`` is a function of tensors on the images' device that reads
nothing back (its LK walk is the ``lk_track`` kernel on a CUDA tensor); the
host-side ``StereoFrontend`` class mirrors the reference's stateful API
around it, one camera with a pyramid ring sized from the rig.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.cameras import StereoCamera
from ..core.se3 import se3_inverse
from ..tracking.stereo_tracker import (
    StereoTrackerParams,
    StereoTrackerState,
    device_scalar,
    track_and_triangulate,
)
from .odometry import OdometryParams, optimize_odometry


class FrontendStatus(enum.IntFlag):
    OK = 0
    FEW_DETECTED_FEATURES = 1
    ODOM_ESTIMATION_FAILED = 2
    NO_FEATURES_FROM_LAST_KF = 4


@dataclasses.dataclass(frozen=True)
class FrontendParams:
    tracker: StereoTrackerParams = StereoTrackerParams()
    odometry: OdometryParams = OdometryParams()
    pixel_sigma: float = 2.0
    min_features: int = 8
    # Odometry acceptance gate on mean whitened reprojection residual
    # (stereo_frontend.cpp:149, default 5.0 sigmas).
    max_avg_reprojection_error: float = 5.0


class VoResult(NamedTuple):
    """Relative pose between the last keyframe and this frame (vo_result.hpp)."""

    T_prev_cur: torch.Tensor   # (4, 4) cam_prevKF_T_cam_cur
    covariance: torch.Tensor   # (6, 6)
    is_keyframe: torch.Tensor
    status: torch.Tensor       # int32 bitmask
    n_tracked: torch.Tensor
    n_inliers: torch.Tensor
    avg_reprojection_err: torch.Tensor
    lmk_ids: torch.Tensor      # (K,) observations for the smoother
    lmk_pixels: torch.Tensor   # (K, 2)
    lmk_disparities: torch.Tensor  # (K,)
    lmk_valid: torch.Tensor    # (K,)


def frontend_step(
    state: StereoTrackerState,
    prev_left: torch.Tensor,
    cur_left: torch.Tensor,
    cur_right: torch.Tensor,
    rig: StereoCamera,
    params: FrontendParams,
    force_keyframe=False,
) -> Tuple[StereoTrackerState, VoResult]:
    """Track + solve odometry in one step on the images' device."""
    dev = cur_left.device
    fxb = device_scalar(float(np.float32(rig.fx) * np.float32(rig.baseline)), torch.float32, dev)
    prev_table = state.table  # keyframe snapshot BEFORE this step's update
    new_state, out = track_and_triangulate(
        state, prev_left, cur_left, cur_right, fxb, params.tracker, force_keyframe
    )
    table = new_state.table

    # Correspondences: landmarks observed (with disparity) at the LAST
    # keyframe (pre-update snapshot — on keyframe steps the table already
    # re-snapshotted to the current frame, which would yield identity VO)
    # tracked into the current frame. Slot identity must hold across the step.
    same_lmk = (prev_table.ids == table.ids) & (prev_table.ids >= 0)
    has_kf_3d = same_lmk & table.alive & (prev_table.kf_disparities > 0) & (table.missed == 0)
    depth_kf = fxb / torch.clamp(prev_table.kf_disparities, min=1e-3)
    P0 = rig.left.backproject(prev_table.kf_pixels, depth_kf)  # (K, 3) prev-KF cam
    sigmas = torch.full((table.capacity,), params.pixel_sigma, dtype=P0.dtype, device=dev)

    odo = optimize_odometry(P0, table.pixels, sigmas, has_kf_3d, rig, params=params.odometry)

    n_corr = torch.sum(has_kf_3d.to(torch.int32))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    status = torch.where(out.n_tracked < params.min_features,
                         FrontendStatus.FEW_DETECTED_FEATURES.value, zero)
    odom_failed = ~odo.success | (odo.error > params.max_avg_reprojection_error)
    status = status | torch.where(odom_failed, FrontendStatus.ODOM_ESTIMATION_FAILED.value, zero)
    status = status | torch.where(n_corr == 0, FrontendStatus.NO_FEATURES_FROM_LAST_KF.value,
                                  zero)

    # T_prev_cur = inverse of the estimated T_10 (frame0 = prev KF in cam
    # coords, frame1 = current).
    vo = VoResult(
        T_prev_cur=se3_inverse(odo.T_10),
        covariance=odo.covariance,
        is_keyframe=out.is_keyframe,
        status=status,
        n_tracked=out.n_tracked,
        n_inliers=odo.n_inliers,
        avg_reprojection_err=odo.error,
        lmk_ids=out.observations.lmk_ids,
        lmk_pixels=out.observations.pixels,
        lmk_disparities=out.observations.disparities,
        lmk_valid=out.observations.valid,
    )
    return new_state, vo


def to_device(x, device, dtype: torch.dtype) -> torch.Tensor:
    """An array or tensor on ``device`` in ``dtype``. A host array bound for
    the card goes through pinned memory without blocking, so the copy is no
    host sync (the pinned block is kept until the copy has run)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.as_tensor(np.ascontiguousarray(x)).to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class StereoFrontend:
    """Host-side stateful wrapper (reference StereoFrontend class API) on one
    device: float32 images there, the tracker's pyramid ring sized from the
    rig for k-ago re-tracking (stereo_tracker.cpp:33-88 parity)."""

    def __init__(self, params: FrontendParams, rig: StereoCamera, device="cpu"):
        self.params = params
        self.rig = rig
        self.device = torch.device(device)
        self.state = StereoTrackerState.create(
            params.tracker, image_shape=(int(rig.left.height), int(rig.left.width)),
            device=self.device,
        )
        self._prev_left: Optional[torch.Tensor] = None

    def track(self, left, right, force_keyframe: bool = False) -> VoResult:
        left = to_device(left, self.device, torch.float32)
        right = to_device(right, self.device, torch.float32)
        prev = self._prev_left if self._prev_left is not None else left
        self.state, vo = frontend_step(self.state, prev, left, right, self.rig, self.params,
                                       force_keyframe or self._prev_left is None)
        self._prev_left = left
        return vo
