"""The port's StateEstimator against the JAX engine on the CPU, on two
missions built from numpy seeds:

1. IMU + depth (``tests/test_state_estimator.py``'s engine: window 6, 4 GN
   iterations, 100 Hz IMU, 2 Hz depth, no vision): the mode, the keypose
   count, every smoother callback's pose and the final filter state agree
   to 1e-8 (float64 on both sides; measured ~1e-13).
2. Vision (``tests/test_vio_vision_e2e.py``'s scene: 160x240, capacity 96,
   LK ``max_level`` 2, window 6): the mode after every frame, the keypose
   count and every frame's VO status are equal; every smoother callback's
   pose agrees to 1e-4 m and rad (the float32 frontend feeds it).

Each JAX engine is built and driven once, in a module-scoped fixture.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from ocean_perception_tpu.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu.core.measurements import (
    DepthMeasurement,
    ImuMeasurement,
    StereoImage,
)
from ocean_perception_tpu.tracking import DetectorParams, LKParams, StripeMatcherParams
from ocean_perception_tpu.tracking.stereo_tracker import StereoTrackerParams
from ocean_perception_tpu.vio import state_estimator as jse
from ocean_perception_tpu.vio.odometry import OdometryParams
from ocean_perception_tpu.vio.smoother import SmootherConfig
from ocean_perception_tpu.vio.stereo_frontend import FrontendParams
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.core import measurements as tmeas
from ocean_perception_tpu_torch.vio import state_estimator as tse

GRAVITY = np.array([0.0, 0.0, -9.81])
H, W = 160, 240
FX = 200.0
BASELINE = 0.3
DISP = FX * BASELINE / 5.0  # a plane at 5 m: 12 px


def port_of(params, rig):
    return tse.StateEstimator(convert.state_estimator_params_from_jax(params),
                              convert.stereo_camera_from_jax(rig), device="cpu")


def record(est, to_np):
    """Every smoother callback's pose [R | p] as one (3, 4) float64 array."""
    poses = []
    est.smoother_callbacks.append(
        lambda r: poses.append(np.concatenate([to_np(r.R), to_np(r.p)[:, None]], axis=1)))
    return poses


def jax_np(x):
    return np.asarray(x, np.float64)


def torch_np(x):
    return x.detach().cpu().double().numpy()


def rot_err(Ra, Rb):
    """The angle of Raᵀ Rb, from ||Ra - Rb||_F = 2√2 sin(θ/2) (well-conditioned
    at 0, unlike the trace's arccos)."""
    return float(2.0 * np.arcsin(min(np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0)), 1.0)))


def pose_errors(pa, pb):
    assert len(pa) == len(pb)
    trans = max(float(np.abs(a[:, 3] - b[:, 3]).max()) for a, b in zip(pa, pb))
    rot = max(rot_err(a[:, :3], b[:, :3]) for a, b in zip(pa, pb))
    return trans, rot


# -- mission 1: IMU + depth ---------------------------------------------------


def imu_depth_params():
    return jse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(),
        smoother=SmootherConfig(window=6, iterations=4),
        max_imu_per_keypose=128,
        max_sec_btw_keyposes=0.5,
    )


def drive_imu_depth(est, meas):
    modes = []
    est.initialize(0, np.eye(4))
    vel = np.array([0.2, 0.0, -0.1])
    rng = np.random.default_rng(21)
    for i in range(1, 301):  # 3 s at 100 Hz
        t_ns = int(i * 0.01 * 1e9)
        if i % 50 == 0:
            depth = float(np.array([0, 0, -1.0]) @ (vel * i * 0.01))
            est.receive_depth(meas.DepthMeasurement(timestamp=t_ns - 1, depth=depth))
        noise = rng.normal(0, 1e-3, 6)
        est.receive_imu(meas.ImuMeasurement(timestamp=t_ns, angular_velocity=noise[:3],
                                            linear_acceleration=-GRAVITY + noise[3:]))
        modes.append(est.mode.name)
    return modes


class _JaxMeas:
    DepthMeasurement = DepthMeasurement
    ImuMeasurement = ImuMeasurement


@pytest.fixture(scope="module")
def imu_depth_jax():
    cam = PinholeCamera.create(300.0, 300.0, 320.0, 240.0, 480, 640)
    rig = StereoCamera.create(cam, cam, baseline=0.2)
    params = imu_depth_params()
    est = jse.StateEstimator(params, rig)
    poses = record(est, jax_np)
    modes = drive_imu_depth(est, _JaxMeas)
    return dict(rig=rig, est=est, poses=poses, modes=modes)


def test_imu_depth_mission_matches_jax(imu_depth_jax):
    ref = imu_depth_jax
    est = port_of(imu_depth_params(), ref["rig"])
    poses = record(est, torch_np)
    modes = drive_imu_depth(est, tmeas)
    assert modes == ref["modes"]
    assert est._n_keyposes == ref["est"]._n_keyposes
    assert est._keypose_times_ns == ref["est"]._keypose_times_ns
    assert len(poses) == len(ref["poses"]) >= 5
    trans, rot = pose_errors(poses, ref["poses"])
    assert trans < 1e-8 and rot < 1e-8, (trans, rot)
    fs, fs_j = est.filter_state(), ref["est"].filter_state()
    assert fs.timestamp == fs_j.timestamp
    np.testing.assert_allclose(fs.world_T_body, fs_j.world_T_body, atol=1e-8)
    np.testing.assert_allclose(fs.velocity, fs_j.velocity, atol=1e-8)
    np.testing.assert_allclose(fs.covariance, fs_j.covariance, atol=1e-8)
    ss, ss_j = est.smoother_state(), ref["est"].smoother_state()
    assert ss.timestamp == ss_j.timestamp
    np.testing.assert_allclose(ss.world_T_body, ss_j.world_T_body, atol=1e-8)
    # The window stays on the estimator's device in its dtype.
    assert est.window.p.dtype == torch.float64 and est.window.p.device.type == "cpu"


def test_estimator_window_dtype_float32_runs():
    """A float32 window (the EKF stays float64) runs the same mission and
    stays within 1e-3 of the float64 engine."""
    cam = PinholeCamera.create(300.0, 300.0, 320.0, 240.0, 480, 640)
    rig = convert.stereo_camera_from_jax(StereoCamera.create(cam, cam, baseline=0.2))
    params = convert.state_estimator_params_from_jax(imu_depth_params())
    est32 = tse.StateEstimator(params, rig, device="cpu", dtype=torch.float32)
    est64 = tse.StateEstimator(params, rig, device="cpu")
    p32, p64 = record(est32, torch_np), record(est64, torch_np)
    drive_imu_depth(est32, tmeas)
    drive_imu_depth(est64, tmeas)
    assert est32.window.p.dtype == torch.float32
    assert est32.ekf_state.S.dtype == torch.float64
    trans, rot = pose_errors(p32, p64)
    assert trans < 1e-3 and rot < 1e-3, (trans, rot)


# -- mission 2: vision --------------------------------------------------------


def vision_params():
    return jse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(),
        frontend=FrontendParams(
            tracker=StereoTrackerParams(
                capacity=96,
                detector=DetectorParams(max_features=96, min_distance=10, border=10),
                lk=LKParams(max_level=2),
                matcher=StripeMatcherParams(
                    max_disp=32, templ_cols=15, templ_rows=11, max_matching_cost=0.3
                ),
                trigger_keyframe_k=2,
            ),
            odometry=OdometryParams(),
            pixel_sigma=1.0,
        ),
        smoother=SmootherConfig(window=6, iterations=4, max_landmarks=8),
        min_sec_btw_keyposes=0.05,
        max_sec_btw_keyposes=10.0,
    )


N_FRAMES = 16


def vision_frames():
    rng = np.random.default_rng(4)
    canvas = rng.random((H, W + 200)).astype(np.float32)
    canvas = cv2.GaussianBlur(canvas, (5, 5), 1.0) * 0.8 + 0.1
    frames = []
    for i in range(N_FRAMES):
        x = 40 + 4 * i  # 4 px a frame: 0.1 m at 5 m
        frames.append((np.ascontiguousarray(canvas[:, x:x + W]),
                       np.ascontiguousarray(canvas[:, x + int(DISP):x + int(DISP) + W])))
    return frames


def drive_vision(est, StereoImageCls, frames, status_of):
    modes, statuses = [], []
    track = est.frontend.track

    def tracked(left, right, force_keyframe=False):
        vo = track(left, right, force_keyframe)
        statuses.append(status_of(vo))
        return vo

    est.frontend.track = tracked
    est.initialize(int(1e8), np.eye(4))
    for i, (left, right) in enumerate(frames):
        est.receive_stereo(StereoImageCls(int((i + 1) * 1e8), 0, left, right))
        modes.append(est.mode.name)
    return modes, statuses


@pytest.fixture(scope="module")
def vision_jax():
    cam = PinholeCamera.create(FX, FX, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, BASELINE)
    est = jse.StateEstimator(vision_params(), rig)
    poses = record(est, jax_np)
    frames = vision_frames()
    modes, statuses = drive_vision(est, StereoImage, frames, lambda vo: int(vo.status))
    return dict(rig=rig, est=est, poses=poses, modes=modes, statuses=statuses, frames=frames)


def test_vision_mission_matches_jax(vision_jax):
    ref = vision_jax
    est = port_of(vision_params(), ref["rig"])
    poses = record(est, torch_np)
    modes, statuses = drive_vision(est, tmeas.StereoImage, ref["frames"],
                                   lambda vo: int(vo.status))
    assert statuses == ref["statuses"]
    assert modes == ref["modes"]
    assert "VISION_AVAILABLE" in modes
    assert est._n_keyposes == ref["est"]._n_keyposes >= 4
    assert len(poses) == len(ref["poses"])
    trans, rot = pose_errors(poses, ref["poses"])
    assert trans < 1e-4 and rot < 1e-4, (trans, rot)
    # The landmark columns the host assigned are the same.
    assert est._lmk_columns == ref["est"]._lmk_columns
    # The window slid, and the trajectory moves +x at 0.1 m a frame (within
    # the 30% tests/test_vio_vision_e2e.py allows the JAX engine).
    assert est._n_keyposes == 6 and len(poses) > 6
    p = est.smoother_state().world_T_body[:3, 3]
    total = 0.1 * ((est._last_smoother_t_ns / 1e8) - 1.0)
    assert abs(p[0] - total) < 0.3 * total, p


@pytest.mark.parametrize("shared", ["Farmsim", "HIMB"])
def test_vio_loaders_match_jax(shared):
    """The port's VIO loaders build from the shipped node config what the
    JAX loaders build (compared through the converters)."""
    import dataclasses

    from ocean_perception_tpu.config.bindings import load_state_estimator_params as jload
    from ocean_perception_tpu.config.yaml_parser import YamlParser as JParser
    from ocean_perception_tpu_torch.config.bindings import load_state_estimator_params
    from ocean_perception_tpu_torch.config.yaml_parser import YamlParser

    repo = Path(__file__).resolve().parent.parent
    node = str(repo / "config/nodes/StateEstimatorNode.yaml")
    shared = str(repo / f"config/shared/{shared}.yaml")
    want = convert.state_estimator_params_from_jax(jload(JParser(node_path=node,
                                                                 shared_path=shared)))
    got = load_state_estimator_params(YamlParser(node_path=node, shared_path=shared))
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert got.smoother.window == 40 and got.smoother.max_landmarks == 16
