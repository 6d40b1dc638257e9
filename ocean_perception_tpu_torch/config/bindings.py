"""YAML -> pipeline-params bindings (port of ``ocean_perception_tpu.config.bindings``).

The reference's Params structs each own a LoadParams(parser) (params/README);
the port's compute-path params are frozen dataclasses, so the loaders live
here, mapping the reference's config keys (config/nodes/*.yaml +
config/shared/*.yaml) onto them, the VIO stack's included.
"""

from __future__ import annotations

from ..core.cameras import StereoCamera
from .yaml_parser import YamlParser


def load_detector_params(p: YamlParser):
    from ..tracking.detector import DetectorParams

    return DetectorParams(
        max_features=int(p.get("max_features_per_frame", 200)),
        quality_level=float(p.get("gftt_quality_level", 0.01)),
        block_size=int(p.get("gftt_block_size", 9)),
        use_harris=bool(p.get("gftt_use_harris_corner_detector", 0)),
        harris_k=float(p.get("gftt_k", 0.04)),
        min_distance=float(p.get("min_distance_btw_tracked_and_detected_features", 20.0)),
        subpixel=bool(p.get("subpixel_corners", 0)),
    )


def load_lk_params(p: YamlParser):
    from ..tracking.lk import LKParams

    return LKParams(
        window=int(p.get("klt_winsize", 21)),
        max_level=int(p.get("klt_max_level", 3)),
        max_iters=int(p.get("klt_maxiters", 30)),
        eps=float(p.get("klt_epsilon", 0.01)),
        bidirectional=True,
        bwd_levels=int(p.get("klt_bwd_levels", 0)),
        bwd_zncc_min=float(p.get("klt_bwd_zncc_min", 0.5)),
        zncc_gate=bool(p.get("klt_zncc_gate", 0)),
    )


def load_matcher_params(p: YamlParser):
    from ..tracking.stripe_match import StripeMatcherParams

    return StripeMatcherParams(
        templ_cols=int(p.get("templ_cols", 31)),
        templ_rows=int(p.get("templ_rows", 11)),
        max_disp=int(p.get("max_disp", 128)),
        max_matching_cost=float(p.get("max_matching_cost", 0.15)),
        subpixel=bool(p.get("subpixel_refinement", 0)),
    )


def load_tracker_params(p: YamlParser):
    from ..tracking.stereo_tracker import StereoTrackerParams

    kwargs = dict(
        stereo_max_depth=float(p.get("stereo_max_depth", 20.0)),
        stereo_min_depth=float(p.get("stereo_min_depth", 0.2)),
        retrack_frames_k=int(p.get("retrack_frames_k", 3)),
        trigger_keyframe_min_lmks=int(p.get("trigger_keyframe_min_lmks", 10)),
        trigger_keyframe_k=int(p.get("trigger_keyframe_k", 5)),
    )
    if p.has("FeatureDetector"):
        kwargs["detector"] = load_detector_params(p.subtree("FeatureDetector"))
        kwargs["capacity"] = kwargs["detector"].max_features
    if p.has("FeatureTracker"):
        kwargs["lk"] = load_lk_params(p.subtree("FeatureTracker"))
    if p.has("StereoMatcher"):
        kwargs["matcher"] = load_matcher_params(p.subtree("StereoMatcher"))
    return StereoTrackerParams(**kwargs)


def load_mesher_params(p: YamlParser):
    from ..mesher.object_mesher import ObjectMesherDeviceParams, ObjectMesherParams
    from ..tracking.stereo_tracker import StereoTrackerParams

    sub = p.subtree("ObjectMesher") if p.has("ObjectMesher") else p
    tracker = (
        load_tracker_params(sub.subtree("StereoTracker"))
        if sub.has("StereoTracker")
        else StereoTrackerParams()
    )
    device = ObjectMesherDeviceParams(
        foreground_ksize=int(sub.get("foreground_ksize", 15)),
        foreground_min_gradient=float(sub.get("foreground_min_gradient", 20.0)),
        edge_min_foreground_percent=float(sub.get("edge_min_foreground_percent", 0.9)),
        edge_max_depth_change=float(sub.get("edge_max_depth_change", 1.0)),
        min_obs_connect_edge=float(sub.get("min_obs_connect_edge", 7)),
        min_obs_disconnect_edge=float(sub.get("min_obs_disconnect_edge", 4)),
        tracker=tracker,
    )
    return ObjectMesherParams(
        device=device,
        vertex_min_obs=int(sub.get("vertex_min_obs", 3)),
    )


def load_rig(p: YamlParser, rig_id: str = "/shared/stereo_forward") -> StereoCamera:
    rig, _, _ = p.get_stereo_rig(rig_id)
    return rig


def load_imu_calibration(p: YamlParser):
    """From the shared rig file (imu0.noise_model)."""
    from ..vio.imu_preintegration import ImuCalibration

    node = "/shared/imu0/noise_model/"
    return ImuCalibration(
        accel_noise_sigma=float(p.get(node + "accel_noise_sigma", 0.001)),
        gyro_noise_sigma=float(p.get(node + "gyro_noise_sigma", 0.0004)),
        accel_bias_rw_sigma=float(p.get(node + "accel_bias_rw_sigma", 0.0001)),
        gyro_bias_rw_sigma=float(p.get(node + "gyro_bias_rw_sigma", 0.00004)),
    )


def load_odometry_params(p: YamlParser):
    """StereoFrontend LM keys (StateEstimatorLcm.yaml StereoFrontend block)."""
    from ..vio.odometry import OdometryParams

    return OdometryParams(
        max_iters=int(p.get("lm_max_iters", 20)),
        max_error_stdevs=float(p.get("lm_max_error_stdevs", 3.0)),
    )


def load_frontend_params(p: YamlParser):
    from ..vio.stereo_frontend import FrontendParams
    from ..tracking.stereo_tracker import StereoTrackerParams

    tracker = (
        load_tracker_params(p.subtree("StereoTracker"))
        if p.has("StereoTracker")
        else StereoTrackerParams()
    )
    return FrontendParams(
        tracker=tracker,
        odometry=load_odometry_params(p),
        pixel_sigma=float(p.get("sigma_tracked_point", 2.0)),
        min_features=int(p.get("min_features", 8)),
        max_avg_reprojection_error=float(p.get("max_avg_reprojection_error", 5.0)),
    )


def load_ekf_params(p: YamlParser):
    """StateEkf keys (StateEstimatorLcm.yaml StateEkf block; sigma_Q_uq is
    the reference's name for the orientation tangent noise)."""
    from ..vio.ekf import EkfParams

    return EkfParams(
        sigma_Q_t=float(p.get("sigma_Q_t", 1e-3)),
        sigma_Q_v=float(p.get("sigma_Q_v", 1e-2)),
        sigma_Q_a=float(p.get("sigma_Q_a", 1e-2)),
        sigma_Q_theta=float(p.get("sigma_Q_uq", p.get("sigma_Q_theta", 1e-3))),
        sigma_Q_w=float(p.get("sigma_Q_w", 1e-2)),
        sigma_R_imu_a=float(p.get("sigma_R_imu_a", 0.1)),
        sigma_R_imu_w=float(p.get("sigma_R_imu_w", 0.01)),
        sigma_R_depth=float(p.get("sigma_R_depth", 0.05)),
        sigma_R_range=float(p.get("sigma_R_range", 0.2)),
    )


def load_smoother_config(p: YamlParser):
    """FixedLagSmoother keys. mag field/scale come from the shared rig file
    when present (config/shared/*.yaml mag0 block)."""
    from ..vio.smoother import SmootherConfig

    mag_field = (0.0, 0.0, 1.0)
    mag_scale = float(p.get("mag_scale", 1.0))
    if p.has("/shared/mag0/local_field"):
        mag_field = tuple(float(v) for v in p.get("/shared/mag0/local_field"))
        mag_scale = float(p.get("/shared/mag0/scale_factor", mag_scale))
    return SmootherConfig(
        window=int(p.get("window", 12)),
        iterations=int(p.get("iterations", 6)),
        vo_rot_sigma=float(p.get("vo_rot_sigma", 0.02)),
        vo_trans_sigma=float(p.get("vo_trans_sigma", 0.05)),
        depth_sigma=float(p.get("depth_sigma", 0.05)),
        range_sigma=float(p.get("range_sigma", 0.3)),
        bias_rw_gyro_sigma=float(p.get("bias_rw_gyro_sigma", 1e-4)),
        bias_rw_accel_sigma=float(p.get("bias_rw_accel_sigma", 1e-3)),
        mag_sigma=float(p.get("mag_sigma", 0.1)),
        mag_scale=mag_scale,
        mag_local_field=mag_field,
        max_landmarks=int(p.get("max_landmarks", 0)),
        lmk_sigma_px=float(p.get("lmk_sigma_px", 2.0)),
        lmk_cauchy_k=float(p.get("lmk_cauchy_k", 3.0)),
        max_ranges=int(p.get("max_ranges", 4)),
    )


def load_state_estimator_params(p: YamlParser):
    """Build the COMPLETE StateEstimatorParams from the two-file YAML model:
    node config (config/nodes/StateEstimatorNode.yaml) + shared rig file
    (n_gravity, IMU noise model) — zero Python-side parameter literals.

    Reference parity: the params cascade at state_estimator.cpp:13-51 +
    config/auv/lcm_nodes/StateEstimatorLcm.yaml:33-60."""
    import numpy as np

    from ..vio.state_estimator import StateEstimatorParams

    sub = p.subtree("StateEstimator") if p.has("StateEstimator") else p
    kwargs = dict(
        ekf=load_ekf_params(sub.subtree("StateEkf")) if sub.has("StateEkf") else load_ekf_params(sub),
        imu_calib=load_imu_calibration(p),
        max_imu_per_keypose=int(sub.get("max_imu_per_keypose", 256)),
        min_sec_btw_keyposes=float(sub.get("min_sec_btw_keyposes", 0.5)),
        max_sec_btw_keyposes=float(sub.get("max_sec_btw_keyposes", 1.0)),
        depth_tolerance=float(sub.get("allowed_misalignment_depth", 0.1)),
        range_tolerance=float(sub.get("allowed_misalignment_range", 0.2)),
        soft_correction_pos=float(sub.get("soft_correction_pos", 0.05)),
        hard_correction_pos=float(sub.get("hard_correction_pos", 0.5)),
        ekf_history_sec=float(sub.get("ekf_history_sec", 10.0)),
        vo_align_tolerance=float(sub.get("vo_align_tolerance", 0.01)),
        filter_use_depth=bool(sub.get("filter_use_depth", 1)),
        filter_use_range=bool(sub.get("filter_use_range", 1)),
    )
    if sub.has("FixedLagSmoother"):
        kwargs["smoother"] = load_smoother_config(sub.subtree("FixedLagSmoother"))
    if sub.has("StereoFrontend"):
        kwargs["frontend"] = load_frontend_params(sub.subtree("StereoFrontend"))
    if p.has("/shared/n_gravity"):
        kwargs["n_gravity"] = np.asarray(p.get("/shared/n_gravity"), np.float64)
    # Sensor extrinsics from the shared rig file (reference param plumbing:
    # state_estimator.cpp:49, state_ekf.cpp:54-56, fixed_lag_smoother.cpp:
    # 62-68). Missing keys default to identity mounts.
    for key, yaml_id in (
        ("body_T_imu", "/shared/imu0/body_T_imu"),
        ("body_T_receiver", "/shared/aps0/body_T_receiver"),
        ("body_T_mag", "/shared/mag0/body_T_sensor"),
        ("body_T_cam", "/shared/stereo_forward/camera_left/body_T_cam"),
    ):
        if p.has(yaml_id):
            kwargs[key] = np.asarray(p.get(yaml_id), np.float64).reshape(4, 4)
    if p.has("/shared/mag0/sensor_bias"):
        kwargs["mag_sensor_bias"] = np.asarray(
            p.get("/shared/mag0/sensor_bias"), np.float64
        ).reshape(3)
    return StateEstimatorParams(**kwargs)
