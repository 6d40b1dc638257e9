"""YAML -> pipeline-params bindings (port of ``ocean_perception_tpu.config.bindings``).

The reference's Params structs each own a LoadParams(parser) (params/README);
the port's compute-path params are frozen dataclasses, so the loaders live
here, mapping the reference's config keys (config/nodes/*.yaml +
config/shared/*.yaml) onto them. The loaders of the VIO stack come with its
port.
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
