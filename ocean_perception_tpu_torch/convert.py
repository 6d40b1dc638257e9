"""Bridge from the JAX package's parameter objects to the port's.

This system has no learned weights: its "weights" are the configuration
dataclasses and the stereo rig. Its carried state is the 12-vector
attenuation guess and, for the front end, the tracker state (track table,
frame counters, pyramid ring) and the landmark graph. The functions here
read the JAX objects' fields by attribute and ``np.asarray`` (duck-typed, so
this module imports no JAX) and return the port's frozen dataclasses and
tensors. Fields that only choose between TPU code paths that compute the
same result (scan unrolls, the Pallas routes) have no counterpart; the one
such choice the port also offers, the strip-volume build, carries over.

The state converters keep whatever leading axes the arrays have: a fleet's
state (``parallel.sharded_pipeline.create_fleet_frontend_state``, a leading
camera axis on every leaf) converts as one camera's does.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cameras import PinholeCamera, StereoCamera
from .imaging.enhance import EnhanceParams
from .mesher.landmark_graph import LandmarkGraph
from .mesher.object_mesher import ObjectMesherDeviceParams
from .models.perception import PerceptionConfig
from .stereo.patchmatch import PatchMatchParams
from .stereo.sgm import SgmParams
from .tracking.detector import DetectorParams
from .tracking.lk import LKParams
from .tracking.stereo_tracker import StereoTrackerParams, StereoTrackerState
from .tracking.stripe_match import StripeMatcherParams
from .tracking.tracks import TrackTable


def _scalar(v) -> float:
    return float(np.asarray(v, dtype=np.float32))


def pinhole_camera_from_jax(cam) -> PinholeCamera:
    return PinholeCamera.create(
        _scalar(cam.fx), _scalar(cam.fy), _scalar(cam.cx), _scalar(cam.cy),
        int(cam.height), int(cam.width),
    )


def stereo_camera_from_jax(rig) -> StereoCamera:
    return StereoCamera.create(
        pinhole_camera_from_jax(rig.left), pinhole_camera_from_jax(rig.right),
        _scalar(rig.baseline),
    )


def enhance_params_from_jax(params) -> EnhanceParams:
    return EnhanceParams(**{f: getattr(params, f) for f in EnhanceParams.__dataclass_fields__})


def perception_config_from_jax(cfg) -> PerceptionConfig:
    """The port's config for a JAX ``PerceptionConfig``. ``use_pallas_build``
    becomes ``use_strip_volumes`` (None, JAX's AUTO, resolves to False);
    ``scan_unroll`` and ``use_pallas_fused`` are dropped: they choose
    between TPU paths that compute the same match."""
    return PerceptionConfig(
        engine=str(cfg.engine),
        max_disp=int(cfg.max_disp),
        internal_scale=int(cfg.internal_scale),
        max_depth=float(cfg.max_depth),
        enhance=enhance_params_from_jax(cfg.enhance),
        run_enhance=bool(cfg.run_enhance),
        chunks=int(cfg.chunks),
        use_strip_volumes=bool(cfg.use_pallas_build),
    )


def patchmatch_params_from_jax(params) -> PatchMatchParams:
    """``use_pallas_build`` becomes ``use_strip_volumes`` (None resolves to
    False); ``scan_unroll``, ``fused_inner_loop`` and the other
    ``use_pallas_*`` routes are dropped: they compute the same match."""
    kw = {f: getattr(params, f) for f in PatchMatchParams.__dataclass_fields__
          if f != "use_strip_volumes"}
    return PatchMatchParams(**kw, use_strip_volumes=bool(params.use_pallas_build))


def sgm_params_from_jax(params) -> SgmParams:
    """``scan_unroll`` is dropped: it never changes the result."""
    return SgmParams(**{f: getattr(params, f) for f in SgmParams.__dataclass_fields__})


def beta_guess_from_numpy(beta, device=None) -> torch.Tensor:
    """The 12-vector attenuation state [a, b, c, d] (RGB) as a float32 tensor."""
    arr = np.asarray(beta, dtype=np.float32)
    if arr.shape != (12,):
        raise ValueError(f"beta_D guess must have shape (12,), got {arr.shape}")
    return torch.as_tensor(arr, device=device)


def _fields(cls, obj, **nested):
    """The port's dataclass ``cls`` from the same-named fields of ``obj``."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        kw[f.name] = nested[f.name](v) if f.name in nested else type(f.default)(v)
    return cls(**kw)


def detector_params_from_jax(params) -> DetectorParams:
    return _fields(DetectorParams, params)


def lk_params_from_jax(params) -> LKParams:
    """The TPU scheduling knobs (fused_lk, pallas_iters, corr_iters,
    corr_impl, batched_windows, early_exit, exit_unroll, iter_unroll) are
    dropped: they choose between paths that compute the same walk."""
    return _fields(LKParams, params)


def stripe_matcher_params_from_jax(params) -> StripeMatcherParams:
    """``impl`` (sliced or batched) is dropped: the two agree."""
    return _fields(StripeMatcherParams, params)


def stereo_tracker_params_from_jax(params) -> StereoTrackerParams:
    return _fields(StereoTrackerParams, params, detector=detector_params_from_jax,
                   lk=lk_params_from_jax, matcher=stripe_matcher_params_from_jax)


def object_mesher_device_params_from_jax(params) -> ObjectMesherDeviceParams:
    """``edge_gate_impl`` is dropped: the port gathers, which equals the
    one-hot form on every output."""
    return _fields(ObjectMesherDeviceParams, params, tracker=stereo_tracker_params_from_jax)


def _tensor(v, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def track_table_from_jax(table, device=None) -> TrackTable:
    f32, i32 = torch.float32, torch.int32
    return TrackTable(
        ids=_tensor(table.ids, i32, device), pixels=_tensor(table.pixels, f32, device),
        disparities=_tensor(table.disparities, f32, device),
        kf_pixels=_tensor(table.kf_pixels, f32, device),
        kf_disparities=_tensor(table.kf_disparities, f32, device),
        ages=_tensor(table.ages, i32, device), missed=_tensor(table.missed, i32, device))


def stereo_tracker_state_from_jax(state, device=None) -> StereoTrackerState:
    """The tracker state, with its pyramid ring when it has one."""
    ring = None if state.ring is None else tuple(
        _tensor(level, torch.float32, device) for level in state.ring)
    return StereoTrackerState(
        table=track_table_from_jax(state.table, device),
        frame_idx=_tensor(state.frame_idx, torch.int32, device),
        last_kf_frame=_tensor(state.last_kf_frame, torch.int32, device),
        next_lmk_id=_tensor(state.next_lmk_id, torch.int32, device),
        ring=ring)


def landmark_graph_from_jax(graph, device=None) -> LandmarkGraph:
    return LandmarkGraph(weights=_tensor(graph.weights, torch.float32, device),
                         ids=_tensor(graph.ids, torch.int32, device))
