"""Many cameras in one call on one card (port of the one-device forms of
``ocean_perception_tpu.parallel.sharded_pipeline``).

A farm-scale static sensor package sends N synchronized stereo cameras; the
N frames form a leading camera axis and one call runs the whole step for
all of them (``fabric/nodes/farm_perception_node.py`` dispatches
``multi_camera_frontend_step`` once a fleet frame). The JAX package spreads
that axis over a device mesh; these forms run it on one card, so they take
no mesh: every kernel launch carries all cameras.

Frames may arrive as uint8 and mono, one byte a pixel on the wire: the
cast to float32 / 255 and the broadcast to three channels run on the
device (:func:`prepare_frames`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.cameras import StereoCamera
from ..mesher.landmark_graph import LandmarkGraph
from ..mesher.object_mesher import ObjectMesherDeviceParams
from ..models.perception import (FullFrontendOutput, PerceptionConfig, PerceptionOutput,
                                 full_frontend_step, perception_step)
from ..ops.cuda import entry_device
from ..tracking.stereo_tracker import StereoTrackerState


class FleetStats(NamedTuple):
    mean_depth: torch.Tensor         # (N,) per-camera mean valid depth
    valid_fraction: torch.Tensor     # (N,) per-camera valid-depth fraction
    global_mean_depth: torch.Tensor  # scalar, weighted by each camera's valid count


def prepare_frames(frames, device) -> torch.Tensor:
    """(N, H, W, 3) float32 frames on ``device`` from (N, H, W[, 3]) frames:
    uint8 becomes float32 / 255 (a true division, as the JAX package's),
    mono is broadcast to three channels; both on the device."""
    x = torch.as_tensor(frames, device=device)
    if x.dtype == torch.uint8:
        x = x.float() / torch.full((), 255.0, device=x.device)
    x = x.float()
    if x.ndim == 3:
        x = x[..., None].expand(*x.shape, 3).contiguous()
    return x


def create_fleet_frontend_state(n_cams: int, mesher_params: Optional[ObjectMesherDeviceParams]
                                = None, image_shape: Optional[Tuple[int, int]] = None,
                                device: torch.device | str = "cuda"
                                ) -> Tuple[StereoTrackerState, LandmarkGraph]:
    """The tracker states and landmark graphs of n_cams cameras on a leading
    camera axis, on ``device`` (the card by default). ``image_shape`` is
    the tracker's (at mesher scale); None tracks without a pyramid ring."""
    mesher_params = mesher_params or ObjectMesherDeviceParams()
    device = entry_device(device)
    state = StereoTrackerState.create(mesher_params.tracker, image_shape=image_shape,
                                      device=device, batch=n_cams)
    graph = LandmarkGraph.create(mesher_params.tracker.capacity, device=device, batch=n_cams)
    return state, graph


def fleet_stats(depth: torch.Tensor) -> FleetStats:
    """Per-camera mean valid depth and valid fraction of (N, H, W) depths,
    and the fleet's mean weighted by valid counts, so that a blind camera
    (no valid pixel) does not drag it toward 0."""
    valid = depth > 0
    counts = valid.sum(dim=(-2, -1))
    mean_depth = torch.where(valid, depth, 0.0).sum(dim=(-2, -1)) / counts.clamp_min(1)
    valid_fraction = valid.float().mean(dim=(-2, -1))
    global_mean = (mean_depth * counts).sum() / counts.sum().clamp_min(1)
    return FleetStats(mean_depth, valid_fraction, global_mean)


def multi_camera_step(batch_left, batch_right, rig: StereoCamera, config: PerceptionConfig,
                      device: torch.device | str = "cuda"
                      ) -> Tuple[PerceptionOutput, FleetStats]:
    """The dense step for N cameras in one call on ``device``: (N, H, W[, 3])
    frames, float or uint8. Returns the (N, ...) PerceptionOutput and the
    FleetStats."""
    device = entry_device(device)
    out = perception_step(prepare_frames(batch_left, device),
                          prepare_frames(batch_right, device), rig, config, device)
    return out, fleet_stats(out.depth)


def multi_camera_frontend_step(tracker_states: StereoTrackerState, graphs: LandmarkGraph,
                               prev_grays, batch_left, batch_right, rig: StereoCamera,
                               config: PerceptionConfig,
                               mesher_params: Optional[ObjectMesherDeviceParams] = None,
                               mesher_scale: int = 1, device: torch.device | str = "cuda"
                               ) -> Tuple[FullFrontendOutput, torch.Tensor]:
    """The full frontend (enhance, disparity, tracking, landmark graph) for N
    cameras in one call on ``device``: (N, H, W[, 3]) frames, float or
    uint8; the states and graphs of :func:`create_fleet_frontend_state`;
    (N, H/s, W/s) prev_grays at ``mesher_scale`` s. Returns
    (FullFrontendOutput with a leading camera axis, cur_grays); thread the
    states, graphs and grays between frames as for one camera."""
    device = entry_device(device)
    return full_frontend_step(tracker_states, graphs, prev_grays,
                              prepare_frames(batch_left, device),
                              prepare_frames(batch_right, device), rig, config, mesher_params,
                              mesher_scale=mesher_scale, device=device)
