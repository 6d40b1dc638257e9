"""Many cameras in one call, and one frame across several devices (port
of ``ocean_perception_tpu.parallel.sharded_pipeline``).

A farm-scale static sensor package sends N synchronized stereo cameras; the
N frames form a leading camera axis and one call runs the whole step for
all of them (``fabric/nodes/farm_perception_node.py`` dispatches
``multi_camera_frontend_step`` once a fleet frame). Without a mesh the call
runs on one card, every kernel launch carrying all cameras. With a mesh
the camera axis is split over the mesh's ``cam`` devices, each running the
one-card call on its share; only the fleet's mean depth crosses devices.

:func:`sharded_perception_step` is the other axis, the latency one: ONE
frame's rows split over the mesh's ``strip`` devices, each computing its
block of the whole perception step (``stereo_sharded.py``, ``spatial.py``).

Frames may arrive as uint8 and mono, one byte a pixel on the wire: the
cast to float32 / 255 and the broadcast to three channels run on the
device (:func:`prepare_frames`).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..core.cameras import StereoCamera
from ..mesher.landmark_graph import LandmarkGraph
from ..mesher.object_mesher import ObjectMesherDeviceParams
from ..models.perception import (FullFrontendOutput, PerceptionConfig, PerceptionOutput,
                                 full_frontend_step, perception_step)
from ..ops.cuda import entry_device
from ..ops.image import nearest_source, pyr_down, resize, to_grayscale
from ..stereo.patchmatch import PatchMatchParams
from ..tracking.stereo_tracker import StereoTrackerState
from .mesh import Mesh, join_rows, join_tree, split_rows, split_tree
from .spatial import enhance_blocks
from .stereo_sharded import patchmatch_blocks


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


def _camera_stats(depth: torch.Tensor):
    """(mean valid depth, valid fraction, valid count) of each of (N, H, W) depths."""
    valid = depth > 0
    counts = valid.sum(dim=(-2, -1))
    mean_depth = torch.where(valid, depth, 0.0).sum(dim=(-2, -1)) / counts.clamp_min(1)
    return mean_depth, valid.float().mean(dim=(-2, -1)), counts


def _fleet(mean_depth: torch.Tensor, valid_fraction: torch.Tensor,
           counts: torch.Tensor) -> FleetStats:
    """The fleet's mean weighted by valid counts, so that a blind camera (no
    valid pixel) does not drag it toward 0."""
    global_mean = (mean_depth * counts).sum() / counts.sum().clamp_min(1)
    return FleetStats(mean_depth, valid_fraction, global_mean)


def fleet_stats(depth: torch.Tensor) -> FleetStats:
    """Per-camera mean valid depth and valid fraction of (N, H, W) depths,
    and the fleet's mean weighted by valid counts."""
    return _fleet(*_camera_stats(depth))


def _camera_devices(mesh: Mesh, axis: str, n_cams: int):
    devices = mesh.axis_devices(axis)
    if n_cams % len(devices):
        raise ValueError(f"{n_cams} cameras do not split evenly over {len(devices)} devices")
    return devices


def multi_camera_step(batch_left, batch_right, rig: StereoCamera, config: PerceptionConfig,
                      device: torch.device | str = "cuda", mesh: Optional[Mesh] = None,
                      axis: str = "cam") -> Tuple[PerceptionOutput, FleetStats]:
    """The dense step for N cameras: (N, H, W[, 3]) frames, float or uint8.
    Returns the (N, ...) PerceptionOutput and the FleetStats. Without a mesh
    one call on ``device``; with one, the cameras split evenly over
    ``mesh[axis]``, each device's share one call there, the outputs and the
    fleet's mean (reduced from the gathered per-camera means and counts)
    on the axis's first device."""
    if mesh is None:
        device = entry_device(device)
        out = perception_step(prepare_frames(batch_left, device),
                              prepare_frames(batch_right, device), rig, config, device)
        return out, fleet_stats(out.depth)
    devices = _camera_devices(mesh, axis, len(batch_left))
    outs, stats = [], []
    for l, r, d in zip(split_rows(torch.as_tensor(batch_left), devices),
                       split_rows(torch.as_tensor(batch_right), devices), devices):
        outs.append(perception_step(prepare_frames(l, d), prepare_frames(r, d), rig, config, d))
        stats.append(_camera_stats(outs[-1].depth))
    lead = devices[0]
    return join_tree(outs, lead), _fleet(*(join_rows(s, lead) for s in zip(*stats)))


def multi_camera_frontend_step(tracker_states: StereoTrackerState, graphs: LandmarkGraph,
                               prev_grays, batch_left, batch_right, rig: StereoCamera,
                               config: PerceptionConfig,
                               mesher_params: Optional[ObjectMesherDeviceParams] = None,
                               mesher_scale: int = 1, device: torch.device | str = "cuda",
                               mesh: Optional[Mesh] = None, axis: str = "cam"
                               ) -> Tuple[FullFrontendOutput, torch.Tensor]:
    """The full frontend (enhance, disparity, tracking, landmark graph) for N
    cameras: (N, H, W[, 3]) frames, float or uint8; the states and graphs
    of :func:`create_fleet_frontend_state`; (N, H/s, W/s) prev_grays at
    ``mesher_scale`` s. Returns (FullFrontendOutput with a leading camera
    axis, cur_grays); thread the states, graphs and grays between frames as
    for one camera. Without a mesh one call on ``device``; with one, the
    cameras (frames, states, graphs and grays) split evenly over
    ``mesh[axis]``, each device's share one call there, and the outputs
    joined on the axis's first device."""
    if mesh is None:
        device = entry_device(device)
        return full_frontend_step(tracker_states, graphs, prev_grays,
                                  prepare_frames(batch_left, device),
                                  prepare_frames(batch_right, device), rig, config, mesher_params,
                                  mesher_scale=mesher_scale, device=device)
    devices = _camera_devices(mesh, axis, len(batch_left))
    parts = zip(split_tree(tracker_states, devices), split_tree(graphs, devices),
                split_rows(torch.as_tensor(prev_grays), devices),
                split_rows(torch.as_tensor(batch_left), devices),
                split_rows(torch.as_tensor(batch_right), devices), devices)
    outs = [full_frontend_step(s, g, pg, prepare_frames(l, d), prepare_frames(r, d), rig, config,
                               mesher_params, mesher_scale=mesher_scale, device=d)
            for s, g, pg, l, r, d in parts]
    return join_tree(outs, devices[0])


def _pyr_down_blocks(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """pyr_down of an image split by rows into blocks of an even count:
    each block with 2 rows of its neighbours (reflect-101 mirrors of its own
    at the frame's edge), so its output rows are the whole image's."""
    out = []
    for i, x in enumerate(blocks):
        top = blocks[i - 1][-2:].to(x.device) if i > 0 else x[1:3].flip(0)
        bot = blocks[i + 1][:2].to(x.device) if i < len(blocks) - 1 else x[-3:-1].flip(0)
        out.append(pyr_down(torch.cat([top, x, bot]))[1:1 + x.shape[0] // 2])
    return out


@functools.lru_cache(maxsize=64)
def _upsample_index(h: int, H: int, row0: int, n: int, scale: int,
                    device: torch.device) -> torch.Tensor:
    """Local source rows of output rows [scale * row0, scale * (row0 + n))
    of the nearest upsampling of h rows to H, on ``device``."""
    return torch.as_tensor(nearest_source(h, H)[scale * row0:scale * (row0 + n)] - row0,
                           device=device)


def _upsample_rows(disp: torch.Tensor, row0: int, H: int, W: int, h: int,
                   scale: int) -> torch.Tensor:
    """Rows [scale * row0, scale * (row0 + n)) of the nearest upsampling to
    (H, W) of an h-row map, from its block of n rows at row0, times scale."""
    n = disp.shape[0]
    rows = _upsample_index(h, H, row0, n, scale, disp.device)
    return resize(disp.index_select(0, rows), (scale * n, W), method="nearest") * float(scale)


def sharded_perception_step(left_rgb, right_rgb, rig: StereoCamera, config: PerceptionConfig,
                            mesh: Mesh, axis: str = "strip") -> PerceptionOutput:
    """ONE frame's whole perception (gray, pyramid, PatchMatch, depth,
    enhancement) solved by every device of ``mesh[axis]``, each on a block
    of the frame's rows: the latency-axis complement of the camera split.
    (H, W, 3) images; outputs on the axis's first device.

    Each block runs the gray conversion and the pyramid on its rows, with
    2 rows of its neighbours a level; then ``patchmatch_blocks`` (the
    blocks as the column passes' strips), the nearest x``internal_scale``
    upsampling and the depth on its rows, and the enhancement with its
    global reductions gathered (``spatial.enhance_blocks``).

    Requires engine='patchmatch' and heights the mesh divides at every
    pyramid level. Semantics: disparity and depth equal ``perception_step``
    with ``chunks_y`` = the axis's size bit for bit, the enhancement its
    enhancement."""
    if config.engine != "patchmatch":
        raise ValueError("sharded_perception_step supports the patchmatch engine")
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if config.chunks_y not in (None, n):
        raise ValueError(f"the sharded step's column strips are its {n} blocks, got chunks_y="
                         f"{config.chunks_y}")
    left_rgb = torch.as_tensor(left_rgb, dtype=torch.float32)
    right_rgb = torch.as_tensor(right_rgb, dtype=torch.float32)
    H, W = left_rgb.shape[0], left_rgb.shape[1]
    scale = config.internal_scale
    if scale < 1 or (scale & (scale - 1)) != 0:
        raise ValueError(f"internal_scale must be a power of two, got {scale}")
    h = H // scale
    if h % n != 0:
        raise ValueError(f"internal height {h} must divide over {n} devices")
    if H % (scale * n) != 0:
        raise ValueError(f"height {H} must divide over {n} devices at every level of "
                         f"internal_scale {scale}")

    lefts, rights = split_rows(left_rgb, devices), split_rows(right_rgb, devices)
    gray_l = [to_grayscale(x) for x in lefts]
    gray_r = [to_grayscale(x) for x in rights]
    for _ in range(scale.bit_length() - 1):  # log2(scale) halvings
        gray_l, gray_r = _pyr_down_blocks(gray_l), _pyr_down_blocks(gray_r)

    d_small = config.max_disp // scale if scale > 1 else config.max_disp
    pm = PatchMatchParams(max_disp=d_small, chunks=config.chunks, right_wta=True,
                          volume_bf16=True)
    results = patchmatch_blocks(gray_l, gray_r, pm)

    disps, depths = [], []
    for i, res in enumerate(results):
        disp = res.left
        if scale > 1:
            disp = _upsample_rows(disp, i * (h // n), H, W, h, scale)
        depth = rig.disp_to_depth(disp)
        depths.append(torch.where(torch.isfinite(depth) & (depth <= config.max_depth), depth, 0.0))
        disps.append(disp)
    enhanced = enhance_blocks(lefts, depths, config.enhance)[0] if config.run_enhance else lefts
    lead = devices[0]
    return PerceptionOutput(disparity=join_rows(disps, lead), depth=join_rows(depths, lead),
                            enhanced_left=join_rows(enhanced, lead))
