"""The perception step: stereo pair -> disparity -> depth -> enhanced image,
and the full front end, which adds tracked features -> landmark-graph
clusters (port of ``ocean_perception_tpu.models.perception``).

Operating point parity with the reference PatchMatch benchmark:
``internal_scale=2`` solves disparity at half resolution with max_disp/2
planes, then upsamples (nearest) and doubles it. Both entry points run on
the card unless the caller passes ``device="cpu"``: on a CUDA device the
cost volume and the PatchMatch match run on the hand-written kernels in
``csrc/``, and so does the LK tracker; on the CPU their plain twins run.

``perception_step`` and ``full_frontend_step`` also take a batch of
cameras, (B, H, W, 3) images, the counterpart of ``jax.vmap`` of the
reference step: every kernel launch and every plain op carries all B
cameras, so a batched call launches about as many kernels as one camera's
call.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

import torch

from ..core.cameras import StereoCamera
from ..imaging.enhance import EnhanceParams, enhance_underwater
from ..ops.cuda import entry_device
from ..ops.image import pyr_down, resize, to_grayscale
from ..stereo.api import StereoEngine, estimate_disparity
from ..stereo.patchmatch import PatchMatchParams
from ..stereo.sgm import SgmParams


@dataclasses.dataclass(frozen=True)
class PerceptionConfig:
    engine: str = "patchmatch"
    max_disp: int = 128
    internal_scale: int = 2
    max_depth: float = 20.0
    enhance: EnhanceParams = EnhanceParams()
    run_enhance: bool = True
    # PatchMatch strip count (the reference's own decomposition).
    chunks: int = 16
    # Strips of PatchMatch's column passes; None = ``chunks``. The sharded
    # step (parallel/sharded_pipeline.py) equals this step with chunks_y = N.
    chunks_y: Optional[int] = None
    # PatchMatch over the two strip layouts built straight from the images
    # (kernel build_volumes and the *_strip match kernels); bit-identical.
    use_strip_volumes: bool = False


class PerceptionOutput(NamedTuple):
    disparity: torch.Tensor      # ([B,] H, W) full-res left disparity, 0 = invalid
    depth: torch.Tensor          # ([B,] H, W) meters, 0 = invalid/background
    enhanced_left: torch.Tensor  # ([B,] H, W, 3) enhanced left RGB


def perception_step(
    left_rgb: torch.Tensor,
    right_rgb: torch.Tensor,
    rig: StereoCamera,
    config: PerceptionConfig = PerceptionConfig(),
    device: torch.device | str = "cuda",
) -> PerceptionOutput:
    """One frame through the dense-vision stack, on ``device``: (H, W, 3)
    images, or (B, H, W, 3) for one frame of each of B cameras, with
    outputs of the same leading axis."""
    if config.engine not in ("patchmatch", "sgm", "wta"):
        raise ValueError(f"unknown stereo engine {config.engine!r}")
    device = entry_device(device)
    left_rgb = torch.as_tensor(left_rgb, dtype=torch.float32, device=device)
    right_rgb = torch.as_tensor(right_rgb, dtype=torch.float32, device=device)
    if left_rgb.ndim not in (3, 4) or left_rgb.shape[-1] != 3 \
            or right_rgb.shape != left_rgb.shape:
        raise ValueError(f"need two ([B,] H, W, 3) images of one shape, got "
                         f"{tuple(left_rgb.shape)} and {tuple(right_rgb.shape)}")
    H, W = left_rgb.shape[-3], left_rgb.shape[-2]

    gray_l = to_grayscale(left_rgb)
    gray_r = to_grayscale(right_rgb)

    scale = config.internal_scale
    if scale < 1 or scale & (scale - 1):
        raise ValueError(f"internal_scale must be a power of two, got {scale}")
    for _ in range(scale.bit_length() - 1):
        gray_l = pyr_down(gray_l)
        gray_r = pyr_down(gray_r)

    d_small = config.max_disp // scale if scale > 1 else config.max_disp
    if config.engine == "patchmatch":
        pm = PatchMatchParams(max_disp=d_small, chunks=config.chunks, chunks_y=config.chunks_y,
                              right_wta=True, volume_bf16=True,
                              use_strip_volumes=config.use_strip_volumes)
        result = estimate_disparity(gray_l, gray_r, engine=StereoEngine.PATCHMATCH,
                                    patchmatch_params=pm)
    elif config.engine == "sgm":
        result = estimate_disparity(gray_l, gray_r, engine=StereoEngine.SGM,
                                    sgm_params=SgmParams(max_disp=d_small))
    else:
        result = estimate_disparity(gray_l, gray_r, engine=StereoEngine.WTA, max_disp=d_small)

    disp = result.left
    if scale > 1:
        disp = resize(disp, (H, W), method="nearest") * float(scale)

    depth = rig.disp_to_depth(disp)
    depth = torch.where(torch.isfinite(depth) & (depth <= config.max_depth), depth, 0.0)

    if config.run_enhance:
        enhanced, _ = enhance_underwater(left_rgb, depth, config.enhance)
    else:
        enhanced = left_rgb
    return PerceptionOutput(disparity=disp, depth=depth, enhanced_left=enhanced)


class FullFrontendOutput(NamedTuple):
    perception: PerceptionOutput
    mesher: "object"         # mesher.object_mesher.MesherDeviceOutput
    tracker_state: "object"  # tracking.stereo_tracker.StereoTrackerState
    graph: "object"          # mesher.landmark_graph.LandmarkGraph


def full_frontend_step(
    tracker_state,
    graph,
    prev_left_gray: torch.Tensor,
    left_rgb: torch.Tensor,
    right_rgb: torch.Tensor,
    rig: StereoCamera,
    config: PerceptionConfig = PerceptionConfig(),
    mesher_params=None,
    mesher_scale: int = 1,
    device: torch.device | str = "cuda",
) -> Tuple[FullFrontendOutput, torch.Tensor]:
    """camera -> enhanced -> disparity -> tracked features -> landmark-graph
    clusters for one frame, on ``device`` (the state is moved there too),
    with no branch on a device value. The host threads the state between
    frames and runs the per-cluster Delaunay
    (``mesher.object_mesher.build_meshes``).

    A batch of B cameras: (B, H, W, 3) images, (B, H, W) ``prev_left_gray``
    and the batched state and graph (``StereoTrackerState.create(...,
    batch=B)``, ``LandmarkGraph.create(..., batch=B)``); every output has
    the same leading axis.

    ``mesher_scale`` (a power of two) runs the tracking/mesher half on
    pyr_down'ed grays (the reference mesher node's ``mesher_input_height``).
    Its pixels and disparities are then in downscaled coordinates, and the
    tracker state must be created with the downscaled image shape; the
    perception half always runs at full resolution.

    Returns (FullFrontendOutput, cur_left_gray): feed cur_left_gray back as
    prev_left_gray next frame (it is at mesher scale).
    """
    from ..mesher.object_mesher import ObjectMesherDeviceParams, mesher_device_step

    if mesher_scale < 1 or (mesher_scale & (mesher_scale - 1)):
        raise ValueError(f"mesher_scale must be a power of two, got {mesher_scale}")
    mesher_params = mesher_params or ObjectMesherDeviceParams()
    device = entry_device(device)
    left_rgb = torch.as_tensor(left_rgb, dtype=torch.float32, device=device)
    right_rgb = torch.as_tensor(right_rgb, dtype=torch.float32, device=device)
    prev_left_gray = torch.as_tensor(prev_left_gray, dtype=torch.float32, device=device)
    batch = tuple(left_rgb.shape[:-3])
    if tuple(tracker_state.table.ids.shape[:-1]) != batch \
            or tuple(prev_left_gray.shape[:-2]) != batch:
        raise ValueError(f"images of batch {batch} need a tracker state and a previous gray of "
                         f"that batch, got {tuple(tracker_state.table.ids.shape[:-1])} and "
                         f"{tuple(prev_left_gray.shape[:-2])}")
    tracker_state, graph = tracker_state.to(device), graph.to(device)
    out = perception_step(left_rgb, right_rgb, rig, config, device)
    gray_l = to_grayscale(left_rgb)
    gray_r = to_grayscale(right_rgb)
    for _ in range(mesher_scale.bit_length() - 1):
        gray_l = pyr_down(gray_l)
        gray_r = pyr_down(gray_r)
    # fx scales with the image; disparities are measured at 1/s resolution.
    fxb = np.float32(rig.fx) * np.float32(rig.baseline) / np.float32(mesher_scale)
    fxb = torch.full((), float(fxb), dtype=torch.float32, device=gray_l.device)
    new_state, new_graph, mesh_out = mesher_device_step(
        tracker_state, graph, prev_left_gray, gray_l, gray_r, fxb, mesher_params)
    return FullFrontendOutput(perception=out, mesher=mesh_out, tracker_state=new_state,
                              graph=new_graph), gray_l
