"""The perception step: stereo pair -> disparity -> depth -> enhanced image
(port of ``ocean_perception_tpu.models.perception``).

Operating point parity with the reference PatchMatch benchmark:
``internal_scale=2`` solves disparity at half resolution with max_disp/2
planes, then upsamples (nearest) and doubles it. Everything runs on the
inputs' device; on a CUDA device the cost volume and the PatchMatch match
run on the hand-written kernels in ``csrc/``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.cameras import StereoCamera
from ..imaging.enhance import EnhanceParams, enhance_underwater
from ..ops.image import pyr_down, resize, to_grayscale
from ..stereo.api import StereoEngine, estimate_disparity
from ..stereo.patchmatch import PatchMatchParams


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


class PerceptionOutput(NamedTuple):
    disparity: torch.Tensor      # (H, W) full-res left disparity, 0 = invalid
    depth: torch.Tensor          # (H, W) meters, 0 = invalid/background
    enhanced_left: torch.Tensor  # (H, W, 3) enhanced left RGB


def perception_step(
    left_rgb: torch.Tensor,
    right_rgb: torch.Tensor,
    rig: StereoCamera,
    config: PerceptionConfig = PerceptionConfig(),
) -> PerceptionOutput:
    """One frame through the dense-vision stack, on the inputs' device."""
    if config.engine != "patchmatch":
        raise NotImplementedError(
            f"engine {config.engine!r} is not ported yet: it comes with slice 3 "
            "(stereo engines); only 'patchmatch' runs")
    left_rgb = torch.as_tensor(left_rgb).float()
    right_rgb = torch.as_tensor(right_rgb).float()
    H, W = left_rgb.shape[0], left_rgb.shape[1]

    gray_l = to_grayscale(left_rgb)
    gray_r = to_grayscale(right_rgb)

    scale = config.internal_scale
    if scale < 1 or scale & (scale - 1):
        raise ValueError(f"internal_scale must be a power of two, got {scale}")
    for _ in range(scale.bit_length() - 1):
        gray_l = pyr_down(gray_l)
        gray_r = pyr_down(gray_r)

    d_small = config.max_disp // scale if scale > 1 else config.max_disp
    pm = PatchMatchParams(max_disp=d_small, chunks=config.chunks, right_wta=True, volume_bf16=True)
    result = estimate_disparity(gray_l, gray_r, engine=StereoEngine.PATCHMATCH, patchmatch_params=pm)

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
