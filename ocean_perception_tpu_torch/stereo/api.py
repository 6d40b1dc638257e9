"""Dense-stereo entry point (port of ``ocean_perception_tpu.stereo.api``).

Only the PatchMatch engine is ported; SGM and WTA come with slice 3.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from .patchmatch import PatchMatchParams, patchmatch_disparity


class StereoEngine(str, enum.Enum):
    PATCHMATCH = "patchmatch"
    SGM = "sgm"
    WTA = "wta"


class DisparityResult(NamedTuple):
    left: torch.Tensor      # masked left disparity (0 = background/occluded)
    right: torch.Tensor     # right disparity
    left_raw: torch.Tensor  # left before occlusion masking


def estimate_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    engine: StereoEngine | str = StereoEngine.SGM,
    patchmatch_params: Optional[PatchMatchParams] = None,
    max_disp: int = 128,
) -> DisparityResult:
    engine = StereoEngine(engine)
    if engine is not StereoEngine.PATCHMATCH:
        raise NotImplementedError(
            f"stereo engine {engine.value!r} is not ported yet: it comes with "
            "slice 3 (stereo engines); only 'patchmatch' runs")
    p = patchmatch_params or PatchMatchParams(max_disp=max_disp)
    r = patchmatch_disparity(left, right, p)
    return DisparityResult(r.left, r.right, r.left_raw)
