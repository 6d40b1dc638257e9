"""Dense-stereo entry point (port of ``ocean_perception_tpu.stereo.api``):
one call, selectable engine."""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from .cost import cost_volume, right_cost_volume_from_left, sample_at_disparity, subpixel_refine
from .patchmatch import PatchMatchParams, patchmatch_disparity
from .sgm import SgmParams, sgm_disparity


class StereoEngine(str, enum.Enum):
    PATCHMATCH = "patchmatch"  # reference-semantics propagation engine
    SGM = "sgm"                # semi-global aggregation
    WTA = "wta"                # plain winner-take-all block matching


class DisparityResult(NamedTuple):
    left: torch.Tensor      # masked left disparity (0 = background/occluded)
    right: torch.Tensor     # right disparity
    left_raw: torch.Tensor  # left before occlusion masking


def wta_disparity(iml: torch.Tensor, imr: torch.Tensor, max_disp: int = 128,
                  alpha: float = 0.9, subpixel: bool = True) -> DisparityResult:
    """Winner-take-all over the reference cost on both sides, then an LR
    consistency check (1.5 px)."""
    C = cost_volume(iml.float(), imr.float(), max_disp, alpha)
    C_r = right_cost_volume_from_left(C)
    d_l = torch.argmin(C, dim=-1)
    d_r = torch.argmin(C_r, dim=-1)
    if subpixel:
        disp_l = subpixel_refine(C, d_l)
        disp_r = subpixel_refine(C_r, d_r)
    else:
        disp_l = d_l.float()
        disp_r = d_r.float()
    d_int = torch.round(disp_l).clamp(0, max_disp - 1).long()
    dr = sample_at_disparity(disp_r, d_int, max_disp)
    ok = (dr - disp_l).abs() <= 1.5
    return DisparityResult(torch.where(ok, disp_l, 0.0), disp_r, disp_l)


def estimate_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    engine: StereoEngine | str = StereoEngine.SGM,
    patchmatch_params: Optional[PatchMatchParams] = None,
    sgm_params: Optional[SgmParams] = None,
    max_disp: int = 128,
) -> DisparityResult:
    engine = StereoEngine(engine)
    if engine is StereoEngine.PATCHMATCH:
        r = patchmatch_disparity(left, right, patchmatch_params or PatchMatchParams(max_disp=max_disp))
        return DisparityResult(r.left, r.right, r.left_raw)
    if engine is StereoEngine.SGM:
        r = sgm_disparity(left, right, sgm_params or SgmParams(max_disp=max_disp))
        return DisparityResult(r.left, r.right, r.left_raw)
    return wta_disparity(left, right, max_disp=max_disp)
