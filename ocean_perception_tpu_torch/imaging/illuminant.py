"""Local illuminant estimation (Sea-thru LSAC approximation); port of
``ocean_perception_tpu.imaging.illuminant``: a range-guided fast guided
filter of the descattered image, times the Akkaynak factor of 2."""

from __future__ import annotations

import torch

from ..ops.guided_filter import fast_guided_filter


def estimate_illuminant_range_guided(
    descattered: torch.Tensor,
    range_img: torch.Tensor,
    radius: int,
    eps: float = 0.01,
    subsample: int = 8,
) -> torch.Tensor:
    """il = 2 * GuidedFilter(range -> D)  (illuminant.cpp:24-34)."""
    return 2.0 * fast_guided_filter(range_img, descattered, radius, eps, subsample)
