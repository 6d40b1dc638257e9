"""Fast guided filter (He & Sun, arXiv 1505.00996); port of ``ocean_perception_tpu.ops.guided_filter``.

The linear-model fit runs at 1/s resolution (nearest subsample, box radius
r/s); the (a, b) coefficients are upsampled bilinearly and applied at full
resolution: q = a*I + b. The guide is single-channel, (..., H, W); the
target is (..., H, W) or (..., H, W, C), all channels sharing the guide.
Leading axes are a batch of images, each filtered on its own.
"""

from __future__ import annotations

import torch

from .image import box_filter, resize


def fast_guided_filter(
    guide: torch.Tensor,
    target: torch.Tensor,
    radius: int,
    eps: float,
    subsample: int = 8,
) -> torch.Tensor:
    """Edge-preserving smoothing of ``target`` guided by ``guide``; ``radius``
    is the box radius at full resolution."""
    if target.ndim == guide.ndim + 1:  # colour: each channel as a gray image, C in front
        return fast_guided_filter(guide.unsqueeze(-3), target.movedim(-1, -3), radius, eps,
                                  subsample).movedim(-3, -1)
    H, W = guide.shape[-2], guide.shape[-1]
    h, w, r_small = guided_size(H, W, radius, subsample)

    I = resize(guide, (h, w), method="nearest").float()
    p = resize(target, (h, w), method="nearest").float()
    mean_a, mean_b = guided_coefficients(I, p, r_small, eps)
    return resize(mean_a, (H, W), method="linear") * guide + resize(mean_b, (H, W), method="linear")


def guided_size(H: int, W: int, radius: int, subsample: int):
    """(h, w, r_small): the low resolution of the fit and its box radius."""
    s = max(1, int(subsample))
    return max(2, H // s), max(2, W // s), max(1, int(round(radius / s)))


def guided_coefficients(I: torch.Tensor, p: torch.Tensor, r_small: int, eps: float):
    """The box-filtered linear-model coefficients (a, b) of the guided
    filter at low resolution, from the subsampled guide I and target p."""
    mean_I = box_filter(I, r_small)
    mean_p = box_filter(p, r_small)
    corr_I = box_filter(I * I, r_small)
    corr_Ip = box_filter(I * p, r_small)

    var_I = corr_I - mean_I * mean_I
    cov_Ip = corr_Ip - mean_I * mean_p

    a = cov_Ip / (var_I + eps)
    b = mean_p - a * mean_I
    return box_filter(a, r_small), box_filter(b, r_small)
