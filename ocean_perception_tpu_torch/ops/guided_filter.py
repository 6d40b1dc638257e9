"""Fast guided filter (He & Sun, arXiv 1505.00996); port of ``ocean_perception_tpu.ops.guided_filter``.

The linear-model fit runs at 1/s resolution (nearest subsample, box radius
r/s); the (a, b) coefficients are upsampled bilinearly and applied at full
resolution: q = a*I + b. The guide is single-channel; the target may be
(H, W) or (H, W, C), all channels sharing the guide.
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
    H, W = guide.shape[0], guide.shape[1]
    s = max(1, int(subsample))
    h, w = max(2, H // s), max(2, W // s)
    r_small = max(1, int(round(radius / s)))

    I = resize(guide, (h, w), method="nearest").float()
    p = resize(target, (h, w), method="nearest").float()

    multi = p.ndim == 3
    I_ = I[..., None] if multi else I

    mean_I = box_filter(I, r_small)
    mean_p = box_filter(p, r_small)
    corr_I = box_filter(I * I, r_small)
    corr_Ip = box_filter(I_ * p, r_small)

    var_I = corr_I - mean_I * mean_I
    mean_I_ = mean_I[..., None] if multi else mean_I
    var_I_ = var_I[..., None] if multi else var_I
    cov_Ip = corr_Ip - mean_I_ * mean_p

    a = cov_Ip / (var_I_ + eps)
    b = mean_p - a * mean_I_

    mean_a = resize(box_filter(a, r_small), (H, W), method="linear")
    mean_b = resize(box_filter(b, r_small), (H, W), method="linear")

    guide_full = guide[..., None] if multi else guide
    return mean_a * guide_full + mean_b
