"""Masked percentile threshold by bisection (port of ``ocean_perception_tpu.ops.histogram``).

Parity: imaging/backscatter.cpp FindDarkFast. Each iteration is one masked
count over the image; the loop stays on the device (no host reads).
"""

from __future__ import annotations

import torch

_IMAGE = (-2, -1)  # the axes of one image; leading axes are a batch


def bisect_threshold(lo: torch.Tensor, hi: torch.Tensor, count, total: torch.Tensor,
                     percentile: float, iters: int) -> torch.Tensor:
    """Bisection of [lo, hi] for t with count(t) / total ~= percentile, where
    count(t) counts the masked values below t."""
    denom = torch.clamp_min(total, 1.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = count(mid) / denom > percentile
        lo, hi = torch.where(too_many, lo, mid), torch.where(too_many, mid, hi)
    return 0.5 * (lo + hi)


def masked_percentile_threshold(
    values: torch.Tensor,
    mask: torch.Tensor,
    percentile: float,
    iters: int = 10,
) -> torch.Tensor:
    """Threshold t with frac(values[mask] < t) ~= percentile, for (..., H, W)
    values: one threshold an image, shape (...) (0-d for one image).

    ``mask`` is boolean; an empty mask yields a meaningless threshold, as in
    the reference. The counts are sums of 0/1 floats, exact in any order
    below 2^24 pixels."""
    mask_f = mask.to(values.dtype)
    big = torch.finfo(values.dtype).max
    lo = torch.where(mask, values, big).amin(dim=_IMAGE)
    hi = torch.where(mask, values, -big).amax(dim=_IMAGE)

    def count(mid):
        return torch.where(values < mid[..., None, None], mask_f, 0.0).sum(dim=_IMAGE)

    return bisect_threshold(lo, hi, count, mask_f.sum(dim=_IMAGE), percentile, iters)
