"""Sparse stereo matching along epipolar stripes, batched over keypoints
(port of ``ocean_perception_tpu.tracking.stripe_match``).

Reference: ft/StereoMatcher (stereo_matcher.cpp:22-134). For each left
keypoint a (templ_rows x templ_cols) template is matched with
TM_SQDIFF_NORMED against a right-image stripe reaching max_disp to the left,
two rows taller than the template (rectification slack). The best match must
beat max_matching_cost and lie left of the keypoint.

One implementation, with the JAX package's per-point ("sliced") semantics:
all K windows come out of one gather, and the correlation at every offset
accumulates over the template's columns.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.image import sqrt_f32
from ..ops.windows import extract_windows


@dataclasses.dataclass(frozen=True)
class StripeMatcherParams:
    templ_cols: int = 31
    templ_rows: int = 11
    max_disp: int = 128
    max_matching_cost: float = 0.15
    subpixel: bool = False


class StripeMatches(NamedTuple):
    disparity: torch.Tensor  # ([B,] K) float32; -1 = no match
    cost: torch.Tensor       # ([B,] K) best normalized SSD


def match_rectified(left: torch.Tensor, right: torch.Tensor, points: torch.Tensor,
                    valid: torch.Tensor, p: StripeMatcherParams = StripeMatcherParams()) -> StripeMatches:
    """(K,) matches of K points (K, 2) of (H, W) images; a batch, (*batch,
    H, W) images and (*batch, K, 2) points, gives (*batch, K), each camera's
    points matched in its own images."""
    H, W = left.shape[-2], left.shape[-1]
    tc, tr = p.templ_cols, p.templ_rows
    rx, ry = tc // 2, tr // 2
    stripe_h = tr + 2
    stripe_w = p.max_disp + tc
    n_offsets = p.max_disp + 1

    x = torch.round(points[..., 0]).long()
    y = torch.round(points[..., 1]).long()
    ty = (y - ry).clamp(0, H - tr)
    tx = (x - rx).clamp(0, W - tc)
    templ = extract_windows(left, ty, tx, tr, size_x=tc).reshape(-1, tr, tc)
    sy = (y - ry - 1).clamp(0, H - stripe_h)
    sx = (x - p.max_disp - rx).clamp(0, W - stripe_w)
    stripe = extract_windows(right, sy, sx, stripe_h, size_x=stripe_w)
    stripe = stripe.reshape(-1, stripe_h, stripe_w)

    # SQDIFF_NORMED = (sum t^2 + sum s^2 - 2 sum t*s) / sqrt(sum t^2 * sum s^2).
    t2 = (templ * templ).sum(dim=(1, 2))[:, None]
    costs = []
    for dy in range(stripe_h - tr + 1):
        rows = stripe[:, dy:dy + tr, :]
        cum = torch.nn.functional.pad(torch.cumsum(rows * rows, dim=2), (1, 0))
        s2 = (cum[:, :, tc:] - cum[:, :, :-tc]).sum(dim=1)[:, :n_offsets]
        corr = torch.zeros_like(s2)
        for c in range(tc):
            corr = corr + (templ[:, :, c:c + 1] * rows[:, :, c:c + n_offsets]).sum(dim=1)
        ssd = t2 + s2 - 2.0 * corr
        costs.append(ssd / sqrt_f32((t2 * s2).clamp_min(1e-12)))
    cost2d = torch.stack(costs, dim=1)                                # (K, n_dy, U)
    flat = cost2d.reshape(cost2d.shape[0], -1)
    best = flat.argmin(dim=1)                                         # first minimum
    best_cost = flat.gather(1, best[:, None])[:, 0]
    best_u = (best % n_offsets).float()

    if p.subpixel:
        dyi = best // n_offsets
        u = best % n_offsets
        ar = torch.arange(cost2d.shape[0], device=left.device)
        c0 = cost2d[ar, dyi, (u - 1).clamp(0, n_offsets - 1)]
        c1 = cost2d[ar, dyi, u]
        c2 = cost2d[ar, dyi, (u + 1).clamp(0, n_offsets - 1)]
        denom = c0 - 2 * c1 + c2
        big = denom.abs() > 1e-9
        off = torch.where(big, 0.5 * (c0 - c2) / torch.where(big, denom, 1.0), 0.0)
        best_u = best_u + off.clamp(-0.5, 0.5)

    disp = tx.reshape(-1).float() - (sx.reshape(-1).float() + best_u)
    ok = (best_cost < p.max_matching_cost) & (disp >= 0.0) & valid.reshape(-1)
    shape = points.shape[:-1]
    return StripeMatches(disparity=torch.where(ok, disp, -1.0).reshape(shape),
                         cost=best_cost.reshape(shape))
