"""Feature detection: Shi-Tomasi / Harris corners with a spatial spread
(port of ``ocean_perception_tpu.tracking.detector``).

Reference: ft/FeatureDetector (feature_detector.cpp:88-123), GFTT with a
quality level relative to the best corner and a mask around tracked points.
The reference's RangeTree ANMS is the JAX package's grid-bucketed selection:
the best corner per cell, then a global top-K.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.image import box_filter, dilate, sobel_x, sobel_y, sqrt_f32
from ..ops.interp import gather_pixels


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    max_features: int = 200
    quality_level: float = 0.01
    block_size: int = 9
    use_harris: bool = False
    harris_k: float = 0.04
    min_distance: float = 20.0
    border: int = 8
    # Quadratic peak fit on the score map (the reference's cornerSubPix option).
    subpixel: bool = False


class Detections(NamedTuple):
    points: torch.Tensor  # ([B,] K, 2) float32 (x, y)
    scores: torch.Tensor  # ([B,] K)
    valid: torch.Tensor   # ([B,] K) bool


def corner_score(image: torch.Tensor, params: DetectorParams) -> torch.Tensor:
    """Dense GFTT score: the min eigenvalue (or Harris response) of the
    structure tensor box-summed over block_size."""
    gx = sobel_x(image)
    gy = sobel_y(image)
    r = params.block_size // 2
    a = box_filter(gx * gx, r)
    b = box_filter(gx * gy, r)
    c = box_filter(gy * gy, r)
    if params.use_harris:
        tr = a + c
        return (a * c - b * b) - params.harris_k * tr * tr
    d = a - c
    return 0.5 * ((a + c) - sqrt_f32(d * d + 4.0 * b * b))


def mask_around_points(shape: Tuple[int, int], points: torch.Tensor, valid: torch.Tensor,
                       radius: float) -> torch.Tensor:
    """(H, W) bool, True within ``radius`` (a square) of any valid point:
    a max-splat of the points, then a square dilation. Points (*batch, K, 2)
    give (*batch, H, W), each camera its own points."""
    H, W = shape
    batch = points.shape[:-2]
    xs = torch.round(points[..., 0]).clamp(0, W - 1).long()
    ys = torch.round(points[..., 1]).clamp(0, H - 1).long()
    index = ys * W + xs
    if batch:
        cams = torch.arange(math.prod(batch), device=points.device).reshape(*batch, 1)
        index = index + cams * (H * W)
    splat = torch.zeros(math.prod(batch) * H * W, dtype=torch.float32, device=points.device)
    splat.scatter_reduce_(0, index.reshape(-1), valid.float().reshape(-1), reduce="amax")
    return dilate(splat.reshape(*batch, H, W), 2 * int(radius) + 1) > 0.5


def detect_features(image: torch.Tensor, params: DetectorParams = DetectorParams(),
                    exclude_points: Optional[torch.Tensor] = None,
                    exclude_valid: Optional[torch.Tensor] = None) -> Detections:
    """Top-K spatially spread corners; static output shape (K slots + valid).
    An (*batch, H, W) image gives (*batch, K) detections, each camera's
    corners ranked against its own best."""
    H, W = image.shape[-2], image.shape[-1]
    batch = image.shape[:-2]
    K = params.max_features
    dev = image.device
    score = corner_score(image, params)

    # 3x3 non-max suppression, then the quality threshold relative to the best.
    score = torch.where(score >= dilate(score, 3), score, 0.0)
    best = score.amax(dim=(-2, -1), keepdim=True)
    score = torch.where(score >= params.quality_level * best, score, 0.0)

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    b = params.border
    interior = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
    score = torch.where(interior, score, 0.0)
    if exclude_points is not None:
        excl = mask_around_points((H, W), exclude_points, exclude_valid, params.min_distance)
        score = torch.where(excl, 0.0, score)

    # Best corner per cell of about min_distance (argmax takes the first).
    cell = max(4, int(params.min_distance))
    Hc, Wc = -(-H // cell), -(-W // cell)
    padded = torch.nn.functional.pad(score, (0, Wc * cell - W, 0, Hc * cell - H))
    cells = padded.reshape(*batch, Hc, cell, Wc, cell).transpose(-3, -2)
    cells = cells.reshape(*batch, Hc * Wc, cell * cell)
    cell_best = cells.amax(dim=-1)
    cell_arg = cells.argmax(dim=-1)
    n = torch.arange(Hc * Wc, device=dev)
    cy = (n // Wc) * cell + cell_arg // cell
    cx = (n % Wc) * cell + cell_arg % cell

    # lax.top_k: descending, ties in index order; a stable sort gives that.
    k_eff = min(K, Hc * Wc)
    order = torch.sort(cell_best, dim=-1, descending=True, stable=True).indices[..., :k_eff]
    top_scores = cell_best.gather(-1, order)
    iy, ix = cy.gather(-1, order), cx.gather(-1, order)
    pts = torch.stack([ix.float(), iy.float()], dim=-1)
    valid = top_scores > 0.0

    if params.subpixel:
        n_img = math.prod(batch)
        ge = torch.nn.functional.pad(corner_score(image, params).reshape(n_img, 1, H, W),
                                     (1, 1, 1, 1), mode="replicate")
        ge = ge.reshape(*batch, H + 2, W + 2)

        def at(y, x):
            return gather_pixels(ge, y, x, len(batch))

        c = at(iy + 1, ix + 1)
        sx0, sx1 = at(iy + 1, ix), at(iy + 1, ix + 2)
        sy0, sy1 = at(iy, ix + 1), at(iy + 2, ix + 1)
        denx = sx0 + sx1 - 2.0 * c
        deny = sy0 + sy1 - 2.0 * c
        dx = torch.where(denx.abs() > 1e-12, 0.5 * (sx0 - sx1) / denx, 0.0)
        dy = torch.where(deny.abs() > 1e-12, 0.5 * (sy0 - sy1) / deny, 0.0)
        offs = torch.stack([dx.clamp(-0.5, 0.5), dy.clamp(-0.5, 0.5)], dim=-1)
        pts = pts + torch.where(valid[..., None], offs, 0.0)

    if k_eff < K:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, K - k_eff))
        top_scores = torch.nn.functional.pad(top_scores, (0, K - k_eff))
        valid = torch.nn.functional.pad(valid, (0, K - k_eff))
    return Detections(points=pts, scores=top_scores, valid=valid)
