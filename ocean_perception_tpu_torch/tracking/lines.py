"""2D/3D line-feature geometry (latent line-VO support); port of
``ocean_perception_tpu.tracking.lines`` on torch tensors.

Reference parity: vision_core/line_feature.hpp + line_util.hpp (stvo-pl
style; the reference carries these with **no consumer in its main path** —
SURVEY.md §2.1 — as groundwork for point+line VO). Provided here for the
same reason: segment overlap, extrapolation, and endpoint-disparity
propagation for rectified stereo line matching. Every function runs on its
inputs' device and dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LineSegment2d(NamedTuple):
    p0: torch.Tensor  # (2,)
    p1: torch.Tensor  # (2,)


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones(1, dtype=p.dtype, device=p.device)])


def line_equation(seg: LineSegment2d) -> torch.Tensor:
    """Homogeneous line l = p0 x p1 (normalized so that |n| = 1)."""
    l = torch.linalg.cross(_homogeneous(seg.p0), _homogeneous(seg.p1))
    n = torch.linalg.norm(l[:2])
    return l / torch.clamp(n, min=1e-9)


def point_line_distance(line: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    return torch.abs(torch.dot(line, _homogeneous(point)))


def segment_overlap_y(seg_a: LineSegment2d, seg_b: LineSegment2d) -> torch.Tensor:
    """Vertical-interval overlap ratio of two segments (line_util
    SegmentOverlap): used to gate left/right line matches in rectified pairs."""
    a0, a1 = torch.minimum(seg_a.p0[1], seg_a.p1[1]), torch.maximum(seg_a.p0[1], seg_a.p1[1])
    b0, b1 = torch.minimum(seg_b.p0[1], seg_b.p1[1]), torch.maximum(seg_b.p0[1], seg_b.p1[1])
    inter = torch.clamp(torch.minimum(a1, b1) - torch.maximum(a0, b0), min=0.0)
    union = torch.maximum(a1, b1) - torch.minimum(a0, b0)
    return inter / torch.clamp(union, min=1e-9)


def extrapolate_to_rows(seg: LineSegment2d, y0, y1) -> LineSegment2d:
    """Extend/trim a segment so its endpoints lie on rows y0/y1
    (ExtrapolateLineSegment): makes left/right endpoints row-aligned so
    endpoint disparities are valid."""
    dy = seg.p1[1] - seg.p0[1]
    safe = torch.where(torch.abs(dy) < 1e-9, torch.ones_like(dy), dy)
    t0 = (y0 - seg.p0[1]) / safe
    t1 = (y1 - seg.p0[1]) / safe
    d = seg.p1 - seg.p0
    return LineSegment2d(seg.p0 + t0 * d, seg.p0 + t1 * d)


def endpoint_disparities(
    left: LineSegment2d, right: LineSegment2d
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disparities of the (row-aligned) endpoints of a matched line pair."""
    r = extrapolate_to_rows(right, left.p0[1], left.p1[1])
    return left.p0[0] - r.p0[0], left.p1[0] - r.p1[0]


def backproject_line(
    seg: LineSegment2d, disp0, disp1, fx, fy, cx, cy, baseline
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Endpoints → 3D via their disparities (rectified stereo)."""
    def bp(p, d):
        z = fx * baseline / torch.clamp(torch.as_tensor(d, dtype=p.dtype, device=p.device),
                                        min=1e-6)
        x = (p[0] - cx) / fx * z
        y = (p[1] - cy) / fy * z
        return torch.stack([x, y, z])

    return bp(seg.p0, disp0), bp(seg.p1, disp1)
