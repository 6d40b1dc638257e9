"""The object mesher's device half in the reference: the foreground mask and
one frame's update of the landmark graph, and its clusters.

Written from the reference repository's ObjectMesher::ProcessStereo
(object_mesher.cpp) and LandmarkGraph: the foreground is a morphological
gradient at a quarter of the resolution above min_gradient; a pair of live
landmarks with a disparity, within neighbor_radius_px of each other, gains
one observation of evidence when their depths differ by at most
edge_max_depth_change and the segment between them lies on the foreground
(edge_min_foreground_percent of edge_samples points), and loses one
otherwise, held in [0, connect + disconnect]; a slot whose landmark changed
starts afresh; clusters are the connected components of the edges with at
least min_obs_connect_edge, each labelled by its smallest slot.
"""

from __future__ import annotations

import torch

from .image import dilate, erode, resize_linear

NEIGHBOR_RADIUS = 80.0
EDGE_SAMPLES = 16
FG_DOWNSAMPLE = 4


def foreground(gray: torch.Tensor, ksize: int, min_gradient: float, tie: float = 0.0):
    """(H, W) bool masks of textured regions of an (H, W) gray in [0, 1]:
    (the mask, where its decision is a tie). With uint8 input and dyadic
    weights a gradient can equal min_gradient exactly, where rounding
    decides; a pixel's decision is a tie where its gradient lies within
    ``tie`` of the threshold, and a full-resolution pixel's where it
    differs between those read either way."""
    H, W = gray.shape[-2:]
    f = FG_DOWNSAMPLE
    k = 2 * max(2, ksize // f) + 1
    small = resize_linear(gray, (H // f, W // f))
    grad = dilate(small, k) - erode(small, k)
    thr = min_gradient / 255.0
    mask, near = grad > thr, (grad - thr).abs() <= tie

    def up(m):
        return resize_linear(m.to(gray.dtype), (H, W)) > 0.5

    return up(mask), up(mask | near) != up(mask & ~near)


def update(weights: torch.Tensor, graph_ids: torch.Tensor, ids: torch.Tensor,
           pixels: torch.Tensor, disparities: torch.Tensor, fg: torch.Tensor, fxb: float,
           p: dict):
    """One camera's (K, K) weights after this frame's observations, and the
    cluster label of each slot (-1 for slots without a live landmark)."""
    K = ids.shape[0]
    dev = weights.device
    # The values that decide an edge, in float32 as the configuration states
    # them (in the precision of the weights where that is lower).
    dec = torch.float32 if weights.dtype == torch.float64 else weights.dtype
    live = (ids >= 0) & (disparities > 0)
    pts = pixels.to(dec)
    diff = pts[:, None, :] - pts[None, :, :]
    near = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] <= NEIGHBOR_RADIUS ** 2
    z = torch.tensor(fxb, dtype=dec, device=dev) / disparities.to(dec).clamp_min(1e-3)
    depth_ok = (z[:, None] - z[None, :]).abs() <= p["edge_max_depth_change"]
    f = FG_DOWNSAMPLE
    Hf, Wf = fg.shape[0] // f, fg.shape[1] // f
    cover = fg[:Hf * f, :Wf * f].to(dec).reshape(Hf, f, Wf, f).mean((1, 3))
    # EDGE_SAMPLES points of each segment, at fractions k / (EDGE_SAMPLES - 1).
    t = torch.arange(EDGE_SAMPLES, dtype=dec, device=dev) * (1.0 / (EDGE_SAMPLES - 1))
    t[-1] = 1.0
    t = t[:, None]
    seg = pts[:, None, None, :] * (1 - t) + pts[None, :, None, :] * t
    yy = torch.trunc(seg[..., 1] / f).long().clamp(0, Hf - 1)
    xx = torch.trunc(seg[..., 0] / f).long().clamp(0, Wf - 1)
    fg_ok = cover[yy, xx].mean(-1) >= p["edge_min_foreground_percent"]
    pair = near & live[:, None] & live[None, :]
    moved = graph_ids != ids
    w = torch.where(moved[:, None] | moved[None, :], 0.0, weights)
    w = torch.where(pair, w + torch.where(depth_ok & fg_ok, 1.0, -1.0), w)
    w = w.clamp(0.0, p["min_obs_connect_edge"] + p["min_obs_disconnect_edge"])
    w = w * (1 - torch.eye(K, dtype=w.dtype, device=dev))
    # Connected components of the strong edges between live slots.
    strong = ((w >= p["min_obs_connect_edge"]) & live[:, None] & live[None, :]).cpu()
    label = list(range(K))

    def root(i):
        while label[i] != i:
            label[i] = label[label[i]]
            i = label[i]
        return i

    for i, j in strong.nonzero().tolist():
        a, b = root(i), root(j)
        if a != b:
            label[max(a, b)] = min(a, b)
    labels = torch.tensor([root(i) if bool(live[i]) else -1 for i in range(K)], device=dev)
    return w, labels
