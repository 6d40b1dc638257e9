"""Subpixel sampling primitives (port of ``ocean_perception_tpu.ops.interp``).

Coordinates are clamped to the valid interior, as in the reference's
GetSubpixel (patchmatch_gpu.cu:18-42).
"""

from __future__ import annotations

import math

import torch


def gather_pixels(image: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                  batch_dims: int = 0) -> torch.Tensor:
    """``image[y, x]`` for integer (y, x); with ``batch_dims`` leading axes,
    image (*batch, H, W, ...) and y, x (*batch, ...), each entry of the
    batch read from its own image."""
    if batch_dims == 0:
        return image[y, x]
    batch = image.shape[:batch_dims]
    n = math.prod(batch)
    b = torch.arange(n, device=image.device)[:, None]
    flat = image.reshape(n, *image.shape[batch_dims:])
    out = flat[b, y.reshape(n, -1), x.reshape(n, -1)]
    return out.reshape(*y.shape, *image.shape[batch_dims + 2:])


def bilinear_sample(image: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    batch_dims: int = 0) -> torch.Tensor:
    """Sample an (H, W) or (H, W, C) image at float (y, x), clamped to the
    borders: lerp rows, then columns. y and x broadcast to any shape. With
    ``batch_dims`` leading axes, image (*batch, H, W[, C]) and y, x of the
    same (*batch, ...) shape, each entry sampling its own image."""
    H, W = image.shape[batch_dims], image.shape[batch_dims + 1]
    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = (y0 + 1).clamp_max(H - 1)
    x1 = (x0 + 1).clamp_max(W - 1)
    ty = y - y0.to(y.dtype)
    tx = x - x0.to(x.dtype)
    if image.ndim == batch_dims + 3:
        ty = ty[..., None]
        tx = tx[..., None]

    def at(yi, xi):
        return gather_pixels(image, yi, xi, batch_dims)

    c0 = (1.0 - ty) * at(y0, x0) + ty * at(y1, x0)
    c1 = (1.0 - ty) * at(y0, x1) + ty * at(y1, x1)
    return (1.0 - tx) * c0 + tx * c1


def _axis_weights(center: torch.Tensor, size: int, window: int) -> torch.Tensor:
    """(..., size, window) two-tap bilinear weights: row i selects position
    ``center + i - size//2`` of a length-``window`` axis, clamped to it."""
    offs = torch.arange(size, dtype=center.dtype, device=center.device) - (size // 2)
    pos = (center[..., None] + offs).clamp(0.0, window - 1.0)
    p0 = torch.floor(pos)
    t = pos - p0
    src = torch.arange(window, dtype=center.dtype, device=center.device)
    is0 = (src == p0[..., None]).to(center.dtype)
    is1 = (src == (p0 + 1.0).clamp_max(window - 1.0)[..., None]).to(center.dtype)
    # Where p0 is the last column both taps hit it and the weights add.
    return is0 * (1.0 - t)[..., None] + is1 * t[..., None]


def sample_patches_bilinear(window: torch.Tensor, center_y: torch.Tensor,
                            center_x: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """(..., patch_h, patch_w) patches around float centres of a batch of
    (..., Hw, Ww) windows: ``W_y @ window @ W_x^T`` with two-tap weights."""
    wy = _axis_weights(center_y, patch_h, window.shape[-2])
    wx = _axis_weights(center_x, patch_w, window.shape[-1])
    return wy @ window @ wx.transpose(-1, -2)
