"""Image operations of the reference, written from their definitions (OpenCV's
and ``jax.image.resize``'s), in the precision of their input.

Images are (..., H, W) tensors; leading axes are a batch of images, each
filtered on its own. Borders are OpenCV's defaults: reflect-101 for linear
filters, the image's own edge for the max and min filters.
"""

from __future__ import annotations

import numpy as np
import torch

LUMA = (0.299, 0.587, 0.114)        # BT.601, rounded to float32 as the configuration states
PYR_TAPS = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def f32(v: float) -> float:
    """v rounded to float32, as a Python float."""
    return float(np.float32(v))


def reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of each position -lo .. n + hi - 1 under reflect-101."""
    i = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(i)
    j = np.abs(i) % (2 * (n - 1))
    return np.where(j >= n, 2 * (n - 1) - j, j)


def _taps(x: torch.Tensor, taps, axis: int, stride: int = 1) -> torch.Tensor:
    """Correlation of ``x`` with ``taps`` along ``axis`` (reflect-101), keeping
    every ``stride``-th output."""
    n, r = x.shape[axis], len(taps) // 2
    src = torch.as_tensor(reflect101(n, r, r), device=x.device)
    out = None
    for k, w in enumerate(taps):
        term = x.index_select(axis, src[k:k + n:stride]) * w
        out = term if out is None else out + term
    return out


def gray_of_mono(u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The luma of an RGB image whose three channels are the uint8 mono
    frame over 255."""
    v = u8.to(dtype) / 255.0
    return v * f32(LUMA[0]) + v * f32(LUMA[1]) + v * f32(LUMA[2])


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: the 5-tap binomial filter, then every second row and column."""
    return _taps(_taps(x, PYR_TAPS, -2, 2), PYR_TAPS, -1, 2)


def pyramid(x: torch.Tensor, levels: int) -> list:
    out = [x]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def sobel(x: torch.Tensor):
    """cv::Sobel, ksize 3: (d/dx, d/dy)."""
    gx = _taps(_taps(x, (1, 2, 1), -2), (-1, 0, 1), -1)
    gy = _taps(_taps(x, (-1, 0, 1), -2), (1, 2, 1), -1)
    return gx, gy


def box_mean(x: torch.Tensor, r: int) -> torch.Tensor:
    """cv::boxFilter, normalized, (2r+1)^2."""
    k = [1.0 / (2 * r + 1)] * (2 * r + 1)
    return _taps(_taps(x, k, -2), k, -1)


def _running(x: torch.Tensor, k: int, axis: int, largest: bool) -> torch.Tensor:
    n, r = x.shape[axis], k // 2
    out = None
    for o in range(-r, k - r):
        idx = (torch.arange(n, device=x.device) + o).clamp(0, n - 1)
        v = x.index_select(axis, idx)
        out = v if out is None else (torch.maximum(out, v) if largest else torch.minimum(out, v))
    return out


def dilate(x: torch.Tensor, k: int) -> torch.Tensor:
    """cv::dilate with a k x k square."""
    return _running(_running(x, k, -2, True), k, -1, True)


def erode(x: torch.Tensor, k: int) -> torch.Tensor:
    return _running(_running(x, k, -2, False), k, -1, False)


def nearest_index(m: int, n: int) -> np.ndarray:
    """``jax.image.resize`` nearest: output j reads input floor((j + 0.5) m / n)."""
    return np.floor((np.arange(n) + 0.5) * m / n).astype(np.int64).clip(0, m - 1)


def resize_nearest(x: torch.Tensor, shape) -> torch.Tensor:
    rows = torch.as_tensor(nearest_index(x.shape[-2], shape[0]), device=x.device)
    cols = torch.as_tensor(nearest_index(x.shape[-1], shape[1]), device=x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def linear_weights(m: int, n: int) -> np.ndarray:
    """(m, n) weights of ``jax.image.resize`` linear from m to n samples: a
    triangle at half-pixel centres, widened by m/n when shrinking, each
    output's weights normalized to sum to 1."""
    scale = max(m / n, 1.0)
    centre = (np.arange(n) + 0.5) * m / n - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(centre[None, :] - np.arange(m)[:, None]) / scale)
    total = w.sum(axis=0, keepdims=True)
    return np.where(total > 0, w / np.where(total > 0, total, 1.0), 0.0)


def resize_linear(x: torch.Tensor, shape) -> torch.Tensor:
    wr = torch.as_tensor(linear_weights(x.shape[-2], shape[0]), dtype=x.dtype, device=x.device)
    wc = torch.as_tensor(linear_weights(x.shape[-1], shape[1]), dtype=x.dtype, device=x.device)
    return (wr.T @ x) @ wc


def bilinear(img: torch.Tensor, frame: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """img (F, H, W) sampled at (y, x) of frame ``frame`` (broadcast with y
    and x), reads clamped to the image (edge padding)."""
    H, W = img.shape[-2:]
    y0, x0 = torch.floor(y), torch.floor(x)
    ty, tx = y - y0, x - x0
    y0, x0 = y0.long(), x0.long()

    def at(yy, xx):
        return img[frame, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]

    top = at(y0, x0) * (1 - tx) + at(y0, x0 + 1) * tx
    bot = at(y0 + 1, x0) * (1 - tx) + at(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty
