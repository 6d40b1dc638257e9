"""Dense image operations on float32 tensors (port of ``ocean_perception_tpu.ops.image``).

Only the subset that ``perception_step`` and ``full_frontend_step`` run, and the
Gaussian blur. Every function works on the device of its input. An image is
(..., H, W): leading axes are a batch of images, each filtered on its own.
Where the reference filters an (H, W, C) colour image over its two leading
axes, the port's caller moves C in front, (..., C, H, W), and back.

Two numerical rules keep the port equal to the JAX reference:

- Filters are shifted adds, never ``conv2d``: cuDNN runs float32
  convolutions in TF32 by default, which keeps about three decimal digits.
- XLA's CPU backend contracts ``a*b + c`` into one fused multiply-add.
  Where that decides bits that later stages compare exactly (grayscale,
  gradient magnitude, the cost volume's e-term), :func:`fma_f32` reproduces
  the single rounding on any device.
- ``torch.sqrt`` on a CPU float32 tensor is not correctly rounded (it
  differs from IEEE sqrt on about 0.7% of values). :func:`sqrt_f32` is, on
  any device, and every square root of the port goes through it.

The index and weight constants (reflect-101 borders, resize taps) are built
once per shape and device and cached as tensors on that device: a copy from
host memory on every call would stall the CUDA stream.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

# Above this radius the integral (cumsum) path replaces the shifted adds, as
# in the reference (ops/image.py _BOX_SHIFT_MAX_RADIUS).
_BOX_SHIFT_MAX_RADIUS = 8

# cv::pyrDown 5-tap kernel.
_PYR_K = (np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0).tolist()

_GRAY_W = [float(np.float32(w)) for w in (0.299, 0.587, 0.114)]


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` with ONE rounding, like a hardware FMA.

    The float64 product of two float32 values is exact. TwoSum gives the
    exact error of the float64 sum; rounding that sum to odd and then to
    float32 is a correctly rounded result (53 >= 24 + 2 bits).
    """
    s = a.double() * (b.double() if isinstance(b, torch.Tensor) else float(b))
    c = c.double()
    t = s + c
    bb = t - s
    err = (s - (t - bb)) + (c - bb)
    odd = (t.view(torch.int64) & 1).bool()
    toward = torch.where(err > 0, math.inf, -math.inf)
    t = torch.where((err != 0) & ~odd, torch.nextafter(t, toward), t)
    return t.float()


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.

    The float64 root of a float32 value, rounded once to float32, is the
    correctly rounded float32 root (53 >= 2*24 + 2 bits), so this equals
    IEEE ``sqrtf`` (and XLA's, and CUDA's ``__fsqrt_rn``) bit for bit."""
    return torch.sqrt(x.double()).float()


def _reflect101_np(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of padded positions -lo .. n+hi-1 under BORDER_REFLECT_101.

    Folds with period 2(n-1), so pads wider than the image reflect again, as
    ``jnp.pad(mode="reflect")`` does (``F.pad`` refuses them)."""
    i = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.abs(i) % period
    return np.where(j >= n, period - j, j)


@functools.lru_cache(maxsize=256)
def _reflect101_index(n: int, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """:func:`_reflect101_np` on ``device``, copied there once."""
    return torch.as_tensor(_reflect101_np(n, lo, hi), device=device)


def _pad_reflect101(image: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """OpenCV BORDER_REFLECT_101 padding of the H and W axes."""
    rows = _reflect101_index(image.shape[-2], ry, ry, image.device)
    cols = _reflect101_index(image.shape[-1], rx, rx, image.device)
    return image.index_select(-2, rows).index_select(-1, cols)


def _sep_conv2d(image: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 2-D correlation with reflect-101 borders: vertical taps in
    order, then horizontal taps in order (the reference's summation order)."""
    ky = np.asarray(ky, dtype=np.float32).reshape(-1).tolist()
    kx = np.asarray(kx, dtype=np.float32).reshape(-1).tolist()
    ry, rx = len(ky) // 2, len(kx) // 2
    padded = _pad_reflect101(image, ry, rx)
    H, W = image.shape[-2], image.shape[-1]
    acc = None
    for i, w in enumerate(ky):
        term = w * padded[..., i : i + H, :]
        acc = term if acc is None else acc + term
    out = None
    for j, w in enumerate(kx):
        term = w * acc[..., j : j + W]
        out = term if out is None else out + term
    return out


def sobel_x(image: torch.Tensor) -> torch.Tensor:
    """OpenCV Sobel(dx=1, dy=0, ksize=3)."""
    return _sep_conv2d(image, [1.0, 2.0, 1.0], [-1.0, 0.0, 1.0])


def sobel_y(image: torch.Tensor) -> torch.Tensor:
    """OpenCV Sobel(dx=0, dy=1, ksize=3)."""
    return _sep_conv2d(image, [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0])


def gradient_magnitude(image: torch.Tensor) -> torch.Tensor:
    """sqrt(Gx² + Gy²), with Gx² + Gy² fused as XLA fuses it."""
    gx = sobel_x(image)
    gy = sobel_y(image)
    return sqrt_f32(fma_f32(gx, gx, gy * gy))


def _box_sum_1d(padded: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Windowed sum of width k along ``axis`` by cumsum difference."""
    S = torch.cumsum(padded, dim=axis)
    zero_shape = list(S.shape)
    zero_shape[axis] = 1
    S0 = torch.cat([S.new_zeros(zero_shape), S], dim=axis)
    n_out = padded.shape[axis] - k + 1
    return S0.narrow(axis, k, n_out) - S0.narrow(axis, 0, n_out)


def box_filter(image: torch.Tensor, radius: int, normalize: bool = True) -> torch.Tensor:
    """(2r+1)² box sum or mean with reflect-101 borders (cv::boxFilter)."""
    k = 2 * radius + 1
    if radius <= _BOX_SHIFT_MAX_RADIUS:
        kk = np.ones(k, dtype=np.float32)
        if normalize:
            kk = kk / kk.sum()
        return _sep_conv2d(image, kk, kk)
    padded = _pad_reflect101(image, radius, radius)
    out = _box_sum_1d(padded, k, -2)
    out = _box_sum_1d(out, k, -1)
    if normalize:
        out = out * float(np.float32(1.0 / (k * k)))
    return out


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """Normalized Gaussian taps at -radius .. radius, float32."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur, radius round(3 sigma) (at least 1) unless
    given, reflect-101 borders; shifted adds in float32."""
    if radius is None:
        radius = max(1, int(round(3.0 * sigma)))
    k = gaussian_kernel1d(sigma, radius)
    return _sep_conv2d(image, k, k)


def _window_reduce(image: torch.Tensor, k: int, axis: int, largest: bool) -> torch.Tensor:
    """Same-size running max (or min) of width k along ``axis``, edge padded."""
    r = k // 2
    n = image.shape[axis]
    idx = torch.arange(-r, n + k - 1 - r, device=image.device).clamp(0, n - 1)
    windows = image.index_select(axis, idx).unfold(axis, k, 1)
    return windows.amax(dim=-1) if largest else windows.amin(dim=-1)


def dilate(image: torch.Tensor, ksize: int) -> torch.Tensor:
    """Grayscale dilation with a square element (cv::dilate), separable."""
    return _window_reduce(_window_reduce(image, ksize, -2, True), ksize, -1, True)


def erode(image: torch.Tensor, ksize: int) -> torch.Tensor:
    """Grayscale erosion with a square element (cv::erode), separable."""
    return _window_reduce(_window_reduce(image, ksize, -2, False), ksize, -1, False)


def morph_gradient(image: torch.Tensor, ksize: int) -> torch.Tensor:
    """dilate - erode (cv::morphologyEx MORPH_GRADIENT), the mesher's
    foreground-texture cue."""
    return dilate(image, ksize) - erode(image, ksize)


def pyr_down(image: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown: 5-tap Gaussian blur, then 2x decimation, reflect-101."""
    H, W = image.shape[-2], image.shape[-1]
    padded = _pad_reflect101(image, 2, 0)
    acc = None
    for i, w in enumerate(_PYR_K):
        term = w * padded[..., i : i + H, :]
        acc = term if acc is None else acc + term
    acc = acc[..., ::2, :]
    m = -(-W // 2)
    cols = _reflect101_index(W, 2, 2, image.device)
    out = None
    for k, w in enumerate(_PYR_K):
        term = w * acc.index_select(-1, cols[k : k + 2 * m : 2])
        out = term if out is None else out + term
    return out


def image_pyramid(image: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """num_levels images, level 0 = full resolution, each next one pyr_down'ed."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(pyr_down(levels[-1]))
    return levels


def _linear_taps(m: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Nonzero taps of ``jax.image.resize``'s linear weight matrix (m -> n):
    the triangle kernel at half-pixel centres, widened when downsampling
    (antialias), columns normalized to sum to 1. Returns (index, weight),
    both (n, T)."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    w = np.where(((sample_f >= -0.5) & (sample_f <= m - 0.5))[None, :], w, 0.0)
    w = w.astype(np.float32)
    T = max(1, int((w != 0).sum(axis=0).max()))
    idx = np.zeros((n, T), np.int64)
    wt = np.zeros((n, T), np.float32)
    for j in range(n):
        nz = np.nonzero(w[:, j])[0]
        idx[j, : len(nz)] = nz
        wt[j, : len(nz)] = w[nz, j]
    return idx, wt


@functools.lru_cache(maxsize=64)
def _linear_taps_on(m: int, n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_linear_taps` on ``device``, tap-major: (index, weight), both
    (T, n), copied there once."""
    idx, wt = _linear_taps(m, n)
    return (torch.as_tensor(np.ascontiguousarray(idx.T), device=device),
            torch.as_tensor(np.ascontiguousarray(wt.T), device=device))


@functools.lru_cache(maxsize=64)
def _nearest_index(m: int, n: int, device: torch.device) -> torch.Tensor:
    """Source index of each of n outputs resampling m inputs, nearest, on
    ``device``: float32 offsets, exactly as ``jax.image.resize`` computes them."""
    off = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m) / np.float32(n)
    return torch.as_tensor(np.floor(off.astype(np.float32)).astype(np.int64), device=device)


def _resize_axis(image: torch.Tensor, n: int, axis: int, method: str) -> torch.Tensor:
    m = image.shape[axis]
    if m == n:
        return image
    if method == "nearest":
        return image.index_select(axis, _nearest_index(m, n, image.device))
    if method != "linear":
        raise NotImplementedError(f"resize method {method!r} is not ported")
    idx, wt = _linear_taps_on(m, n, image.device)
    shape = [1] * image.ndim
    shape[axis] = n
    out = None
    for t in range(idx.shape[0]):
        term = image.index_select(axis, idx[t]) * wt[t].reshape(shape)
        out = term if out is None else out + term
    return out


def resize(image: torch.Tensor, shape: Sequence[int], method: str = "linear") -> torch.Tensor:
    """Resize the H and W axes to ``shape`` with half-pixel-centre
    sampling (``jax.image.resize`` semantics: ``nearest`` is torch's
    ``nearest-exact``; ``linear`` antialiases when downsampling)."""
    out = _resize_axis(image, shape[0], -2, method)
    return _resize_axis(out, shape[1], -1, method)


def to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) -> luma (BT.601), summed as XLA's CPU dot sums it; a 2-D
    image is taken as gray already."""
    if image.ndim == 2:
        return image
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return fma_f32(b, _GRAY_W[2], fma_f32(g, _GRAY_W[1], r * _GRAY_W[0]))


def compute_intensity(image_rgb: torch.Tensor) -> torch.Tensor:
    """Luma intensity (imaging ComputeIntensity)."""
    return to_grayscale(image_rgb)
