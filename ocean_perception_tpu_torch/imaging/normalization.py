"""Image normalization and tone utilities (port of
``ocean_perception_tpu.imaging.normalization``; reference
imaging/normalization.{hpp,cpp}): contrast stretch, simple white balance,
gamma conversion, gray-world colour correction, illuminant normalization,
unsharp masking.

Colour images are (..., H, W, C) and gray ones (..., H, W); leading axes are
a batch of images, and every statistic is taken over one image, never
across the batch. ``normalize_unit`` and ``enhance_contrast`` take either,
so they are told which (``channels=True`` for colour).
"""

from __future__ import annotations

import torch

from ..ops.image import gaussian_blur

_HW = (-3, -2)  # the pixel axes of a colour image


def normalize_unit(image: torch.Tensor, channels: bool = False) -> torch.Tensor:
    """(I - min) / (max - min) over each image (Normalize): over (H, W), or
    (H, W, C) with channels."""
    dims = (-3, -2, -1) if channels else (-2, -1)
    vmin = image.amin(dim=dims, keepdim=True)
    vmax = image.amax(dim=dims, keepdim=True)
    return (image - vmin) / torch.clamp_min(vmax - vmin, 1e-9)


def enhance_contrast(image: torch.Tensor, channels: bool = False) -> torch.Tensor:
    """Per-image dynamic-range stretch (EnhanceContrast)."""
    return normalize_unit(image, channels)


def enhance_contrast_factor(image: torch.Tensor, factor: float = 1.5) -> torch.Tensor:
    """Fixed-gain contrast about mid-gray (EnhanceContrastFactor,
    normalization.cpp:72-76): clip(factor*(I - 0.5) + 0.5, 0, 1)."""
    return torch.clamp(factor * (image - 0.5) + 0.5, 0.0, 1.0)


def enhance_contrast_clip(image: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    """Clip to [vmin, vmax] then stretch to [0, 1] (EnhanceContrastDerya)."""
    clipped = torch.clamp(image, vmin, vmax)
    return (clipped - vmin) / max(vmax - vmin, 1e-9)


def white_balance_simple(image: torch.Tensor) -> torch.Tensor:
    """Scale channels so their means match the image's overall mean
    (WhiteBalanceSimple)."""
    ch_mean = image.mean(dim=_HW, keepdim=True)
    gray = ch_mean.mean(dim=-1, keepdim=True)
    scale = gray / torch.clamp_min(ch_mean, 1e-6)
    return torch.clamp(image * scale, 0.0, 1.0)


def correct_color_ratio(image: torch.Tensor) -> torch.Tensor:
    """Gray-world normalization: the average pixel colour goes to gray
    (CorrectColorRatio)."""
    ch_mean = image.mean(dim=_HW, keepdim=True)
    max_mean = ch_mean.amax(dim=-1, keepdim=True)
    scale = max_mean / torch.clamp_min(ch_mean, 1e-6)
    return torch.clamp(image * scale, 0.0, 1.0)


def linear_to_gamma(image: torch.Tensor, gamma_power: float = 0.4545) -> torch.Tensor:
    return torch.pow(torch.clamp_min(image, 0.0), gamma_power)


def gamma_to_linear(image: torch.Tensor, gamma_power: float = 2.2) -> torch.Tensor:
    return torch.pow(torch.clamp_min(image, 0.0), gamma_power)


def normalize_color_illuminant(image: torch.Tensor, sigma: float = 15.0) -> torch.Tensor:
    """Remove the global colour cast with a local illuminant estimate
    (NormalizeColorIlluminant): divide by a heavily blurred per-channel
    illuminant and rescale by the illuminant's mean over the image."""
    il = gaussian_blur(image.movedim(-1, -3), sigma).movedim(-3, -1)
    out = image / torch.clamp_min(il, 1e-3)
    return torch.clamp(out * il.mean(dim=(-3, -2, -1), keepdim=True), 0.0, 1.0)


def sharpen(gray: torch.Tensor, amount: float = 1.0, sigma: float = 1.0) -> torch.Tensor:
    """Unsharp mask (Sharpen)."""
    blurred = gaussian_blur(gray, sigma)
    return torch.clamp(gray + amount * (gray - blurred), 0.0, 1.0)
