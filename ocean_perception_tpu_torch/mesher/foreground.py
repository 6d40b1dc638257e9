"""Foreground texture mask by morphological gradient (port of
``ocean_perception_tpu.mesher.foreground``).

Reference: mesher/object_mesher.cpp EstimateForegroundMask (:35-65):
downsample by ``downsize``, morphological gradient with a
(2*ksize/downsize + 1) square element, threshold at min_gradient (on the
0..255 scale; images here are [0, 1]), upsample back.
"""

from __future__ import annotations

import torch

from ..ops.image import morph_gradient, resize


def estimate_foreground_mask(gray: torch.Tensor, ksize: int = 15, min_gradient: float = 20.0,
                             downsize: int = 4) -> torch.Tensor:
    """Boolean (..., H, W) mask of textured (object) regions of (..., H, W)
    images."""
    H, W = gray.shape[-2], gray.shape[-1]
    kwidth = 2 * max(2, ksize // downsize) + 1
    small = resize(gray, (H // downsize, W // downsize), method="linear") if downsize > 1 else gray
    mask_small = morph_gradient(small, kwidth) > (min_gradient / 255.0)
    if downsize == 1:
        return mask_small
    return resize(mask_small.float(), (H, W), method="linear") > 0.5
