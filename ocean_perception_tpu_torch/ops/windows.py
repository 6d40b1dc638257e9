"""Per-point window extraction (port of ``ocean_perception_tpu.ops.windows``).

The JAX package selects windows with one-hot matrix contractions because
gathers are slow on a TPU. Every element of those contractions is
``1 * value`` plus zeros, so a plain gather returns the same values, and on a
GPU a gather is the natural form.
"""

from __future__ import annotations

import torch


def extract_windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: int,
                    src: torch.Tensor | None = None, size_x: int | None = None,
                    pad: int = 0) -> torch.Tensor:
    """(K, size, size_x) windows of ``img`` with top-left corners (y0, x0).

    ``img`` is (H, W), or an (R, H, W) ring with ``src`` (K,) selecting each
    window's frame. Coordinates are those of the image edge-padded by ``pad``
    on every side: reads are clamped to the image instead of padding it.
    With ``pad=0`` the origins must already lie in [0, H - size] and
    [0, W - size], as the JAX function requires.
    """
    size_x = size if size_x is None else size_x
    H, W = img.shape[-2], img.shape[-1]
    dev = img.device
    rows = (y0.long()[:, None] + torch.arange(size, device=dev) - pad).clamp(0, H - 1)
    cols = (x0.long()[:, None] + torch.arange(size_x, device=dev) - pad).clamp(0, W - 1)
    if img.ndim == 2:
        return img[rows[:, :, None], cols[:, None, :]]
    if src is None:
        raise ValueError("a ring of images needs src indices")
    return img[src.long()[:, None, None], rows[:, :, None], cols[:, None, :]]
