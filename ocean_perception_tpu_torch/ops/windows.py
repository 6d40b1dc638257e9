"""Per-point window extraction (port of ``ocean_perception_tpu.ops.windows``).

The JAX package selects windows with one-hot matrix contractions because
gathers are slow on a TPU. Every element of those contractions is
``1 * value`` plus zeros, so a plain gather returns the same values, and on a
GPU a gather is the natural form.

A batch of cameras is folded into a ring: camera b's frame r of an
(*batch, R, H, W) stack is frame b*R + r of one (n*R, H, W) ring
(:func:`fold_rings`), so a point reads only its own camera.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch


def fold_rings(levels: Sequence[torch.Tensor], src: Optional[torch.Tensor], batch: tuple,
               K: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """A batch of rings as one ring: each level (*batch, R, H, W) becomes
    (n*R, H, W), n = prod(batch), and the per-point frame indices src
    (*batch, K) (None: frame 0) become (n*K,) int32 indices into it,
    b*R + clamp(src, 0, R - 1). Every level holds R frames a camera."""
    nb, n = len(batch), math.prod(batch)
    R = levels[0].shape[nb]
    for level in levels:
        if tuple(level.shape[:nb + 1]) != (*batch, R) or level.ndim != nb + 3:
            raise ValueError(f"need (*{batch}, {R}, H, W) rings, got {tuple(level.shape)}")
    flat = [level.reshape(n * R, *level.shape[-2:]) for level in levels]
    base = torch.arange(n, dtype=torch.int32, device=levels[0].device)[:, None] * R
    if src is None:
        return flat, base.expand(n, K).reshape(-1)
    return flat, (base + src.reshape(n, K).int().clamp(0, R - 1)).reshape(-1)


def extract_windows(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: int,
                    src: torch.Tensor | None = None, size_x: int | None = None,
                    pad: int = 0) -> torch.Tensor:
    """(K, size, size_x) windows of ``img`` with top-left corners (y0, x0).

    ``img`` is (H, W), or an (R, H, W) ring with ``src`` (K,) selecting each
    window's frame. Coordinates are those of the image edge-padded by ``pad``
    on every side: reads are clamped to the image instead of padding it.
    With ``pad=0`` the origins must already lie in [0, H - size] and
    [0, W - size], as the JAX function requires.

    A batch: origins (*batch, K) read ``img`` (*batch, H, W), or
    (*batch, R, H, W) with ``src`` (*batch, K), each camera its own, and
    give (*batch, K, size, size_x).
    """
    size_x = size if size_x is None else size_x
    H, W = img.shape[-2], img.shape[-1]
    dev = img.device
    batch = tuple(y0.shape[:-1])
    if batch:
        K = y0.shape[-1]
        ring = img if img.ndim == len(batch) + 3 else img.unsqueeze(len(batch))
        (flat,), idx = fold_rings([ring], src, batch, K)
        out = extract_windows(flat, y0.reshape(-1), x0.reshape(-1), size, src=idx,
                              size_x=size_x, pad=pad)
        return out.reshape(*batch, K, size, size_x)
    rows = (y0.long()[:, None] + torch.arange(size, device=dev) - pad).clamp(0, H - 1)
    cols = (x0.long()[:, None] + torch.arange(size_x, device=dev) - pad).clamp(0, W - 1)
    if img.ndim == 2:
        return img[rows[:, :, None], cols[:, None, :]]
    if src is None:
        raise ValueError("a ring of images needs src indices")
    return img[src.long()[:, None, None], rows[:, :, None], cols[:, None, :]]
