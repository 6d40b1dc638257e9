"""Matching-cost volume over integer disparities (port of ``ocean_perception_tpu.stereo.cost``).

Layout: (H, W, D), disparity-minor, as in the reference. On CUDA tensors
:func:`cost_volume` launches the hand-written kernel in
``csrc/cost_volume.cu``; on CPU tensors it runs :func:`cost_volume_plain`,
which defines the kernel's result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda
from ..ops.image import fma_f32, gradient_magnitude

STENCIL = ((-1, -1), (-1, 1), (0, 0), (1, -1), (1, 1))


def _shift_right_image(im: torch.Tensor, d: int) -> torch.Tensor:
    """R(y, x-d), columns x < d clamped to column 0."""
    if d == 0:
        return im
    W = im.shape[1]
    idx = (torch.arange(W, device=im.device) - d).clamp_min(0)
    return im.index_select(1, idx)


def _stencil_sum(e: torch.Tensor) -> torch.Tensor:
    """5-tap X-stencil sum with edge-clamped neighbours, in STENCIL order."""
    H, W = e.shape
    rows = torch.arange(-1, H + 1, device=e.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=e.device).clamp(0, W - 1)
    padded = e.index_select(0, rows).index_select(1, cols)
    acc = e
    for dy, dx in STENCIL:
        if dy == 0 and dx == 0:
            continue
        acc = acc + padded[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
    return acc


def _alpha_beta(alpha: float):
    """The e-term weights as float32 values, as JAX rounds them."""
    return float(np.float32(alpha)), float(np.float32(1.0 - alpha))


def cost_volume_plain(iml, imr, max_disp: int, alpha: float, gl, gr,
                      dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch twin of the cost-volume kernel.

    The e-term is alpha*|l - r| + (1-alpha)*|gl - gr| with the first product
    fused into the add (one rounding), as XLA's CPU backend computes it."""
    a, b = _alpha_beta(alpha)

    def plane(d: int) -> torch.Tensor:
        rd = _shift_right_image(imr, d)
        gd = _shift_right_image(gr, d)
        e = fma_f32(torch.abs(iml - rd), a, b * torch.abs(gl - gd))
        return _stencil_sum(e).to(dtype)

    return torch.stack([plane(d) for d in range(max_disp)], dim=-1)


def cost_volume(iml, imr, max_disp: int, alpha: float = 0.9, gl=None, gr=None,
                dtype=torch.float32) -> torch.Tensor:
    """(H, W, D) cost volume, D = max_disp, reference X-stencil cost."""
    iml = iml.float()
    imr = imr.float()
    if gl is None:
        gl = gradient_magnitude(iml)
    if gr is None:
        gr = gradient_magnitude(imr)
    if iml.is_cuda:
        a, b = _alpha_beta(alpha)
        return cuda.cost_volume(iml.contiguous(), imr.contiguous(), gl.contiguous(),
                                gr.contiguous(), max_disp, a, b, dtype)
    return cost_volume_plain(iml, imr, max_disp, alpha, gl, gr, dtype)


def cost_of_disparity(C: torch.Tensor, disp_int: torch.Tensor) -> torch.Tensor:
    """Cost at a given integer disparity per pixel: (H, W) lookup into (H, W, D)."""
    return torch.gather(C, -1, disp_int.long().unsqueeze(-1)).squeeze(-1)


def sample_at_disparity(values: torch.Tensor, disp_int: torch.Tensor, max_disp: int) -> torch.Tensor:
    """values[y, x - d(y, x)], columns x < d clamped to column 0.

    ``disp_int`` must lie in [0, max_disp); the reference's one-hot over
    max_disp shifts selects exactly one term, so a gather equals it."""
    W = values.shape[1]
    col = torch.arange(W, device=values.device)[None, :]
    src = (col - disp_int.long()).clamp_min(0)
    return torch.gather(values, 1, src)


def subpixel_refine(C: torch.Tensor, disp_int: torch.Tensor) -> torch.Tensor:
    """Parabola fit on (C[d-1], C[d], C[d+1]) -> float disparity, in float32."""
    D = C.shape[-1]
    c0 = cost_of_disparity(C, (disp_int - 1).clamp(0, D - 1)).float()
    c1 = cost_of_disparity(C, disp_int).float()
    c2 = cost_of_disparity(C, (disp_int + 1).clamp(0, D - 1)).float()
    denom = c0 - 2.0 * c1 + c2
    ok = torch.abs(denom) > 1e-6
    offset = torch.where(ok, 0.5 * (c0 - c2) / torch.where(ok, denom, 1.0), 0.0)
    offset = offset.clamp(-0.5, 0.5)
    interior = (disp_int > 0) & (disp_int < D - 1)
    return disp_int.float() + torch.where(interior, offset, 0.0)
