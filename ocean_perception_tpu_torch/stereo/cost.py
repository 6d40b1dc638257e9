"""Matching-cost volume over integer disparities (port of ``ocean_perception_tpu.stereo.cost``).

Layout: (H, W, D), disparity-minor, as in the reference. Images are
(..., H, W) and volumes (..., H, W, D): leading axes are a batch of stereo
pairs (cameras), each with its own volume, in the same launches. On CUDA tensors
:func:`cost_volume` launches the hand-written kernel in
``csrc/cost_volume.cu``; on CPU tensors it runs :func:`cost_volume_plain`,
which defines the kernel's result bit for bit.

:func:`build_strip_volumes` computes the same cost straight into the two
strip layouts the strip-volume PatchMatch reads (kernel ``build_volumes``,
``csrc/volume_build.cu``), for a strip geometry from :func:`strip_geometry`:

    V_row[i, c, d, h] = C[h, c*chunk_x + i, d]   (chunk_x, chunks_x, D, H)
    V_col[i, c, d, w] = C[c*chunk_y + i, w, d]   (chunk_y, chunks_y, D, W)

each with the batch's leading axes in front.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda
from ..ops.image import box_filter, fma_f32, gradient_magnitude, sqrt_f32

STENCIL = ((-1, -1), (-1, 1), (0, 0), (1, -1), (1, 1))


def _shift_right_image(im: torch.Tensor, d: int) -> torch.Tensor:
    """R(y, x-d), columns x < d clamped to column 0."""
    if d == 0:
        return im
    W = im.shape[-1]
    idx = (torch.arange(W, device=im.device) - d).clamp_min(0)
    return im.index_select(-1, idx)


def _stencil_sum(e: torch.Tensor) -> torch.Tensor:
    """5-tap X-stencil sum with edge-clamped neighbours, in STENCIL order."""
    H, W = e.shape[-2:]
    rows = torch.arange(-1, H + 1, device=e.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=e.device).clamp(0, W - 1)
    padded = e.index_select(-2, rows).index_select(-1, cols)
    acc = e
    for dy, dx in STENCIL:
        if dy == 0 and dx == 0:
            continue
        acc = acc + padded[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
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
    """(..., H, W, D) cost volume, D = max_disp, reference X-stencil cost."""
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


def cost_volume_zncc(iml, imr, max_disp: int, patch_size: int = 5) -> torch.Tensor:
    """(..., H, W, D) volume with cost = 1 - ZNCC over a patch_size box (the
    reference CPU PatchMatch's test functor), from box-filtered means,
    variances and shifted cross-correlations."""
    iml = iml.float()
    imr = imr.float()
    r = patch_size // 2
    mu_l = box_filter(iml, r)
    var_l = torch.clamp_min(box_filter(iml * iml, r) - mu_l * mu_l, 1e-8)

    def plane(d: int) -> torch.Tensor:
        rd = _shift_right_image(imr, d)
        mu_r = box_filter(rd, r)
        var_r = torch.clamp_min(box_filter(rd * rd, r) - mu_r * mu_r, 1e-8)
        cross = box_filter(iml * rd, r) - mu_l * mu_r
        zncc = cross / sqrt_f32(var_l * var_r)
        return 1.0 - torch.clamp(zncc, -1.0, 1.0)

    return torch.stack([plane(d) for d in range(max_disp)], dim=-1)


def right_cost_volume_from_left(C: torch.Tensor) -> torch.Tensor:
    """The right image's volume from the left's: C_R[y, x, d] =
    C_L[y, min(x + d, W - 1), d] (columns past the right edge clamp to the
    last one)."""
    W, D = C.shape[-2:]
    col = torch.arange(W, device=C.device)[:, None] + torch.arange(D, device=C.device)[None, :]
    return torch.gather(C, -2, col.clamp_max(W - 1).expand(C.shape))


def _effective_chunks(n: int, chunks: int) -> int:
    """Largest divisor of n that is <= chunks (strips must tile the axis)."""
    c = min(chunks, n)
    while n % c != 0:
        c -= 1
    return c


class StripGeometry(NamedTuple):
    H: int
    W: int
    D: int
    chunks_x: int  # strips of the row passes (along x)
    chunk_x: int
    chunks_y: int  # strips of the column passes (along y)
    chunk_y: int


def strip_geometry(H: int, W: int, D: int, chunks: int, chunks_y: Optional[int]) -> StripGeometry:
    """Strip counts and sizes of both pass orientations; ``chunks_y=None``
    means ``chunks`` (so 360 rows with 16 strips give 15 strips of 24)."""
    cx = _effective_chunks(W, chunks)
    cy = _effective_chunks(H, chunks if chunks_y is None else chunks_y)
    return StripGeometry(H, W, D, cx, W // cx, cy, H // cy)


def strips_from_volume(C: torch.Tensor, g: StripGeometry):
    """(V_row, V_col) of an (..., H, W, D) volume, both contiguous."""
    *batch, H, W, D = C.shape
    V_row = C.movedim(-3, -1).reshape(*batch, g.chunks_x, g.chunk_x, D, H).transpose(-4, -3)
    V_col = C.transpose(-2, -1).reshape(*batch, g.chunks_y, g.chunk_y, D, W).transpose(-4, -3)
    return V_row.contiguous(), V_col.contiguous()


def volume_from_row_strips(V_row: torch.Tensor) -> torch.Tensor:
    """The (..., H, W, D) volume held in V_row."""
    *batch, chunk, chunks, D, H = V_row.shape
    C = V_row.transpose(-4, -3).reshape(*batch, chunks * chunk, D, H)
    return C.movedim(-1, -3).contiguous()


def volume_from_col_strips(V_col: torch.Tensor) -> torch.Tensor:
    """The (..., H, W, D) volume held in V_col: one permute."""
    *batch, chunk, chunks, D, W = V_col.shape
    return V_col.transpose(-4, -3).transpose(-2, -1).reshape(*batch, chunks * chunk, W, D)


def build_strip_volumes_plain(iml, imr, gl, gr, D: int, alpha: float, chunks: int,
                              chunks_y: Optional[int], dtype=torch.float32):
    """Plain twin of ``build_volumes``: the volume, then both relayouts."""
    g = strip_geometry(iml.shape[-2], iml.shape[-1], D, chunks, chunks_y)
    return strips_from_volume(cost_volume_plain(iml, imr, D, alpha, gl, gr, dtype), g)


def build_strip_volumes(iml, imr, gl, gr, D: int, alpha: float, chunks: int,
                        chunks_y: Optional[int], dtype=torch.float32):
    """(V_row, V_col): the X-stencil cost volume built straight into both
    strip layouts (kernel ``build_volumes`` on CUDA tensors)."""
    iml, imr, gl, gr = (t.float() for t in (iml, imr, gl, gr))
    if iml.is_cuda:
        g = strip_geometry(iml.shape[-2], iml.shape[-1], D, chunks, chunks_y)
        a, b = _alpha_beta(alpha)
        return cuda.build_volumes(iml.contiguous(), imr.contiguous(), gl.contiguous(),
                                  gr.contiguous(), D, a, b, g.chunks_x, g.chunks_y, dtype)
    return build_strip_volumes_plain(iml, imr, gl, gr, D, alpha, chunks, chunks_y, dtype)


def cost_of_disparity(C: torch.Tensor, disp_int: torch.Tensor) -> torch.Tensor:
    """Cost at a given integer disparity per pixel: (..., H, W) lookup into (..., H, W, D)."""
    return torch.gather(C, -1, disp_int.long().unsqueeze(-1)).squeeze(-1)


def sample_at_disparity(values: torch.Tensor, disp_int: torch.Tensor, max_disp: int) -> torch.Tensor:
    """values[y, x - d(y, x)], columns x < d clamped to column 0.

    ``disp_int`` must lie in [0, max_disp); the reference's one-hot over
    max_disp shifts selects exactly one term, so a gather equals it."""
    W = values.shape[-1]
    col = torch.arange(W, device=values.device)
    src = (col - disp_int.long()).clamp_min(0)
    return torch.gather(values, -1, src)


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
