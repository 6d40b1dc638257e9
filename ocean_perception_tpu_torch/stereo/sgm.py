"""Semi-global matching over the shared cost volume (port of
``ocean_perception_tpu.stereo.sgm``).

The SGM recurrence along a path direction r:
    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d±1) + P1,
                               min_d' L_r(p-r, d') + P2 ) - min_d' L_r(p-r, d')

Each directional pass walks its axis step by step (a Python loop, the JAX
scan) with the whole front of every strip advancing at once; 4 directions
are summed. Both sides of every stereo pair of a batch (images (..., H, W))
aggregate as one leading batch (JAX's vmap), so the recurrence's steps run
once for all of them. Plain PyTorch: the JAX package has no TPU kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .cost import (_effective_chunks, cost_volume, right_cost_volume_from_left,
                   sample_at_disparity, subpixel_refine)


@dataclasses.dataclass(frozen=True)
class SgmParams:
    max_disp: int = 128
    alpha: float = 0.9
    p1: float = 0.06
    p2: float = 0.5
    subpixel: bool = True
    uniqueness: float = 0.95
    lr_threshold: float = 1.5
    # Strip-parallel passes: each directional pass splits into ``chunks``
    # strips that warm up over ``halo`` predecessor rows (the tiled-SGM
    # approximation); 1 = exact full-image paths.
    chunks: int = 8
    halo: int = 8
    # Zero pixels whose aggregated d=0 cost is nearly as good as the best;
    # None disables.
    background_improve: Optional[float] = None


def _sgm_step(prev: torch.Tensor, c_row: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One recurrence step: prev (..., M, D) -> (..., M, D); the neighbour
    past either end of D is 1e9."""
    prev_min = prev.amin(dim=-1, keepdim=True)
    up = torch.nn.functional.pad(prev[..., :-1], (1, 0), value=1e9)
    down = torch.nn.functional.pad(prev[..., 1:], (0, 1), value=1e9)
    best = torch.minimum(torch.minimum(prev, torch.minimum(up, down) + p1), prev_min + p2)
    return c_row + best - prev_min


def _directional_pass(C_sweep: torch.Tensor, p1: float, p2: float, chunks: int = 1,
                      halo: int = 0) -> torch.Tensor:
    """Aggregate along axis -3 of (B, N, M, D), forward direction.

    chunks > 1: the N axis splits into strips advancing together (w = N/chunks
    + halo steps instead of N); each strip warms up over ``halo``
    predecessor rows, clamped to row 0."""
    B, N, M, D = C_sweep.shape
    c = _effective_chunks(N, chunks)
    if c <= 1:
        outs = [C_sweep[:, 0]]
        for j in range(1, N):
            outs.append(_sgm_step(outs[-1], C_sweep[:, j], p1, p2))
        return torch.stack(outs, dim=1)

    n = N // c
    w = n + halo
    s = torch.arange(c, device=C_sweep.device)[:, None]
    j = torch.arange(w, device=C_sweep.device)[None, :]
    pos = (s * n - halo + j).clamp(0, N - 1)  # (c, w) absolute rows
    Cc = C_sweep[:, pos]                       # (B, c, w, M, D)
    outs = [Cc[:, :, 0]]
    for k in range(1, w):
        outs.append(_sgm_step(outs[-1], Cc[:, :, k], p1, p2))
    interior = torch.stack(outs[halo:], dim=2)  # (B, c, n, M, D)
    return interior.reshape(B, N, M, D)


def sgm_aggregate(C: torch.Tensor, params: SgmParams) -> torch.Tensor:
    """Sum of the 4 directional passes: (B, H, W, D) -> (B, H, W, D)."""
    p1, p2, ck, hl = params.p1, params.p2, params.chunks, params.halo
    down = _directional_pass(C, p1, p2, ck, hl)
    up = _directional_pass(C.flip(1), p1, p2, ck, hl).flip(1)
    Ch = C.transpose(1, 2)  # (B, W, H, D): horizontal passes
    right = _directional_pass(Ch, p1, p2, ck, hl)
    left = _directional_pass(Ch.flip(1), p1, p2, ck, hl).flip(1)
    return down + up + right.transpose(1, 2) + left.transpose(1, 2)


class SgmResult(NamedTuple):
    left: torch.Tensor
    right: torch.Tensor
    left_raw: torch.Tensor


def _wta_with_masks(S: torch.Tensor, params: SgmParams) -> torch.Tensor:
    """argmin over D (the first minimum), zeroed where background_improve
    says the pixel is background."""
    disp = torch.argmin(S, dim=-1)
    if params.background_improve is not None:
        keep = S.amin(dim=-1) < params.background_improve * S[..., 0]
        disp = torch.where(keep, disp, 0)
    return disp


def _lr_check(disp_l: torch.Tensor, disp_r: torch.Tensor, thresh: float,
              max_disp: int) -> torch.Tensor:
    """Zero left disparities whose right match at x - d disagrees by more
    than ``thresh``."""
    d_int = torch.round(disp_l).clamp(0, max_disp - 1).long()
    dr = sample_at_disparity(disp_r, d_int, max_disp)
    return torch.where((dr - disp_l).abs() <= thresh, disp_l, 0.0)


def sgm_disparity(iml: torch.Tensor, imr: torch.Tensor,
                  params: SgmParams = SgmParams()) -> SgmResult:
    """Cost -> 4-path aggregation of both sides -> WTA -> subpixel -> LR check.
    The right side aggregates the right volume derived from the left."""
    C_l = cost_volume(iml.float(), imr.float(), params.max_disp, params.alpha)
    C_r = right_cost_volume_from_left(C_l)
    sides = torch.stack([C_l, C_r])
    S = sgm_aggregate(sides.reshape(-1, *C_l.shape[-3:]), params).reshape(sides.shape)
    d = _wta_with_masks(S, params)
    if params.subpixel:
        disp_l, disp_r = subpixel_refine(S[0], d[0]), subpixel_refine(S[1], d[1])
    else:
        disp_l, disp_r = d[0].float(), d[1].float()
    left = _lr_check(disp_l, disp_r, params.lr_threshold, params.max_disp)
    return SgmResult(left=left, right=disp_r, left_raw=disp_l)
