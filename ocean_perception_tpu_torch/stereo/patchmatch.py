"""PatchMatch stereo (port of ``ocean_perception_tpu.stereo.patchmatch``).

Reference semantics (patchmatch_gpu.cu, SURVEY.md §A.2): per iteration
{AddForegroundNoise(32/2^iter) -> PropagateRow(+1) -> PropagateCol(+1) ->
PropagateRow(-1) -> PropagateCol(-1)}, then MaskBackground
(cost(d) < 0.8*cost(0)), a right disparity map and MaskOcclusions.

The left-side match runs on three hand-written kernels when the volume is on
a CUDA device (``csrc/patchmatch.cu``): ``pm_refresh`` per iteration,
``pm_propagate`` per directional pass and ``pm_mask_background`` once. On
CPU tensors the plain twins here run instead; they define the kernels'
results bit for bit.

Only the ``right_wta=True`` path is ported (the one ``perception_step``
runs); the full two-sided match comes with slice 3.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda
from ..ops.image import dilate, gradient_magnitude
from .cost import cost_volume, sample_at_disparity, subpixel_refine


@dataclasses.dataclass(frozen=True)
class PatchMatchParams:
    max_disp: int = 128
    iters: int = 3
    alpha: float = 0.9
    improve_factor: float = 0.8
    chunks: int = 16
    # Strip count for the column (scan-along-y) passes; None = ``chunks``.
    chunks_y: Optional[int] = None
    halo: int = 5
    patch_radius: int = 1
    noise_seed: int = 123
    noise_scale0: float = 32.0
    subpixel: bool = True
    occlusion_lo: float = 0.7
    occlusion_hi: float = 1.4
    init_dilate_factor: int = 4
    # True: the right map is a WTA over the left volume (the production
    # path). False, full PatchMatch on both sides, is not ported yet.
    right_wta: bool = False
    # Store the volume in bfloat16 (the production setting).
    volume_bf16: bool = False


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) on uint32 values held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def unit_noise(shape, seed: int, device=None) -> torch.Tensor:
    """Fixed uniform [-1, 1) noise image, bit for bit
    ``jax.random.uniform(jax.random.PRNGKey(seed), shape, float32, -1, 1)``
    under JAX's partitionable threefry (the reference allocates one noise
    image with cv::RNG(123) and reuses it every frame)."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32((seed >> 32) & _M32, seed & _M32, idx >> 32, idx & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * 2.0 - 1.0, -1.0).reshape(tuple(shape))


def add_foreground_noise(disp: torch.Tensor, noise: torch.Tensor, scale: float) -> torch.Tensor:
    """Perturb only nonzero (foreground) pixels; clamp at 0 (cu:298-304)."""
    mask = (disp > 0).to(disp.dtype)
    return torch.clamp_min((disp + noise * scale) * mask, 0.0)


def _lookup_index(d_eff: torch.Tensor, D: int) -> torch.Tensor:
    """Round half to even, clip to [0, D-1] (jnp.round semantics)."""
    return torch.round(d_eff).clamp(0, D - 1).long()


def _full_cost_map(C: torch.Tensor, disp: torch.Tensor, pr: int) -> torch.Tensor:
    """(H, W) cost of each pixel's current disparity, clamped to x - pr."""
    W, D = C.shape[1], C.shape[2]
    x = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, :]
    idx = _lookup_index(torch.minimum(disp, x - pr), D)
    return torch.gather(C, -1, idx.unsqueeze(-1)).squeeze(-1)


def _refresh(C, disp, noise, scale: float, pr: int):
    """add_foreground_noise, then _full_cost_map (kernel ``pm_refresh``)."""
    if C.is_cuda:
        return cuda.pm_refresh(C, disp, noise, scale, pr)
    disp = add_foreground_noise(disp, noise, scale)
    return disp, _full_cost_map(C, disp, pr)


def _effective_chunks(n: int, chunks: int) -> int:
    """Largest divisor of n that is <= chunks (strips must tile the axis)."""
    c = min(chunks, n)
    while n % c != 0:
        c -= 1
    return c


def _chunk_columns(n: int, chunks: int, halo: int, pr: int, device=None):
    """Strip layout along one axis of length n: clipped positions and the
    CUDA loop-bound validity [max(lo, pr), min(hi, n-pr-1)) per (strip,
    in-strip index), both (chunks, w); the chunk size; the scan length w."""
    chunks = _effective_chunks(n, chunks)
    chunk = n // chunks
    w = chunk + 2 * halo
    c = torch.arange(chunks, device=device)[:, None]
    j = torch.arange(w, device=device)[None, :]
    pos = c * chunk - halo + j
    lo = torch.clamp_min(c * chunk - halo, pr)
    hi = torch.clamp_max((c + 1) * chunk + halo, n - pr - 1)
    valid = (pos >= lo) & (pos < hi)
    return pos.clamp(0, n - 1), valid, chunk, w


def _strips(p: PatchMatchParams, axis: int) -> int:
    if axis == 1 or p.chunks_y is None:
        return p.chunks
    return p.chunks_y


def _propagate_plain(C, disp, cost, direction: int, axis: int, p: PatchMatchParams):
    """Plain twin of ``pm_propagate``: one directional pass over all strips.

    Scan position by position (all strips and lanes at once). Every step
    reads the pass-start disparity and cost of its position and only each
    strip's own chunk is written back (the JAX scan's snapshot semantics)."""
    H, W, D = C.shape
    pr, halo = p.patch_radius, p.halo
    if axis == 1:  # rows pass: positions along x, lanes are rows
        dim, N = W, H
        vals_d, vals_c, vol = disp.t(), cost.t(), C.transpose(0, 1)
    else:
        dim, N = H, W
        vals_d, vals_c, vol = disp, cost, C
    pos, valid, chunk, w = _chunk_columns(dim, _strips(p, axis), halo, pr, C.device)
    lanes = torch.arange(N, device=C.device)
    lane_ok = ((lanes >= pr) & (lanes <= N - pr - 1))[None, :]
    forward = direction > 0
    first = pos[:, 0 if forward else -1]
    carry = vals_d[(first - direction).clamp(0, dim - 1)]
    out_d = torch.empty_like(vals_d)
    out_c = torch.empty_like(vals_c)
    for j in range(w) if forward else range(w - 1, -1, -1):
        pj = pos[:, j]
        cur_d, cur_c = vals_d[pj], vals_c[pj]
        x = (pj[:, None] if axis == 1 else lanes[None, :]).to(disp.dtype)
        cand_d = torch.minimum(carry, x - pr)
        cand_c = vol[pj[:, None], lanes[None, :], _lookup_index(cand_d, D)]
        better = (cand_c.float() < cur_c.float()) & valid[:, j, None] & lane_ok
        carry = torch.where(better, cand_d, cur_d)
        if halo <= j < halo + chunk:
            out_d[pj] = carry
            out_c[pj] = torch.where(better, cand_c, cur_c)
    if axis == 1:
        return out_d.t().contiguous(), out_c.t().contiguous()
    return out_d, out_c


def _propagate(C, disp, cost, direction: int, axis: int, p: PatchMatchParams):
    """One directional pass (kernel ``pm_propagate``). Returns (disp, cost)."""
    if C.is_cuda:
        dim = C.shape[1] if axis == 1 else C.shape[0]
        chunks = _effective_chunks(dim, _strips(p, axis))
        return cuda.pm_propagate(C, disp, cost, direction, axis, chunks, p.halo, p.patch_radius)
    return _propagate_plain(C, disp, cost, direction, axis, p)


def mask_background_plain(C: torch.Tensor, disp: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """Plain twin of ``pm_mask_background``: zero the disparity unless it
    improves cost by improve_factor vs d=0, and on the 1-px frame. The
    threshold is a float32 product, as in the reference."""
    H, W = disp.shape
    pr = p.patch_radius
    cost_d = _full_cost_map(C, disp, pr)
    keep = cost_d.float() < p.improve_factor * C[..., 0].float()
    yy = torch.arange(H, device=disp.device)[:, None]
    xx = torch.arange(W, device=disp.device)[None, :]
    interior = (yy >= pr) & (yy <= H - pr - 1) & (xx >= pr) & (xx <= W - pr - 1)
    return torch.where(keep & interior, disp, 0.0)


def mask_background(C: torch.Tensor, disp: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """MaskBackground (kernel ``pm_mask_background``)."""
    if C.is_cuda:
        return cuda.pm_mask_background(C, disp, p.improve_factor, p.patch_radius)
    return mask_background_plain(C, disp, p)


def _improve_threshold(C: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """improve_factor * cost(0) in the volume's dtype: JAX rounds the factor
    to bf16 for a bf16 volume and rounds the product back to bf16."""
    return torch.tensor(p.improve_factor, dtype=C.dtype, device=C.device) * C[..., 0]


def mask_occlusions(displ: torch.Tensor, dispr: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """L/R consistency: zero where dr(x - dl) is outside [0.7, 1.4]*dl."""
    d_int = torch.round(displ).clamp(0, p.max_disp - 1).long()
    dr = sample_at_disparity(dispr, d_int, p.max_disp)
    bad = (dr > p.occlusion_hi * displ) | (dr < p.occlusion_lo * displ)
    return torch.where(bad, 0.0, displ)


def right_wta_from_left(C: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """WTA right disparity from the LEFT volume: C_R(y, x, d) = C_L(y, x+d, d),
    columns past the right edge clamped to the last column. argmin keeps the
    first minimal d, as the reference's strict running min does."""
    H, W, D = C.shape
    col = torch.arange(W, device=C.device)[:, None] + torch.arange(D, device=C.device)[None, :]
    C_r = torch.gather(C, 1, col.clamp_max(W - 1).expand(H, W, D))
    bestd = torch.argmin(C_r, dim=-1).float()
    best = C_r.amin(dim=-1)
    return torch.where(best < _improve_threshold(C, p), bestd, 0.0)


def sparse_wta_seed(C: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """Confident WTA pixels, max-dilated (element 2*(2^f + 1) + 1), replacing
    the reference's GFTT + stripe-template sparse init (cu:414-442)."""
    wta = torch.argmin(C, dim=-1).float()
    best = C.amin(dim=-1)
    seeds = torch.where(best < _improve_threshold(C, p), wta, 0.0)
    dilate_size = 2 ** p.init_dilate_factor + 1
    return dilate(seeds, 2 * dilate_size + 1)


class PatchMatchResult(NamedTuple):
    left: torch.Tensor
    right: torch.Tensor
    left_raw: torch.Tensor  # before occlusion masking


def _match_one_side(C, seed, noise, p: PatchMatchParams) -> torch.Tensor:
    """The whole left-side match: per iteration noise + cost refresh and the
    R+ C+ R- C- passes, then MaskBackground."""
    disp = seed.float().contiguous()
    for it in range(p.iters):
        disp, cost = _refresh(C, disp, noise, p.noise_scale0 / 2.0**it, p.patch_radius)
        disp, cost = _propagate(C, disp, cost, +1, 1, p)
        disp, cost = _propagate(C, disp, cost, +1, 0, p)
        disp, cost = _propagate(C, disp, cost, -1, 1, p)
        disp, cost = _propagate(C, disp, cost, -1, 0, p)
    return mask_background(C, disp, p)


def patchmatch_disparity(
    iml: torch.Tensor,
    imr: torch.Tensor,
    params: PatchMatchParams = PatchMatchParams(),
    seed_left: Optional[torch.Tensor] = None,
) -> PatchMatchResult:
    """PatchMatch pipeline: left disparity (masked and raw) and right WTA map."""
    if not params.right_wta:
        raise NotImplementedError(
            "right_wta=False (full PatchMatch on both sides) is not ported yet: "
            "it comes with slice 3 (stereo engines)")
    iml = iml.float()
    imr = imr.float()
    gl = gradient_magnitude(iml)
    gr = gradient_magnitude(imr)
    vdtype = torch.bfloat16 if params.volume_bf16 else torch.float32
    C_l = cost_volume(iml, imr, params.max_disp, params.alpha, gl, gr, dtype=vdtype)

    noise = unit_noise(iml.shape, params.noise_seed, device=iml.device)
    if seed_left is None:
        seed_left = sparse_wta_seed(C_l, params)
    disp_l = _match_one_side(C_l, seed_left, noise, params)
    disp_r = right_wta_from_left(C_l, params)

    if params.subpixel:
        int_l = torch.round(disp_l).clamp(0, params.max_disp - 1).long()
        disp_l = torch.where(disp_l > 0, subpixel_refine(C_l, int_l), 0.0)

    left_masked = mask_occlusions(disp_l, disp_r, params)
    return PatchMatchResult(left=left_masked, right=disp_r, left_raw=disp_l)
