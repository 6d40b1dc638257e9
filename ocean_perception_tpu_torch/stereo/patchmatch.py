"""PatchMatch stereo (port of ``ocean_perception_tpu.stereo.patchmatch``).

Reference semantics (patchmatch_gpu.cu, SURVEY.md §A.2): per iteration
{AddForegroundNoise(32/2^iter) -> PropagateRow(+1) -> PropagateCol(+1) ->
PropagateRow(-1) -> PropagateCol(-1)}, then MaskBackground
(cost(d) < 0.8*cost(0)), a right disparity map and MaskOcclusions.

Each side's match is one launch of a hand-written kernel when the volume is
on a CUDA device (``csrc/patchmatch.cu``): ``pm_match``, every pass of every
iteration with the refresh and the mask folded in. On CPU tensors the plain
twin :func:`_match_plain` runs instead, built from the plain twins of the
stages (``_refresh_plain``, ``_propagate_plain``, ``mask_background_plain``);
it defines the kernel's result bit for bit.

The kernel reads the volume in one of two layouts. The (H, W, D) volume of
:func:`~.cost.cost_volume`, or, with ``use_strip_volumes``, the two strip
layouts of :func:`~.cost.build_strip_volumes` (``pm_match_strip``): row
passes read ``V_row`` and column passes ``V_col``. Both give the same
disparities bit for bit.

Every function takes a batch: images (..., H, W) and volumes (..., H, W, D),
the leading axes a batch of stereo pairs (cameras), each matched on its own
and all in one kernel launch. The noise image is one (H, W) image for every
pair, as the reference's fixed-key noise is under ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda
from ..ops.image import dilate, gradient_magnitude
from .cost import (_effective_chunks, build_strip_volumes, cost_volume, cost_volume_zncc,
                   right_cost_volume_from_left, sample_at_disparity, subpixel_refine,
                   volume_from_col_strips, volume_from_row_strips)


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
    # path). False: full PatchMatch on both sides.
    right_wta: bool = False
    # Matching cost: "l1g" = the reference X-stencil L1+gradient cost;
    # "zncc" = 1 - ZNCC over zncc_patch (the CPU PatchMatch's test functor).
    cost: str = "l1g"
    zncc_patch: int = 5
    # Build the volume straight into the two strip layouts and match over
    # them (kernel build_volumes and the *_strip kernels). Needs right_wta,
    # the l1g cost and iters >= 1; bit-identical to the (H, W, D) path.
    use_strip_volumes: bool = False
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
    """(..., H, W) cost of each pixel's current disparity, clamped to x - pr."""
    W, D = C.shape[-2], C.shape[-1]
    x = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, :]
    idx = _lookup_index(torch.minimum(disp, x - pr), D)
    return torch.gather(C, -1, idx.unsqueeze(-1)).squeeze(-1)


def _refresh_plain(C, disp, noise, scale: float, pr: int):
    """An iteration's refresh: add_foreground_noise, then _full_cost_map."""
    disp = add_foreground_noise(disp, noise, scale)
    return disp, _full_cost_map(C, disp, pr)


def _refresh_strip_plain(V_col, disp, noise, scale: float, pr: int):
    """The refresh over V_col."""
    return _refresh_plain(volume_from_col_strips(V_col), disp, noise, scale, pr)


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
    """One directional pass over all strips (a pass of ``pm_match``).

    Scan position by position (all pairs, strips and lanes at once). Every
    step reads the pass-start disparity and cost of its position and only
    each strip's own chunk is written back (the JAX scan's snapshot
    semantics)."""
    batch = disp.shape[:-2]
    C = C.reshape(-1, *C.shape[-3:])  # one batch axis, a view
    B, H, W, D = C.shape
    disp, cost = disp.reshape(B, H, W), cost.reshape(B, H, W)
    pr, halo = p.patch_radius, p.halo
    if axis == 1:  # rows pass: positions along x, lanes are rows
        dim, N = W, H
        vals_d, vals_c, vol = disp.transpose(1, 2), cost.transpose(1, 2), C.transpose(1, 2)
    else:
        dim, N = H, W
        vals_d, vals_c, vol = disp, cost, C
    pos, valid, chunk, w = _chunk_columns(dim, _strips(p, axis), halo, pr, C.device)
    cams = torch.arange(B, device=C.device)[:, None, None]
    lanes = torch.arange(N, device=C.device)
    lane_ok = (lanes >= pr) & (lanes <= N - pr - 1)
    forward = direction > 0
    first = pos[:, 0 if forward else -1]
    carry = vals_d[:, (first - direction).clamp(0, dim - 1)]  # (B, strips, N)
    out_d = torch.empty_like(vals_d)
    out_c = torch.empty_like(vals_c)
    for j in range(w) if forward else range(w - 1, -1, -1):
        pj = pos[:, j]
        cur_d, cur_c = vals_d[:, pj], vals_c[:, pj]
        x = (pj[:, None] if axis == 1 else lanes).to(disp.dtype)
        cand_d = torch.minimum(carry, x - pr)
        cand_c = vol[cams, pj[:, None], lanes, _lookup_index(cand_d, D)]
        better = (cand_c.float() < cur_c.float()) & valid[:, j, None] & lane_ok
        carry = torch.where(better, cand_d, cur_d)
        if halo <= j < halo + chunk:
            out_d[:, pj] = carry
            out_c[:, pj] = torch.where(better, cand_c, cur_c)
    if axis == 1:
        out_d, out_c = out_d.transpose(1, 2), out_c.transpose(1, 2)
    return out_d.reshape(*batch, H, W).contiguous(), out_c.reshape(*batch, H, W).contiguous()


def _propagate_strip_plain(V, disp, cost, direction: int, axis: int, p: PatchMatchParams):
    """One directional pass over a strip layout: V is V_row for a row pass
    (axis 1) and V_col for a column pass (axis 0)."""
    C = volume_from_row_strips(V) if axis == 1 else volume_from_col_strips(V)
    return _propagate_plain(C, disp, cost, direction, axis, p)


def _mask_with_cost(C: torch.Tensor, disp: torch.Tensor, cost_d: torch.Tensor,
                    p: PatchMatchParams) -> torch.Tensor:
    """MaskBackground given cost_d, the cost of each pixel's disparity:
    zero the disparity unless it improves cost by improve_factor vs d=0, and
    on the 1-px frame. The threshold is a float32 product, as in the
    reference."""
    H, W = disp.shape[-2:]
    pr = p.patch_radius
    keep = cost_d.float() < p.improve_factor * C[..., 0].float()
    yy = torch.arange(H, device=disp.device)[:, None]
    xx = torch.arange(W, device=disp.device)[None, :]
    interior = (yy >= pr) & (yy <= H - pr - 1) & (xx >= pr) & (xx <= W - pr - 1)
    return torch.where(keep & interior, disp, 0.0)


def mask_background_plain(C: torch.Tensor, disp: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """MaskBackground, the cost of each disparity looked up in C."""
    return _mask_with_cost(C, disp, _full_cost_map(C, disp, p.patch_radius), p)


def mask_background_strip_plain(V_col: torch.Tensor, disp: torch.Tensor,
                                p: PatchMatchParams) -> torch.Tensor:
    """MaskBackground over V_col."""
    return mask_background_plain(volume_from_col_strips(V_col), disp, p)


def _improve_threshold(C: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """improve_factor * cost(0) in the volume's dtype: JAX rounds the factor
    to bf16 for a bf16 volume and rounds the product back to bf16. The
    factor, so rounded, is a Python float: exact in float32, where torch
    multiplies, and no copy to the device."""
    factor = float(torch.tensor(p.improve_factor, dtype=C.dtype))
    return factor * C[..., 0]


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
    C_r = right_cost_volume_from_left(C)
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


PASSES = ((+1, 1), (+1, 0), (-1, 1), (-1, 0))  # R+ C+ R- C-: (direction, axis)


def _match_passes(C_row, C_col, seed, noise, p: PatchMatchParams):
    """The match before its mask: per iteration noise + cost refresh and the
    R+ C+ R- C- passes. Returns (disp, cost), where cost is the one the
    passes carry: the cost of each pixel's disparity (after the refresh and
    after every pass, ``cost == _full_cost_map(C, disp, pr)``). Row passes
    read C_row, the refresh and column passes C_col: the same volume, one
    copy a layout."""
    disp = seed.float()
    cost = _full_cost_map(C_col, disp, p.patch_radius)
    for it in range(p.iters):
        disp, cost = _refresh_plain(C_col, disp, noise, p.noise_scale0 / 2.0**it, p.patch_radius)
        for direction, axis in PASSES:
            disp, cost = _propagate_plain(C_row if axis == 1 else C_col, disp, cost, direction,
                                          axis, p)
    return disp, cost


def _match_plain(C_row, C_col, seed, noise, p: PatchMatchParams) -> torch.Tensor:
    """Plain twin of ``pm_match``: :func:`_match_passes`, then MaskBackground
    on the cost the passes carry."""
    return _mask_with_cost(C_col, *_match_passes(C_row, C_col, seed, noise, p), p)


def _match_one_side(C, seed, noise, p: PatchMatchParams) -> torch.Tensor:
    """One side's match (kernel ``pm_match``): C (..., H, W, D), seed
    (..., H, W), one (H, W) noise image for all."""
    if C.is_cuda:
        H, W = C.shape[-3:-1]
        return cuda.pm_match(C, seed.float().contiguous(), noise, p.iters, p.noise_scale0,
                             _effective_chunks(W, p.chunks), _effective_chunks(H, _strips(p, 0)),
                             p.halo, p.patch_radius, p.improve_factor)
    return _match_plain(C, C, seed, noise, p)


def _match_one_side_strips(V_row, V_col, seed, noise, p: PatchMatchParams) -> torch.Tensor:
    """:func:`_match_one_side` over the strip layouts (kernel
    ``pm_match_strip``): row passes read V_row, column passes V_col."""
    if V_row.is_cuda:
        return cuda.pm_match_strip(V_row, V_col, seed.float().contiguous(), noise, p.iters,
                                   p.noise_scale0, p.halo, p.patch_radius, p.improve_factor)
    return _match_plain(volume_from_row_strips(V_row), volume_from_col_strips(V_col), seed, noise, p)


def _refine(C: torch.Tensor, disp: torch.Tensor, p: PatchMatchParams) -> torch.Tensor:
    """Parabola subpixel refinement of the nonzero disparities."""
    d_int = torch.round(disp).clamp(0, p.max_disp - 1).long()
    return torch.where(disp > 0, subpixel_refine(C, d_int), 0.0)


def patchmatch_disparity(
    iml: torch.Tensor,
    imr: torch.Tensor,
    params: PatchMatchParams = PatchMatchParams(),
    seed_left: Optional[torch.Tensor] = None,
    seed_right: Optional[torch.Tensor] = None,
) -> PatchMatchResult:
    """PatchMatch pipeline: left disparity (masked and raw) and right map."""
    p = params
    if p.cost not in ("l1g", "zncc"):
        raise ValueError(f"unknown matching cost {p.cost!r}: 'l1g' or 'zncc'")
    if p.use_strip_volumes and not (p.right_wta and p.cost == "l1g" and p.iters >= 1):
        raise ValueError("use_strip_volumes needs right_wta=True, cost='l1g' and iters >= 1, got "
                         f"right_wta={p.right_wta}, cost={p.cost!r}, iters={p.iters}")
    iml = iml.float()
    imr = imr.float()
    strips = None
    if p.cost == "zncc":
        C_l = cost_volume_zncc(iml, imr, p.max_disp, p.zncc_patch)
    else:
        gl = gradient_magnitude(iml)
        gr = gradient_magnitude(imr)
        vdtype = torch.bfloat16 if p.volume_bf16 else torch.float32
        if p.use_strip_volumes:
            strips = build_strip_volumes(iml, imr, gl, gr, p.max_disp, p.alpha, p.chunks,
                                         p.chunks_y, vdtype)
            # The seed, right WTA and subpixel consumers read (H, W, D).
            C_l = volume_from_col_strips(strips[1])
        else:
            C_l = cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, dtype=vdtype)

    noise = unit_noise(iml.shape[-2:], p.noise_seed, device=iml.device)
    if seed_left is None:
        seed_left = sparse_wta_seed(C_l, p)
    if p.right_wta:
        if strips is None:
            disp_l = _match_one_side(C_l, seed_left, noise, p)
        else:
            disp_l = _match_one_side_strips(*strips, seed_left, noise, p)
        disp_r = right_wta_from_left(C_l, p)
    else:
        C_r = right_cost_volume_from_left(C_l)
        if seed_right is None:
            seed_right = sparse_wta_seed(C_r, p)
        disp_l = _match_one_side(C_l, seed_left, noise, p)
        disp_r = _match_one_side(C_r, seed_right, noise, p)

    if p.subpixel:
        disp_l = _refine(C_l, disp_l, p)
        # The WTA right map only feeds the occlusion ratio check.
        if not p.right_wta:
            disp_r = _refine(C_r, disp_r, p)

    left_masked = mask_occlusions(disp_l, disp_r, p)
    return PatchMatchResult(left=left_masked, right=disp_r, left_raw=disp_l)
