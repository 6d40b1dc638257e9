"""The enhancement with an image's rows split across devices (port of
``ocean_perception_tpu.parallel.spatial``).

Each device holds a block of rows of the image and its range map, and
runs the stages that are local to a pixel or a row on its block: the
intensity, the dark mask, the backscatter removal, the guided filter's
subsampling and its upsampled coefficients, the attenuation correction.
What crosses devices, each gathered in row order to the lead device (the
axis's first) and the result sent back:
  - the dark-pixel bisection: each block's masked count below the midpoint,
    and the masked minimum, maximum and count of its intensity;
  - the backscatter fit's samples: each block's candidate for each of the
    sampling buckets (its masked pixel of highest hash rank and lowest
    index, with its colour and range); the fit (its normal equations and
    their solves) runs on the lead device;
  - the guided filter's subsampled guide and target rows: the box filters
    run at the low resolution on the lead device, where their radius
    reaches a third of the image's width, and each block upsamples the
    coefficients' rows it owns;
  - the attenuation fit's grid samples; the fit runs on the lead device;
  - the largest range, for the attenuation correction's empty ranges.
Counts, extrema and selections are exact in any order, and each fit sees
the samples of the whole image in their order, so the result equals the
unsplit :func:`~..imaging.enhance.enhance_underwater` bit for bit.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from ..imaging.attenuation import (best_fit, correct_attenuation, fit_beta, grid_positions,
                                   pad_samples)
from ..imaging.backscatter import (MIN_VALID_RANGE, fit_backscatter, remove_backscatter,
                                   sample_masked_pixels_blocks)
from ..imaging.enhance import EnhanceInfo, EnhanceParams, _next_even_int
from ..imaging.formation import beta_guesses
from ..ops.guided_filter import guided_coefficients, guided_size
from ..ops.histogram import bisect_threshold
from ..ops.image import compute_intensity, nearest_source, resize
from .mesh import Mesh, Sharding, join_rows, split_rows


def strip_sharding(mesh: Mesh, axis: str = "strip", batch_axis: str | None = None) -> Sharding:
    """Sharding of (H, W[, C]) images, rows over ``axis``, or of batched
    (N, H, W[, C]) ones when ``batch_axis`` is given."""
    if batch_axis is None:
        return Sharding(mesh, (axis,))
    return Sharding(mesh, (batch_axis, axis))


def _dark_masks(intensity, valid, percentile: float, lead: torch.device):
    """find_dark_mask over the blocks: one bisection on the lead device."""
    big = torch.finfo(torch.float32).max
    mask_f = [v.float() for v in valid]
    total = torch.stack([m.sum().to(lead) for m in mask_f]).sum()
    lo = torch.stack([torch.where(v, x, big).amin().to(lead) for x, v in zip(intensity, valid)]).amin()
    hi = torch.stack([torch.where(v, x, -big).amax().to(lead) for x, v in zip(intensity, valid)]).amax()

    def count(mid):
        return torch.stack([torch.where(x < mid.to(x.device), m, 0.0).sum().to(lead)
                            for x, m in zip(intensity, mask_f)]).sum()

    thresh = bisect_threshold(lo, hi, count, total, percentile, 10)
    return [v & (x < thresh.to(x.device)) for x, v in zip(intensity, valid)]


@functools.lru_cache(maxsize=64)
def _subsampled_rows(H: int, h: int, row0: int, n: int, device: torch.device) -> torch.Tensor:
    """Local index of the rows of block [row0, row0 + n) that the nearest
    subsampling of H rows to h keeps, on ``device``."""
    src = nearest_source(H, h)
    return torch.as_tensor(src[(src >= row0) & (src < row0 + n)] - row0, device=device)


@functools.lru_cache(maxsize=64)
def _grid_rows(H: int, W: int, num_px: int, row0: int, n: int, device: torch.device):
    """(y, x): the attenuation grid's samples in block [row0, row0 + n), local rows."""
    yy, xx = (t.numpy() for t in grid_positions(H, W, num_px))
    mine = (yy >= row0) & (yy < row0 + n)
    return (torch.as_tensor(yy[mine] - row0, device=device),
            torch.as_tensor(xx[mine], device=device))


def _guided_illuminant(ranges, D, radius: int, eps: float, subsample: int, lead: torch.device):
    """2 * fast_guided_filter(range, D) over the blocks: the subsampled rows
    gathered on the lead device, the coefficients' rows upsampled on each."""
    H, W = sum(r.shape[0] for r in ranges), ranges[0].shape[1]
    h, w, r_small = guided_size(H, W, radius, subsample)
    I_rows, p_rows, row0 = [], [], 0
    for rng, d in zip(ranges, D):
        n = rng.shape[0]
        # The guide and the target's channels in front, their columns
        # subsampled, then the subsampled rows that come from this block.
        small = resize(torch.cat([rng[None], d.movedim(-1, 0)]), (n, w), "nearest")
        small = small.index_select(-2, _subsampled_rows(H, h, row0, n, rng.device)).to(lead)
        I_rows.append(small[:1])
        p_rows.append(small[1:])
        row0 += n
    mean_a, mean_b = guided_coefficients(torch.cat(I_rows, dim=-2), torch.cat(p_rows, dim=-2),
                                         r_small, eps)
    out, row0 = [], 0
    for rng in ranges:
        n, dev = rng.shape[0], rng.device
        a = resize(mean_a.to(dev), (H, W), "linear", rows=(row0, n))
        b = resize(mean_b.to(dev), (H, W), "linear", rows=(row0, n))
        out.append((2.0 * (a * rng[None] + b)).movedim(0, -1))
        row0 += n
    return out


def _grid_samples_blocks(ranges, illuminants, num_px: int, lead: torch.device):
    """The attenuation fit's grid samples of the blocks, in row order, on the lead."""
    H, W = sum(r.shape[0] for r in ranges), ranges[0].shape[1]
    zs, Es, row0 = [], [], 0
    for rng, il in zip(ranges, illuminants):
        n = rng.shape[0]
        y, x = _grid_rows(H, W, num_px, row0, n, rng.device)
        zs.append(rng[y, x].to(lead))
        Es.append(il[y, x, :].to(lead))
        row0 += n
    return pad_samples(torch.cat(zs), torch.cat(Es), num_px)


def enhance_blocks(images: Sequence[torch.Tensor], ranges: Sequence[torch.Tensor],
                   params: EnhanceParams = EnhanceParams(), beta_D_guess=None
                   ) -> tuple[List[torch.Tensor], EnhanceInfo]:
    """enhance_underwater of one (H, W, 3) image split by rows into blocks,
    (h, W, 3) images and (h, W) ranges on their devices in row order: the
    enhanced blocks, each on its device, and the EnhanceInfo on the first
    block's device. See the module docstring for what crosses devices."""
    images = [x.float() for x in images]
    ranges = [r.float() for r in ranges]
    lead = images[0].device
    W = ranges[0].shape[1]

    intensity = [compute_intensity(x) for x in images]
    dark = _dark_masks(intensity, [r > MIN_VALID_RANGE for r in ranges], params.dark_percentile,
                       lead)
    fit = fit_backscatter(*sample_masked_pixels_blocks(images, ranges, dark, params.back_num_px,
                                                       lead), params.back_opt_iters)
    D = [remove_backscatter(x, r, fit.B.to(x.device), fit.beta_B.to(x.device))
         for x, r in zip(images, ranges)]

    il = _guided_illuminant(ranges, D, _next_even_int(W // 3), params.guided_eps,
                            params.guided_subsample, lead)
    starts = beta_guesses(lead)
    if beta_D_guess is not None:
        guess = torch.as_tensor(beta_D_guess, dtype=torch.float32, device=lead)
        starts = torch.cat([starts, guess.reshape(1, 12)])
    beta_fit = best_fit(fit_beta(*_grid_samples_blocks(ranges, il, params.beta_num_px, lead),
                                 params.beta_opt_iters, starts))

    zmax = torch.stack([r.amax().to(lead) for r in ranges]).amax()
    out = [correct_attenuation(d, r, beta_fit.X.to(r.device), zmax.to(r.device).reshape(1, 1))
           for d, r in zip(D, ranges)]
    info = EnhanceInfo(B=fit.B, beta_B=fit.beta_B, Jp=fit.Jp, beta_Dp=fit.beta_Dp,
                       beta_D=beta_fit.X, error_backscatter=fit.error,
                       error_attenuation=beta_fit.error, success_backscatter=fit.error < 0.1,
                       success_attenuation=beta_fit.error < 0.1)
    return out, info


def sharded_enhance(image: torch.Tensor, range_img: torch.Tensor, mesh: Mesh,
                    params: EnhanceParams = EnhanceParams(), axis: str = "strip"):
    """Enhancement of one (H, W, 3) image with its rows split over
    ``mesh[axis]``; semantics identical to the unsplit call. Returns
    (enhanced image, EnhanceInfo) on the axis's first device."""
    devices = mesh.axis_devices(axis)
    images = split_rows(torch.as_tensor(image, dtype=torch.float32), devices)
    ranges = split_rows(torch.as_tensor(range_img, dtype=torch.float32), devices)
    out, info = enhance_blocks(images, ranges, params)
    return join_rows(out, devices[0]), info
