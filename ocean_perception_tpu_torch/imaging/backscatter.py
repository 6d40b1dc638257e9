"""Backscatter estimation and removal, Sea-thru stage 1 (port of
``ocean_perception_tpu.imaging.backscatter``).

- FindDarkFast: the darkest percentile of valid-range pixels, by bisection.
- EstimateBackscatter: LM over 12 parameters X = [B, beta_B, J', beta_D'] on
  up to num_px sampled dark pixels, Cauchy-weighted, accept/reject on the
  unweighted mean SSD.
- RemoveBackscatter: D = max(I - B(1 - exp(-beta_B z)), 0), zero ranges set
  to 20 m.

Pixel sampling is the reference's lattice-bucketed hash-argmax: static
shapes, deterministic given the image.

Images are (..., H, W, 3) with (..., H, W) ranges: leading axes are a batch
of images (cameras), each with its own threshold, samples and fit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.histogram import masked_percentile_threshold
from ..ops.lm import LMConfig, LMResult, channel_sq, lm_solve, row_sums
from .formation import backscatter_start

BACKGROUND_RANGE = 20.0  # meters; backscatter.cpp kBackgroundRange
MIN_VALID_RANGE = 0.1    # meters; closer pixels carry no range signal

_M32 = 0xFFFFFFFF


def find_dark_mask(
    intensity: torch.Tensor,
    range_img: torch.Tensor,
    percentile: float = 0.01,
    iters: int = 10,
) -> torch.Tensor:
    """Boolean mask of the darkest ``percentile`` of valid-range pixels."""
    valid = range_img > MIN_VALID_RANGE
    thresh = masked_percentile_threshold(intensity, valid, percentile, iters)
    return valid & (intensity < thresh[..., None, None])


def _hash_rank(n: int, device=None, start: int = 0) -> torch.Tensor:
    """Knuth-hash ranking of flat pixel indices start .. start+n-1 with
    uint32 wraparound, held in int64: (idx * 2654435761 mod 2^32) ^ (idx >> 16)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return ((idx * 2654435761) & _M32) ^ (idx >> 16)


def _buckets(num_px: int) -> Tuple[int, int]:
    """(s1, s2), s1*s2 = num_px: the bucket lattice of the sampling."""
    s1 = int(num_px**0.5)
    while num_px % s1:
        s1 -= 1
    return s1, num_px // s1


def sample_masked_pixels(
    image: torch.Tensor,
    range_img: torch.Tensor,
    mask: torch.Tensor,
    num_px: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to num_px pixels of ``mask`` in each image: (rgb (..., N, 3),
    z (..., N), valid (..., N)).

    Pixel (r, c) belongs to bucket (r mod s1, c mod s2), s1*s2 = num_px;
    each bucket gives its masked pixel of highest hash rank (ties to the
    first index). The rank hashes the pixel's index within its image."""
    *batch, H, W = range_img.shape
    s1, s2 = _buckets(num_px)
    hb, wb = -(-H // s1), -(-W // s2)
    rank = _hash_rank(H * W, range_img.device).reshape(H, W)
    score = range_img.new_full((*batch, hb * s1, wb * s2), -1, dtype=torch.int64)
    score[..., :H, :W] = torch.where(mask, rank >> 1, -1)
    tiles = score.reshape(*batch, hb, s1, wb, s2).movedim((-3, -1), (-4, -3))
    tiles = tiles.reshape(*batch, num_px, hb * wb)
    j = torch.argmax(tiles, dim=-1)
    valid = torch.gather(tiles, -1, j[..., None])[..., 0] >= 0
    b = torch.arange(num_px, device=range_img.device)
    rp = (j // wb) * s1 + b // s2
    cp = (j % wb) * s2 + b % s2
    idx = torch.clamp_max(rp, H - 1) * W + torch.clamp_max(cp, W - 1)
    rgb = torch.gather(image.reshape(*batch, H * W, 3), -2, idx[..., None].expand(*idx.shape, 3))
    return rgb, torch.gather(range_img.reshape(*batch, H * W), -1, idx), valid


class BackscatterFit(NamedTuple):
    B: torch.Tensor        # (..., 3)
    beta_B: torch.Tensor   # (..., 3)
    Jp: torch.Tensor       # (..., 3)
    beta_Dp: torch.Tensor  # (..., 3)
    error: torch.Tensor    # (...) mean channel SSD over the samples


def _residual_terms(X: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor):
    X = X[..., None, :]  # broadcast the parameters over the samples
    B, beta_B, Jp, beta_Dp = X[..., 0:3], X[..., 3:6], X[..., 6:9], X[..., 9:12]
    zz = z[..., None]
    atten_back = 1.0 - torch.exp(-beta_B * zz)
    exp_beta_D = torch.exp(-beta_Dp * zz)
    model = B * atten_back + Jp * exp_beta_D
    return rgb - model, atten_back, exp_beta_D


def sample_masked_pixels_blocks(images, ranges, masks, num_px: int, lead: torch.device):
    """:func:`sample_masked_pixels` of one (H, W) image split by rows into
    blocks on their devices ((h, W, 3) images, (h, W) ranges and masks, in
    row order): each block's candidate for each bucket, its masked pixel of
    highest hash rank and lowest index, goes to ``lead``, where the best of
    the blocks' candidates is kept. The same pixels as the whole image's."""
    W = ranges[0].shape[-1]
    H = sum(r.shape[-2] for r in ranges)
    s1, s2 = _buckets(num_px)
    if H < s1 or W < s2:
        raise ValueError(f"blocks of a {H}x{W} image leave sampling buckets of {s1}x{s2} empty")
    keys, rgbs, zs = [], [], []
    row0 = 0
    for image, rng, mask in zip(images, ranges, masks):
        h, dev = rng.shape[-2], rng.device
        idx = torch.arange(row0 * W, (row0 + h) * W, dtype=torch.int64, device=dev)
        score = torch.where(mask.reshape(-1), _hash_rank(h * W, dev, row0 * W) >> 1, -1)
        # Highest score first, then lowest index: (score, -idx) as one int64.
        key = score * 2**32 + (_M32 - idx)
        rows = torch.arange(row0, row0 + h, device=dev)[:, None] % s1
        cols = torch.arange(W, device=dev)[None, :] % s2
        bucket = (rows * s2 + cols).reshape(-1)
        best = torch.full((num_px,), torch.iinfo(torch.int64).min, dtype=torch.int64, device=dev)
        best = best.scatter_reduce(0, bucket, key, "amax")
        local = (_M32 - (best & _M32) - row0 * W).clamp(0, h * W - 1)
        keys.append(best.to(lead))
        rgbs.append(image.reshape(h * W, 3)[local].to(lead))
        zs.append(rng.reshape(h * W)[local].to(lead))
        row0 += h
    keys = torch.stack(keys)
    j = torch.argmax(keys, dim=0, keepdim=True)
    rgb = torch.take_along_dim(torch.stack(rgbs), j[..., None], dim=0)[0]
    z = torch.take_along_dim(torch.stack(zs), j, dim=0)[0]
    return rgb, z, torch.take_along_dim(keys, j, dim=0)[0] >= 0


def estimate_backscatter(
    image: torch.Tensor,
    range_img: torch.Tensor,
    dark_mask: torch.Tensor,
    num_px: int = 256,
    iters: int = 10,
) -> BackscatterFit:
    """Fit the 12-parameter backscatter model to sampled dark pixels, from
    the Sea-thru D5 defaults."""
    return fit_backscatter(*sample_masked_pixels(image, range_img, dark_mask, num_px), iters)


def backscatter_config(iters: int = 10) -> LMConfig:
    """The backscatter fit's LM settings."""
    return LMConfig(max_iters=iters, lambda0_scale=1e-3, lambda_up=2.0, lambda_down=3.0,
                    step_size=1.0, marquardt_diag=True)


def fit_backscatter(rgb: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                    iters: int = 10) -> BackscatterFit:
    """The fit of :func:`estimate_backscatter` on its samples: rgb (..., N,
    3), z (..., N) and valid (..., N). On CUDA tensors one launch of
    ``sea_thru_fit`` (csrc/sea_thru_fit.cu, a block a camera), on the CPU
    :func:`backscatter_lm_plain`."""
    x0, config = backscatter_start(rgb.device), backscatter_config(iters)
    if z.is_cuda:
        from ..ops import cuda

        result = cuda.sea_thru_fit("backscatter", rgb.contiguous(), z.contiguous(),
                                   valid.contiguous(), x0, config)
    else:
        result = backscatter_lm_plain(rgb, z, valid, x0, config)
    X = result.x
    return BackscatterFit(X[..., 0:3], X[..., 3:6], X[..., 6:9], X[..., 9:12], result.error)


def backscatter_lm_plain(rgb: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                         x0: torch.Tensor, config: LMConfig, kernels: bool = False) -> LMResult:
    """The backscatter fit's LM from x0 ((12,) or one a camera, (..., 12)):
    the plain version of ``sea_thru_fit``, ``ops/lm.py::lm_solve`` over the
    model's residuals and Jacobian, on any device. ``kernels`` takes its
    steps and error sums by ``lm_solve_small`` and ``lm_row_sum`` on CUDA
    tensors; the CPU runs their twins either way."""
    X0 = x0.expand(*z.shape[:-1], 12)
    w_valid = valid.float()
    n_valid = w_valid.sum(dim=-1)
    zz = z[..., None]
    total = row_sums(kernels)

    def residual_jac(X):
        r_c, atten_back, exp_beta_D = _residual_terms(X, rgb, z)
        r = channel_sq(r_c)
        w = 1.0 / (1.0 + r * r) * w_valid
        B, Jp = X[..., None, 0:3], X[..., None, 6:9]
        exp_beta_B = torch.exp(-X[..., None, 3:6] * zz)
        # Analytic dr/dX (backscatter.cpp LinearizeImageFormation).
        J_B = -2.0 * r_c * atten_back
        J_beta_B = -2.0 * r_c * B * zz * exp_beta_B
        J_Jp = -2.0 * r_c * exp_beta_D
        J_beta_Dp = 2.0 * r_c * Jp * zz * exp_beta_D
        J = torch.cat([J_B, J_beta_B, J_Jp, J_beta_Dp], dim=-1)
        return w * r, w[..., None] * J

    def error_fn(X):
        r_c, _, _ = _residual_terms(X, rgb, z)
        r = channel_sq(r_c) * w_valid
        return total(r) / torch.clamp_min(n_valid, 1.0)

    return lm_solve(residual_jac, X0, config, project=lambda X: torch.clamp_min(X, 0.0),
                    valid_count=n_valid, error_fn=error_fn, kernels=kernels)


def remove_backscatter(
    image: torch.Tensor,
    range_img: torch.Tensor,
    B: torch.Tensor,
    beta_B: torch.Tensor,
) -> torch.Tensor:
    """D = max(I - B(1 - exp(-beta_B z)), 0); zero ranges -> 20 m background.
    B and beta_B are (..., 3), one an image."""
    z = torch.where(range_img > 1e-3, range_img, BACKGROUND_RANGE)
    B, beta_B = B[..., None, None, :], beta_B[..., None, None, :]
    scatter = B * (1.0 - torch.exp(-beta_B * z[..., None]))
    return torch.clamp_min(image - scatter, 0.0)
