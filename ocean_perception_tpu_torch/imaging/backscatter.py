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
from ..ops.lm import LMConfig, lm_solve
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


def _hash_rank(n: int, device=None) -> torch.Tensor:
    """Knuth-hash ranking of flat pixel indices with uint32 wraparound,
    held in int64: (idx * 2654435761 mod 2^32) ^ (idx >> 16)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return ((idx * 2654435761) & _M32) ^ (idx >> 16)


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
    s1 = int(num_px**0.5)
    while num_px % s1:
        s1 -= 1
    s2 = num_px // s1
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


def estimate_backscatter(
    image: torch.Tensor,
    range_img: torch.Tensor,
    dark_mask: torch.Tensor,
    num_px: int = 256,
    iters: int = 10,
) -> BackscatterFit:
    """Fit the 12-parameter backscatter model to sampled dark pixels, from
    the Sea-thru D5 defaults."""
    X0 = backscatter_start(image.device).expand(*range_img.shape[:-2], 12)
    rgb, z, valid = sample_masked_pixels(image, range_img, dark_mask, num_px)
    w_valid = valid.float()
    n_valid = w_valid.sum(dim=-1)
    zz = z[..., None]

    def residual_jac(X):
        r_c, atten_back, exp_beta_D = _residual_terms(X, rgb, z)
        r = (r_c * r_c).sum(dim=-1)
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
        r = (r_c * r_c).sum(dim=-1) * w_valid
        return r.sum(dim=-1) / torch.clamp_min(n_valid, 1.0)

    result = lm_solve(
        residual_jac,
        X0,
        LMConfig(max_iters=iters, lambda0_scale=1e-3, lambda_up=2.0, lambda_down=3.0,
                 step_size=1.0, marquardt_diag=True),
        project=lambda X: torch.clamp_min(X, 0.0),
        valid_count=n_valid,
        error_fn=error_fn,
    )
    X = result.x
    return BackscatterFit(X[..., 0:3], X[..., 3:6], X[..., 6:9], X[..., 9:12], result.error)


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
