"""Wideband attenuation estimation and correction, Sea-thru stage 2 (port of
``ocean_perception_tpu.imaging.attenuation``).

- EstimateBeta: fit beta_D(z) = a*e^{bz} + c*e^{dz} (12 parameters over RGB)
  by LM on up to num_px grid-sampled pixels. The residual is in the range
  domain: z_pred = -log(E)/beta_D(z) against the observed z.
- CorrectAttenuation: out = D * exp(beta_D(z) * z), zero ranges set to the
  image's largest range.

The fit is batched over initial guesses: X0 (G, 12) runs G independent fits
in one LM loop (the reference vmaps them). Images are (..., H, W) ranges and
(..., H, W, 3) illuminants: leading axes are a batch of images (cameras),
and X0 (..., G, 12) gives each its own starts, all B x G fits one LM loop.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.lm import LMConfig, lm_solve
from .formation import beta_d_of_z, beta_guesses


def _grid_samples(
    range_img: torch.Tensor, illuminant: torch.Tensor, num_px: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniform-grid sample of (z, E, valid), static shape (..., num_px, ...),
    skipping a 5-px border; the same pixels of every image."""
    *batch, H, W = range_img.shape
    dev = range_img.device
    px_per_row = max(1, int((4 * num_px) ** 0.5))
    stride_y = max(1, (H - 10) // px_per_row)
    stride_x = max(1, (W - 10) // px_per_row)
    ys = torch.arange(5, H - 5, stride_y, device=dev)
    xs = torch.arange(5, W - 5, stride_x, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    yy = yy.reshape(-1)
    xx = xx.reshape(-1)
    n = yy.shape[0]
    if n >= num_px:
        sel = torch.arange(num_px, device=dev) * (n // num_px)
        yy, xx = yy[sel], xx[sel]
        n = num_px
    z = range_img[..., yy, xx]
    E = illuminant[..., yy, xx, :]
    valid = z > 1e-3
    if n < num_px:
        pad = num_px - n
        z = torch.cat([z, z.new_zeros((*batch, pad))], dim=-1)
        E = torch.cat([E, E.new_zeros((*batch, pad, 3))], dim=-2)
        valid = torch.cat([valid, valid.new_zeros((*batch, pad))], dim=-1)
    return z, E, valid


class BetaFit(NamedTuple):
    X: torch.Tensor      # (..., 12) [a, b, c, d] packed per RGB channel
    error: torch.Tensor  # (...) mean range-domain SSD


def _clamp_beta(X: torch.Tensor) -> torch.Tensor:
    """a, c >= 0; b, d <= 0 (attenuation.cpp:98-105)."""
    return torch.cat(
        [
            torch.clamp_min(X[..., 0:3], 0.0),
            torch.clamp_max(X[..., 3:6], 0.0),
            torch.clamp_min(X[..., 6:9], 0.0),
            torch.clamp_max(X[..., 9:12], 0.0),
        ],
        dim=-1,
    )


def estimate_beta(
    range_img: torch.Tensor,
    illuminant: torch.Tensor,
    num_px: int = 256,
    iters: int = 20,
    X0: torch.Tensor | None = None,
) -> BetaFit:
    """LM fit of beta_D from X0, which is (12,), a batch of starts (G, 12),
    or starts for each image (..., G, 12); the fit and its error have X0's
    shape without the last axis."""
    if X0 is None:
        X0 = beta_guesses(range_img.device)[0]
    single = X0.ndim == 1
    X0 = _clamp_beta(X0.float())
    if single:
        X0 = X0[None]
    z, E, valid = _grid_samples(range_img, illuminant, num_px)
    # The samples broadcast over the starts: (..., 1, N) against (..., G, N).
    w_valid = valid.float()[..., None, :]
    n_valid = w_valid.sum(dim=-1)
    log_E = torch.log(torch.clamp_min(E, 1e-3))[..., None, :, :]  # (..., 1, N, 3)
    zz = z[..., None, :, None]

    def terms(X):
        X = X[..., None, :]  # broadcast the parameters over the samples
        a, b, c, d = X[..., 0:3], X[..., 3:6], X[..., 6:9], X[..., 9:12]
        exp_bz = torch.exp(b * zz)
        exp_dz = torch.exp(d * zz)
        beta = a * exp_bz + c * exp_dz
        beta_inv = 1.0 / torch.clamp_min(beta, 1e-3)
        z_pred = -log_E * beta_inv
        return zz - z_pred, exp_bz, exp_dz, beta, a, c

    def residual_jac(X):
        r_c, exp_bz, exp_dz, beta, a, c = terms(X)
        r = (r_c * r_c).sum(dim=-1)
        w = 1.0 / (1.0 + r * r) * w_valid
        beta2_inv = 1.0 / torch.clamp_min(beta * beta, 1e-3)
        outer = -2.0 * r_c * log_E * beta2_inv
        J_a = outer * exp_bz
        J_b = outer * zz * a * exp_bz
        J_c = outer * exp_dz
        J_d = outer * zz * c * exp_dz
        J = torch.cat([J_a, J_b, J_c, J_d], dim=-1)
        return w * r, w[..., None] * J

    def error_fn(X):
        r_c = terms(X)[0]
        r = (r_c * r_c).sum(dim=-1) * w_valid
        return r.sum(dim=-1) / torch.clamp_min(n_valid, 1.0)

    result = lm_solve(
        residual_jac,
        X0,
        # Marquardt diagonal scaling with full steps, as in the reference
        # port (it reaches the reference's minima in ~4x fewer iterations).
        LMConfig(max_iters=iters, lambda0_scale=1e-3, lambda_up=4.0, lambda_down=3.0,
                 step_size=1.0, marquardt_diag=True),
        project=_clamp_beta,
        valid_count=n_valid,
        error_fn=error_fn,
    )
    if single:
        return BetaFit(result.x[..., 0, :], result.error[..., 0])
    return BetaFit(result.x, result.error)


def estimate_beta_multi_start(
    range_img: torch.Tensor,
    illuminant: torch.Tensor,
    guesses: torch.Tensor,  # (G, 12) or (..., G, 12)
    num_px: int = 256,
    iters: int = 20,
) -> BetaFit:
    """Fit from every guess (one batched LM run) and keep, for each image,
    the fit of lowest error."""
    fits = estimate_beta(range_img, illuminant, num_px=num_px, iters=iters, X0=guesses)
    # An index tensor: a 0-d one would be read back to the host.
    best = torch.argmin(fits.error, dim=-1, keepdim=True)
    return BetaFit(torch.take_along_dim(fits.X, best[..., None], dim=-2)[..., 0, :],
                   torch.take_along_dim(fits.error, best, dim=-1)[..., 0])


def correct_attenuation(image: torch.Tensor, range_img: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """J = D * exp(beta_D(z) * z); zero ranges -> the image's largest range.
    X is (..., 12), one fit an image. The exponent is clamped at 60 so a
    diverged fit stays finite."""
    zmax = range_img.amax(dim=(-2, -1), keepdim=True)
    z = torch.where(range_img > 0.0, range_img, zmax)
    X = X[..., None, None, :]  # over the image's pixels
    E = torch.exp(torch.clamp_max(beta_d_of_z(X, z) * z[..., None], 60.0))
    return image * E
