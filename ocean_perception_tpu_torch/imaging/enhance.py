"""EnhanceUnderwater: the Sea-thru pipeline (port of ``ocean_perception_tpu.imaging.enhance``).

intensity -> FindDark -> EstimateBackscatter -> RemoveBackscatter ->
EstimateIlluminantRangeGuided(r = NextEvenInt(W/3), eps, s) -> multi-start
EstimateBeta -> CorrectAttenuation, all in float32 on the input's device.

An image is (..., H, W, 3) with an (..., H, W) range map: leading axes are a
batch of cameras, each enhanced on its own (its own dark pixels, fits and
illuminant) in the same launches. :class:`EnhanceSequence` carries the
attenuation fit from frame to frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.cuda import entry_device
from ..ops.image import compute_intensity
from .attenuation import correct_attenuation, estimate_beta_multi_start
from .backscatter import estimate_backscatter, find_dark_mask, remove_backscatter
from .formation import beta_guesses
from .illuminant import estimate_illuminant_range_guided


@dataclasses.dataclass(frozen=True)
class EnhanceParams:
    back_num_px: int = 256
    back_opt_iters: int = 10
    beta_num_px: int = 256
    beta_opt_iters: int = 20
    dark_percentile: float = 0.01
    guided_eps: float = 0.01
    guided_subsample: int = 8


class EnhanceInfo(NamedTuple):
    B: torch.Tensor
    beta_B: torch.Tensor
    Jp: torch.Tensor
    beta_Dp: torch.Tensor
    beta_D: torch.Tensor               # (..., 12) attenuation fit
    error_backscatter: torch.Tensor
    error_attenuation: torch.Tensor
    success_backscatter: torch.Tensor  # error < 0.1 (enhance.cpp:54)
    success_attenuation: torch.Tensor  # error < 0.1 (enhance.cpp:78)


def _next_even_int(x: int) -> int:
    return x if x % 2 == 0 else x + 1


def enhance_underwater(
    image: torch.Tensor,
    range_img: torch.Tensor,
    params: EnhanceParams = EnhanceParams(),
    beta_D_guess: torch.Tensor | None = None,
) -> tuple[torch.Tensor, EnhanceInfo]:
    """Enhance an (..., H, W, 3) RGB image given an (..., H, W) range map in
    meters.

    The attenuation fit starts from both reference site guesses, plus the
    caller's guess ((12,) or one an image, (..., 12)) when given, and keeps
    the best fit."""
    image = image.float()
    range_img = range_img.float()
    dev = image.device
    batch = range_img.shape[:-2]

    intensity = compute_intensity(image)
    dark = find_dark_mask(intensity, range_img, params.dark_percentile)
    fit = estimate_backscatter(
        image, range_img, dark, num_px=params.back_num_px, iters=params.back_opt_iters
    )
    D = remove_backscatter(image, range_img, fit.B, fit.beta_B)

    radius = _next_even_int(image.shape[-2] // 3)
    il = estimate_illuminant_range_guided(
        D, range_img, radius, params.guided_eps, params.guided_subsample
    )

    starts = beta_guesses(dev).expand(*batch, 2, 12)
    if beta_D_guess is not None:
        guess = torch.as_tensor(beta_D_guess, dtype=torch.float32, device=dev)
        starts = torch.cat([starts, guess.expand(*batch, 12)[..., None, :]], dim=-2)
    beta_fit = estimate_beta_multi_start(
        range_img, il, starts,
        num_px=params.beta_num_px, iters=params.beta_opt_iters,
    )

    out = correct_attenuation(D, range_img, beta_fit.X)
    info = EnhanceInfo(
        B=fit.B,
        beta_B=fit.beta_B,
        Jp=fit.Jp,
        beta_Dp=fit.beta_Dp,
        beta_D=beta_fit.X,
        error_backscatter=fit.error,
        error_attenuation=beta_fit.error,
        success_backscatter=fit.error < 0.1,
        success_attenuation=beta_fit.error < 0.1,
    )
    return out, info


class EnhanceSequence:
    """Enhances the frames of one camera (or of a batch of cameras) in turn,
    starting each frame's attenuation fit also from the last successful
    beta_D fit, as the reference's EnhanceSequence does (the fit is costly
    to re-converge, and the water changes slowly). The first guess is
    BETA_GUESS_1 unless the caller gives one.

    The guess stays on ``device``: after a frame it becomes the new fit
    where that fit succeeded (``torch.where``), so a frame reads nothing
    back to the host. Runs on the card unless ``device="cpu"``."""

    def __init__(self, params: EnhanceParams = EnhanceParams(), beta_D_guess=None,
                 device: torch.device | str = "cuda"):
        self.params = params
        self.device = entry_device(device)
        if beta_D_guess is None:
            self.guess = beta_guesses(self.device)[0].clone()
        else:
            self.guess = torch.as_tensor(beta_D_guess, dtype=torch.float32, device=self.device)

    def __call__(self, image, range_img) -> tuple[torch.Tensor, EnhanceInfo]:
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        range_img = torch.as_tensor(range_img, dtype=torch.float32, device=self.device)
        out, info = enhance_underwater(image, range_img, self.params, self.guess)
        self.guess = torch.where(info.success_attenuation[..., None], info.beta_D, self.guess)
        return out, info
