"""Position trilateration from beacon ranges (port of
``ocean_perception_tpu.vio.trilateration``).

Reference parity: vio/trilateration.{hpp,cpp} — LM with residual
(‖p - b_i‖ - r_i)/sigma_i, Jacobian rows = unit vectors beacon→robot,
covariance from the final Hessian. Requires >= 3 beacons for a fix.

It runs on its inputs' device in their dtype (float64, as the JAX function
runs under x64). On the card its LM steps and error sums launch
``lm_solve_small`` and ``lm_row_sum`` (``ops/lm.py``; their double build for
float64), and nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.lm import LMConfig, lm_solve


class TrilaterationResult(NamedTuple):
    position: torch.Tensor    # (3,)
    covariance: torch.Tensor  # (3,3)
    error: torch.Tensor
    success: torch.Tensor


def trilaterate(
    beacons: torch.Tensor,   # (N, 3) beacon world positions
    ranges: torch.Tensor,    # (N,)
    sigmas: torch.Tensor,    # (N,)
    mask: torch.Tensor,      # (N,) valid measurements
    p0: Optional[torch.Tensor] = None,
    iters: int = 20,
) -> TrilaterationResult:
    dtype = beacons.dtype
    maskf = mask.to(dtype)
    if p0 is None:
        denom = torch.clamp_min(maskf.sum(), 1.0)
        p0 = (beacons * maskf[:, None]).sum(dim=0) / denom

    def residual_jac(p):
        delta = p - beacons
        dist = torch.linalg.vector_norm(delta, dim=-1)
        unit = delta / torch.clamp_min(dist, 1e-9)[:, None]
        r = (dist - ranges) / sigmas * maskf
        J = unit / sigmas[:, None] * maskf[:, None]
        return r, J

    res = lm_solve(residual_jac, p0, LMConfig(max_iters=iters, marquardt_diag=True))
    _, J = residual_jac(res.x)
    H = J.T @ J
    cov = torch.linalg.inv_ex(H + 1e-9 * torch.eye(3, dtype=dtype, device=beacons.device))[0]
    n = mask.to(torch.int32).sum()
    return TrilaterationResult(position=res.x, covariance=cov, error=res.error, success=n >= 3)
