"""Levenberg-Marquardt on fixed-size parameter vectors (port of ``ocean_perception_tpu.ops.lm``).

Batched over leading dimensions: ``x0`` is (..., P), and the problem's
``residual_jac(x)`` returns r (..., N) and J (..., N, P). A batch of
independent fits (the attenuation multi-start) is one call. The loop runs a
fixed number of iterations with ``torch.where`` accept/reject, so it never
reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class LMConfig(NamedTuple):
    max_iters: int = 20
    lambda0_scale: float = 1e-3  # lambda0 = scale * max diag(JtJ) (backscatter.cpp:124)
    lambda_up: float = 2.0       # on a rejected step
    lambda_down: float = 3.0     # on an accepted step
    step_size: float = 1.0       # x <- x + step * delta
    min_lambda: float = 1e-12
    max_lambda: float = 1e12
    # lambda * diag(JtJ) damping (Marquardt scaling) instead of lambda * I.
    marquardt_diag: bool = False


class LMResult(NamedTuple):
    x: torch.Tensor
    error: torch.Tensor      # final mean squared residual
    lambda_: torch.Tensor
    n_accepted: torch.Tensor


def _normal_equations(r: torch.Tensor, J: torch.Tensor):
    """JtJ and Jtr as elementwise products and sums: float32 on every device
    (a CUDA matmul may run in TF32 when that is enabled)."""
    JtJ = (J.unsqueeze(-1) * J.unsqueeze(-2)).sum(dim=-3)
    Jtr = (J * r.unsqueeze(-1)).sum(dim=-2)
    return JtJ, Jtr


def _mean_sq(r: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return (r * r).sum(dim=-1) / torch.clamp_min(count, 1.0)


def lm_solve(
    residual_jac: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    config: LMConfig = LMConfig(),
    project: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    valid_count: Optional[torch.Tensor] = None,
    error_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> LMResult:
    """Minimize ||r(x)||^2 with LM.

    ``valid_count``: number of live residual rows (masked rows must be zero
    in r and J), used only to normalize the reported error. ``error_fn``: the
    accept/reject metric; the imaging fits pass the unweighted mean SSD."""
    r0, J0 = residual_jac(x0)
    if valid_count is None:
        count = torch.full(r0.shape[:-1], float(r0.shape[-1]), dtype=r0.dtype, device=r0.device)
    else:
        count = torch.as_tensor(valid_count, dtype=r0.dtype, device=r0.device)

    def eval_error(x, r):
        return error_fn(x) if error_fn is not None else _mean_sq(r, count)

    JtJ0, _ = _normal_equations(r0, J0)
    lam = config.lambda0_scale * torch.diagonal(JtJ0, dim1=-2, dim2=-1).amax(dim=-1)
    err = eval_error(x0, r0)
    x = x0
    n_acc = torch.zeros(lam.shape, dtype=torch.int32, device=x0.device)
    P = x0.shape[-1]
    eye = torch.eye(P, dtype=x0.dtype, device=x0.device)

    for _ in range(config.max_iters):
        r, J = residual_jac(x)
        JtJ, Jtr = _normal_equations(r, J)
        if config.marquardt_diag:
            damp = torch.diag_embed(torch.clamp_min(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-12))
        else:
            damp = eye
        A = JtJ + lam[..., None, None] * damp
        # solve_ex does not raise on a singular A (JAX returns non-finite
        # values there); the guard below zeroes such a step either way.
        delta, _ = torch.linalg.solve_ex(A, -Jtr)
        finite = torch.isfinite(delta).all(dim=-1, keepdim=True)
        delta = torch.where(finite, delta, 0.0)
        x_new = x + config.step_size * delta
        if project is not None:
            x_new = project(x_new)
        if error_fn is not None:
            err_new = error_fn(x_new)
        else:
            err_new = _mean_sq(residual_jac(x_new)[0], count)
        better = err_new < err
        x = torch.where(better[..., None], x_new, x)
        err = torch.where(better, err_new, err)
        lam = torch.where(better, lam / config.lambda_down, lam * config.lambda_up)
        lam = lam.clamp(config.min_lambda, config.max_lambda)
        n_acc = n_acc + better.to(torch.int32)
    return LMResult(x=x, error=err, lambda_=lam, n_accepted=n_acc)
