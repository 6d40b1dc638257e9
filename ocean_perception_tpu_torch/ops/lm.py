"""Levenberg-Marquardt on fixed-size parameter vectors (port of ``ocean_perception_tpu.ops.lm``).

Batched over leading dimensions: ``x0`` is (..., P), and the problem's
``residual_jac(x)`` returns r (..., N) and J (..., N, P). A batch of
independent fits (the attenuation multi-start, or the cameras of a fleet)
is one call. The loop runs a fixed number of iterations with
``torch.where`` accept/reject, so it never reads a value back to the host.

On the card the Sea-thru fits do not come here: each runs whole in one
launch of ``sea_thru_fit`` (``csrc/sea_thru_fit.cu``), bit for bit this
loop's result; this loop is their plain version (``kernels=False`` keeps
it off the port's kernels on the card too) and trilateration's LM.

A system's bits do not depend on the batch it is solved in. Its damped
normal equations, their solve and the error sums that accept or reject a
step are formed by fixed arithmetic in a fixed order (a pairwise tree over
the samples, Gaussian elimination with partial pivoting), on the card by
the kernels of ``csrc/lm_solve.cu`` and on the CPU by their twins below. A
library's reduction or batched solve picks its order, or its kernel, by
the number of systems, and the Sea-thru fits are ill-conditioned enough
(cond ~4e9 in float32) for that rounding to move a fit out of its basin.
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


def tree_sum_plain(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` by a fixed pairwise tree: the axis is padded with
    zeros to a power of two, then each level adds neighbours (2m, 2m+1).
    Every sum takes the same operations in the same order at any batch
    size and on any device (the twin of csrc/lm_solve.cu's tree)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        x = torch.nn.functional.pad(x, (0, size - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def channel_sq(r: torch.Tensor) -> torch.Tensor:
    """Squared norm over a last axis of 3 (RGB residuals), summed left to
    right by elementwise adds: a library reduction over the axis may pick its
    order by the number of rows."""
    sq = r * r
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis in the order of :func:`tree_sum_plain`: on a
    CUDA tensor one launch of ``lm_row_sum``, on the CPU the twin."""
    if x.is_cuda:
        from . import cuda

        return cuda.lm_row_sum(x.contiguous())
    return tree_sum_plain(x)


def solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for (..., P, P) A and (..., P) b: Gaussian
    elimination with partial pivoting (the first row of largest |pivot|,
    as ``torch.argmax`` picks it), then back substitution a column at a
    time. Every product, quotient and difference is its own rounded
    operation. A zero pivot gives a non-finite x."""
    *batch, P = b.shape
    A = A.reshape(-1, P, P).clone()
    b = b.reshape(-1, P).clone()
    rows = torch.arange(A.shape[0], device=A.device)
    for k in range(P):
        p = k + torch.argmax(A[:, k:, k].abs(), dim=-1)
        A_k, A_p = A[rows, k].clone(), A[rows, p].clone()
        A[rows, k], A[rows, p] = A_p, A_k
        b_k, b_p = b[rows, k].clone(), b[rows, p].clone()
        b[rows, k], b[rows, p] = b_p, b_k
        f = A[:, k + 1:, k] / A[:, k, k, None]
        A[:, k + 1:, k + 1:] -= f[..., None] * A[:, k, None, k + 1:]
        b[:, k + 1:] -= f * b[:, k, None]
    x = torch.empty_like(b)
    for i in reversed(range(P)):
        x[:, i] = b[:, i] / A[:, i, i]
        b[:, :i] -= A[:, :i, i] * x[:, i, None]
    return x.reshape(*batch, P)


def damped_system(J: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
                  marquardt: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, b) = (JtJ + lam * damp, -Jtr) of (..., N, P) J and (..., N) r,
    the sums over N in the tree order; damp is diag(max(diag(JtJ), 1e-12))
    (Marquardt) or the identity."""
    JtJ = tree_sum_plain(J.unsqueeze(-1) * J.unsqueeze(-2), dim=-3)
    Jtr = tree_sum_plain(J * r.unsqueeze(-1), dim=-2)
    if marquardt:
        damp = torch.diag_embed(torch.clamp_min(torch.diagonal(JtJ, dim1=-2, dim2=-1), 1e-12))
    else:
        damp = torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
    return JtJ + lam[..., None, None] * damp, -Jtr


def lm_step_plain(J: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
                  marquardt: bool) -> torch.Tensor:
    """Each system's LM step, :func:`damped_system` solved by
    :func:`solve_plain`: the twin of ``lm_solve_small``."""
    return solve_plain(*damped_system(J, r, lam, marquardt))


def lm_step(J: torch.Tensor, r: torch.Tensor, lam: torch.Tensor, marquardt: bool) -> torch.Tensor:
    """:func:`lm_step_plain`: on CUDA tensors one launch of
    ``lm_solve_small`` (csrc/lm_solve.cu, a warp a system), on the CPU the
    twin."""
    if J.is_cuda:
        from . import cuda

        return cuda.lm_solve_small(J.contiguous(), r.contiguous(), lam.contiguous(), marquardt)
    return lm_step_plain(J, r, lam, marquardt)


def row_sums(kernels: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The error sums of :func:`lm_solve`: :func:`row_sum` (``lm_row_sum``
    on a CUDA tensor), or its twin on any device."""
    return row_sum if kernels else tree_sum_plain


def lm_solve(
    residual_jac: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    config: LMConfig = LMConfig(),
    project: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    valid_count: Optional[torch.Tensor] = None,
    error_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    kernels: bool = True,
) -> LMResult:
    """Minimize ||r(x)||^2 with LM.

    ``valid_count``: number of live residual rows (masked rows must be zero
    in r and J), used only to normalize the reported error. ``error_fn``: the
    accept/reject metric; the imaging fits pass the unweighted mean SSD,
    summed with ``row_sums(kernels)``. ``kernels``: the steps and sums by
    :func:`lm_step` and :func:`row_sum`, which launch ``lm_solve_small`` and
    ``lm_row_sum`` on CUDA tensors, or (False) by their twins on any
    device."""
    step, total = (lm_step if kernels else lm_step_plain), row_sums(kernels)
    r0, J0 = residual_jac(x0)
    if valid_count is None:
        count = torch.full(r0.shape[:-1], float(r0.shape[-1]), dtype=r0.dtype, device=r0.device)
    else:
        count = torch.as_tensor(valid_count, dtype=r0.dtype, device=r0.device)

    def mean_sq(r):
        return total(r * r) / torch.clamp_min(count, 1.0)

    def eval_error(x, r):
        return error_fn(x) if error_fn is not None else mean_sq(r)

    # diag(JtJ) in the tree order of the step's normal equations.
    lam = config.lambda0_scale * total((J0 * J0).transpose(-1, -2)).amax(dim=-1)
    err = eval_error(x0, r0)
    x = x0
    n_acc = torch.zeros(lam.shape, dtype=torch.int32, device=x0.device)

    for _ in range(config.max_iters):
        r, J = residual_jac(x)
        # A singular system gives a non-finite step (as JAX's solve does);
        # the guard below zeroes it.
        delta = step(J, r, lam, config.marquardt_diag)
        finite = torch.isfinite(delta).all(dim=-1, keepdim=True)
        delta = torch.where(finite, delta, 0.0)
        x_new = x + config.step_size * delta
        if project is not None:
            x_new = project(x_new)
        if error_fn is not None:
            err_new = error_fn(x_new)
        else:
            err_new = mean_sq(residual_jac(x_new)[0])
        better = err_new < err
        x = torch.where(better[..., None], x_new, x)
        err = torch.where(better, err_new, err)
        lam = torch.where(better, lam / config.lambda_down, lam * config.lambda_up)
        lam = lam.clamp(config.min_lambda, config.max_lambda)
        n_acc = n_acc + better.to(torch.int32)
    return LMResult(x=x, error=err, lambda_=lam, n_accepted=n_acc)
