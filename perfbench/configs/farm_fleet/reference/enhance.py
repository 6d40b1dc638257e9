"""Sea-thru enhancement of the reference (Akkaynak & Treibitz, CVPR 2019), as
the reference repository's imaging/ code runs it and the JAX package states
it:

1. the darkest percentile of the pixels with a range, by bisection of the
   intensity;
2. one dark pixel of each of num_px lattice buckets, the one of highest
   Knuth-hash rank of its index;
3. the backscatter fit B(1 - e^{-beta_B z}) + J' e^{-beta_D' z} to them, by
   Levenberg-Marquardt from the D5 defaults (Cauchy-weighted squared colour
   error, Marquardt damping, a step kept where it lowers the unweighted
   mean error), and its removal, D = max(I - B(1 - e^{-beta_B z}), 0);
4. the illuminant, twice a fast guided filter of D guided by the range;
5. the attenuation fit beta_D(z) = a e^{bz} + c e^{dz} on a grid of pixels
   from two starts, the better kept, in the range domain z = -log(E) /
   beta_D(z); and J = D e^{beta_D(z) z}.

Arithmetic runs in the precision of the inputs; the small normal equations
are solved in float32 where that precision is bfloat16, which no solver
takes.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import box_mean, resize_linear, resize_nearest

B_D5 = (0.0559, 0.115, 0.132, 1.11, 0.695, 0.358, 0.05, 0.05, 0.05, 0.891, 1.23, 1.17)
BETA_STARTS = ((1.1, 0.77, 0.85, 0.0, -0.30, -0.38, 2.9, 2.0, 1.4, -1.6, -1.9, -2.0),
               (0.26, 0.088, 0.023, -0.08, -0.051, -0.032, 1.69, 1.04, 0.025, -2.3, -2.1,
                -0.039))
BACKGROUND = 20.0


def _f32s(values, like: torch.Tensor) -> torch.Tensor:
    """Constants as the configuration states them (float32)."""
    return torch.as_tensor(np.asarray(values, np.float32), device=like.device).to(like.dtype)


def dark_mask(intensity: torch.Tensor, z: torch.Tensor, percentile: float, iters: int = 10):
    valid = z > 0.1
    n = valid.sum().clamp_min(1).to(intensity.dtype)
    lo, hi = intensity[valid].min(), intensity[valid].max()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if ((intensity < mid) & valid).sum() / n > percentile:
            hi = mid
        else:
            lo = mid
    return valid & (intensity < 0.5 * (lo + hi))


def sample_dark(image: torch.Tensor, z: torch.Tensor, dark: torch.Tensor, num_px: int):
    """(rgb (N, 3), z (N), valid (N)): bucket (r mod s1, c mod s2) gives its
    dark pixel of highest rank ((i * 2654435761 mod 2^32) xor (i >> 16)) >> 1,
    i the pixel's index; the first of the bucket where none is dark."""
    H, W = z.shape
    s1 = int(num_px ** 0.5)
    while num_px % s1:
        s1 -= 1
    s2 = num_px // s1
    i = np.arange(H * W, dtype=np.int64)
    rank = torch.as_tensor((((i * 2654435761) & 0xFFFFFFFF) ^ (i >> 16)) >> 1,
                           device=z.device).reshape(H, W)
    score = torch.where(dark, rank, -1)
    rgb, zs, valid = [], [], []
    for b in range(num_px):
        r0, c0 = b // s2, b % s2
        sub = score[r0::s1, c0::s2]
        k = int(torch.argmax(sub.reshape(-1)))
        y, x = r0 + (k // sub.shape[1]) * s1, c0 + (k % sub.shape[1]) * s2
        rgb.append(image[y, x])
        zs.append(z[y, x])
        valid.append(bool(sub.reshape(-1)[k] >= 0))
    return torch.stack(rgb), torch.stack(zs), torch.tensor(valid, device=z.device)


def levenberg_marquardt(residual, x0, iters, up, down, project, error):
    """x0 (S, P) from S starts; residual(x) -> (w r (S, N), w J (S, N, P))."""
    r, J = residual(x0)
    lam = 1e-3 * (J * J).sum(1).amax(-1)
    err = error(x0)
    x = x0
    accepted = 0
    for _ in range(iters):
        r, J = residual(x)
        JtJ = J.transpose(1, 2) @ J
        A = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=1, dim2=2).clamp_min(1e-12))
        b = -(J.transpose(1, 2) @ r[..., None])[..., 0]
        solve_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        delta = torch.linalg.solve_ex(A.to(solve_dtype), b.to(solve_dtype))[0].to(x.dtype)
        delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True), delta, 0.0)
        x_new = project(x + delta)
        e_new = error(x_new)
        better = e_new < err
        accepted = accepted + better.sum()
        x = torch.where(better[:, None], x_new, x)
        err = torch.where(better, e_new, err)
        lam = torch.where(better, lam / down, lam * up).clamp(1e-12, 1e12)
    return x, err, int(accepted)


def fit_backscatter(rgb, z, valid, iters, work=None):
    w0 = valid.to(rgb.dtype)
    zz = z[:, None]

    def parts(X):
        B, bB, Jp, bD = X[:, None, 0:3], X[:, None, 3:6], X[:, None, 6:9], X[:, None, 9:12]
        back = 1 - torch.exp(-bB * zz)
        direct = torch.exp(-bD * zz)
        return rgb - (B * back + Jp * direct), back, direct, B, bB, Jp

    def residual(X):
        rc, back, direct, B, bB, Jp = parts(X)
        r = (rc * rc).sum(-1)
        w = w0 / (1 + r * r)
        J = torch.cat([-2 * rc * back, -2 * rc * B * zz * torch.exp(-bB * zz),
                       -2 * rc * direct, 2 * rc * Jp * zz * direct], -1)
        return w * r, w[..., None] * J

    def error(X):
        rc = parts(X)[0]
        return ((rc * rc).sum(-1) * w0).sum(-1) / w0.sum().clamp_min(1)

    x0 = _f32s(B_D5, rgb)[None]
    X, _, accepted = levenberg_marquardt(residual, x0, iters, 2.0, 3.0,
                                         lambda X: X.clamp_min(0), error)
    if work is not None:
        work.append(dict(model="backscatter", N=z.shape[0], fits=1, starts=1, iters=iters,
                         accepted=accepted))
    return X[0]


def _clamp_beta(X):
    sign = torch.tensor([1.0] * 3 + [-1.0] * 3 + [1.0] * 3 + [-1.0] * 3, dtype=X.dtype,
                        device=X.device)
    return (X * sign).clamp_min(0) * sign


def fit_attenuation(z, E, valid, iters, work=None):
    w0 = valid.to(z.dtype)
    logE = torch.log(E.clamp_min(1e-3))
    zz = z[:, None]

    def parts(X):
        a, b, c, d = X[:, None, 0:3], X[:, None, 3:6], X[:, None, 6:9], X[:, None, 9:12]
        eb, ed = torch.exp(b * zz), torch.exp(d * zz)
        beta = a * eb + c * ed
        return zz + logE / beta.clamp_min(1e-3), eb, ed, beta, a, c

    def residual(X):
        rc, eb, ed, beta, a, c = parts(X)
        r = (rc * rc).sum(-1)
        w = w0 / (1 + r * r)
        g = -2 * rc * logE / (beta * beta).clamp_min(1e-3)
        J = torch.cat([g * eb, g * zz * a * eb, g * ed, g * zz * c * ed], -1)
        return w * r, w[..., None] * J

    def error(X):
        rc = parts(X)[0]
        return ((rc * rc).sum(-1) * w0).sum(-1) / w0.sum().clamp_min(1)

    X, err, accepted = levenberg_marquardt(residual, _clamp_beta(_f32s(BETA_STARTS, z)), iters,
                                           4.0, 3.0, _clamp_beta, error)
    if work is not None:
        work.append(dict(model="attenuation", N=z.shape[0], fits=len(BETA_STARTS),
                         starts=len(BETA_STARTS), iters=iters, accepted=accepted))
    return X[int(torch.argmin(err))]


def enhance(image: torch.Tensor, z: torch.Tensor, intensity: torch.Tensor, p: dict,
            work: dict | None = None):
    """One (H, W, 3) image with its (H, W) range map in metres. ``work``,
    where given, gets the two fits' sizes and accepted steps under
    "sea_thru_fit"."""
    fits = None if work is None else []
    H, W = z.shape
    dark = dark_mask(intensity, z, p["dark_percentile"])
    rgb, zs, valid = sample_dark(image, z, dark, p["back_num_px"])
    X = fit_backscatter(rgb, zs, valid, p["back_opt_iters"], fits)
    zb = torch.where(z > 1e-3, z, BACKGROUND)[..., None]
    D = (image - X[0:3] * (1 - torch.exp(-X[3:6] * zb))).clamp_min(0)
    # The illuminant: twice the fast guided filter of D guided by the range.
    radius = W // 3 + (W // 3) % 2
    s = p["guided_subsample"]
    h, w, rs = max(2, H // s), max(2, W // s), max(1, int(round(radius / s)))
    I = resize_nearest(z, (h, w))
    P = resize_nearest(D.movedim(-1, 0), (h, w))
    mI, mP = box_mean(I, rs), box_mean(P, rs)
    var = box_mean(I * I, rs) - mI * mI
    a = (box_mean(I * P, rs) - mI * mP) / (var + p["guided_eps"])
    bb = mP - a * mI
    il = 2 * (resize_linear(box_mean(a, rs), (H, W)) * z + resize_linear(box_mean(bb, rs), (H, W)))
    il = il.movedim(0, -1)
    # The attenuation fit on a grid of pixels, a 5 px border skipped.
    n = p["beta_num_px"]
    per_row = max(1, int((4 * n) ** 0.5))
    ys = torch.arange(5, H - 5, max(1, (H - 10) // per_row), device=z.device)
    xs = torch.arange(5, W - 5, max(1, (W - 10) // per_row), device=z.device)
    yy = ys[:, None].expand(-1, len(xs)).reshape(-1)
    xx = xs[None, :].expand(len(ys), -1).reshape(-1)
    if yy.shape[0] >= n:
        pick = torch.arange(n, device=z.device) * (yy.shape[0] // n)
        yy, xx = yy[pick], xx[pick]
    zg, Eg = z[yy, xx], il[yy, xx]
    if zg.shape[0] < n:
        zg = torch.cat([zg, zg.new_zeros(n - zg.shape[0])])
        Eg = torch.cat([Eg, Eg.new_zeros((n - Eg.shape[0], 3))])
    Xb = fit_attenuation(zg, Eg, zg > 1e-3, p["beta_opt_iters"], fits)
    if work is not None:
        work.setdefault("sea_thru_fit", []).append(fits)
    zc = torch.where(z > 0, z, z.max())[..., None]
    beta = Xb[0:3] * torch.exp(Xb[3:6] * zc) + Xb[6:9] * torch.exp(Xb[9:12] * zc)
    return D * torch.exp((beta * zc).clamp_max(60.0))
