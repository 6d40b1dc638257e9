"""Stereo of the reference: the PatchMatch disparity of a rectified pair at
the configuration's internal scale, and depth from disparity.

Written from the algorithm (the reference repository's patchmatch_gpu.cu as
the JAX package runs it): the X-stencil cost alpha|L - R| + (1 - alpha)|dL -
dR| over integer disparities, held in bfloat16 as the configuration states;
a seed of confident winner-take-all disparities max-dilated; three
iterations of foreground noise (one fixed uniform image, JAX's threefry
stream under key 123) and four directional scans R+ C+ R- C-, each over
strips with a halo, every step reading the scan's starting values; the
background mask, a parabola's subpixel offset, a winner-take-all right map
and the left-right check; nearest upsampling. Arithmetic runs in the
precision of the images; thresholds that decide a pixel are the float32 or
bfloat16 products the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import dilate, f32, gray_of_mono, pyr_down, resize_nearest, sobel

ALPHA = 0.9
IMPROVE = 0.8
ITERS = 3
CHUNKS = 16
HALO = 5
PR = 1                      # the stencil's radius
NOISE_KEY = 123
NOISE_SCALE0 = 32.0
SEED_REACH = 2 ** 4 + 1     # the seed's dilation, 2^4 + 1 each way
OCCLUSION = (0.7, 1.4)
STENCIL = ((-1, -1), (-1, 1), (0, 0), (1, -1), (1, 1))
M32 = np.uint64(0xFFFFFFFF)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return ((v << np.uint64(r)) | (v >> np.uint64(32 - r))) & M32


def threefry2x32(key: tuple, c0: np.ndarray, c1: np.ndarray):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011), on uint32 values held
    in uint64 arrays."""
    k = [np.uint64(key[0]), np.uint64(key[1])]
    k.append(k[0] ^ k[1] ^ np.uint64(0x1BD11BDA))
    rot = (13, 15, 26, 6, 17, 29, 16, 24)
    x0, x1 = (c0 + k[0]) & M32, (c1 + k[1]) & M32
    for group in range(5):
        for i in range(4):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, rot[(group % 2) * 4 + i]) ^ x0
        x0 = (x0 + k[(group + 1) % 3]) & M32
        x1 = (x1 + k[(group + 2) % 3] + np.uint64(group + 1)) & M32
    return x0, x1


def unit_noise(h: int, w: int) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(123), (h, w), float32, -1, 1)`` under the
    partitionable threefry: element i is hashed from the counter (i >> 32,
    i mod 2^32), its two words xor'ed, and its top 23 bits made the
    mantissa of a float in [1, 2)."""
    i = np.arange(h * w, dtype=np.uint64)
    a, b = threefry2x32((0, NOISE_KEY), i >> np.uint64(32), i & M32)
    mant = ((a ^ b) >> np.uint64(9)).astype(np.float64)
    u = mant / 2.0 ** 23                         # [0, 1), exact
    return np.maximum(u * 2.0 - 1.0, -1.0).reshape(h, w)


def cost_volume(L: torch.Tensor, R: torch.Tensor, D: int) -> torch.Tensor:
    """(B, h, w, D) X-stencil cost in bfloat16: plane d compares L(y, x) with
    R(y, x - d), columns left of the image read column 0."""
    gl = torch.hypot(*sobel(L))
    gr = torch.hypot(*sobel(R))
    h, w = L.shape[-2:]
    rows = torch.arange(h, device=L.device)
    cols = torch.arange(w, device=L.device)
    planes = []
    for d in range(D):
        src = (cols - d).clamp_min(0)
        e = f32(ALPHA) * (L - R[..., src]).abs() + f32(1.0 - ALPHA) * (gl - gr[..., src]).abs()
        acc = 0
        for dy, dx in STENCIL:
            acc = acc + e[..., (rows + dy).clamp(0, h - 1), :][..., (cols + dx).clamp(0, w - 1)]
        planes.append(acc)
    return torch.stack(planes, dim=-1).to(torch.bfloat16)


def _bf16_threshold(c0: torch.Tensor) -> torch.Tensor:
    """IMPROVE * cost(0) for a bfloat16 volume: both rounded to bfloat16."""
    factor = float(torch.tensor(IMPROVE, dtype=torch.bfloat16))
    return (factor * c0.float()).to(torch.bfloat16)


def _f32_threshold(c0: torch.Tensor) -> torch.Tensor:
    """IMPROVE * cost(0) as one float32 product."""
    return c0.float() * f32(IMPROVE)


def _lookup(C: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """C (B, h, w, D) at each pixel's disparity d (B, h, w), rounded half to
    even and clipped to the planes."""
    idx = torch.round(d).clamp(0, C.shape[-1] - 1).long()
    return torch.gather(C, -1, idx[..., None])[..., 0]


def _strips(n: int) -> int:
    """The largest strip count <= CHUNKS that tiles n."""
    s = min(CHUNKS, n)
    while n % s:
        s -= 1
    return s


def _scan(C: torch.Tensor, disp: torch.Tensor, cost: torch.Tensor, forward: bool,
          along_x: bool):
    """One directional scan over all strips. Along x a position is a column
    and the lanes are the rows; along y a position is a row. Each step reads
    the scan's starting disparity and cost at its position; a strip writes
    back its own chunk only."""
    if along_x:                                  # (B, positions, lanes[, D])
        Ct, dT, cT = C.transpose(1, 2), disp.transpose(1, 2), cost.transpose(1, 2)
    else:
        Ct, dT, cT = C, disp, cost
    B, n, L = dT.shape
    D = C.shape[-1]
    dev = dT.device
    S = _strips(n)
    chunk = n // S
    steps = chunk + 2 * HALO
    s = torch.arange(S, device=dev)
    lo = (s * chunk - HALO).clamp_min(PR)
    hi = ((s + 1) * chunk + HALO).clamp_max(n - PR - 1)
    lanes = torch.arange(L, device=dev)
    lane_ok = ((lanes >= PR) & (lanes <= L - PR - 1))[None, None, :]
    b = torch.arange(B, device=dev)[:, None, None]
    order = range(steps) if forward else range(steps - 1, -1, -1)
    start = s * chunk - HALO + (0 if forward else steps - 1)
    carry = dT[:, (start - (1 if forward else -1)).clamp(0, n - 1)]
    out_d, out_c = dT.clone(), cT.clone()
    for j in order:
        p = s * chunk - HALO + j
        valid = ((p >= lo) & (p < hi))[None, :, None]
        pc = p.clamp(0, n - 1)
        cur_d, cur_c = dT[:, pc], cT[:, pc]
        x = pc[None, :, None] if along_x else lanes[None, None, :]
        cand = torch.minimum(carry, (x - PR).to(carry.dtype))
        idx = torch.round(cand).clamp(0, D - 1).long()
        cand_c = Ct[b, pc[None, :, None], lanes[None, None, :], idx]
        better = (cand_c < cur_c) & valid & lane_ok
        carry = torch.where(better, cand, cur_d)
        if HALO <= j < HALO + chunk:
            out_d[:, p] = carry
            out_c[:, p] = torch.where(better, cand_c, cur_c)
    if along_x:
        out_d, out_c = out_d.transpose(1, 2), out_c.transpose(1, 2)
    return out_d.contiguous(), out_c.contiguous()


def _clamped_cost(C: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    x = torch.arange(disp.shape[-1], device=disp.device).to(disp.dtype)
    return _lookup(C, torch.minimum(disp, x - PR))


def match(C: torch.Tensor, seed: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The left disparity after the iterations and the background mask."""
    disp = seed
    for it in range(ITERS):
        disp = torch.clamp_min((disp + noise * (NOISE_SCALE0 / 2 ** it)) * (disp > 0), 0.0)
        cost = _clamped_cost(C, disp)
        for forward, along_x in ((True, True), (True, False), (False, True), (False, False)):
            disp, cost = _scan(C, disp, cost, forward, along_x)
    h, w = disp.shape[-2:]
    yy = torch.arange(h, device=disp.device)[:, None]
    xx = torch.arange(w, device=disp.device)[None, :]
    inside = (yy >= PR) & (yy <= h - PR - 1) & (xx >= PR) & (xx <= w - PR - 1)
    keep = cost.float() < _f32_threshold(C[..., 0])
    return torch.where(keep & inside, disp, 0.0)


def _wta(C: torch.Tensor) -> torch.Tensor:
    """The first least-cost plane where it beats the improvement threshold."""
    best = C.amin(dim=-1)
    first = (C == best[..., None]).float().argmax(dim=-1)
    return torch.where(best < _bf16_threshold(C[..., 0]), first, -1)


def disparity(left_u8: torch.Tensor, right_u8: torch.Tensor, max_disp: int, scale: int,
              dtype: torch.dtype, work: dict | None = None) -> torch.Tensor:
    """(B, H, W) left disparity at full resolution, 0 where none. ``work``,
    where given, gets under "pm_match" each image's (volume, seed, noise,
    :func:`match`)."""
    L, R = gray_of_mono(left_u8, dtype), gray_of_mono(right_u8, dtype)
    for _ in range(scale.bit_length() - 1):
        L, R = pyr_down(L), pyr_down(R)
    D = max_disp // scale
    C = cost_volume(L, R, D)
    h, w = L.shape[-2:]
    noise = torch.as_tensor(unit_noise(h, w), device=L.device).to(dtype)
    seed = dilate(_wta(C).to(dtype).clamp_min(0), 2 * SEED_REACH + 1)
    if work is not None:
        work.setdefault("pm_match", []).extend((C[i], seed[i], noise, match)
                                               for i in range(len(C)))
    dl = match(C, seed, noise)
    # Subpixel: the parabola through the costs around the rounded disparity.
    di = torch.round(dl).clamp(0, D - 1).long()
    c = [torch.gather(C, -1, (di + o).clamp(0, D - 1)[..., None])[..., 0].to(dtype)
         for o in (-1, 0, 1)]
    den = c[0] - 2 * c[1] + c[2]
    off = torch.where(den.abs() > 1e-6, 0.5 * (c[0] - c[2]) / torch.where(den.abs() > 1e-6, den,
                                                                           1.0), 0.0)
    off = torch.where((di > 0) & (di < D - 1), off.clamp(-0.5, 0.5), 0.0)
    dl = torch.where(dl > 0, di.to(dtype) + off, 0.0)
    # The right map: the winner-take-all of C_R(y, x, d) = C(y, min(x + d, w - 1), d).
    cols = (torch.arange(w, device=L.device)[:, None] + torch.arange(D, device=L.device)).clamp(
        max=w - 1)
    CR = torch.gather(C, -2, cols.expand(*C.shape[:-2], w, D))
    best = CR.amin(dim=-1)
    first = (CR == best[..., None]).float().argmax(dim=-1)
    dr = torch.where(best < _bf16_threshold(C[..., 0]), first, 0).to(dtype)
    # Left-right check at the rounded disparity.
    di = torch.round(dl).clamp(0, D - 1).long()
    src = (torch.arange(w, device=L.device) - di).clamp_min(0)
    drs = torch.gather(dr, -1, src)
    bad = (drs.float() > f32(OCCLUSION[1]) * dl.float()) | \
        (drs.float() < f32(OCCLUSION[0]) * dl.float())
    dl = torch.where(bad, 0.0, dl)
    H, W = left_u8.shape[-2:]
    return resize_nearest(dl, (H, W)) * scale


def depth(disp: torch.Tensor, fx: float, baseline: float, max_depth: float) -> torch.Tensor:
    """fx * baseline / disparity (fx * baseline a float32 product), 0 where
    the disparity is none or the depth beyond max_depth."""
    fxb = f32(f32(fx) * f32(baseline))
    z = fxb / torch.where(disp > 0, disp, 1.0)
    return torch.where((disp > 0) & (z <= max_depth), z, 0.0)
