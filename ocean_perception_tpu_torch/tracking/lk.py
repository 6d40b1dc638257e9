"""Pyramidal Lucas-Kanade optical flow (port of
``ocean_perception_tpu.tracking.lk``).

Reference: ft/FeatureTracker (feature_tracker.cpp:19-95) around
cv::calcOpticalFlowPyrLK: window 21, 4 levels, at most 30 iterations,
eps 0.01, and a forward/backward consistency check.

The default LK path is the one the TPU's fused kernel pair computes
(``ops/pallas/lk_prep.py`` + ``ops/pallas/lk_iterate.py``). Per pyramid level
and direction, for all K points:

- the prep (K5) fetches each point's (win+3)^2 template window and its
  slack window (win + 2*(slack+1))^2 from the level, or from the point's
  frame of a ring of levels; recentres the template on its subpixel position
  with two-tap tents (y, then x); takes central-difference gradients; inverts
  the 2x2 normal matrix and applies the min-eigenvalue gate; and builds the
  correlation surfaces S_g(a, b) = <swin[a:a+win, b:b+win], g>, whose
  bilinear lookups are the Gauss-Newton step's two scalars;
- the walk (K6) runs ``max_iters`` masked Gauss-Newton steps on those
  surfaces; a point that leaves its slack window stops and fails the level;
- the level update keeps the walk's position where the point passed every
  gate, and doubles the guess for the next finer level.

:func:`lk_track` runs every level of one direction, coarse to fine. On a
CUDA tensor that is one launch of the ``lk_track`` kernel (``csrc/lk.cu``),
a block a point; on a CPU tensor it is :func:`lk_track_plain`, made of the
plain twins :func:`lk_prep_plain` and :func:`lk_walk_plain`, which spell
every reduction out as a loop of elementwise ops in the kernel's order, so
that kernel and twins agree bit for bit.

Two options of the reference, which it runs in XLA:

- ``search_slack <= 0``, the unbounded walk: a level is the template side
  and a walk that reads a (win+2)^2 window at the position on every step
  (:func:`lk_walk_unbounded_plain`); on the card a mode of the same
  ``lk_track`` launch.
- ``coarse_init``: an exhaustive SSD block match at the coarsest level seeds
  the forward walk (:func:`coarse_block_match`), one ``lk_coarse_match``
  launch (``csrc/lk_coarse.cu``) on the card.

Levels are never padded: the reference edge-pads each level by
``pad = window//2 + 2``; here coordinates are those of the padded level and
reads are clamped to the image, which gives the same values.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import cuda
from ..ops.image import image_pyramid, sqrt_f32
from ..ops.interp import sample_patches_bilinear
from ..ops.windows import extract_windows, fold_rings


@dataclasses.dataclass(frozen=True)
class LKParams:
    window: int = 21
    max_level: int = 3          # 4 levels: 0..3
    max_iters: int = 30
    eps: float = 0.01
    # cv2 uses 1e-4 on 0..255 images; these are [0, 1], hence ~1e-4/255^2.
    min_eig_threshold: float = 1.5e-9
    bidirectional: bool = True
    fwd_bwd_tol: float = 2.0
    # Large-displacement start: an exhaustive SSD block match of a
    # coarse_patch^2 template over (2*coarse_search + 1)^2 whole offsets at
    # the coarsest level seeds the forward walk.
    coarse_init: bool = False
    coarse_search: int = 12
    coarse_patch: int = 9
    # Half-width of the search slack around each level's guess. <= 0 walks
    # unbounded: every step re-reads a (window+2)^2 window at the position,
    # so only max_iters limits the motion, and no point is stopped at an
    # edge of its window.
    search_slack: int = 4
    # Backward pass over only the N finest levels, from an offset start
    # (0 = all levels from a zero-motion guess, the reference's semantics).
    bwd_levels: int = 0
    # ZNCC appearance gate: applied when bwd_levels truncates, or always
    # with zncc_gate.
    bwd_zncc_min: float = 0.5
    zncc_gate: bool = False


class FlowResult(NamedTuple):
    points: torch.Tensor  # ([B,] K, 2) tracked positions in the new image
    status: torch.Tensor  # ([B,] K) bool


def _f32(v: float) -> float:
    return float(np.float32(v))


_DET_MIN = _f32(1e-12)


# --- K5: per-level prep ------------------------------------------------------


def _origin(c: torch.Tensor, back: int, hi: int) -> torch.Tensor:
    """clip(floor(c) - back, 0, hi) as int32: a window origin in padded
    coordinates (``back`` already holds ``-pad``)."""
    return (torch.floor(c) - back).clamp(0, hi).int()


def _sum_rows_first(v: torch.Tensor) -> torch.Tensor:
    """(K, n, n) -> (K,): each row summed left to right, then the rows top to
    bottom (csrc/lk.cu sums in this order)."""
    rows = torch.zeros_like(v[:, :, 0])
    for x in range(v.shape[2]):
        rows = rows + v[:, :, x]
    total = torch.zeros_like(rows[:, 0])
    for y in range(v.shape[1]):
        total = total + rows[:, y]
    return total


def _tents(pos: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) two-tap bilinear weights max(0, 1 - |pos - a|), a = 0..n-1."""
    a = torch.arange(n, dtype=torch.float32, device=pos.device)
    return (1.0 - (pos[..., None] - a).abs()).clamp_min(0.0)


def _recentre(twin: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
              P: Optional[int] = None) -> torch.Tensor:
    """(K, P, P) patch of the (K, n, n) window centred on its subpixel
    position (fy, fx), P = n - 1 unless given: row p's tent centre is
    clip((fy + p) - P//2, 0, n - 1). Tents over the rows (the y
    contraction), then over the columns, each a sum over the whole axis."""
    ST = twin.shape[-1]
    P = ST - 1 if P is None else P
    i = torch.arange(P, dtype=torch.float32, device=twin.device)
    wy = _tents(((fy[:, None] + i) - (P // 2)).clamp(0, ST - 1), ST)  # (K, P, ST)
    wx = _tents(((fx[:, None] + i) - (P // 2)).clamp(0, ST - 1), ST)
    t1 = torch.zeros_like(wy)
    for a in range(ST):
        t1 = t1 + wy[:, :, a:a + 1] * twin[:, a:a + 1, :]
    t2 = torch.zeros_like(wy[:, :, :P])
    for b in range(ST):
        t2 = t2 + t1[:, :, b:b + 1] * wx[:, None, :, b]
    return t2


def _finite_or_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)


class TemplateSide(NamedTuple):
    """One level's template side for K points (what K5 computes before the
    search window): the recentred patch and its central-difference
    gradients (K, win, win), the inverse normal matrix (K, 4) [inv00, inv01,
    inv10, inv11] and the min-eigenvalue gate (K,) bool."""
    tpatch: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    inv: torch.Tensor
    okg: torch.Tensor


def template_side_plain(tmpl: torch.Tensor, pts: torch.Tensor, src_t: torch.Tensor, *,
                        win: int, pad: int, min_eig_threshold: float) -> TemplateSide:
    """Plain twin of the template side of one level: tmpl (Rt, H, W), pts
    (K, 2) [x, y] at the level's scale, src_t (K,) each point's frame."""
    H, W = tmpl.shape[-2], tmpl.shape[-1]
    r = win // 2
    ST = win + 3
    P = win + 2
    # Non-finite points get origin 0; the caller's finite check fails them.
    ptx, pty = _finite_or_zero(pts[:, 0]), _finite_or_zero(pts[:, 1])
    t0y = _origin(pty, r + 1 - pad, H + 2 * pad - ST)
    t0x = _origin(ptx, r + 1 - pad, W + 2 * pad - ST)
    fy = (pty + pad) - t0y.float()
    fx = (ptx + pad) - t0x.float()
    st = src_t.long().clamp(0, tmpl.shape[0] - 1)
    twin = extract_windows(tmpl, t0y, t0x, ST, src=st, pad=pad)   # (K, ST, ST)

    t2 = _recentre(twin, fy, fx)
    tpatch = t2[:, 1:P - 1, 1:P - 1]
    gx = 0.5 * (t2[:, 1:P - 1, 2:] - t2[:, 1:P - 1, :P - 2])
    gy = 0.5 * (t2[:, 2:, 1:P - 1] - t2[:, :P - 2, 1:P - 1])

    # Normal matrix, its inverse and the min-eigenvalue gate.
    gxx = _sum_rows_first(gx * gx)
    gxy = _sum_rows_first(gx * gy)
    gyy = _sum_rows_first(gy * gy)
    det = gxx * gyy - gxy * gxy
    d = gxx - gyy
    half = 0.5 * ((gxx + gyy) - sqrt_f32(d * d + 4.0 * gxy * gxy))
    # Tensor by tensor: torch divides a CUDA tensor by a scalar as a
    # multiplication by its reciprocal, which rounds twice.
    min_eig = half / torch.full_like(half, win * win)
    okg = (det > _DET_MIN) & (min_eig > _f32(min_eig_threshold))
    dsafe = torch.where(det > _DET_MIN, det, 1.0)
    inv01 = -gxy / dsafe
    inv = torch.stack([gyy / dsafe, inv01, inv01, gxx / dsafe], dim=1)
    return TemplateSide(tpatch, gx, gy, inv, okg)


def lk_prep_plain(tmpl: torch.Tensor, srch: torch.Tensor, pts: torch.Tensor,
                  guess: torch.Tensor, src_t: torch.Tensor, src_s: torch.Tensor, *,
                  win: int, slack: int, pad: int, min_eig_threshold: float):
    """Plain twin of the prep: one level, all K points.

    tmpl (Rt, H, W) and srch (Rs, H, W) are unpadded levels (rings allowed);
    pts and guess are (K, 2) [x, y] at the level's scale; src_t and src_s
    (K,) pick each point's frame. Returns corr (K, 2, A, A) [gx, gy surfaces,
    y offset, x offset], scal (K, 8) [tgx, tgy, inv00, inv01, inv10, inv11,
    sy0, sx0] and the template gate okg (K,) bool.
    """
    H, W = tmpl.shape[-2], tmpl.shape[-1]
    r = win // 2
    ws = win + 2 * (slack + 1)
    A = ws - win + 1
    ts = template_side_plain(tmpl, pts, src_t, win=win, pad=pad,
                             min_eig_threshold=min_eig_threshold)
    gsx, gsy = _finite_or_zero(guess[:, 0]), _finite_or_zero(guess[:, 1])
    sy0 = _origin(gsy, r + slack + 1 - pad, H + 2 * pad - ws)
    sx0 = _origin(gsx, r + slack + 1 - pad, W + 2 * pad - ws)
    ss = src_s.long().clamp(0, srch.shape[0] - 1)
    swin = extract_windows(srch, sy0, sx0, ws, src=ss, pad=pad)   # (K, ws, ws)

    # Correlation surfaces, one accumulator over (y, x) in row-major order.
    g2 = torch.stack([ts.gx, ts.gy], dim=1)                          # (K, 2, win, win)
    corr = torch.zeros((pts.shape[0], 2, A, A), dtype=torch.float32, device=pts.device)
    for y in range(win):
        for x in range(win):
            corr = corr + g2[:, :, y, x, None, None] * swin[:, None, y:y + A, x:x + A]

    scal = torch.cat([
        torch.stack([_sum_rows_first(ts.tpatch * ts.gx), _sum_rows_first(ts.tpatch * ts.gy)],
                    dim=1),
        ts.inv, torch.stack([sy0.float(), sx0.float()], dim=1),
    ], dim=1)
    return corr, scal, ts.okg


def _require_cpu(t: torch.Tensor, name: str) -> None:
    if t.is_cuda:
        raise ValueError(f"{name} runs on the CPU; on the card the levels run fused in "
                         "one lk_track launch")


def lk_prep(tmpl, srch, pts, guess, src_t, src_s, *, win: int, slack: int, pad: int,
            min_eig_threshold: float):
    """One level's prep (TPU kernel K5, ``ops/pallas/lk_prep.py::lk_prep_pallas``)
    on CPU tensors: :func:`lk_prep_plain`."""
    _require_cpu(tmpl, "lk_prep")
    return lk_prep_plain(tmpl, srch, pts.float(), guess.float(), src_t, src_s, win=win,
                         slack=slack, pad=pad, min_eig_threshold=min_eig_threshold)


# --- K6: the Gauss-Newton walk -----------------------------------------------


def _surface_lookup(corr: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """(K, 2) bilinear lookups of the (K, 2, A, A) surfaces at (ry, rx): tents
    over the x offsets, then over the y offsets, each a sum over the whole
    axis."""
    A = corr.shape[-1]
    wy = _tents(ry, A)                                                # (K, A)
    wx = _tents(rx, A)
    t = torch.zeros_like(corr[:, :, :, 0])                            # (K, 2, A)
    for b in range(A):
        t = t + corr[:, :, :, b] * wx[:, None, b:b + 1]
    acc = torch.zeros_like(t[:, :, 0])                                # (K, 2)
    for a in range(A):
        acc = acc + t[:, :, a] * wy[:, a:a + 1]
    return acc


def lk_walk_plain(corr: torch.Tensor, scal: torch.Tensor, pos0: torch.Tensor, *, r: int,
                  ws: int, pad: int, max_iters: int, eps: float, count_steps: bool = False):
    """Plain twin of the walk: ``max_iters`` masked steps.

    Each step first tests that the patch still lies inside the slack window
    (else the point is hit and stops), then looks up the two residual
    scalars with tents over the surfaces (x offsets, then y), solves the
    2x2 step and marks the point converged once |step| < eps. A stopped
    point keeps its position. Returns pos (K, 2) and hit (K,) bool, and with
    ``count_steps`` also the (K,) int32 count of steps each point moved.
    """
    tgx, tgy, i00, i01, i10, i11, sy0, sx0 = scal.unbind(1)
    px, py = pos0[:, 0], pos0[:, 1]
    conv = torch.zeros_like(px, dtype=torch.bool)
    hit = torch.zeros_like(conv)
    steps = torch.zeros_like(px, dtype=torch.int32)
    lo, hi = r + 1, ws - r - 2
    eps2 = _f32(eps * eps)
    for _ in range(max_iters):
        cy = (py + pad) - sy0
        cx = (px + pad) - sx0
        hit = hit | ~((cy >= lo) & (cy <= hi) & (cx >= lo) & (cx <= hi))
        stop = conv | hit
        acc = _surface_lookup(corr, cy - r, cx - r)
        bx = acc[:, 0] - tgx
        by = acc[:, 1] - tgy
        dx = -(i00 * bx + i01 * by)
        dy = -(i10 * bx + i11 * by)
        px = torch.where(stop, px, px + dx)
        py = torch.where(stop, py, py + dy)
        steps = steps + (~stop).int()
        conv = stop | ((dx * dx + dy * dy) < eps2)
    pos = torch.stack([px, py], dim=1)
    return (pos, hit, steps) if count_steps else (pos, hit)


def lk_walk(corr, scal, pos0, *, r: int, ws: int, pad: int, max_iters: int, eps: float):
    """One level's walk (TPU kernel K6, ``ops/pallas/lk_iterate.py``) on CPU
    tensors: :func:`lk_walk_plain`."""
    _require_cpu(corr, "lk_walk")
    return lk_walk_plain(corr, scal, pos0.float(), r=r, ws=ws, pad=pad, max_iters=max_iters,
                         eps=eps)


def lk_walk_unbounded_plain(srch: torch.Tensor, src_s: torch.Tensor, ts: TemplateSide,
                            pos0: torch.Tensor, *, pad: int, max_iters: int, eps: float,
                            count_steps: bool = False):
    """Plain twin of the unbounded walk (search_slack <= 0): ``max_iters``
    masked Gauss-Newton steps, each on a window read afresh at the position.

    Each step reads the (win+2)^2 window of frame src_s (K,) of srch
    (Rs, H, W) whose origin is clip(floor(pos) + pad - r - 1, 0, H + 2*pad
    - ws) in padded coordinates, resamples the win x win patch at the
    position with tents (the template's recentring, rows then columns),
    sums diff*gx and diff*gy row by row, solves the 2x2 step and marks the
    point converged once |step| < eps; a converged point keeps its position.
    A non-finite position reads the window at 0 and stays non-finite.
    Returns pos (K, 2), and with ``count_steps`` also the (K,) int32 count of
    steps each point moved and the (K, 2) int32 [rows, columns] of the box
    that covers every window it read before it converged.
    """
    win = ts.tpatch.shape[-1]
    r, ws = win // 2, win + 2
    H, W = srch.shape[-2], srch.shape[-1]
    ss = src_s.long().clamp(0, srch.shape[0] - 1)
    i00, i01, i10, i11 = ts.inv.unbind(1)
    px, py = pos0[:, 0], pos0[:, 1]
    conv = torch.zeros_like(px, dtype=torch.bool)
    steps = torch.zeros_like(px, dtype=torch.int32)
    lo = torch.full((px.shape[0], 2), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=px.device)
    hi = torch.full_like(lo, -1)
    eps2 = _f32(eps * eps)
    for _ in range(max_iters):
        cpx, cpy = _finite_or_zero(px), _finite_or_zero(py)
        y0 = _origin(cpy, r + 1 - pad, H + 2 * pad - ws)
        x0 = _origin(cpx, r + 1 - pad, W + 2 * pad - ws)
        at = torch.stack([y0, x0], dim=1)
        lo = torch.where(conv[:, None], lo, torch.minimum(lo, at))
        hi = torch.where(conv[:, None], hi, torch.maximum(hi, at))
        swin = extract_windows(srch, y0, x0, ws, src=ss, pad=pad)
        patch = _recentre(swin, (cpy + pad) - y0.float(), (cpx + pad) - x0.float(), win)
        diff = patch - ts.tpatch
        bx = _sum_rows_first(diff * ts.gx)
        by = _sum_rows_first(diff * ts.gy)
        dx = -(i00 * bx + i01 * by)
        dy = -(i10 * bx + i11 * by)
        px = torch.where(conv, px, px + dx)
        py = torch.where(conv, py, py + dy)
        steps = steps + (~conv).int()
        conv = conv | ((dx * dx + dy * dy) < eps2)
    pos = torch.stack([px, py], dim=1)
    box = torch.where(hi >= 0, hi - lo + ws, 0)
    return (pos, steps, box) if count_steps else pos


# --- coarse to fine ----------------------------------------------------------


def lk_track_plain(tmpl_levels: Sequence[torch.Tensor], srch_levels: Sequence[torch.Tensor],
                   points: torch.Tensor, init: torch.Tensor, src_t: torch.Tensor,
                   src_s: torch.Tensor, *, wins: Sequence[Optional[int]], slack: int, pad: int,
                   min_eig_threshold: float, max_iters: int, eps: float,
                   steps: Optional[list] = None, boxes: Optional[list] = None):
    """Plain twin of the ``lk_track`` kernel: one direction, every level.

    tmpl_levels and srch_levels hold one (R, H, W) ring a level, finest
    first; points and init are (K, 2) [x, y] at level 0's scale; wins[l] is
    level l's window, None where the level is skipped. Walks the levels
    coarse to fine: prep, walk, then the level update (the walk's position
    is kept where the template gate passed, the position lies inside the
    level and is finite, and the point never left its slack window; the
    guess doubles below every level but the finest). With slack <= 0 a
    level is the template side and the unbounded walk
    (:func:`lk_walk_unbounded_plain`), which no point can leave. Returns
    the points (K, 2) and the status (K,) bool, level 0's gate. ``steps``, where given,
    gets one (level, (K,) int32 steps moved) entry a level walked; ``boxes``,
    where given, one (level, (K, 2) int32 [rows, columns] of the box that
    covers every window the walk read) entry a level of the unbounded walk.

    A batch of cameras, as the kernel takes it: points, init, src_t and
    src_s (*batch, K, ...) and (*batch, R, H, W) rings are folded into one
    ring of n*R frames and n*K points (ops/windows.py::fold_rings); the
    outputs, the steps and the boxes come back (*batch, K, ...).
    """
    batch = tuple(points.shape[:-2])
    if batch:
        K = points.shape[-2]
        tmpl_levels, src_t = fold_rings(tmpl_levels, src_t, batch, K)
        srch_levels, src_s = fold_rings(srch_levels, src_s, batch, K)
        flat_steps = None if steps is None else []
        flat_boxes = None if boxes is None else []
        pts, ok = lk_track_plain(tmpl_levels, srch_levels, points.reshape(-1, 2),
                                 init.reshape(-1, 2), src_t, src_s, wins=wins, slack=slack,
                                 pad=pad, min_eig_threshold=min_eig_threshold,
                                 max_iters=max_iters, eps=eps, steps=flat_steps,
                                 boxes=flat_boxes)
        if steps is not None:
            steps.extend((lvl, moved.reshape(*batch, K)) for lvl, moved in flat_steps)
        if boxes is not None:
            boxes.extend((lvl, box.reshape(*batch, K, 2)) for lvl, box in flat_boxes)
        return pts.reshape(*batch, K, 2), ok.reshape(*batch, K)
    levels = len(tmpl_levels)
    points, guess = points.float(), init.float() / 2.0 ** (levels - 1)
    ok = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for lvl in range(levels - 1, -1, -1):
        win = wins[lvl]
        if win is not None:
            H, W = tmpl_levels[lvl].shape[-2], tmpl_levels[lvl].shape[-1]
            pts_l = points / 2.0 ** lvl
            if slack > 0:
                corr, scal, ok_g = lk_prep_plain(
                    tmpl_levels[lvl], srch_levels[lvl], pts_l, guess, src_t, src_s, win=win,
                    slack=slack, pad=pad, min_eig_threshold=min_eig_threshold)
                pos, hit, moved = lk_walk_plain(corr, scal, guess, r=win // 2,
                                                ws=win + 2 * (slack + 1), pad=pad,
                                                max_iters=max_iters, eps=eps, count_steps=True)
            else:
                ts = template_side_plain(tmpl_levels[lvl], pts_l, src_t, win=win, pad=pad,
                                         min_eig_threshold=min_eig_threshold)
                ok_g = ts.okg
                pos, moved, box = lk_walk_unbounded_plain(srch_levels[lvl], src_s, ts, guess,
                                                          pad=pad, max_iters=max_iters,
                                                          eps=eps, count_steps=True)
                hit = torch.zeros_like(ok_g)
                if boxes is not None:
                    boxes.append((lvl, box))
            if steps is not None:
                steps.append((lvl, moved))
            in_img = ((pos[:, 0] >= 0) & (pos[:, 0] <= W - 1)
                      & (pos[:, 1] >= 0) & (pos[:, 1] <= H - 1))
            ok_l = ok_g & in_img & torch.isfinite(pos).all(dim=-1) & ~hit
            guess = torch.where(ok_l[:, None], pos, guess)
            if lvl == 0:
                # OpenCV semantics: the status comes from the finest level.
                ok = ok_l
        if lvl > 0:
            guess = guess * 2.0
    return guess, ok


def lk_track(tmpl_levels, srch_levels, points, init, src_t, src_s, *, wins, slack: int,
             pad: int, min_eig_threshold: float, max_iters: int, eps: float):
    """Every level of one LK direction for all K points (TPU kernels K5 and
    K6): one ``lk_track`` launch (``csrc/lk.cu``) on a CUDA tensor,
    :func:`lk_track_plain` on a CPU one, a batch of cameras included.
    Returns (points, status)."""
    if points.is_cuda:
        return cuda.lk_track([t.contiguous() for t in tmpl_levels],
                             [t.contiguous() for t in srch_levels],
                             points.float().contiguous(), init.float().contiguous(),
                             src_t.int().contiguous(), src_s.int().contiguous(),
                             [0 if w is None else w for w in wins], slack, pad,
                             _f32(min_eig_threshold), max_iters, _f32(eps * eps))
    return lk_track_plain(tmpl_levels, srch_levels, points, init, src_t, src_s, wins=wins,
                          slack=slack, pad=pad, min_eig_threshold=min_eig_threshold,
                          max_iters=max_iters, eps=eps)


# --- the coarse start --------------------------------------------------------


# Points are clamped to +-2^20 px before rounding (the kernel's int range).
_COARSE_MAX = float(2 ** 20)


def _slice_start(v: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """A start as ``jax.lax.dynamic_slice`` takes it: a negative start
    counts from the end (v + dim), then it is clamped to [0, dim - size]."""
    return torch.where(v < 0, v + dim, v).clamp(0, dim - size)


def coarse_block_match_plain(prev: torch.Tensor, nxt: torch.Tensor, points: torch.Tensor,
                             src: Optional[torch.Tensor], *, search: int,
                             patch: int) -> torch.Tensor:
    """Plain twin of the ``lk_coarse_match`` kernel: the coarse start.

    prev (R, H, W) is the coarsest level of the template frames (a ring;
    src (K,) picks each point's frame, None frame 0) or (H, W) one frame,
    nxt (H, W) the same level of the search frame, points (K, 2) [x, y] at
    that level's scale. For each point the SSD of the patch^2 template at
    round(pt) (half to even) against every whole offset of
    (2*search + 1)^2, each summed row by row over the patch, left to right;
    the first least cost in row-major (dy, dx) order wins (a NaN cost
    counts as least, as ``jnp.argmin`` takes it). The template's and the
    window's origins in the level edge-padded by search + patch//2 + 1 are
    taken as ``jax.lax.dynamic_slice`` takes a start (:func:`_slice_start`),
    and reads are clamped to the level, which is the edge padding; a
    non-finite point is taken at 0. Returns pt + (dx, dy), (K, 2).

    A batch of cameras, points and src (*batch, K, ...), prev
    (*batch, [R,] H, W) and nxt (*batch, H, W), is folded into rings as
    :func:`lk_track_plain` folds it.
    """
    batch = tuple(points.shape[:-2])
    nb, K = len(batch), points.shape[-2]
    (prev,), st = fold_rings([_as_ring(prev, nb)], src, batch, K)
    (nxt,), sn = fold_rings([_as_ring(nxt, nb)], None, batch, K)
    pts = points.reshape(-1, 2).float()
    H, W = prev.shape[-2], prev.shape[-1]
    n, r, wn = 2 * search + 1, patch // 2, patch + 2 * search
    pad = search + r + 1
    c = torch.round(_finite_or_zero(pts).clamp(-_COARSE_MAX, _COARSE_MAX)).long()
    cx, cy = c[:, 0], c[:, 1]
    Hp, Wp = H + 2 * pad, W + 2 * pad
    templ = extract_windows(prev, _slice_start(cy + (pad - r), Hp, patch),
                            _slice_start(cx + (pad - r), Wp, patch), patch, src=st, pad=pad)
    window = extract_windows(nxt, _slice_start(cy + (pad - r - search), Hp, wn),
                             _slice_start(cx + (pad - r - search), Wp, wn), wn, src=sn, pad=pad)
    cost = torch.zeros((pts.shape[0], n, n), dtype=torch.float32, device=pts.device)
    for i in range(patch):
        for j in range(patch):
            d = window[:, i:i + n, j:j + n] - templ[:, i, j, None, None]
            cost = cost + d * d
    best = torch.where(torch.isnan(cost), -1.0, cost).flatten(1).argmin(dim=1)
    off = torch.stack([best % n - search, best // n - search], dim=1)
    return (pts + off.float()).reshape(*batch, K, 2)


def coarse_block_match(prev, nxt, points, src, *, search: int, patch: int) -> torch.Tensor:
    """The coarse start (JAX's ``_coarse_block_match`` and
    ``_coarse_block_match_ring``, which XLA runs): one ``lk_coarse_match``
    launch (``csrc/lk_coarse.cu``) on a CUDA tensor,
    :func:`coarse_block_match_plain` on a CPU one, a batch of cameras
    included. Returns the (K, 2) matched positions at the level's scale."""
    if points.is_cuda:
        nb = points.ndim - 2
        src = torch.zeros(points.shape[:-1], dtype=torch.int32, device=points.device) \
            if src is None else src
        return cuda.lk_coarse_match(_as_ring(prev, nb).contiguous(), nxt.contiguous(),
                                    points.float().contiguous(), src.int().contiguous(),
                                    search, patch)
    return coarse_block_match_plain(prev, nxt, points, src, search=search, patch=patch)


def _coarse_start(prev_pyr, next_pyr, points, p: LKParams,
                  src: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """The forward walk's start at level 0's scale: the coarse block match
    at the coarsest level where ``coarse_init`` is set, else None."""
    if not p.coarse_init:
        return None
    scale = 2.0 ** (len(next_pyr) - 1)
    return coarse_block_match(prev_pyr[-1], next_pyr[-1], points / scale, src,
                              search=p.coarse_search, patch=p.coarse_patch) * scale


def _as_ring(level: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """A level (*batch, H, W) as a ring of one frame, (*batch, 1, H, W); a
    ring (*batch, R, H, W) as it is."""
    return level if level.ndim == batch_dims + 3 else level.unsqueeze(batch_dims)


def pyramidal_lk(prev_pyr: Sequence[torch.Tensor], next_pyr: Sequence[torch.Tensor],
                 points: torch.Tensor, p: LKParams,
                 initial_flow: Optional[torch.Tensor] = None,
                 src_prev: Optional[torch.Tensor] = None,
                 src_next: Optional[torch.Tensor] = None) -> FlowResult:
    """Coarse-to-fine LK over prebuilt pyramids. Either pyramid may be a
    ring, levels shaped (R, H, W), with per-point frame indices. A batch of
    cameras: points (*batch, K, 2), levels (*batch, [R,] H, W), frame
    indices (*batch, K)."""
    levels = len(prev_pyr)
    nb = points.ndim - 2
    zeros_k = torch.zeros(points.shape[:-1], dtype=torch.int32, device=points.device)
    sp = zeros_k if src_prev is None else src_prev.int()
    sn = zeros_k if src_next is None else src_next.int()

    def level_window(lvl: int):
        avail = min(min(prev_pyr[lvl].shape[-2:]), min(next_pyr[lvl].shape[-2:]))
        win = min(p.window, avail)
        win -= (win + 1) % 2
        return win if win >= 7 else None

    pts, ok = lk_track([_as_ring(l, nb) for l in prev_pyr], [_as_ring(l, nb) for l in next_pyr],
                       points, points if initial_flow is None else initial_flow, sp, sn,
                       wins=[level_window(l) for l in range(levels)], slack=p.search_slack,
                       pad=p.window // 2 + 2, min_eig_threshold=p.min_eig_threshold,
                       max_iters=p.max_iters, eps=p.eps)
    return FlowResult(points=pts, status=ok)


def _bwd_level_count(p: LKParams, levels: int) -> int:
    return levels if p.bwd_levels <= 0 else min(levels, p.bwd_levels)


def _bwd_init(points: torch.Tensor, p: LKParams) -> torch.Tensor:
    """Start of the truncated backward walk: the round-trip target offset by
    fwd_bwd_tol per axis, so a walk that never moves lands at
    offset*sqrt(2) > tol and fails the check. With a slack window the offset
    is clamped to search_slack - 1, inside the window; the unbounded walk
    takes it whole."""
    off = float(p.fwd_bwd_tol)
    if p.search_slack > 0:
        off = min(off, float(p.search_slack - 1))
        if off * 1.4142 <= p.fwd_bwd_tol:
            raise ValueError(
                f"bwd_levels requires fwd_bwd_tol ({p.fwd_bwd_tol}) comfortably inside "
                f"search_slack ({p.search_slack}): the clamped init offset {off} px no longer "
                "satisfies offset*sqrt(2) > tol. Raise search_slack or lower fwd_bwd_tol.")
    return points + off


def _appearance_gate(prev_img: torch.Tensor, next_img: torch.Tensor, pts_prev: torch.Tensor,
                     pts_next: torch.Tensor, p: LKParams,
                     src_prev: Optional[torch.Tensor] = None,
                     src_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K,) bool: ZNCC(template at pts_prev, patch at pts_next) >= bwd_zncc_min,
    both patches recentred on their subpixel positions. A batch of cameras
    is folded into the rings, as :func:`lk_track_plain` folds it."""
    batch = tuple(pts_prev.shape[:-2])
    if batch:
        K = pts_prev.shape[-2]
        nb = len(batch)
        (prev_img,), src_prev = fold_rings([_as_ring(prev_img, nb)], src_prev, batch, K)
        (next_img,), src_next = fold_rings([_as_ring(next_img, nb)], src_next, batch, K)
        ok = _appearance_gate(prev_img, next_img, pts_prev.reshape(-1, 2),
                              pts_next.reshape(-1, 2), p, src_prev, src_next)
        return ok.reshape(*batch, K)
    win = p.window
    pad = win // 2 + 2
    H, W = prev_img.shape[-2], prev_img.shape[-1]
    zk = torch.zeros(pts_prev.shape[0], dtype=torch.long, device=pts_prev.device)

    def patch(img, src, pt):
        ty = _origin(pt[:, 1], win // 2 + 1 - pad, H + 2 * pad - (win + 3))
        tx = _origin(pt[:, 0], win // 2 + 1 - pad, W + 2 * pad - (win + 3))
        w = extract_windows(_as_ring(img, 0), ty, tx, win + 3,
                            src=zk if src is None else src.long(), pad=pad)
        full = sample_patches_bilinear(w, (pt[:, 1] + pad) - ty.float(),
                                       (pt[:, 0] + pad) - tx.float(), win + 2, win + 2)
        return full[:, 1:-1, 1:-1]

    za = patch(prev_img, src_prev, pts_prev)
    zb = patch(next_img, src_next, pts_next)
    za = za - za.mean(dim=(1, 2), keepdim=True)
    zb = zb - zb.mean(dim=(1, 2), keepdim=True)
    denom = sqrt_f32((za * za).sum(dim=(1, 2)) * (zb * zb).sum(dim=(1, 2)))
    zncc = (za * zb).sum(dim=(1, 2)) / denom.clamp_min(1e-12)
    return zncc >= p.bwd_zncc_min


def _round_trip(prev_pyr, next_pyr, points, valid, fwd: FlowResult, p: LKParams,
                src: Optional[torch.Tensor]) -> torch.Tensor:
    """Forward status, then the backward check into the template frames."""
    status = fwd.status & valid
    if not p.bidirectional:
        return status
    levels = len(next_pyr)
    nb = _bwd_level_count(p, levels)
    bwd = pyramidal_lk(next_pyr[:nb], prev_pyr[:nb], fwd.points, p, src_next=src,
                       initial_flow=_bwd_init(points, p) if nb < levels else None)
    d = bwd.points - points
    status = status & bwd.status & ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                                    <= p.fwd_bwd_tol ** 2)
    if nb < levels or p.zncc_gate:
        status = status & _appearance_gate(prev_pyr[0], next_pyr[0], points, fwd.points, p,
                                           src_prev=src)
    return status


def track_points(prev_img: torch.Tensor, next_img: torch.Tensor, points: torch.Tensor,
                 valid: torch.Tensor, p: LKParams = LKParams()) -> FlowResult:
    """Pyramids, forward LK and the optional backward check
    (FeatureTracker::Track, feature_tracker.cpp:49-95). A batch: (*batch,
    H, W) images and (*batch, K, 2) points."""
    levels = p.max_level + 1
    prev_pyr = image_pyramid(prev_img, levels)
    next_pyr = image_pyramid(next_img, levels)
    fwd = pyramidal_lk(prev_pyr, next_pyr, points, p,
                       initial_flow=_coarse_start(prev_pyr, next_pyr, points, p))
    return FlowResult(points=fwd.points,
                      status=_round_trip(prev_pyr, next_pyr, points, valid, fwd, p, None))


def track_points_ring(ring_pyr: Sequence[torch.Tensor], next_pyr: Sequence[torch.Tensor],
                      points: torch.Tensor, valid: torch.Tensor, src_idx: torch.Tensor,
                      p: LKParams = LKParams()) -> FlowResult:
    """k-ago re-tracking (stereo_tracker.cpp:33-88): each landmark's template
    comes from ring slot ``src_idx`` (the frame it was last seen in, slot 0
    the newest), and the backward check searches in that same slot. A
    batch: (*batch, R, H, W) ring levels, (*batch, H, W) next levels and
    (*batch, K) points and slots."""
    src = src_idx.int().clamp(0, ring_pyr[0].shape[-3] - 1)
    fwd = pyramidal_lk(ring_pyr, next_pyr, points, p, src_prev=src,
                       initial_flow=_coarse_start(ring_pyr, next_pyr, points, p, src))
    return FlowResult(points=fwd.points,
                      status=_round_trip(ring_pyr, next_pyr, points, valid, fwd, p, src))

