"""The stereo tracker of the reference, one frame, from a given state.

Written from the reference repository's StereoTracker::TrackAndTriangulate
(stereo_tracker.cpp) and FeatureTracker, as the JAX package states it:

1. re-track each live landmark from the frame it was last seen in (a ring
   of the last retrack_frames_k + 1 pyramids) by pyramidal Lucas-Kanade:
   per level, coarse to fine, Gauss-Newton steps on a template of the
   window's size at the landmark, each step bounded to a slack window
   around the level's first guess; then back from the found point into the
   template frame, and a landmark is tracked if both walks pass every gate
   and the round trip lands within fwd_bwd_tol;
2. count misses and drop landmarks missed more than retrack_frames_k times;
3. a keyframe when few landmarks were tracked or trigger_keyframe_k frames
   passed: detect Shi-Tomasi corners away from live landmarks, the best of
   each min_distance cell, the best cells first, into the free slots;
4. match every live landmark along its row in the right image
   (TM_SQDIFF_NORMED over a templ_rows x templ_cols template) and gate the
   disparity by depth.

Arithmetic runs in the precision of the images.
"""

from __future__ import annotations

import dataclasses

import torch

from .image import bilinear, box_mean, dilate, f32, pyramid, sobel

SLACK = 4            # the walk's slack window around a level's first guess, in px
FWD_BWD_TOL = 2.0
MIN_EIG = 1.5e-9
DET_MIN = 1e-12
BORDER = 8           # the detector's border


@dataclasses.dataclass
class State:
    """One camera's tracker state: the slots' fields and the pyramid ring."""
    ids: torch.Tensor            # (K,) int, -1 free
    pixels: torch.Tensor         # (K, 2) x, y
    disparities: torch.Tensor    # (K,)
    kf_pixels: torch.Tensor
    kf_disparities: torch.Tensor
    ages: torch.Tensor
    missed: torch.Tensor
    frame_idx: int
    last_kf_frame: int
    next_id: int
    ring: list                   # per level (R, h, w), slot 0 the newest frame


def _level_window(win: int, shape) -> int:
    w = min(win, min(shape))
    w -= (w + 1) % 2
    return w


def lk(tmpl: list, t_frame: torch.Tensor, srch: list, s_frame: torch.Tensor,
       points: torch.Tensor, guess: torch.Tensor, win: int, iters: int, eps: float,
       work: list | None = None):
    """One direction of pyramidal LK: template levels ``tmpl`` and search
    levels ``srch`` ((F, h, w) each, finest first) read at frames t_frame and
    s_frame (K,); points and guess (K, 2) at level 0. Returns the points
    (K, 2) and level 0's status (K,). ``work``, where given, gets one
    (level, window, steps moved) a level, the steps summed over the points."""
    levels = len(tmpl)
    pad = win // 2 + 2                       # the level's edge padding, in px
    guess = guess / 2 ** (levels - 1)
    ok = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for lvl in range(levels - 1, -1, -1):
        T, S = tmpl[lvl], srch[lvl]
        h, w = T.shape[-2:]
        wl = _level_window(win, (h, w))
        r = wl // 2
        p = points / 2 ** lvl
        o = torch.arange(-r - 1, r + 2, device=p.device, dtype=p.dtype)
        # The template: the window at the point, resampled at its subpixel
        # position, and its central-difference gradients.
        tw = bilinear(T, t_frame[:, None, None], p[:, 1, None, None] + o[:, None],
                      p[:, 0, None, None] + o[None, :])
        tpl = tw[:, 1:-1, 1:-1]
        gx = 0.5 * (tw[:, 1:-1, 2:] - tw[:, 1:-1, :-2])
        gy = 0.5 * (tw[:, 2:, 1:-1] - tw[:, :-2, 1:-1])
        a, b, c = (gx * gx).sum((1, 2)), (gx * gy).sum((1, 2)), (gy * gy).sum((1, 2))
        det = a * c - b * b
        min_eig = 0.5 * ((a + c) - torch.sqrt((a - c) ** 2 + 4 * b * b)) / (wl * wl)
        gate = (det > f32(DET_MIN)) & (min_eig > f32(MIN_EIG))
        det = torch.where(det > f32(DET_MIN), det, 1.0)
        # The slack window: a walk that leaves it fails the level.
        ws = wl + 2 * (SLACK + 1)
        oy = (torch.floor(guess[:, 1]) - (r + SLACK + 1) + pad).clamp(0, h + 2 * pad - ws)
        ox = (torch.floor(guess[:, 0]) - (r + SLACK + 1) + pad).clamp(0, w + 2 * pad - ws)
        q = guess.clone()
        done = torch.zeros_like(gate)
        hit = torch.zeros_like(gate)
        oi = o[1:-1]
        moved = 0
        for _ in range(iters):
            cy, cx = q[:, 1] + pad - oy, q[:, 0] + pad - ox
            hit = hit | ~((cy >= r + 1) & (cy <= ws - r - 2) & (cx >= r + 1) & (cx <= ws - r - 2))
            stop = done | hit
            moved = moved + (~stop).sum()
            patch = bilinear(S, s_frame[:, None, None], q[:, 1, None, None] + oi[:, None],
                             q[:, 0, None, None] + oi[None, :])
            e = patch - tpl
            bx, by = (e * gx).sum((1, 2)), (e * gy).sum((1, 2))
            dx = -(c * bx - b * by) / det
            dy = -(-b * bx + a * by) / det
            q = torch.where(stop[:, None], q, q + torch.stack([dx, dy], 1))
            done = stop | (dx * dx + dy * dy < f32(eps * eps))
        if work is not None:
            work.append((lvl, wl, int(moved)))
        inside = (q[:, 0] >= 0) & (q[:, 0] <= w - 1) & (q[:, 1] >= 0) & (q[:, 1] <= h - 1)
        ok_l = gate & inside & torch.isfinite(q).all(1) & ~hit
        guess = torch.where(ok_l[:, None], q, guess)
        if lvl == 0:
            ok = ok_l
        else:
            guess = guess * 2
    return guess, ok


def corners(img: torch.Tensor, exclude: torch.Tensor, params: dict):
    """The detector on one (H, W) image, away from the (N, 2) points
    ``exclude``: (max_features, 2) points and their validity."""
    H, W = img.shape
    gx, gy = sobel(img)
    r = params["block_size"] // 2
    a, b, c = box_mean(gx * gx, r), box_mean(gx * gy, r), box_mean(gy * gy, r)
    score = 0.5 * ((a + c) - torch.sqrt((a - c) ** 2 + 4 * b * b))
    score = torch.where(score >= dilate(score, 3), score, 0.0)
    score = torch.where(score >= f32(params["quality_level"]) * score.max(), score, 0.0)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    score = torch.where((yy >= BORDER) & (yy < H - BORDER) & (xx >= BORDER) & (xx < W - BORDER),
                        score, 0.0)
    if exclude.shape[0]:
        near = torch.zeros((H, W), dtype=img.dtype, device=img.device)
        ex = torch.round(exclude).long()
        near[ex[:, 1].clamp(0, H - 1), ex[:, 0].clamp(0, W - 1)] = 1.0
        score = torch.where(dilate(near, 2 * int(params["min_distance"]) + 1) > 0.5, 0.0, score)
    cell = max(4, int(params["min_distance"]))
    Hc, Wc = -(-H // cell), -(-W // cell)
    padded = score.new_zeros((Hc * cell, Wc * cell))
    padded[:H, :W] = score
    cells = padded.reshape(Hc, cell, Wc, cell).permute(0, 2, 1, 3).reshape(Hc * Wc, cell * cell)
    best = cells.amax(dim=1)
    k = (cells == best[:, None]).float().argmax(dim=1)      # the first best of each cell
    n_ = torch.arange(Hc * Wc, device=img.device)
    where = torch.stack([(n_ % Wc) * cell + k % cell, (n_ // Wc) * cell + k // cell], 1)
    where = where.to(img.dtype)
    n = min(params["max_features"], Hc * Wc)
    order = torch.sort(best, descending=True, stable=True).indices[:n]
    pts, valid = where[order], best[order] > 0
    K = params["max_features"]
    if n < K:
        pts = torch.cat([pts, pts.new_zeros((K - n, 2))])
        valid = torch.cat([valid, valid.new_zeros(K - n)])
    return pts, valid


def stripe_match(left: torch.Tensor, right: torch.Tensor, pts: torch.Tensor, params: dict):
    """(K,) disparity of each point along its row, -1 where there is no match
    better than max_matching_cost."""
    H, W = left.shape
    tr, tc, md = params["templ_rows"], params["templ_cols"], params["max_disp"]
    x, y = torch.round(pts[:, 0]).long(), torch.round(pts[:, 1]).long()
    ty = (y - tr // 2).clamp(0, H - tr)
    tx = (x - tc // 2).clamp(0, W - tc)
    sy = (y - tr // 2 - 1).clamp(0, H - tr - 2)
    sx = (x - md - tc // 2).clamp(0, W - md - tc)
    ar, ac = torch.arange(tr, device=left.device), torch.arange(tc, device=left.device)
    T = left[(ty[:, None] + ar)[:, :, None], (tx[:, None] + ac)[:, None, :]]      # (K, tr, tc)
    best = torch.full((pts.shape[0],), float("inf"), dtype=left.dtype, device=left.device)
    best_u = torch.zeros(pts.shape[0], dtype=torch.long, device=left.device)
    t2 = (T * T).sum((1, 2))
    for dy in range(3):
        for u in range(md + 1):
            Sw = right[(sy[:, None] + dy + ar)[:, :, None], (sx[:, None] + u + ac)[:, None, :]]
            cost = ((T - Sw) ** 2).sum((1, 2)) / torch.sqrt((t2 * (Sw * Sw).sum((1, 2)))
                                                           .clamp_min(1e-12))
            better = cost < best                     # the first least cost, (dy, u) row-major
            best = torch.where(better, cost, best)
            best_u = torch.where(better, u, best_u)
    disp = (tx - sx - best_u).to(left.dtype)
    ok = (best < f32(params["max_matching_cost"])) & (disp >= 0)
    return torch.where(ok, disp, -1.0)


def step(state: State, cur: torch.Tensor, right: torch.Tensor, fxb: float, p: dict,
         work: dict | None = None) -> State:
    """One frame of one camera: (H, W) current left and right grays.
    ``work``, where given, gets each LK direction's levels under "lk_track"."""
    lkp, K = p["lk"], state.ids.shape[0]
    levels = lkp["max_level"] + 1
    cur_pyr = pyramid(cur, levels)
    alive = state.ids >= 0
    R = state.ring[0].shape[0]
    src = state.missed.long().clamp(0, R - 1)
    zero = torch.zeros_like(src)
    walks = ([], [])
    cur_ring = [level[None] for level in cur_pyr]
    pts, okf = lk(state.ring, src, cur_ring, zero, state.pixels, state.pixels, lkp["window"],
                  lkp["max_iters"], lkp["eps"], walks[0])
    back, okb = lk(cur_ring, zero, state.ring, src, pts, pts, lkp["window"], lkp["max_iters"],
                   lkp["eps"], walks[1])
    if work is not None:
        work.setdefault("lk_track", []).append([(K, walk) for walk in walks])
    d = back - state.pixels
    tracked = alive & okf & okb & ((d * d).sum(1) <= FWD_BWD_TOL ** 2)
    missed = torch.where(tracked, 0, state.missed + 1)
    keep = alive & (missed <= p["retrack_frames_k"])
    ids = torch.where(keep, state.ids, -1)
    pixels = torch.where(tracked[:, None], pts, state.pixels)
    missed = torch.where(keep, missed, 0)
    ages = torch.where(keep, state.ages + 1, 0)
    kf_pixels, kf_disp = state.kf_pixels, state.kf_disparities
    next_id = state.next_id
    n_tracked = int((tracked & keep).sum())
    is_kf = n_tracked < p["trigger_keyframe_min_lmks"] or \
        state.frame_idx - state.last_kf_frame >= p["trigger_keyframe_k"]
    if is_kf:
        det, valid = corners(cur, pixels[ids >= 0], p["detector"])
        free = (ids < 0).nonzero()[:, 0].tolist()          # free slots in slot order
        for slot, k in zip(free, valid.nonzero()[:, 0].tolist()):
            ids[slot] = next_id
            next_id += 1
            pixels[slot] = det[k]
            ages[slot] = missed[slot] = 0
    live = ids >= 0
    disp = stripe_match(cur, right, pixels, p["matcher"])
    gate = (disp > f32(fxb) / p["stereo_max_depth"]) & (disp < f32(fxb) / p["stereo_min_depth"])
    disparities = torch.where(live & gate, disp, -1.0)
    if is_kf:
        kf_pixels, kf_disp = pixels.clone(), disparities.clone()
    ring = [torch.cat([c[None], lvl[:-1]]) for c, lvl in zip(cur_pyr, state.ring)]
    return State(ids=ids, pixels=pixels, disparities=disparities, kf_pixels=kf_pixels,
                 kf_disparities=kf_disp, ages=ages, missed=missed,
                 frame_idx=state.frame_idx + 1,
                 last_kf_frame=state.frame_idx if is_kf else state.last_kf_frame,
                 next_id=next_id, ring=ring)
