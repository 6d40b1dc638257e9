"""AprilTag fiducial detection (tag36h11 / tag25h9 / tag16h5); port of
``ocean_perception_tpu.tracking.apriltags``.

Original implementation of the AprilTag fiducial system (Olson, ICRA 2011)
with the same capability surface as the reference's vendored detector
(src/external/apriltags/AprilTags/TagDetector.h,
TagFamily.h) — which the reference ships but never wires into its vehicle
code (SURVEY.md §2.3 "external/apriltags ... fiducial support"). Carried
here so the inventory row is complete AND useful: detections expose
subpixel corners, the tag->image homography, and a metric SE(3) pose
(`tag_pose`) ready to feed the smoother as a pose measurement.

Pipeline (this file, none of it translated from the reference — the
reference detector is segment-based [gradient clustering -> line segments
-> quad search]; ours is region-based, which suits the fixed-capacity /
vectorized style of this framework):

1. adaptive binarization — 4x4 px tile min/max, 3x3-tile dilation,
   threshold (min+max)/2, low-contrast tiles forced to background
   (the AprilTag 2 thresholding scheme, Wang & Olson IROS 2016 §III.A);
2. connected components of dark pixels (the black border ring plus any
   payload cells touching it form one region; the white quiet zone
   isolates it);
3. convex hull per region -> best inscribed quadrilateral (greedy
   extremes + coordinate-ascent area maximization over hull vertices),
   rejected unless the quad explains >=92% of the hull area;
4. subpixel corner refinement: boundary pixels are assigned to their
   nearest quad side, each side gets a total-least-squares (PCA) line
   fit, adjacent lines are intersected;
5. 4-point DLT homography from the unit square; black/white intensity
   models from the border cells and the quiet zone (TagDetector.cc
   :438-455 semantics: border cells must classify dark, else reject);
6. payload bits sampled at cell centers (MSB = top-left cell, row-major,
   white = 1 — the standard family layout, TagDetector.cc:457-475), then
   matched against the family table over all 4 rotations with hamming
   error recovery (TagFamily.cc decode semantics; default budget 1 bit).

Detection is host-side numpy by design: fiducial detection is a sparse,
irregular, at-initialization task (like the mesher's host Delaunay), and
the reference itself never runs it on the vehicle hot path. The code
tables are public constant data (tracking/tag_family_data.py). The
detection code is the JAX package's, line for line, so its detections are
the same. ``estimate_camera_pose`` solves on a torch device, the card by
default, through ``vio/odometry.py::optimize_odometry`` (a CUDA graph
replay there, captured once for each corner count's ``min_inliers``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tag_family_data import FAMILY_TABLES

__all__ = [
    "TagFamily",
    "TagDetection",
    "TagDetectorParams",
    "detect_tags",
    "render_tag",
    "tag_pose",
    "tag_corners_world",
    "estimate_camera_pose",
]


# ---------------------------------------------------------------------------
# Tag families
# ---------------------------------------------------------------------------


def _codes_to_grids(codes: np.ndarray, dim: int) -> np.ndarray:
    """(N,) uint64 -> (N, dim, dim) uint8 bit grids, MSB = [0, 0]."""
    n = codes.shape[0]
    bits = dim * dim
    shifts = (bits - 1 - np.arange(bits, dtype=np.uint64)).astype(np.uint64)
    grid = (codes[:, None] >> shifts[None, :]) & np.uint64(1)
    return grid.astype(np.uint8).reshape(n, dim, dim)


def _grids_to_codes(grids: np.ndarray) -> np.ndarray:
    """(N, dim, dim) uint8 -> (N,) uint64, MSB = [0, 0]."""
    n, dim, _ = grids.shape
    bits = dim * dim
    shifts = (bits - 1 - np.arange(bits, dtype=np.uint64)).astype(np.uint64)
    flat = grids.reshape(n, bits).astype(np.uint64)
    return np.bitwise_or.reduce(flat << shifts[None, :], axis=1)


@dataclasses.dataclass(frozen=True)
class TagFamily:
    """A tag code family plus the precomputed rotation-closed match table."""

    name: str
    bits: int
    dim: int  # payload grid edge (6 for tag36h11)
    min_hamming: int
    codes: np.ndarray  # (N,) uint64, canonical orientation
    rot_codes: np.ndarray  # (4, N) uint64: codes rotated k*90deg CCW

    @staticmethod
    def create(name: str) -> "TagFamily":
        if name not in FAMILY_TABLES:
            raise KeyError(f"unknown tag family {name!r}; have {sorted(FAMILY_TABLES)}")
        bits, dim, hmin, codes = FAMILY_TABLES[name]
        grids = _codes_to_grids(codes, dim)
        rots = [codes]
        g = grids
        for _ in range(3):
            g = np.rot90(g, 1, axes=(1, 2))
            rots.append(_grids_to_codes(g))
        return TagFamily(name, bits, dim, hmin, codes, np.stack(rots))

    def decode(self, observed: int, max_hamming: int) -> Tuple[int, int, int]:
        """Best (tag_id, hamming, rotation) for an observed payload code.

        rotation k means: rotating the OBSERVED bit grid by k*90deg CCW
        yields the canonical table code. Returns (-1, 99, 0) if the best
        match exceeds ``max_hamming``.
        """
        x = self.rot_codes ^ np.uint64(observed)  # (4, N)
        dist = _popcount64(x)
        k, idx = np.unravel_index(int(np.argmin(dist)), dist.shape)
        best = int(dist[k, idx])
        if best > max_hamming:
            return -1, 99, 0
        return int(idx), best, int(k)


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount64(x: np.ndarray) -> np.ndarray:
    return _POP8[x.view(np.uint8).reshape(*x.shape, 8)].sum(axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# Rendering (tests, tag-board generation)
# ---------------------------------------------------------------------------


def render_tag(
    family: TagFamily, tag_id: int, cell_px: int = 8, white_border: int = 2
) -> np.ndarray:
    """Render a tag as float32 [0, 1], white quiet zone included.

    Cell layout matches the standard family images: payload MSB at the
    top-left cell, row-major, bit 1 = white; one-cell black border.
    """
    dim = family.dim
    grid = _codes_to_grids(family.codes[tag_id : tag_id + 1], dim)[0]
    dd = dim + 2
    design = np.zeros((dd, dd), np.float32)
    design[1 : 1 + dim, 1 : 1 + dim] = grid.astype(np.float32)
    full = np.pad(design, white_border, constant_values=1.0)
    return np.kron(full, np.ones((cell_px, cell_px), np.float32))


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TagDetectorParams:
    tile: int = 4  # threshold tile edge, px
    min_contrast: float = 0.12  # tile max-min below this -> background
    min_area_px: int = 64  # reject smaller dark regions
    max_area_frac: float = 0.25  # reject regions bigger than this image frac
    quad_hull_ratio: float = 0.92  # quad area / hull area acceptance
    max_hamming: int = 1  # error-recovery bit budget (TagFamily default)
    min_border_frac: float = 0.85  # border cells that must classify dark
    refine_max_dist: float = 2.0  # boundary px -> side assignment radius


@dataclasses.dataclass
class TagDetection:
    tag_id: int
    hamming: int
    family: str
    corners: np.ndarray  # (4, 2) float64 pixel coords, tag-frame order:
    #   corners[0] = tag (-1,-1) [bottom-left, y up in tag frame]
    #   corners[1] = tag (+1,-1), corners[2] = (+1,+1), corners[3] = (-1,+1)
    center: np.ndarray  # (2,) pixel coords
    H: np.ndarray  # (3, 3) homography: tag coords [-1,1]^2 -> pixels
    code: int  # observed payload bits (canonical orientation)


def _adaptive_binarize(img: np.ndarray, p: TagDetectorParams) -> np.ndarray:
    """True where pixel is confidently dark (AprilTag2 tile thresholding)."""
    H, W = img.shape
    t = p.tile
    Ht, Wt = (H + t - 1) // t, (W + t - 1) // t
    pad = np.pad(img, ((0, Ht * t - H), (0, Wt * t - W)), mode="edge")
    tiles = pad.reshape(Ht, t, Wt, t)
    tmin = tiles.min(axis=(1, 3))
    tmax = tiles.max(axis=(1, 3))

    def dilate3(a, op):
        b = a
        for ax in (0, 1):
            s1 = np.roll(b, 1, axis=ax)
            s2 = np.roll(b, -1, axis=ax)
            # edge-replicate instead of wrap
            if ax == 0:
                s1[0] = b[0]
                s2[-1] = b[-1]
            else:
                s1[:, 0] = b[:, 0]
                s2[:, -1] = b[:, -1]
            b = op(op(s1, s2), b)
        return b

    lo = dilate3(tmin, np.minimum)
    hi = dilate3(tmax, np.maximum)
    thresh = (lo + hi) * 0.5
    ok = (hi - lo) >= p.min_contrast
    thr_full = np.kron(thresh, np.ones((t, t)))[:H, :W]
    ok_full = np.kron(ok, np.ones((t, t), bool))[:H, :W]
    return ok_full & (img < thr_full)


def _convex_hull(points_xy: np.ndarray) -> np.ndarray:
    """Hull vertices (CCW in y-down image coords) via scipy."""
    from scipy.spatial import ConvexHull, QhullError

    try:
        h = ConvexHull(points_xy)
    except QhullError:
        return np.empty((0, 2))
    return points_xy[h.vertices]


def _quad_area(q: np.ndarray) -> float:
    x, y = q[:, 0], q[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _best_quad(hull: np.ndarray) -> Optional[np.ndarray]:
    """Indices of the 4 hull vertices maximizing quadrilateral area.

    Greedy farthest-point init then coordinate ascent — hulls here are
    tiny (tens of vertices), so this converges in 2-3 sweeps.
    """
    n = hull.shape[0]
    if n < 4:
        return None
    c = hull.mean(axis=0)
    i0 = int(np.argmax(((hull - c) ** 2).sum(axis=1)))
    i1 = int(np.argmax(((hull - hull[i0]) ** 2).sum(axis=1)))
    d01 = hull[i1] - hull[i0]
    cross = (hull[:, 0] - hull[i0, 0]) * d01[1] - (hull[:, 1] - hull[i0, 1]) * d01[0]
    i2 = int(np.argmax(cross))
    i3 = int(np.argmin(cross))
    idx = sorted({i0, i1, i2, i3})
    while len(idx) < 4:  # degenerate init: seed with spread vertices
        for j in range(n):
            if j not in idx:
                idx.append(j)
                break
        idx = sorted(set(idx))
    idx = idx[:4]

    improved = True
    while improved:
        improved = False
        for slot in range(4):
            best_j, best_a = idx[slot], _quad_area(hull[idx])
            for j in range(n):
                if j in idx:
                    continue
                trial = sorted(idx[:slot] + [j] + idx[slot + 1 :])
                a = _quad_area(hull[trial])
                if a > best_a + 1e-9:
                    best_a, best_j = a, j
            if best_j != idx[slot]:
                idx[slot] = best_j
                idx = sorted(idx)
                improved = True
    return hull[sorted(idx)]


def _refine_corners(
    quad: np.ndarray, boundary_xy: np.ndarray, p: TagDetectorParams
) -> np.ndarray:
    """PCA line fit per side over nearest boundary pixels, then intersect."""
    lines = []
    for k in range(4):
        a, b = quad[k], quad[(k + 1) % 4]
        ab = b - a
        L = np.hypot(*ab) + 1e-9
        t = ((boundary_xy - a) @ ab) / (L * L)
        rel = boundary_xy - a
        perp = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / L
        sel = (t > 0.08) & (t < 0.92) & (perp < p.refine_max_dist)
        pts = boundary_xy[sel]
        if pts.shape[0] < 6:
            # too few pixels: keep the hull side as the line
            lines.append((a, ab / L))
            continue
        mu = pts.mean(axis=0)
        u, s, vt = np.linalg.svd(pts - mu, full_matrices=False)
        lines.append((mu, vt[0]))
    out = np.zeros((4, 2))
    for k in range(4):
        (p1, d1), (p2, d2) = lines[(k - 1) % 4], lines[k]
        A = np.array([[d1[0], -d2[0]], [d1[1], -d2[1]]])
        rhs = p2 - p1
        det = np.linalg.det(A)
        if abs(det) < 1e-9:
            out[k] = quad[k]
            continue
        t1 = np.linalg.solve(A, rhs)[0]
        out[k] = p1 + t1 * d1
    return out


def _h_from_unit_square(corners: np.ndarray) -> np.ndarray:
    """DLT homography mapping (u,v) in [0,1]^2 to the 4 corners.

    Corner k corresponds to (u,v) = (0,0), (1,0), (1,1), (0,1).
    """
    src = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    A = []
    for (u, v), (x, y) in zip(src, corners):
        A.append([u, v, 1, 0, 0, 0, -u * x, -v * x, -x])
        A.append([0, 0, 0, u, v, 1, -u * y, -v * y, -y])
    A = np.asarray(A)
    _, _, vt = np.linalg.svd(A)
    Hm = vt[-1].reshape(3, 3)
    return Hm / Hm[2, 2]


def _project(Hm: np.ndarray, uv: np.ndarray) -> np.ndarray:
    ph = np.concatenate([uv, np.ones((*uv.shape[:-1], 1))], axis=-1) @ Hm.T
    return ph[..., :2] / ph[..., 2:3]


def _bilinear(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    H, W = img.shape
    x = np.clip(xy[..., 0], 0.0, W - 1.001)
    y = np.clip(xy[..., 1], 0.0, H - 1.001)
    x0, y0 = x.astype(int), y.astype(int)
    fx, fy = x - x0, y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def detect_tags(
    image: np.ndarray,
    family: TagFamily | str = "tag36h11",
    params: TagDetectorParams = TagDetectorParams(),
) -> List[TagDetection]:
    """Detect AprilTags in a grayscale image (float [0,1] or uint8)."""
    from scipy import ndimage

    if isinstance(family, str):
        family = TagFamily.create(family)
    img = np.asarray(image)
    if img.ndim == 3:
        img = img.mean(axis=2)
    if img.dtype != np.float64 and img.dtype != np.float32:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float64)
    H, W = img.shape

    dark = _adaptive_binarize(img, params)
    labels, n = ndimage.label(dark, structure=np.ones((3, 3), int))
    if n == 0:
        return []
    slices = ndimage.find_objects(labels)

    dim = family.dim
    dd = dim + 2
    dets: List[TagDetection] = []
    for i, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        ys, xs = sl
        h, w = ys.stop - ys.start, xs.stop - xs.start
        area_box = h * w
        if area_box < params.min_area_px or area_box > params.max_area_frac * H * W:
            continue
        if ys.start < 1 or xs.start < 1 or ys.stop > H - 1 or xs.stop > W - 1:
            continue  # touches the image edge: quiet zone incomplete
        mask = labels[sl] == i
        if int(mask.sum()) < params.min_area_px:
            continue
        pts_rc = np.argwhere(mask)
        pts_xy = pts_rc[:, ::-1] + np.array([xs.start, ys.start])  # (x, y)
        hull = _convex_hull(pts_xy.astype(np.float64))
        quad = _best_quad(hull)
        if quad is None:
            continue
        hull_area = _quad_area(hull)  # shoelace: valid for any n-gon
        qa = _quad_area(quad)
        if hull_area <= 0 or qa < params.quad_hull_ratio * hull_area:
            continue

        interior = ndimage.binary_erosion(mask)
        boundary_rc = np.argwhere(mask & ~interior)
        boundary_xy = boundary_rc[:, ::-1] + np.array([xs.start, ys.start])
        # push the fitted lines half a pixel outward: binarized boundary
        # pixel centers sit half a pixel inside the true dark/light edge
        corners = _refine_corners(quad, boundary_xy.astype(np.float64), params)
        ctr = corners.mean(axis=0)
        dirs = corners - ctr
        corners = corners + 0.5 * dirs / np.maximum(
            np.linalg.norm(dirs, axis=1, keepdims=True), 1e-9
        ) * np.sqrt(2.0)

        Hs = _h_from_unit_square(corners)

        # black/white models: border cell centers vs quiet-zone ring
        ib, jb = np.meshgrid(np.arange(dd), np.arange(dd), indexing="ij")
        is_border = (ib == 0) | (ib == dd - 1) | (jb == 0) | (jb == dd - 1)
        buv = np.stack([(jb[is_border] + 0.5) / dd, (ib[is_border] + 0.5) / dd], -1)
        # Cell indices -1 and dd on every edge; the (i + 0.5)/dd mapping
        # below turns them into the half-cell-outside quiet-zone ring
        # (-0.5/dd and (dd+0.5)/dd) — matching the arange(-1, dd+1) edges.
        wuv_i = np.concatenate(
            [np.full(dd + 2, -1.0), np.full(dd + 2, float(dd)),
             np.arange(-1, dd + 1), np.arange(-1, dd + 1)]
        )
        wuv_j = np.concatenate(
            [np.arange(-1, dd + 1), np.arange(-1, dd + 1),
             np.full(dd + 2, -1.0), np.full(dd + 2, float(dd))]
        )
        wuv = np.stack([(wuv_j + 0.5) / dd, (wuv_i + 0.5) / dd], -1)
        bpx = _project(Hs, buv)
        wpx = _project(Hs, wuv)
        inb = (
            (wpx[:, 0] >= 0) & (wpx[:, 0] < W - 1)
            & (wpx[:, 1] >= 0) & (wpx[:, 1] < H - 1)
        )
        if inb.sum() < 8:
            continue
        black_v = _bilinear(img, bpx)
        white_v = _bilinear(img, wpx[inb])
        thr = 0.5 * (black_v.mean() + white_v.mean())
        if white_v.mean() - black_v.mean() < params.min_contrast:
            continue
        if (black_v < thr).mean() < params.min_border_frac:
            continue

        # payload bits, MSB = top-left cell (u, v both smallest)
        ic, jc = np.meshgrid(np.arange(dim), np.arange(dim), indexing="ij")
        cuv = np.stack([(jc + 1.5) / dd, (ic + 1.5) / dd], -1).reshape(-1, 2)
        vals = _bilinear(img, _project(Hs, cuv))
        bits = (vals > thr).astype(np.uint8).reshape(dim, dim)
        observed = int(_grids_to_codes(bits[None])[0])

        tag_id, hamming, rot = family.decode(observed, params.max_hamming)
        if tag_id < 0:
            continue

        # Tag-frame corner order [bl, br, tr, tl] (tag x right, y UP). The
        # sampling frame walks the quad (0,0)->(1,0)->(1,1)->(0,1) with u
        # right / v down in the IMAGE; rot = k means the observed grid
        # rotated k*90deg CCW-in-grid matches the table. The resulting
        # sample-corner permutation is pinned empirically by the rendered
        # round-trip tests (all four np.rot90 placements, subpixel corner
        # ground truth): tests/test_apriltags.py.
        c_out = corners[[(3 - rot) % 4, (2 - rot) % 4, (1 - rot) % 4, (0 - rot) % 4]]

        # homography in tag coords ([-1,1]^2, y up) -> pixels
        Ht = _h_from_unit_square(c_out[[0, 1, 2, 3]])
        # unit-square (0,0),(1,0),(1,1),(0,1) == tag (-1,-1),(1,-1),(1,1),(-1,1)
        S = np.array([[0.5, 0.0, 0.5], [0.0, 0.5, 0.5], [0.0, 0.0, 1.0]])
        Ht = Ht @ S

        dets.append(
            TagDetection(
                tag_id=tag_id,
                hamming=hamming,
                family=family.name,
                corners=c_out,
                center=_project(Hs, np.array([[0.5, 0.5]]))[0],
                H=Ht,
                code=observed,
            )
        )

    # duplicate suppression: same id, overlapping centers -> best hamming
    dets.sort(key=lambda d: d.hamming)
    kept: List[TagDetection] = []
    for d in dets:
        dup = any(
            d.tag_id == e.tag_id and np.linalg.norm(d.center - e.center) < 10
            for e in kept
        )
        if not dup:
            kept.append(d)
    return kept


# ---------------------------------------------------------------------------
# Metric pose
# ---------------------------------------------------------------------------


def tag_pose(
    detection: TagDetection,
    tag_size_m: float,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
) -> np.ndarray:
    """cam_T_tag (4, 4) from the detection homography.

    ``tag_size_m`` is the BLACK BORDER outer edge length. Tag frame: x
    right, y up, z out of the tag toward the camera; corners at
    (+-s/2, +-s/2, 0). Standard planar homography decomposition:
    K^-1 H = [r1 r2 t] up to scale; R re-orthonormalized by SVD.
    (Reference equivalent: TagDetection::getRelativeTransform.)
    """
    s = tag_size_m / 2.0
    Kinv = np.array([[1.0 / fx, 0, -cx / fx], [0, 1.0 / fy, -cy / fy], [0, 0, 1.0]])
    # H maps tag coords in [-1, 1]; rescale to metric tag plane
    Hm = detection.H @ np.diag([1.0 / s, 1.0 / s, 1.0])
    M = Kinv @ Hm
    scale = np.sqrt(np.linalg.norm(M[:, 0]) * np.linalg.norm(M[:, 1]))
    if scale <= 0:
        raise ValueError("degenerate homography")
    M = M / scale
    if M[2, 2] < 0:  # tag must be in front of the camera (+z)
        M = -M
    r1, r2, t = M[:, 0], M[:, 1], M[:, 2]
    R = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ np.diag([1.0, 1.0, float(np.linalg.det(u @ vt))]) @ vt
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def tag_corners_world(world_T_tag: np.ndarray, tag_size_m: float) -> np.ndarray:
    """(4, 3) world coordinates of a tag's black-border corners.

    Row order matches ``TagDetection.corners``: tag-frame (-1,-1), (+1,-1),
    (+1,+1), (-1,+1) scaled by half the border edge length.
    """
    s = tag_size_m / 2.0
    local = np.array(
        [[-s, -s, 0.0], [s, -s, 0.0], [s, s, 0.0], [-s, s, 0.0]]
    )
    return local @ world_T_tag[:3, :3].T + world_T_tag[:3, 3]


def estimate_camera_pose(
    detections: Sequence[TagDetection],
    world_T_tags: "dict[int, np.ndarray]",
    tag_size_m: float,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    sigma_px: float = 0.5,
    max_corners: int = 64,
    device="cuda",
):
    """Localize the camera from a map of known tag poses.

    All corners of every detected tag with a known ``world_T_tags`` entry
    become 3D->2D correspondences, refined jointly by the same Cauchy-robust
    LM pose solver the VIO odometry uses (vio/odometry.optimize_odometry) —
    initialized from the first tag's homography pose. This is the fiducial
    relocalization capability the reference's vendored AprilTags library was
    meant for but was never wired to (SURVEY §2.3).

    Returns ``(world_T_cam, result)`` or ``None`` if no detected tag is in
    the map. ``result.success`` is False when fewer than ``min_inliers``
    corner correspondences survive the outlier pass. Correspondence arrays
    are padded to ``max_corners`` so repeated calls share one CUDA graph for
    each corner count. The solve runs on ``device``, the card unless told
    otherwise (and it raises without one): the inputs go up in one pinned
    copy and the result comes back in one read-back, the call's one host
    sync, so ``world_T_cam`` (float64) and ``result`` are on the host.
    """
    from ..core.cameras import PinholeCamera, StereoCamera
    from ..ops.cuda import entry_device
    from ..vio.odometry import OdometryParams, OdometryResult, optimize_odometry
    from ..vio.stereo_frontend import to_device, to_host

    device = entry_device(device)
    known = [d for d in detections if d.tag_id in world_T_tags]
    if not known:
        return None
    P_w = np.concatenate(
        [tag_corners_world(world_T_tags[d.tag_id], tag_size_m) for d in known]
    )
    p_obs = np.concatenate([d.corners for d in known])
    n = min(P_w.shape[0], max_corners)
    # One (max_corners, 7) block [P | q | sigma | mask] of float32.
    rows = np.zeros((max_corners, 7), np.float32)
    rows[:n, 0:3], rows[:n, 3:5], rows[:n, 6] = P_w[:n], p_obs[:n], 1.0
    rows[:, 5] = sigma_px

    # Init: single-tag homography pose composed into cam_T_world.
    cam_T_tag = tag_pose(known[0], tag_size_m, fx, fy, cx, cy)
    T0 = cam_T_tag @ np.linalg.inv(world_T_tags[known[0].tag_id])

    cam = PinholeCamera.create(fx, fy, cx, cy)
    rig = StereoCamera.create(cam, cam, baseline=0.1)  # baseline unused here
    # min_inliers must scale with the tag count: with >=2 tags in view a
    # wrong-planar-branch solve that fits ONE tag perfectly can have the
    # outlier pass discard every other tag's corners — 4 surviving inliers
    # must then mean FAILURE, or the localizer's min_tags guard is
    # silently defeated (it checks tags *detected*, not tags *fit*).
    min_inl = 4 if len(known) == 1 else max(6, (3 * n) // 4)
    flat = to_device(np.concatenate([rows.reshape(-1), T0.astype(np.float32).reshape(-1)]),
                     device, torch.float32)
    rows_d, T0_d = flat[:-16].reshape(max_corners, 7), flat[-16:].reshape(4, 4)
    res = optimize_odometry(
        rows_d[:, 0:3], rows_d[:, 3:5], rows_d[:, 5], rows_d[:, 6], rig, T_init=T0_d,
        params=OdometryParams(min_inliers=min_inl),
    )
    out = to_host(torch.cat([res.T_10.reshape(-1), res.covariance.reshape(-1),
                             torch.stack([res.error, res.n_inliers.to(torch.float32),
                                          res.success.to(torch.float32)])]))
    res = OdometryResult(
        T_10=torch.from_numpy(out[:16].reshape(4, 4).copy()),
        covariance=torch.from_numpy(out[16:52].reshape(6, 6).copy()),
        error=torch.tensor(out[52]),
        n_inliers=torch.tensor(int(out[53]), dtype=torch.int32),
        success=torch.tensor(bool(out[54])),
    )
    world_T_cam = np.linalg.inv(out[:16].reshape(4, 4).astype(np.float64))
    return world_T_cam, res


# ---------------------------------------------------------------------------
# CLI: detect tags in an image file
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="AprilTag detector")
    ap.add_argument("image")
    ap.add_argument("--family", default="tag36h11")
    ap.add_argument("--max-hamming", type=int, default=1)
    args = ap.parse_args(argv)

    from ..utils.image_io import load_image

    img = load_image(args.image, grayscale=True)
    dets = detect_tags(
        img, args.family, TagDetectorParams(max_hamming=args.max_hamming)
    )
    for d in dets:
        print(
            f"id={d.tag_id} hamming={d.hamming} center=({d.center[0]:.1f},"
            f"{d.center[1]:.1f}) corners={d.corners.round(2).tolist()}"
        )
    print(f"{len(dets)} tag(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
