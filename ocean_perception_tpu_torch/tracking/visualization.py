"""2D front-end visualization (reference: ft/visualization_2d.{hpp,cpp})
(a copy of ``ocean_perception_tpu.tracking.visualization``).

Draws detected features, optical-flow tracks, and stereo matches onto images
for debugging. Host-side numpy/cv2 (output images are saved or published;
headless environments have no display).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_bgr_u8(image: np.ndarray) -> np.ndarray:
    img = np.clip(np.asarray(image), 0, 1)
    u8 = (img * 255).astype(np.uint8)
    if u8.ndim == 2:
        u8 = np.stack([u8] * 3, axis=-1)
    return np.ascontiguousarray(u8)


def draw_features(image: np.ndarray, points: np.ndarray, valid: Optional[np.ndarray] = None,
                  color=(0, 255, 0)) -> np.ndarray:
    import cv2

    out = _to_bgr_u8(image)
    pts = np.asarray(points)
    v = np.ones(len(pts), bool) if valid is None else np.asarray(valid)
    for (x, y), ok in zip(pts, v):
        if ok:
            cv2.circle(out, (int(round(x)), int(round(y))), 3, color, 1, cv2.LINE_AA)
    return out


def draw_tracks(image: np.ndarray, prev_points: np.ndarray, cur_points: np.ndarray,
                valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Flow vectors prev→cur (DrawFeatureTracks parity)."""
    import cv2

    out = _to_bgr_u8(image)
    v = np.ones(len(cur_points), bool) if valid is None else np.asarray(valid)
    for (x0, y0), (x1, y1), ok in zip(np.asarray(prev_points), np.asarray(cur_points), v):
        if not ok:
            continue
        p0 = (int(round(x0)), int(round(y0)))
        p1 = (int(round(x1)), int(round(y1)))
        cv2.line(out, p0, p1, (255, 0, 0), 1, cv2.LINE_AA)
        cv2.circle(out, p1, 3, (0, 255, 0), 1, cv2.LINE_AA)
    return out


def draw_stereo_matches(left: np.ndarray, right: np.ndarray, points: np.ndarray,
                        disparities: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Side-by-side pair with match lines (DrawStereoMatches parity)."""
    import cv2

    l = _to_bgr_u8(left)
    r = _to_bgr_u8(right)
    H, W = l.shape[:2]
    out = np.concatenate([l, r], axis=1)
    v = np.ones(len(points), bool) if valid is None else np.asarray(valid)
    for (x, y), d, ok in zip(np.asarray(points), np.asarray(disparities), v):
        if not ok or d < 0:
            continue
        p0 = (int(round(x)), int(round(y)))
        p1 = (int(round(x - d)) + W, int(round(y)))
        cv2.circle(out, p0, 3, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.circle(out, p1, 3, (0, 255, 255), 1, cv2.LINE_AA)
        cv2.line(out, p0, p1, (200, 120, 0), 1, cv2.LINE_AA)
    return out


def colorize_disparity(disp: np.ndarray, max_disp: Optional[float] = None) -> np.ndarray:
    """Disparity → turbo-colormapped BGR image (color_mapping.hpp parity)."""
    import cv2

    d = np.asarray(disp, np.float32)
    md = float(max_disp) if max_disp else max(float(d.max()), 1e-6)
    norm = np.clip(d / md, 0, 1)
    u8 = (norm * 255).astype(np.uint8)
    out = cv2.applyColorMap(u8, cv2.COLORMAP_TURBO)
    out[d <= 0] = 0
    return out
