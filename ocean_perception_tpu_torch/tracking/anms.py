"""Adaptive non-maximal suppression (host-side exact variant)
(a copy of ``ocean_perception_tpu.tracking.anms``).

Reference parity: src/external/anms (RangeTree ANMS used by
FeatureDetector). The device detector uses grid-bucketed top-K (same spatial
spread intent, parallel); this module provides the exact adaptive-radius
selection via binary search on the suppression radius with grid hashing —
"Suppression via Square Covering" (Bailo et al.), numerically equivalent in
output spirit to the reference's RangeTree search. Host numpy; used by tools
that want exactly-n spatially-even features.
"""

from __future__ import annotations

import numpy as np


def ssc_anms(
    points: np.ndarray,     # (N, 2) sorted by response (best first)
    num_ret: int,
    rows: int,
    cols: int,
    tolerance: float = 0.1,
    max_iters: int = 30,
) -> np.ndarray:
    """Indices of ~num_ret spatially-even points (best-response preferred)."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n <= num_ret:
        return np.arange(n)

    # Binary search bounds on the suppression radius (SSC closed form).
    exp1 = rows + cols + 2 * num_ret
    exp2 = (
        4 * cols + 4 * num_ret + 4 * rows * num_ret + rows * rows + cols * cols
        - 2 * rows * cols + 4 * rows * cols * num_ret
    )
    exp3 = np.sqrt(max(exp2, 0))
    exp4 = num_ret - 1
    sol1 = -round((exp1 + exp3) / exp4) if exp4 else 1
    sol2 = -round((exp1 - exp3) / exp4) if exp4 else 1
    high = max(sol1, sol2, 1)
    low = np.floor(np.sqrt(n / max(num_ret, 1)))

    k_min = round(num_ret - (num_ret * tolerance))
    k_max = round(num_ret + (num_ret * tolerance))

    best: np.ndarray = np.arange(min(n, num_ret))
    prev_width = -1.0
    while True:
        width = low + (high - low) / 2.0
        if width == prev_width or low > high:
            break
        prev_width = width
        c = max(width / 2.0, 1.0)
        num_cell_cols = int(cols / c) + 1
        num_cell_rows = int(rows / c) + 1
        covered = np.zeros((num_cell_rows + 1, num_cell_cols + 1), bool)
        kept = []
        for i in range(n):
            row = int(pts[i, 1] / c)
            col = int(pts[i, 0] / c)
            if covered[row, col]:
                continue
            kept.append(i)
            r0 = max(0, row - 2)
            r1 = min(num_cell_rows, row + 2)
            c0 = max(0, col - 2)
            c1 = min(num_cell_cols, col + 2)
            covered[r0 : r1 + 1, c0 : c1 + 1] = True
        if k_min <= len(kept) <= k_max:
            return np.asarray(kept[:num_ret])
        if len(kept) < k_min:
            high = width - 1
        else:
            low = width + 1
            best = np.asarray(kept)
    return best[:num_ret]
