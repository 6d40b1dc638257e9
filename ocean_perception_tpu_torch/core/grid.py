"""2D spatial hash grid (reference: core/grid_lookup.hpp:13-77).

Host-side nearest-neighbor helper: map points to grid cells, query ROIs.
The device-side mesher uses dense pairwise distances instead (faster at
K~200 on the device); this class serves host tools and parity tests.

A copy of ``ocean_perception_tpu.core.grid``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class GridLookup:
    def __init__(self, rows: int, cols: int):
        self.rows = rows
        self.cols = cols
        self._cells: Dict[Tuple[int, int], List[int]] = defaultdict(list)

    def clear(self) -> None:
        self._cells.clear()

    def insert(self, cell: Tuple[int, int], value: int) -> None:
        r, c = cell
        assert 0 <= r < self.rows and 0 <= c < self.cols
        self._cells[(r, c)].append(value)

    def get_cell(self, cell: Tuple[int, int]) -> List[int]:
        return self._cells.get(tuple(cell), [])

    def get_roi(self, min_cell: Tuple[int, int], max_cell: Tuple[int, int]) -> List[int]:
        """All values in cells [min, max] inclusive, clipped to bounds."""
        r0 = max(0, min_cell[0])
        c0 = max(0, min_cell[1])
        r1 = min(self.rows - 1, max_cell[0])
        c1 = min(self.cols - 1, max_cell[1])
        out: List[int] = []
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                out.extend(self._cells.get((r, c), []))
        return out


def map_to_grid_cells(
    points: np.ndarray, image_rows: int, image_cols: int, grid_rows: int, grid_cols: int
) -> np.ndarray:
    """Pixel coords → (row, col) grid cells (mesher/neighbor_grid parity)."""
    pts = np.asarray(points)
    r = np.clip((pts[:, 1] / image_rows * grid_rows).astype(int), 0, grid_rows - 1)
    c = np.clip((pts[:, 0] / image_cols * grid_cols).astype(int), 0, grid_cols - 1)
    return np.stack([r, c], axis=-1)


def populate_grid(cells: np.ndarray, grid: GridLookup) -> None:
    for i, cell in enumerate(np.asarray(cells)):
        grid.insert((int(cell[0]), int(cell[1])), i)
