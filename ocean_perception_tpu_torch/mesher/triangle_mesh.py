"""Triangle mesh container (reference: mesher/triangle_mesh.hpp:14-26)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """Host-side obstacle mesh: 3D vertices and triangle index triples."""

    vertices: np.ndarray   # (V, 3) float, camera frame
    triangles: np.ndarray  # (T, 3) int indices into vertices
    cluster_ids: np.ndarray | None = None  # (T,) source cluster per triangle

    @classmethod
    def empty(cls) -> "TriangleMesh":
        return cls(np.zeros((0, 3)), np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    @staticmethod
    def merge(meshes: List["TriangleMesh"]) -> "TriangleMesh":
        if not meshes:
            return TriangleMesh.empty()
        verts, tris, cids = [], [], []
        offset = 0
        for i, m in enumerate(meshes):
            verts.append(m.vertices)
            tris.append(m.triangles + offset)
            cids.append(np.full(len(m.triangles), i, np.int32))
            offset += len(m.vertices)
        return TriangleMesh(np.concatenate(verts), np.concatenate(tris), np.concatenate(cids))
