"""RRT* path planner skeleton (a copy of ``ocean_perception_tpu.planning.rrt``).

Reference parity: src/vehicle/rrt (nanoflann kd-tree RRT*, labeled abandoned
in the reference README:54). This is a compact working numpy implementation:
sample → nearest → steer → collision check → choose parent in radius →
rewire. Collision checking is a caller-supplied callable (e.g. against the
mesher's obstacle meshes).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class RrtParams:
    max_iters: int = 2000
    step_size: float = 0.5
    goal_tolerance: float = 0.5
    rewire_radius: float = 1.5
    goal_bias: float = 0.1


class RrtStar:
    def __init__(
        self,
        bounds_min: np.ndarray,
        bounds_max: np.ndarray,
        is_free: Callable[[np.ndarray, np.ndarray], bool],
        params: RrtParams = RrtParams(),
        seed: int = 0,
    ):
        self.lo = np.asarray(bounds_min, float)
        self.hi = np.asarray(bounds_max, float)
        self.is_free = is_free  # is_free(a, b): segment a->b collision free
        self.p = params
        self.rng = np.random.default_rng(seed)

    def plan(self, start: np.ndarray, goal: np.ndarray) -> Optional[np.ndarray]:
        start = np.asarray(start, float)
        goal = np.asarray(goal, float)
        nodes = [start]
        parents = [-1]
        costs = [0.0]
        best_goal_node = -1
        best_goal_cost = np.inf

        for _ in range(self.p.max_iters):
            target = goal if self.rng.random() < self.p.goal_bias else self.rng.uniform(self.lo, self.hi)
            pts = np.asarray(nodes)
            d = np.linalg.norm(pts - target, axis=1)
            i_near = int(np.argmin(d))
            direction = target - nodes[i_near]
            dist = np.linalg.norm(direction)
            if dist < 1e-9:
                continue
            new = nodes[i_near] + direction / dist * min(self.p.step_size, dist)
            if not self.is_free(nodes[i_near], new):
                continue
            # Choose best parent within the rewire radius.
            dn = np.linalg.norm(pts - new, axis=1)
            near_idx = np.where(dn <= self.p.rewire_radius)[0]
            best_parent = i_near
            best_cost = costs[i_near] + np.linalg.norm(new - nodes[i_near])
            for j in near_idx:
                c = costs[j] + np.linalg.norm(new - nodes[j])
                if c < best_cost and self.is_free(nodes[j], new):
                    best_parent, best_cost = int(j), c
            nodes.append(new)
            parents.append(best_parent)
            costs.append(best_cost)
            i_new = len(nodes) - 1
            # Rewire neighbors through the new node.
            for j in near_idx:
                c = best_cost + np.linalg.norm(new - nodes[j])
                if c < costs[j] and self.is_free(new, nodes[j]):
                    parents[j] = i_new
                    costs[j] = c
            # Goal check.
            gd = np.linalg.norm(new - goal)
            if gd <= self.p.goal_tolerance and self.is_free(new, goal):
                total = best_cost + gd
                if total < best_goal_cost:
                    best_goal_cost = total
                    best_goal_node = i_new

        if best_goal_node < 0:
            return None
        path: List[np.ndarray] = [goal]
        i = best_goal_node
        while i >= 0:
            path.append(nodes[i])
            i = parents[i]
        return np.asarray(path[::-1])
