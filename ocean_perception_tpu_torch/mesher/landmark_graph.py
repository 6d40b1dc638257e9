"""Evidence-weighted landmark graph with connected-component clustering
(port of ``ocean_perception_tpu.mesher.landmark_graph``).

Reference: mesher/landmark_graph.{hpp,cpp}. Edges gain +1 evidence when
observed and lose 1 when not, clamped to [0, connect + disconnect]; an edge
joins the active subgraph at min_obs_connect_edge, and clusters are its
connected components. The graph is a dense (K, K) matrix keyed by tracker
slot; components come from min-label propagation with pointer jumping. A
graph of B cameras is (B, K, K), each camera's components its own.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class LandmarkGraph:
    weights: torch.Tensor  # ([B,] K, K) symmetric evidence
    ids: torch.Tensor      # ([B,] K) int32 landmark id owning each slot (-1 free)

    @classmethod
    def create(cls, capacity: int, device=None, batch: int | None = None) -> "LandmarkGraph":
        """An empty graph; with ``batch``, one for each of B cameras."""
        lead = () if batch is None else (batch,)
        return cls(weights=torch.zeros(lead + (capacity, capacity), dtype=torch.float32,
                                       device=device),
                   ids=torch.full(lead + (capacity,), -1, dtype=torch.int32, device=device))

    def to(self, device) -> "LandmarkGraph":
        return LandmarkGraph(weights=self.weights.to(device), ids=self.ids.to(device))


def update_graph(graph: LandmarkGraph, slot_ids: torch.Tensor, observed: torch.Tensor,
                 pair_valid: torch.Tensor, max_weight: float) -> LandmarkGraph:
    """UpdateEdge (+1 observed, -1 not, clamped). A slot whose landmark id
    changed since the last frame loses its old edges."""
    changed = graph.ids != slot_ids
    w = torch.where(changed[..., :, None] | changed[..., None, :], 0.0, graph.weights)
    delta = torch.where(observed, 1.0, -1.0) * pair_valid.float()
    w = (w + delta).clamp(0.0, max_weight)
    w = w.masked_fill(torch.eye(w.shape[-1], dtype=torch.bool, device=w.device), 0.0)
    return LandmarkGraph(weights=w, ids=slot_ids)


def get_cluster_labels(graph: LandmarkGraph, alive: torch.Tensor, min_subgraph_weight: float,
                       iters: int | None = None) -> torch.Tensor:
    """([B,] K) component label per slot (its smallest slot index); -1 if dead."""
    K = graph.weights.shape[-1]
    dev = graph.weights.device
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    adj = ((graph.weights >= min_subgraph_weight) & alive[..., :, None]
           & alive[..., None, :]) | eye
    labels = torch.where(alive, torch.arange(K, dtype=torch.int32, device=dev), K).int()
    # Neighbour-min plus pointer jumping: O(log K) steps even for chains.
    n_iters = iters if iters is not None else max(4, int(math.ceil(math.log2(max(K, 2)))) + 2)
    for _ in range(n_iters):
        neigh = torch.where(adj, labels[..., None, :], K)
        labels = torch.minimum(labels, neigh.amin(dim=-1)).int()
        jumped = torch.where(labels < K, labels.gather(-1, labels.clamp(0, K - 1).long()),
                             labels)
        labels = torch.minimum(labels, jumped).int()
    return torch.where(alive, labels, -1).int()


def cluster_sizes(labels: torch.Tensor) -> torch.Tensor:
    """([B,] K) number of members of the component rooted at each slot."""
    K = labels.shape[-1]
    ar = torch.arange(K, dtype=labels.dtype, device=labels.device)
    return (labels[..., None, :] == ar[:, None]).sum(dim=-1, dtype=torch.int32)
