"""ObjectMesher: tracked landmarks -> obstacle meshes (port of
``ocean_perception_tpu.mesher.object_mesher``).

Reference: mesher/object_mesher.{hpp,cpp} ProcessStereo (:183-345):

1. StereoTracker::TrackAndTriangulate;
2. EstimateForegroundMask (morphological gradient at 1/4 scale);
3. landmark-graph evidence, gated by depth similarity
   (edge_max_depth_change) and by the foreground fraction along each 2-D
   edge (edge_min_foreground_percent), for pairs within neighbor_radius_px;
4. clusters = connected components of the thresholded subgraph;
5. per cluster of >= 3 members: Delaunay and back-projection (host side).

Steps 1-4 are :func:`mesher_device_step`, on the images' device; step 5 is
:func:`build_meshes`, on the host with scipy. The edge gate samples S points
along every pair's segment from the mask with one gather (the JAX package's
``edge_gate_impl="gather"`` form, equal to its one-hot form on every output).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.cameras import StereoCamera
from ..ops.cuda import entry_device
from ..ops.interp import bilinear_sample, gather_pixels
from ..tracking.stereo_tracker import (StereoTrackerParams, StereoTrackerState, device_scalar,
                                      track_and_triangulate)
from ..utils.profiling import annotate
from .foreground import estimate_foreground_mask
from .landmark_graph import LandmarkGraph, cluster_sizes, get_cluster_labels, update_graph
from .triangle_mesh import TriangleMesh


@dataclasses.dataclass(frozen=True)
class ObjectMesherDeviceParams:
    foreground_ksize: int = 15
    foreground_min_gradient: float = 20.0
    edge_min_foreground_percent: float = 0.9
    edge_max_depth_change: float = 1.0
    neighbor_radius_px: float = 80.0
    min_obs_connect_edge: float = 7.0
    min_obs_disconnect_edge: float = 4.0
    edge_samples: int = 16
    # Sample the gate from a 1/f box-averaged mask, nearest (1 = bilinear on
    # the full-resolution mask, the reference's behaviour).
    fg_downsample: int = 4
    tracker: StereoTrackerParams = StereoTrackerParams()


class MesherDeviceOutput(NamedTuple):
    labels: torch.Tensor       # ([B,] K) cluster label per slot (-1 dead)
    sizes: torch.Tensor        # ([B,] K) component size at root slots
    pixels: torch.Tensor       # ([B,] K, 2)
    disparities: torch.Tensor  # ([B,] K)
    alive: torch.Tensor        # ([B,] K)
    foreground: torch.Tensor   # ([B,] H, W) bool
    is_keyframe: torch.Tensor  # ([B,]) bool


def segment_fractions(S: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, S)`` in float32, bit for bit: arange(S) times the
    float32 step 1/(S-1), with the last value exactly 1 (``torch.linspace``
    differs from it in the last bit of some values)."""
    if S == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = float(np.float32(1.0 / (S - 1)))
    ts = torch.arange(S, dtype=torch.float32, device=device) * step
    return torch.cat([ts[:-1], torch.ones(1, dtype=torch.float32, device=device)])


def mesher_device_step(tracker_state: StereoTrackerState, graph: LandmarkGraph,
                       prev_left: torch.Tensor, cur_left: torch.Tensor, cur_right: torch.Tensor,
                       fx_baseline, params: ObjectMesherDeviceParams
                       ) -> Tuple[StereoTrackerState, LandmarkGraph, MesherDeviceOutput]:
    """Steps 1-4 of ProcessStereo, on the images' device, with no host sync.
    A batch of cameras: a batched state and graph and (B, H, W) images; the
    pairwise gates are (B, K, K), each camera's pairs its own."""
    dev = cur_left.device
    new_state, out = track_and_triangulate(tracker_state, prev_left, cur_left, cur_right,
                                           fx_baseline, params.tracker)
    with annotate("landmark_graph"):
        obs = out.observations
        fg = estimate_foreground_mask(cur_left, params.foreground_ksize,
                                      params.foreground_min_gradient)
        fxb = device_scalar(fx_baseline, torch.float32, dev)

        # Pairwise gates.
        alive = obs.valid & (obs.disparities > 0)
        pts = obs.pixels
        nb = pts.ndim - 2
        diff = pts[..., :, None, :] - pts[..., None, :, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        near = d2 <= params.neighbor_radius_px ** 2
        depth = fxb / obs.disparities.clamp_min(1e-3)
        depth_ok = (depth[..., :, None] - depth[..., None, :]).abs() <= params.edge_max_depth_change

        # Foreground fraction along each segment: S samples per pair.
        ts = segment_fractions(params.edge_samples, dev)[:, None]
        # (K, K, S, 2)
        seg = pts[..., :, None, None, :] * (1 - ts) + pts[..., None, :, None, :] * ts
        f = params.fg_downsample
        if f > 1:
            Hf, Wf = fg.shape[-2] // f, fg.shape[-1] // f
            fg_small = fg[..., : Hf * f, : Wf * f].float().reshape(*fg.shape[:-2], Hf, f, Wf, f)
            fg_small = fg_small.mean(dim=(-3, -1))
            fdiv = torch.full((), float(f), device=dev)
            yy = (seg[..., 1] / fdiv).int().clamp(0, Hf - 1).long()
            xx = (seg[..., 0] / fdiv).int().clamp(0, Wf - 1).long()
            fg_frac = gather_pixels(fg_small, yy, xx, nb).mean(dim=-1)
        else:
            fg_frac = bilinear_sample(fg.float(), seg[..., 1], seg[..., 0], nb).mean(dim=-1)
        fg_ok = fg_frac >= params.edge_min_foreground_percent

        pair_valid = near & alive[..., :, None] & alive[..., None, :]
        max_weight = params.min_obs_connect_edge + params.min_obs_disconnect_edge
        graph = update_graph(graph, obs.lmk_ids, depth_ok & fg_ok, pair_valid, max_weight)
        labels = get_cluster_labels(graph, alive, params.min_obs_connect_edge)
        return new_state, graph, MesherDeviceOutput(
            labels=labels, sizes=cluster_sizes(labels), pixels=pts, disparities=obs.disparities,
            alive=alive, foreground=fg, is_keyframe=out.is_keyframe)


@dataclasses.dataclass
class ObjectMesherParams:
    device: ObjectMesherDeviceParams = dataclasses.field(default_factory=ObjectMesherDeviceParams)
    vertex_min_obs: int = 3          # min cluster size to mesh
    disparity_scale: float = 1.0     # if the mesher ran on downscaled images


class ObjectMesher:
    """Host wrapper: the device step, then per-cluster Delaunay and
    back-projection, for one camera. Runs on ``device``: the card by
    default, where it raises without one; CPU callers pass
    ``device="cpu"``."""

    def __init__(self, params: ObjectMesherParams, rig: StereoCamera,
                 device: torch.device | str = "cuda"):
        self.params = params
        self.rig = rig
        self.device = entry_device(device)
        capacity = params.device.tracker.capacity
        self.tracker_state = StereoTrackerState.create(params.device.tracker, device=self.device)
        self.graph = LandmarkGraph.create(capacity, device=self.device)
        self._prev_left: Optional[torch.Tensor] = None
        fxb = np.float32(rig.fx) * np.float32(rig.baseline)
        self._fxb = torch.full((), float(fxb), dtype=torch.float32, device=self.device)

    def process_stereo(self, left, right) -> TriangleMesh:
        left = torch.as_tensor(left, dtype=torch.float32).to(self.device)
        right = torch.as_tensor(right, dtype=torch.float32).to(self.device)
        prev = self._prev_left if self._prev_left is not None else left
        self.tracker_state, self.graph, out = mesher_device_step(
            self.tracker_state, self.graph, prev, left, right, self._fxb, self.params.device)
        self._prev_left = left
        return build_meshes(out, self.rig, self.params.disparity_scale, self.params.vertex_min_obs)


def build_meshes(out: MesherDeviceOutput, rig: StereoCamera, disparity_scale: float = 1.0,
                 vertex_min_obs: int = 3) -> TriangleMesh:
    """Step 5 of ProcessStereo on the host: per-cluster Delaunay and
    back-projection through each vertex's disparity, for one camera (a
    fleet caller passes camera b's slice of each output)."""
    from scipy.spatial import Delaunay, QhullError

    labels = out.labels.cpu().numpy()
    pixels = out.pixels.cpu().numpy()
    disps = out.disparities.cpu().numpy() * np.float32(disparity_scale)
    alive = out.alive.cpu().numpy()
    fxb = np.float32(rig.fx) * np.float32(rig.baseline)

    meshes: List[TriangleMesh] = []
    for root in np.unique(labels[labels >= 0]):
        members = np.where((labels == root) & alive)[0]
        if len(members) < max(3, vertex_min_obs):
            continue
        pts2d = pixels[members]
        try:
            tri = Delaunay(pts2d)
        except QhullError:
            continue
        depth = fxb / np.maximum(disps[members], np.float32(1e-3))
        verts = rig.left.backproject(torch.from_numpy(pts2d), torch.from_numpy(depth)).numpy()
        meshes.append(TriangleMesh(verts, tri.simplices.astype(np.int32)))
    return TriangleMesh.merge(meshes)
