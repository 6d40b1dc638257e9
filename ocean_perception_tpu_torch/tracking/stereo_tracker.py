"""StereoTracker: the front end's state machine as one function of tensors
(port of ``ocean_perception_tpu.tracking.stereo_tracker``).

Reference: ft/StereoTracker::TrackAndTriangulate (stereo_tracker.cpp:31-199):

1. re-track live landmarks with pyramidal LK (bidirectional check);
2. keyframe = forced, or fewer than trigger_keyframe_min_lmks tracked, or
   trigger_keyframe_k frames since the last keyframe;
3. on keyframes, detect new features masked around live tracks;
4. stereo-match every live landmark along its epipolar stripe;
5. depth-gate the disparities and kill landmarks missed for more than
   retrack_frames_k frames.

Detection and matching always run and are masked in on keyframes, so the
step takes no branch on a device value and needs no host sync. With a
pyramid ring (``StereoTrackerState.create(..., image_shape=...)``) each
landmark is re-tracked from the frame it was last seen in (k-ago
re-tracking, stereo_tracker.cpp:33-88).

A batch of B cameras (the counterpart of ``jax.vmap`` of the JAX step):
a state with a leading (B,) axis on every field, (B, H, W) images; every
decision, rank and count is taken per camera.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.image import image_pyramid
from ..utils.profiling import annotate
from .detector import DetectorParams, detect_features
from .lk import LKParams, track_points, track_points_ring
from .stripe_match import StripeMatcherParams, match_rectified
from .tracks import LandmarkObservation, TrackTable


@dataclasses.dataclass(frozen=True)
class StereoTrackerParams:
    capacity: int = 200
    retrack_frames_k: int = 3
    trigger_keyframe_min_lmks: int = 10
    trigger_keyframe_k: int = 5
    stereo_max_depth: float = 20.0
    stereo_min_depth: float = 0.2
    detector: DetectorParams = DetectorParams()
    lk: LKParams = LKParams()
    matcher: StripeMatcherParams = StripeMatcherParams()


@dataclasses.dataclass(frozen=True)
class StereoTrackerState:
    table: TrackTable
    frame_idx: torch.Tensor      # int32 scalar, ([B,])
    last_kf_frame: torch.Tensor  # int32 scalar
    next_lmk_id: torch.Tensor    # int32 scalar
    # Past-frame pyramid ring: one ([B,] retrack_frames_k + 1, Hl, Wl) tensor
    # per level, slot 0 = the newest past frame. None = track from prev_left.
    ring: Optional[Tuple[torch.Tensor, ...]] = None

    @classmethod
    def create(cls, params: StereoTrackerParams, image_shape: Optional[Tuple[int, int]] = None,
               device=None, batch: Optional[int] = None) -> "StereoTrackerState":
        """The initial state; with ``batch``, one for each of B cameras."""
        lead = () if batch is None else (batch,)
        ring = None
        if image_shape is not None:
            h, w = image_shape
            levels = []
            for _ in range(params.lk.max_level + 1):
                levels.append(torch.zeros(lead + (params.retrack_frames_k + 1, h, w),
                                          dtype=torch.float32, device=device))
                h, w = (h + 1) // 2, (w + 1) // 2
            ring = tuple(levels)

        def scalar(v):
            return torch.full(lead, v, dtype=torch.int32, device=device)

        return cls(table=TrackTable.create(params.capacity, device=device, batch=batch),
                   frame_idx=scalar(0), last_kf_frame=scalar(-(10 ** 6)), next_lmk_id=scalar(0),
                   ring=ring)

    def replace(self, **changes) -> "StereoTrackerState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "StereoTrackerState":
        return StereoTrackerState(
            table=self.table.to(device), frame_idx=self.frame_idx.to(device),
            last_kf_frame=self.last_kf_frame.to(device), next_lmk_id=self.next_lmk_id.to(device),
            ring=None if self.ring is None else tuple(l.to(device) for l in self.ring))


class TrackerOutput(NamedTuple):
    observations: LandmarkObservation
    is_keyframe: torch.Tensor  # bool scalar, ([B,])
    n_tracked: torch.Tensor    # landmarks tracked this frame, ([B,])


def device_scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim tensor on ``device``; a Python value is filled in place there
    (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _per_camera(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-camera mask ([B,]) shaped to broadcast against a field
    ([B,] K, ...) camera by camera."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - mask.ndim))


def _fill_free_slots(table: TrackTable, det_pts: torch.Tensor, det_valid: torch.Tensor,
                     next_id: torch.Tensor) -> Tuple[TrackTable, torch.Tensor]:
    """Give the valid detections, in order, the free slots, in slot order,
    camera by camera."""
    K = table.capacity
    alive = table.alive
    free_order = torch.argsort(alive.int(), dim=-1, stable=True)  # free slots first
    n_free = K - alive.sum(dim=-1, keepdim=True)
    det_rank = torch.cumsum(det_valid.int(), -1) - 1          # rank among valid detections
    take = det_valid & (det_rank < n_free)
    # Detections that find no slot go to a spare slot K, dropped afterwards.
    target = torch.where(take, free_order.gather(-1, det_rank.clamp(0, K - 1).long()), K)
    slot_dim = target.ndim - 1

    def scatter(field: torch.Tensor, values) -> torch.Tensor:
        out = torch.cat([field, field.narrow(slot_dim, 0, 1)], dim=slot_dim)
        index = target.reshape(target.shape + (1,) * (field.ndim - target.ndim))
        index = index.expand(*target.shape, *field.shape[slot_dim + 1:])
        # A Python value goes to the kernel as an argument: no copy to the device.
        out.scatter_(slot_dim, index, values)
        return out.narrow(slot_dim, 0, K)

    new_ids = (next_id[..., None] + det_rank).int()
    table = table.replace(
        ids=scatter(table.ids, torch.where(take, new_ids, 0).int()),
        pixels=scatter(table.pixels, det_pts),
        kf_pixels=scatter(table.kf_pixels, det_pts),
        ages=scatter(table.ages, 0),
        missed=scatter(table.missed, 0),
        disparities=scatter(table.disparities, -1.0),
        kf_disparities=scatter(table.kf_disparities, -1.0),
    )
    return table, next_id + take.sum(dim=-1, dtype=torch.int32)


def track_and_triangulate(state: StereoTrackerState, prev_left: torch.Tensor,
                          cur_left: torch.Tensor, cur_right: torch.Tensor,
                          rig_fx_baseline, params: StereoTrackerParams,
                          force_keyframe=False) -> Tuple[StereoTrackerState, TrackerOutput]:
    """One front-end step, on the images' device. ``rig_fx_baseline`` is
    fx * baseline (a float or a scalar tensor), for the depth gate. A batch:
    a batched state and (B, H, W) images."""
    dev = cur_left.device
    table = state.table
    alive = table.alive

    # 1. Re-track live landmarks: from their last-seen frame (ring slot =
    # missed count) with a ring, else from the previous frame.
    with annotate("lk"):
        if state.ring is not None:
            cur_pyr = tuple(image_pyramid(cur_left, params.lk.max_level + 1))
            flow = track_points_ring(state.ring, cur_pyr, table.pixels, alive, table.missed,
                                     params.lk)
        else:
            flow = track_points(prev_left, cur_left, table.pixels, alive, params.lk)
    with annotate("tracker"):
        tracked = flow.status & alive
        missed = torch.where(tracked, 0, table.missed + 1).int()
        keep = alive & (missed <= params.retrack_frames_k)       # KillOffLostLandmarks
        table = table.replace(
            ids=torch.where(keep, table.ids, -1).int(),
            pixels=torch.where(tracked[..., None], flow.points, table.pixels),
            missed=torch.where(keep, missed, 0).int(),
            ages=torch.where(keep, table.ages + 1, 0).int(),
        )
        n_tracked = (tracked & keep).sum(dim=-1, dtype=torch.int32)

        # 2. Keyframe decision, a tensor: no branch on a device value.
        is_kf = (device_scalar(force_keyframe, torch.bool, dev)
                 | (n_tracked < params.trigger_keyframe_min_lmks)
                 | (state.frame_idx - state.last_kf_frame >= params.trigger_keyframe_k))

        # 3. New features, kept only on keyframes.
        det = detect_features(cur_left, params.detector, table.pixels, table.alive)
        kf_table, kf_next_id = _fill_free_slots(table, det.points, det.valid, state.next_lmk_id)
        table = TrackTable(**{
            f.name: torch.where(_per_camera(is_kf, getattr(table, f.name)),
                                getattr(kf_table, f.name), getattr(table, f.name))
            for f in dataclasses.fields(TrackTable)})
        next_id = torch.where(is_kf, kf_next_id, state.next_lmk_id)

        # 4. Stereo-match every live landmark; depth gate (stereo_tracker.cpp:115-118).
        matches = match_rectified(cur_left, cur_right, table.pixels, table.alive, params.matcher)
        fxb = device_scalar(rig_fx_baseline, torch.float32, dev)
        min_disp = fxb / torch.full_like(fxb, params.stereo_max_depth)
        max_disp = fxb / torch.full_like(fxb, params.stereo_min_depth)
        disp_ok = (matches.disparity > min_disp) & (matches.disparity < max_disp)
        disparities = torch.where(disp_ok, matches.disparity, -1.0)

        # 5. Keyframe snapshot for the VO correspondences.
        table = table.replace(
            disparities=disparities,
            kf_pixels=torch.where(_per_camera(is_kf, table.pixels), table.pixels,
                                  table.kf_pixels),
            kf_disparities=torch.where(_per_camera(is_kf, disparities), disparities,
                                       table.kf_disparities),
        )

        # The current frame becomes ring slot 0 for the next step.
        new_ring = state.ring
        if state.ring is not None:
            nb = cur_left.ndim - 2
            new_ring = tuple(torch.cat([cur.unsqueeze(nb),
                                        lvl.narrow(nb, 0, lvl.shape[nb] - 1)], dim=nb)
                             for cur, lvl in zip(cur_pyr, state.ring))

        new_state = StereoTrackerState(
            table=table,
            frame_idx=state.frame_idx + 1,
            last_kf_frame=torch.where(is_kf, state.frame_idx, state.last_kf_frame),
            next_lmk_id=next_id.int(),
            ring=new_ring,
        )
        return new_state, TrackerOutput(observations=table.observation(), is_keyframe=is_kf,
                                        n_tracked=n_tracked)
