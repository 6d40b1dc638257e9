"""Fixed-capacity landmark track table (port of
``ocean_perception_tpu.tracking.tracks``).

K slots with validity given by the id (-1 = free slot). Each slot carries the
landmark id, its current pixel and disparity, its pixel and disparity at the
last keyframe, and bookkeeping ages (reference: StereoTracker's live_tracks_,
stereo_tracker.hpp:26-104). A table of B cameras has a leading (B,) axis on
every field.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

INVALID_ID = -1


class LandmarkObservation(NamedTuple):
    """One frame's observations for all slots."""

    lmk_ids: torch.Tensor      # (K,) int32, -1 = empty
    pixels: torch.Tensor       # (K, 2) float32 (x, y)
    disparities: torch.Tensor  # (K,) float32, -1 = no stereo match
    valid: torch.Tensor        # (K,) bool


@dataclasses.dataclass(frozen=True)
class TrackTable:
    ids: torch.Tensor             # ([B,] K) int32 landmark ids, -1 = free slot
    pixels: torch.Tensor          # (K, 2) current position
    disparities: torch.Tensor     # (K,) current disparity (-1 = none)
    kf_pixels: torch.Tensor       # (K, 2) position at last keyframe
    kf_disparities: torch.Tensor  # (K,) disparity at last keyframe
    ages: torch.Tensor            # (K,) int32 frames since created
    missed: torch.Tensor          # (K,) int32 consecutive frames not tracked

    @classmethod
    def create(cls, capacity: int, device=None, batch: int | None = None) -> "TrackTable":
        """An empty table; with ``batch``, one for each of B cameras."""
        lead = () if batch is None else (batch,)

        def full(shape, value, dtype):
            return torch.full(lead + shape, value, dtype=dtype, device=device)

        return cls(
            ids=full((capacity,), INVALID_ID, torch.int32),
            pixels=full((capacity, 2), 0.0, torch.float32),
            disparities=full((capacity,), -1.0, torch.float32),
            kf_pixels=full((capacity, 2), 0.0, torch.float32),
            kf_disparities=full((capacity,), -1.0, torch.float32),
            ages=full((capacity,), 0, torch.int32),
            missed=full((capacity,), 0, torch.int32),
        )

    def replace(self, **changes) -> "TrackTable":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TrackTable":
        return TrackTable(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]

    @property
    def alive(self) -> torch.Tensor:
        return self.ids >= 0

    def observation(self) -> LandmarkObservation:
        return LandmarkObservation(lmk_ids=self.ids, pixels=self.pixels,
                                   disparities=self.disparities, valid=self.alive)
