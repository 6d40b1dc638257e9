"""The general traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the seed in, the inputs of a run out, made on the run's device.

A mix names its ``kind``; each kind is one function below. The same seed
gives the same inputs; another seed gives other content of the same sizes
and the same arrivals, so seeds change what the program sees, not how much
work it has.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _box_smooth(x: torch.Tensor, k: int) -> torch.Tensor:
    """A k-tap box filter along each image axis with zeros beyond the edge
    (numpy's ``convolve(..., "same")``), on (N, H, W)."""
    w = torch.full((1, 1, 1, k), 1.0 / k, device=x.device)
    y = F.conv2d(x[:, None], w, padding=(0, k // 2))
    y = F.conv2d(y, w.transpose(-1, -2), padding=(k // 2, 0))
    return y[:, 0]


class StereoPan:
    """Rectified uint8 mono stereo pairs of ``cameras`` cameras, each its own
    textured plane at ``true_disparity`` px, panning ``pan_px`` px a frame
    and reversing every ``reverse_every`` frames, so frame i lies at one of
    ``reverse_every + 1`` positions and a tracker never sees a jump.

    Frame i of camera b: left(y, x) = canvas_b(y, x + x0(i)) and
    right(y, x - d) = left(y, x), d the true disparity. The canvases are box
    smoothed uniform noise, scaled to [lo, hi] and quantized to uint8. The
    frames of every position are made once (the pool), so a frame is handed
    over as one contiguous copy."""

    def __init__(self, mix: dict, seed: int, height: int, width: int, device):
        self.cameras = int(mix["cameras"])
        self.d = int(mix["true_disparity"])
        self.pan = int(mix["pan_px"])
        self.period = int(mix["reverse_every"])
        self.height, self.width = int(height), int(width)
        span = self.pan * self.period + self.d
        noise = torch.rand((self.cameras, self.height, self.width + span), device=device,
                           generator=generator(seed, device))
        k = int(mix["texture_box"])
        tex = _box_smooth(noise, k) if k > 1 else noise
        lo, hi = float(mix["level_lo"]), float(mix["level_hi"])
        canvas = ((tex * (hi - lo) + lo).clamp(0, 1) * 255).to(torch.uint8)
        x = [self.pan * p for p in range(self.period + 1)]
        self.left = torch.stack([canvas[:, :, a: a + self.width] for a in x])
        self.right = torch.stack([canvas[:, :, a + self.d: a + self.d + self.width] for a in x])

    def position(self, i: int) -> int:
        """Frame i's position in the pool (0 .. reverse_every)."""
        k = i % (2 * self.period)
        return k if k <= self.period else 2 * self.period - k

    def frames(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Frame i of every camera: (cameras, H, W) uint8 left and right views."""
        p = self.position(i)
        return self.left[p], self.right[p]


KINDS = {"stereo_pan": StereoPan}


def make(mix: dict, seed: int, device, **sizes):
    """The inputs of a run of the mix ``mix`` from ``seed``."""
    kind = mix.get("kind")
    if kind not in KINDS:
        raise KeyError(f"unknown traffic kind {kind!r} (known: {', '.join(KINDS)})")
    return KINDS[kind](mix, seed, device=device, **sizes)
