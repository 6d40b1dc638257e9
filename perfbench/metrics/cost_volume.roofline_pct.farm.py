"""cost_volume.roofline_pct.farm: the cost volume kernel (``stereo/cost.py``
-> ``csrc/cost_volume.cu``) against its roofline at the fleet call's shapes.

Bytes: the four float32 images (two grays and their gradient magnitudes,
B cameras at 1/internal_scale) read once and the (B, h, w, D) bfloat16
volume written once; its device time is the mean over the profiled calls."""

import re

from perfbench.harness.peaks import bound_us, kernel_us

KERNEL = re.compile(r"cost_volume_kernel")


def volume_bytes(B: int, h: int, w: int, D: int, element: int = 2) -> int:
    return 4 * B * h * w * 4 + B * h * w * D * element


def read(rec):
    s = rec.stretch
    if s is None:
        return None
    v = rec.values
    scale = int(v["internal_scale"])
    h, w = -(-int(v["height"]) // scale), -(-int(v["width"]) // scale)
    D = int(v["max_disp"]) // scale
    times = kernel_us([s.kernels_in(u) for u in s.units], KERNEL)
    if not times or min(times) <= 0:
        return None
    device_us = sum(times) / len(times)
    return 100.0 * bound_us(volume_bytes(rec.data["cameras"], h, w, D)) / device_us
