#!/usr/bin/env python
"""Where a sharded frame's time goes, on one GPU: ``sharded_patchmatch``
and ``sharded_perception_step`` at 720p (internal 360x640, D=64, bf16) with
N blocks, every mesh entry ``cuda:0``, beside the one-device match and step
with ``chunks_y = N``.

For each call: the wall time of one call ending in a synchronize (median
of 5, after 2 warm-ups), and one call under ``torch.profiler``: the sum of
its kernels' device time, the busy share of the call's wall time, its
kernel launches, the kernels by device time, the blocks' named regions by
their span on the device (first kernel to last, waits included), and the
host operations by self CPU time (CUDA runtime calls included: a
``cudaMalloc`` or a synchronize shows there).

    python shard_profile.py [--blocks 2 4] [--top 8]
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import pyr_down, to_grayscale
from ocean_perception_tpu_torch.parallel.mesh import make_mesh
from ocean_perception_tpu_torch.parallel.sharded_pipeline import sharded_perception_step
from ocean_perception_tpu_torch.parallel.stereo_sharded import sharded_patchmatch
from ocean_perception_tpu_torch.stereo import patchmatch as pm

H, W, MAX_DISP, SCALE, TRUE_DISP = 720, 1280, 128, 2, 8


def scene() -> tuple[np.ndarray, np.ndarray]:
    """chip_smoke.py's frame 0: a box-smoothed canvas, right(y, x - 8) == left(y, x)."""
    rng = np.random.default_rng(0)
    canvas = rng.random((H, W + 200)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)
    tint = np.array([0.35, 0.75, 0.9], np.float32)

    def rgb(x0):
        return np.clip(canvas[:, x0:x0 + W, None] * tint + 0.05, 0, 1).astype(np.float32)

    return rgb(100), rgb(100 + TRUE_DISP)


def wall_ms(fn, n: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(tag: str, fn, top: int) -> None:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # The blocks' named regions (Queue.run) appear on the device as spans
    # from their first kernel to their last, not as kernels.
    regions = sorted(((e.key, e.device_time_total / 1e3) for e in events
                      if e.device_type == DeviceType.CUDA and e.key.startswith("block ")),
                     key=lambda r: -r[1])
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and not e.key.startswith("block ")),
                     key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    device = sum(r[1] for r in kernels)
    launches = sum(r[2] for r in kernels)
    print(f"[{tag}] profiled call {wall:.3f} ms wall; kernels {device:.3f} ms of device time "
          f"({100 * device / wall:.1f}% of the wall), {launches} kernels")
    for name, ms, count in kernels[:top]:
        print(f"[{tag}]   device {ms:9.3f} ms x{count:<5d} {name[:110]}")
    for name, ms in regions[:top]:
        print(f"[{tag}]   span   {ms:9.3f} ms        {name}")
    for name, ms, count in host[:top]:
        print(f"[{tag}]   host   {ms:9.3f} ms x{count:<5d} {name[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: shard_profile.py runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__}")
    cuda.build()
    dev = torch.device("cuda", 0)
    left_np, right_np = scene()
    left, right = torch.as_tensor(left_np, device=dev), torch.as_tensor(right_np, device=dev)
    cam = PinholeCamera.create(700.0, 700.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=SCALE)
    gl, gr = to_grayscale(left), to_grayscale(right)
    for _ in range(SCALE.bit_length() - 1):
        gl, gr = pyr_down(gl), pyr_down(gr)
    p = pm.PatchMatchParams(max_disp=MAX_DISP // SCALE, chunks=config.chunks, right_wta=True,
                            volume_bf16=True)
    for n in args.blocks:
        mesh = make_mesh(axis_names=("strip",), devices=[dev] * n)
        single = dataclasses.replace(p, chunks_y=n)
        calls = {
            f"match N={n} sharded": lambda: sharded_patchmatch(gl, gr, mesh, p),
            f"match N={n} single": lambda: pm.patchmatch_disparity(gl, gr, single),
            f"step N={n} sharded": lambda: sharded_perception_step(left, right, rig, config, mesh),
            f"step N={n} single": lambda: perception_step(
                left, right, rig, dataclasses.replace(config, chunks_y=n), dev),
        }
        for tag, fn in calls.items():
            print(f"[{tag}] {wall_ms(fn):.3f} ms a call (wall, median of 5)")
            profile(tag, fn, args.top)
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
