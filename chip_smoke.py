#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's entry points at the bench's full width (1280x720 RGB,
max_disp=128, internal_scale=2, enhancement on) on synthetic scenes of known
disparity and motion, in phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels from ``csrc/`` and, beside
   them, a pointer chase that measures the latency of a dependent load
   from L2 (run once before phase 3);
3. the cost volume and the PatchMatch match kernel ``pm_match`` (the whole
   one-side match in one launch) against their plain PyTorch twins on the
   card, at the shapes the 720p path gives them (bit-identical; the match in
   bf16 and float32, on the path's seed and on an adversarial seed whose
   lookups tie and clamp and whose mask fires), with their times, bounds
   and the match's chain of dependent round trips (below);
4. ``perception_step`` end to end: three runs of 8 frames, checking the
   kernels' launch counts, finite outputs and the disparity against the
   scene's truth; its host syncs a frame (there must be none); then the
   whole step captured in one CUDA graph and replayed over the 8 frames
   (ms/frame beside the call path's, and the match's share of the graph
   frame; its disparity equal to the call path's); then the call time of
   each stage;
5. the same perception frame through the port on the CPU, against the card;
6. ``build_volumes`` (bf16 and float32) and ``pm_match_strip`` (the match
   over the two strip layouts) against their twins at the 720p shapes
   (bit-identical, the match as in phase 3, and equal to the (H, W, D)
   match), with their times;
7. ``perception_step`` with ``use_strip_volumes=True``, as in phase 4 (runs,
   launch counts, no host sync, graph replay and the match's share), with a
   disparity equal bit for bit to phase 4's on the same frame;
8. the other stereo configurations at 720p: the SGM and WTA engines of
   ``perception_step`` and two-sided and ZNCC PatchMatch (through
   ``estimate_disparity`` at the perception step's half resolution, then
   upsampled as the step does): ms/frame, accuracy, and one frame each
   against the CPU; then two-sided and ZNCC PatchMatch on N_CAMERAS
   cameras in one call (``pm_match`` once a side a call), each camera's
   disparity equal to its one-camera call's, ms a call beside the one
   camera's ms/frame;
9. the LK kernel ``lk_track`` (every level of one direction in one launch)
   against its twin on one ``full_frontend_step`` frame's recorded inputs at
   720p (K=200 slots, a 4-frame ring, 4 levels, window 21, forward and
   backward; bit-identical), with its times, its bound and chain of
   dependent operations, and the Gauss-Newton steps the points take on
   each level;
10. ``full_frontend_step`` end to end (tracker with the pyramid ring, stripe
   matcher, landmark graph) over 8 frames of a sequence that moves -2 px a
   frame with an 8 px stereo disparity: launch counts, finite outputs, the
   track error against the known motion, the stripe disparities, ms/frame,
   the tracker's share, host syncs per frame (at most FRONTEND_SYNCS, each
   printed with its place in the port) and the stage times; then the whole
   step captured in one CUDA graph and replayed over the same 8 frames, its
   outputs fed back as the next frame's state (ms/frame beside the call
   path's; the first and last frames' labels, slot ids and pixels equal to
   the call path's) and LK's share of its device time;
11. the same frontend frame through the port on the CPU, against the card;
12. ``perception_step`` on a batch of N_CAMERAS cameras in one call, each
   its own frame of the sequence (``make_inputs(canvas, i)``), on the (H, W,
   D) volume, on the strip layouts and at the farm point
   (``internal_scale=4``): the batched kernels against their batched twins
   at the batch's shapes (bit-identical) with their times and bounds beside
   their one-camera times, and the farm point's (``cost_volume`` and
   ``pm_match`` at its quarter-resolution shapes, checked as in phase 3 and
   not timed); then each configuration's batched step, whose
   every camera's disparity and depth must equal the one-camera step's on
   that frame bit for bit and whose enhanced image must stay within the
   enhance tolerance (below), with each kernel launched once a call, no
   host sync, and its CUDA graph's replay equal to the call path; ms per
   call by calls and by graph beside the one-camera graph frame, fps per
   GPU, the CUDA kernels a call runs at one camera and at N_CAMERAS
   (``torch.profiler``, with the kernels whose count differs between the
   two, and the kernel nodes of the call captured in a CUDA graph), and the
   peak device memory of each;
13. the fleet frontend, as a farm node dispatches it:
   ``multi_camera_frontend_step`` on N_CAMERAS cameras of uint8 mono frames
   at the farm point (``internal_scale=4``, ``mesher_scale=1``,
   ``ObjectMesherDeviceParams()``), each camera its own phase of the moving
   canvas (FLEET_PHASE frames apart): ``lk_track`` at B=N_CAMERAS against
   its batched twin (bit-identical) with its times and bound beside the one
   camera's (phase 9); 8 timed calls (launch counts, per-camera track error
   and stripe disparities); each camera's disparity map, depth, labels,
   slot ids and alive set equal to its one-camera ``full_frontend_step`` on
   the card at every timed frame, its pixels within 1e-3 px on >= 99% of
   alive slots (the run prints where they are equal bit for bit); no host
   sync; the call replayed as one CUDA graph with its outputs fed back
   (first and last frames equal to the call path's); ms a call by calls
   and by graph, fps per GPU beside the one-camera frontend's graph frame
   at the same point, CUDA kernels a call (profiler; graph nodes), peak
   memory, and the call times of a call and of its dense and mesher
   halves, at one camera and at N_CAMERAS.

The enhanced image of a batched camera is held to the one-camera step's as
the port's CPU tests hold it to the reference: the median and the 99.9th
percentile of |batched - single| at most twice those of the change the
one-camera enhancement shows when its input moves by one ulp (its LM fits
are ill-conditioned; a batched solve may round differently).

A kernel's times, at each call shape of its path: its device time two ways,
``torch.profiler`` over 20 calls (``profiler_ms``; "not measured" where the
profiler recorded no device time) and CUDA events around the replay of a
CUDA graph that captured 20 calls (``graph_ms``); ``call_ms``, CUDA events
around one Python call, the host's enqueue included; and ``plain_ms``, the
plain twin's call time. ``device_ms`` (also ``ms``) is the profiler's time
where it measured, else the graph replay's, and ``device_method`` says which.

Any failure raises and exits nonzero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit; the one before that lists each kernel with its launches on its
own path (launch counts are zeroed just before each path is driven and read
just after), its error against the plain twin, its times, and its bound:
the larger of the bytes it must move over 3.35 TB/s and the operations it
must do over 67 TFLOP/s (float32), from this run's shapes (for the match,
the volume elements its plain twin reads on this run's seed); for the match
and ``lk_track`` also their chains of dependent operations (the match's in
units of the chase's latency in this run).

Run: ``python chip_smoke.py`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.mesher.landmark_graph import LandmarkGraph
from ocean_perception_tpu_torch.mesher.object_mesher import ObjectMesherDeviceParams
from ocean_perception_tpu_torch.models.perception import (PerceptionConfig, full_frontend_step,
                                                          perception_step)
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import (gradient_magnitude, image_pyramid, pyr_down,
                                                  resize, to_grayscale)
from ocean_perception_tpu_torch.ops.windows import fold_rings
from ocean_perception_tpu_torch.parallel.sharded_pipeline import (create_fleet_frontend_state,
                                                                  multi_camera_frontend_step,
                                                                  prepare_frames)
from ocean_perception_tpu_torch.stereo import cost as sc
from ocean_perception_tpu_torch.stereo import patchmatch as pm
from ocean_perception_tpu_torch.stereo.api import estimate_disparity
from ocean_perception_tpu_torch.stereo.cost import cost_volume_plain
from ocean_perception_tpu_torch.tracking import lk
from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerState

H, W = 720, 1280
MAX_DISP, SCALE = 128, 2
TRUE_DISP = 8
N_FRAMES = 8
N_ENGINE_FRAMES = 3
N_TIMED = 20
N_RUNS = 3  # timed runs of N_FRAMES frames of each perception layout
# Host syncs a full_frontend_step frame keeps (PERF.md, section 5).
FRONTEND_SYNCS = 0
# Launches of each kernel per frame of each path.
PER_FRAME = {"cost_volume": 1, "pm_match": 1}
PER_STRIP_FRAME = {"build_volumes": 1, "pm_match_strip": 1}
PER_FRONTEND_FRAME = dict(PER_FRAME, lk_track=2)  # forward and backward, 4 levels each
N_CAMERAS = 4  # phase 8's, 12's and 13's batch
FLEET_PHASE = 9  # phase 13: camera b's frame i is frame i + FLEET_PHASE * b of the sequence
FARM_SCALE = 4  # the farm point's internal_scale
SHIFT = 2  # frontend sequence: features move -SHIFT px a frame
PM_CU = "ocean_perception_tpu_torch/csrc/patchmatch.cu"
SOURCES = {
    "cost_volume": ("ocean_perception_tpu_torch/csrc/cost_volume.cu",
                    "ocean_perception_tpu/ops/pallas/cost_volume.py:97"),
    "pm_match": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:580 and "
                        "ocean_perception_tpu/ops/pallas/propagate.py:115"),
    "build_volumes": ("ocean_perception_tpu_torch/csrc/volume_build.cu",
                      "ocean_perception_tpu/ops/pallas/volume_build.py:242"),
    "pm_match_strip": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:634"),
    "lk_track": ("ocean_perception_tpu_torch/csrc/lk.cu",
                 "ocean_perception_tpu/ops/pallas/lk_prep.py:291 and "
                 "ocean_perception_tpu/ops/pallas/lk_iterate.py:160"),
}
# H100 SXM peaks (NVIDIA's data sheet): memory rate and float32 rate outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Resident blocks an SM of pm_match's cooperative grid (csrc/patchmatch.cu,
# kMinBlocks).
MATCH_BLOCKS_PER_SM = 3
# A float32 add's latency on Hopper, in cycles, and the H100 SXM's boost
# clock: the time floor of a chain of dependent operations.
OP_CYCLES, CLOCK_HZ = 4, 1.98e9
# The unit of the match's chain of dependent round trips, measured in the
# run (l2_latency): one thread chases a random cycle of indices through a
# 4 MB buffer with loads that go to L2 (ld.global.cg), STEPS steps to bring
# the lines into L2, then the same STEPS again between two readings of the
# SM's clock (clock64) and of the global timer (%globaltimer, ns).
CHASE_STEPS = 4096
CHASE_CU = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
__global__ void chase(const unsigned* next, int steps, unsigned* sink, long long* out) {
  unsigned i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  i = 0;
  const long long c0 = clock64(), t0 = global_ns();
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  const long long t1 = global_ns(), c1 = clock64();
  *sink = i;
  out[0] = c1 - c0;
  out[1] = t1 - t0;
}
extern "C" int opt_chase(const void* next, int steps, void* sink, void* out, void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const unsigned*)next, steps, (unsigned*)sink,
                                           (long long*)out);
  return (int)cudaGetLastError();
}
"""
CHASE_DIR = cuda._BUILD / "l2_chase"
# Dependent operations in one step of lk_track's walk (csrc/lk.cu, walk):
# the position to the offsets (3), floor and the tap's address (3), the
# shared load, two-tap products and sums over x then y (4), the residual
# (1), the 2x2 step (2) and the new position (1).
LK_STEP_CHAIN = 15


def make_canvas() -> np.ndarray:
    """Box-smoothed random canvas, 200 px wider than a frame (bench.py's recipe)."""
    rng = np.random.default_rng(0)
    canvas = rng.random((H, W + 200)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)


def make_inputs(canvas: np.ndarray, i: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Frame i of the synthetic 720p stereo sequence:
    left_i(y, x) = canvas(y, x + 100 + SHIFT*i), right_i(y, x - 8) == left_i(y, x)."""
    x0 = 100 + SHIFT * i
    left = canvas[:, x0 : x0 + W]
    right = canvas[:, x0 + TRUE_DISP : x0 + TRUE_DISP + W]
    tint = np.array([0.35, 0.75, 0.9], np.float32)
    left_rgb = np.clip(left[..., None] * tint + 0.05, 0, 1).astype(np.float32)
    right_rgb = np.clip(right[..., None] * tint + 0.05, 0, 1).astype(np.float32)
    return left_rgb, right_rgb


def make_mono_u8(canvas: np.ndarray, i: int) -> tuple[np.ndarray, np.ndarray]:
    """Frame i of the sequence as a farm camera sends it, uint8 mono: the
    canvas of make_inputs, scaled to [0.05, 0.95] and quantized."""
    x0 = 100 + SHIFT * i

    def u8(a):
        return (np.clip(a * 0.9 + 0.05, 0, 1) * 255).astype(np.uint8)

    return u8(canvas[:, x0 : x0 + W]), u8(canvas[:, x0 + TRUE_DISP : x0 + TRUE_DISP + W])


def call_ms(fn, n: int = N_TIMED) -> float:
    """Median time of one call of fn() in ms over n runs, after two warm-ups:
    CUDA events recorded on an idle stream before and after the call, so the
    host's enqueue (the wrapper's checks, allocations and launches) is in it."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


KERNEL_RE = re.compile(r"(cost_volume|build_volumes|pm_match|lk_track)_kernel")


def launch_name(kernel: str) -> str | None:
    """The launch name of a kernel as the profiler names it, demangled or
    not: ``pm_match_kernel<float, (anonymous namespace)::RowStrips<float>, ...>``
    is ``pm_match_strip``, its Hwd form ``pm_match``; None for a
    kernel that no wrapper of ``ops/cuda.py`` launches."""
    m = KERNEL_RE.search(kernel)
    if m is None:
        return None
    strip = m.group(1).startswith("pm_") and re.search(r"(Row|Col)Strips", kernel)
    return m.group(1) + ("_strip" if strip else "")


def profiler_ms(launch: str, fn, n: int = N_TIMED) -> float | None:
    """Device time of one call's kernel in ms: ``torch.profiler`` over n
    calls of fn(), the kernels' device time in ``key_averages()`` over their
    count (the profiler may miss a launch of the n). None where it recorded
    no device time. Fails if the window ran a kernel of another launch name
    or more kernels than calls."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if launch_name(e.key) != launch:
            raise AssertionError(f"{launch}: the profiled window also ran {e.key!r}")
        total_us += e.device_time_total
        count += e.count
    if count == 0 or total_us <= 0:
        return None
    if count > n:
        raise AssertionError(f"{launch}: {count} kernels profiled over {n} calls")
    if count < n:
        print(f"[profiler] {launch}: {count} of {n} launches recorded")
    return total_us / 1e3 / count


def graph_ms(fn, n: int = N_TIMED, replays: int = 5) -> float:
    """Device time of one call of fn() in ms: CUDA events around the replay
    of a CUDA graph that captured n calls, so the host is out of it; the
    median over replays, over n."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def measure(launch: str, kernel, plain, plain_n: int = N_TIMED) -> dict:
    """One call shape of a kernel: its device time both ways, the time of
    one Python call, and its plain twin's call time."""
    return dict(profiler_ms=profiler_ms(launch, kernel), graph_ms=graph_ms(kernel),
                call_ms=call_ms(kernel), plain_ms=call_ms(plain, plain_n))


def summarize(calls: list) -> dict:
    """A kernel's timing columns, each the mean over its call shapes.
    ``device_ms`` (and ``ms``) is the profiler's where it measured every
    call, else the graph replay's; ``device_method`` says which."""
    def mean(key):
        return statistics.mean(c[key] for c in calls)

    profiled = all(c["profiler_ms"] is not None for c in calls)
    device = mean("profiler_ms") if profiled else mean("graph_ms")
    return dict(ms=device, device_ms=device,
                device_method="profiler" if profiled else "graph replay",
                profiler_ms=mean("profiler_ms") if profiled else "not measured",
                graph_ms=mean("graph_ms"), call_ms=mean("call_ms"), plain_ms=mean("plain_ms"))


def fmt_ms(v) -> str:
    """A time in ms, or "not measured" where a method gave none."""
    return "not measured" if v is None or isinstance(v, str) else f"{v:.5f} ms"


def times_line(t: dict) -> str:
    return (f"device {fmt_ms(t['profiler_ms'])} (profiler), {t['graph_ms']:.5f} ms (graph "
            f"replay); call {t['call_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms")


def adversarial_seed(shape, D: int, device, seed: int = 5):
    """Seeds of shape (..., H, W) and one (H, W) noise image on which the
    match's lookups tie and clamp and its mask fires: disparities on the
    half-integer grid over [0, D + 4), a quarter of them 0 (background), so
    past x - pr at the left edge and past D - 1; noise on the 1/64 grid, so
    that noise * 32, 16 and 8 keep the refreshed disparities on the
    half-integer grid."""
    rng = np.random.default_rng(seed)
    d = np.floor(rng.uniform(0, D + 4, shape) * 2).astype(np.float32) / 2
    d[rng.random(shape) < 0.25] = 0
    noise = (rng.integers(-64, 64, shape[-2:]) / 64).astype(np.float32)
    return torch.from_numpy(d).to(device), torch.from_numpy(noise).to(device)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel differs from its plain twin "
                             f"(max |diff| {max_abs(a, b)})")


def require_launches(tag: str, launches: dict, per_frame: dict, frames: int) -> None:
    """Each kernel of per_frame ran per_frame[k] times a frame; every other
    kernel ran no time."""
    want = {k: per_frame.get(k, 0) * frames for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} over {frames} frames, expected {want}")


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


class VolumeReads(torch.overrides.TorchFunctionMode):
    """Records which elements of the volumes a plain match reads: the
    storage offsets of every advanced index (``vol[cam, a, b, d]``) into a
    view of one of vols and of every ``torch.gather`` from one, each
    volume's offsets apart. A pass's reads where its loop bounds fail (the
    1-px frame, the last row or column of a scan) decide nothing and are
    left out; so are basic indices (the mask's cost(0), added by the
    caller)."""

    def __init__(self, vols, pr: int):
        super().__init__()
        self.vols = {v.data_ptr(): i for i, v in enumerate(vols)}
        self.pr = pr
        self.offsets = [[] for _ in vols]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = args[0] if args else None
        k = self.vols.get(src.data_ptr()) if isinstance(src, torch.Tensor) else None
        if k is not None and func is torch.Tensor.__getitem__ and isinstance(args[1], tuple) \
                and all(isinstance(i, torch.Tensor) for i in args[1]):
            index = torch.broadcast_tensors(*args[1])
            a, b = index[-3], index[-2]
            n, lanes, pr = src.shape[-3], src.shape[-2], self.pr
            used = (a >= pr) & (a <= n - pr - 2) & (b >= pr) & (b <= lanes - pr - 1)
            off = sum(i * st for i, st in zip(index, src.stride()))
            self.offsets[k].append(off[used])
        elif k is not None and func is torch.gather:
            assert args[1] in (-1, src.dim() - 1), "a gather along the disparity axis"
            index = args[2]
            grid = torch.meshgrid(*(torch.arange(m, device=index.device) for m in index.shape[:-1]),
                                  indexing="ij")
            off = sum(g[..., None] * st for g, st in zip(grid, src.stride())) + index * src.stride(-1)
            self.offsets[k].append(off.flatten())
        return func(*args, **kwargs)


def match_bound(C_row: torch.Tensor, C_col: torch.Tensor, seed, noise, p, spec: int,
                l2: dict) -> dict:
    """Bound of one match launch whose row passes read C_row and whose other
    reads go to C_col ((..., H, W, D) each, the same tensor for pm_match),
    on these seeds and noise; and its chain.
    Bytes: what must cross the card's memory in one launch. The seeds and
    the noise are read once and the outputs written once; of the volumes,
    each element the plain twin's reads need (``VolumeReads`` over
    ``_match_passes``, and cost(0) of every pixel for the mask), once a
    layout, however many passes read it. The fronts, 1.4 MB a pair at 720p,
    stay in the 50 MB L2 between passes and are not counted. The chain of dependent L2 round trips: a row pass
    stages its fronts (one trip, two with the refresh's lookups), then
    walks its chunk + 2*halo positions, spec of them a trip; a column pass
    reads its predecessor, then walks one position a trip; a block that
    takes more than one of a pass's work items (B cameras' items over at
    most MATCH_BLOCKS_PER_SM blocks an SM) walks them one after another;
    each grid barrier between passes is two (arrive, then see the release).
    A trip takes l2["ns"], the pointer chase's latency in this run."""
    *batch, H, W, D = C_col.shape
    B = int(np.prod(batch))
    vols = [C_row] if C_row.data_ptr() == C_col.data_ptr() else [C_row, C_col]
    reads = VolumeReads(vols, p.patch_radius)
    with reads:
        pm._match_passes(C_row, C_col, seed, noise, p)
    # The first read is the seeds' cost, which the first refresh replaces
    # before anything reads it.
    if reads.offsets[-1][0].numel() != B * H * W:
        raise AssertionError("the plain match no longer starts with the seed's cost")
    reads.offsets[-1].pop(0)
    cam, yy, xx = torch.meshgrid(*(torch.arange(n, device=C_col.device) for n in (B, H, W)),
                                 indexing="ij")
    C_flat = C_col.reshape(B, H, W, D)
    reads.offsets[-1].append((cam * C_flat.stride(0) + yy * C_flat.stride(1)
                              + xx * C_flat.stride(2)).flatten())
    elements = sum(int(torch.unique(torch.cat(o)).numel()) for o in reads.offsets)
    nbytes = B * H * W * (4 + 4) + H * W * 4 + elements * C_col.element_size()
    passes = 4 * p.iters
    trips = 2 * (passes - 1)
    items = {1: -(-H // 16) * sc._effective_chunks(W, p.chunks),  # kLanes rows an item
             0: -(-W // 128) * sc._effective_chunks(H, pm._strips(p, 0))}  # kColumns
    blocks = min(MATCH_BLOCKS_PER_SM * torch.cuda.get_device_properties(C_col.device)
                 .multi_processor_count, B * max(items.values()))
    for k in range(passes):
        axis = 1 if k % 2 == 0 else 0
        dim = W if axis == 1 else H
        w = dim // sc._effective_chunks(dim, pm._strips(p, axis)) + 2 * p.halo
        waves = -(-B * items[axis] // blocks)
        trips += waves * ((1 + (k % 4 == 0) + -(-w // spec)) if axis == 1 else 1 + w)
    return dict(**bound(nbytes), volume_elements=elements, chain_trips=trips,
                chain_ms=trips * l2["ns"] / 1e6)


def l2_latency(dev) -> dict:
    """The latency of a dependent load that hits L2 (CHASE_CU), the median
    over 3 runs, in cycles of the SM's clock and in ns."""
    n = 1 << 20
    order = np.random.default_rng(9).permutation(n)
    nxt = np.empty(n, np.uint32)
    nxt[order] = np.roll(order, -1)
    nxt_t = torch.from_numpy(nxt.view(np.int32)).to(dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = ctypes.CDLL(str(CHASE_DIR / "chase.so"))
    lib.opt_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p]
    runs = []
    for _ in range(3):
        cuda._check(lib.opt_chase(nxt_t.data_ptr(), CHASE_STEPS, sink.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream), "chase")
        runs.append([v / CHASE_STEPS for v in out.tolist()])
    cycles, ns = statistics.median(r[0] for r in runs), statistics.median(r[1] for r in runs)
    print(f"[l2] pointer chase, a dependent L2 load: "
          + ", ".join(f"{c:.1f} cycles {t:.1f} ns" for c, t in runs)
          + f"; median {cycles:.1f} cycles, {ns:.1f} ns")
    return dict(cycles=cycles, ns=ns)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | {smi} | torch {torch.__version__} | CUDA {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    """The port's kernels and, beside them, the pointer chase."""
    t0 = time.perf_counter()
    CHASE_DIR.mkdir(parents=True, exist_ok=True)
    (CHASE_DIR / "chase.cu").write_text(CHASE_CU)
    chase = subprocess.Popen([cuda._nvcc(), *cuda.NVCC_FLAGS, "-shared", "-o",
                              str(CHASE_DIR / "chase.so"), str(CHASE_DIR / "chase.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        path = cuda.build(verbose=True)
        cuda.library()
    finally:
        _, err = chase.communicate()
    if chase.returncode != 0:
        raise RuntimeError(f"nvcc failed for the pointer chase:\n{err}")
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")


def phase_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor, l2: dict | None,
                  tag: str = "", scale: int = SCALE) -> dict:
    """cost_volume and pm_match against their plain twins on identical
    inputs at the shapes of the path at internal scale ``scale``, then their
    device time (profiler and graph replay), their call time and their
    twins'. The images may be a batch of cameras, (B, H, W, 3): tag names
    it in the printed lines. With l2 None the twins are checked and nothing
    is timed (no rows are returned)."""
    dev = left_rgb.device
    iml, imr = to_grayscale(left_rgb), to_grayscale(right_rgb)
    for _ in range(scale.bit_length() - 1):
        iml, imr = pyr_down(iml), pyr_down(imr)
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = MAX_DISP // scale
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    rows = {}

    C = cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16)
    C_plain = cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16)
    require_equal(f"cost_volume{tag}", C, C_plain)
    C32 = cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.float32)
    require_equal(f"cost_volume{tag} float32", C32,
                  cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.float32))
    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape[-2:], p.noise_seed, device=dev)
    vols = {torch.float32: C32, torch.bfloat16: C}

    def match(vol, s, n):
        return pm._match_one_side(vol, s, n, p)

    if l2 is None:
        print(f"[cost_volume{tag}] images {tuple(iml.shape)}, volume {tuple(C.shape)}: "
              f"bit-identical to the plain twin in bf16 and float32")
        check_match("pm_match", vols, seed, noise, p, match, lambda vol: (vol, vol), None, tag)
        return {}
    rows["cost_volume"] = dict(
        max_abs_err=max_abs(C, C_plain),
        **summarize([measure(
            "cost_volume", lambda: cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16),
            lambda: cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16))]),
        **bound(4 * iml.numel() * 4 + C.numel() * C.element_size()),
    )
    rows["pm_match"] = check_match("pm_match", vols, seed, noise, p, match, lambda vol: (vol, vol),
                                   match_bound(C, C, seed, noise, p, 4, l2), tag)
    return rows


def check_match(name, vols, seed, noise, p, kernel, plain_volumes, bounds, tag="") -> dict:
    """A match kernel, kernel(vol, seed, noise), against the plain twin
    _match_plain(*plain_volumes(vol), ...) on each volume of vols ({dtype:
    volume or layouts}), on the path's seed and noise and on an adversarial
    seed: bit-identical, the mask zeroing some pixels and keeping others.
    Then, unless bounds is None, its times on the last (bf16, the
    production dtype) with the path's seed."""
    err, pr = 0.0, p.patch_radius
    adversarial = adversarial_seed(tuple(seed.shape), p.max_disp, seed.device)
    for dtype, vol in vols.items():
        for seeds, (s, n) in (("the path's", (seed, noise)), ("an adversarial", adversarial)):
            got = kernel(vol, s, n)
            want = pm._match_plain(*plain_volumes(vol), s, n, p)
            require_equal(f"{name}{tag} {dtype} {seeds}", got, want)
            err = max(err, max_abs(got, want))
            # Interior pixels the mask zeroed, of those the passes left nonzero.
            pre = pm._match_passes(*plain_volumes(vol), s, n, p)[0][..., pr:-pr, pr:-pr]
            masked = int(((pre > 0) & (want[..., pr:-pr, pr:-pr] == 0)).sum())
            kept = float((got > 0).float().mean())
            if not (masked > 0 and kept > 0):
                raise AssertionError(f"{name}{tag} {dtype}, {seeds} seed: the mask zeroed "
                                     f"{masked} pixels, {kept} of pixels kept")
            print(f"[{name}{tag}] {dtype}, {seeds} seed: bit-identical to the plain twin, "
                  f"{kept:.4f} of pixels kept, {masked} zeroed by the mask")
    if bounds is None:
        return dict(max_abs_err=err)
    row = dict(max_abs_err=err, **summarize([measure(
        name, lambda: kernel(vol, seed, noise),
        lambda: pm._match_plain(*plain_volumes(vol), seed, noise, p), 5)]), **bounds)
    print(f"[{name}{tag}] {times_line(row)}; bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"{row['volume_elements']} volume elements), chain of {row['chain_trips']} dependent L2 "
          f"round trips ({row['chain_ms']:.5f} ms at the chase's latency)")
    return row


def accuracy(disp: torch.Tensor) -> tuple[float, float]:
    """Median |disparity - TRUE_DISP| over valid pixels, and the valid fraction."""
    valid = disp > 0
    if not valid.any():
        raise AssertionError("no valid disparity")
    return float((disp[valid] - TRUE_DISP).abs().median()), float(valid.float().mean())


def phase_end_to_end(left_rgb, right_rgb, rig, config, tag="e2e",
                     per_frame=PER_FRAME) -> tuple[dict, torch.Tensor, list]:
    """N_RUNS runs of N_FRAMES perturbed frames through perception_step;
    checks launches, finiteness, accuracy and that a frame makes no host
    sync; returns the last run's launch counts, frame 0's disparity and the
    runs' ms/frame."""
    dev = left_rgb.device
    frames = [left_rgb + float(i) * 1e-6 for i in range(N_FRAMES)]
    perception_step(frames[0], right_rgb, rig, config, device=dev)  # warm-up
    torch.cuda.synchronize()

    runs = []
    for _ in range(N_RUNS):
        cuda.reset_launches()
        digest = torch.zeros((), device=dev, dtype=torch.float64)
        outs = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for f in frames:
            out = perception_step(f, right_rgb, rig, config, device=dev)
            # Consume every output, so no stage's work can be skipped.
            digest += out.disparity.sum() + out.depth.sum() + out.enhanced_left.sum()
            outs.append(out)
        end.record()
        end.synchronize()
        launches = dict(cuda.LAUNCHES)
        runs.append(start.elapsed_time(end) / N_FRAMES)
        require_launches(tag, launches, per_frame, N_FRAMES)

    for i, out in enumerate(outs):
        for field, t in out._asdict().items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"frame {i}: non-finite {field}")
        if out.disparity.shape != (H, W) or out.enhanced_left.shape != (H, W, 3):
            raise AssertionError(f"frame {i}: bad output shapes")
    disp = outs[0].disparity
    med, frac = accuracy(disp)
    if not med < 1.0:
        raise AssertionError(f"median |disp - {TRUE_DISP}| = {med} px over valid pixels")
    if not frac > 0.5:
        raise AssertionError(f"valid fraction {frac}")
    print(f"[{tag}] {N_RUNS} runs of {N_FRAMES} frames: "
          f"{', '.join(f'{ms:.3f}' for ms in runs)} ms/frame "
          f"({1000.0 / statistics.median(runs):.1f} fps at the median), "
          f"median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}, digest {float(digest):.6e}, "
          f"launches {launches}")
    sites = sync_sites(lambda: perception_step(frames[0], right_rgb, rig, config, device=dev))
    torch.cuda.synchronize()
    print_syncs(tag, sites)
    if sites:
        raise AssertionError(f"{tag}: perception_step made {len(sites)} host syncs")
    return launches, disp, runs


def phase_graph(left_rgb, right_rgb, rig, config, disp, call_runs, match: tuple | None,
                tag="graph") -> float:
    """perception_step captured whole in one CUDA graph, then replayed over
    N_FRAMES perturbed frames copied into its input, every output consumed
    as in phase_end_to_end; frame 0's replayed disparity must equal the call
    path's bit for bit. Prints the match's share of the replayed frame
    (match: its launch name and graph-replay ms). Returns the replay's
    ms/frame."""
    dev = left_rgb.device
    frames = [left_rgb + float(i) * 1e-6 for i in range(N_FRAMES)]
    static_left = frames[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        perception_step(static_left, right_rgb, rig, config, device=dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = perception_step(static_left, right_rgb, rig, config, device=dev)
    graph.replay()
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for f in frames:
        static_left.copy_(f)
        graph.replay()
        digest += out.disparity.sum() + out.depth.sum() + out.enhanced_left.sum()
    end.record()
    end.synchronize()
    ms_frame = start.elapsed_time(end) / N_FRAMES
    static_left.copy_(frames[0])
    graph.replay()
    require_equal(f"{tag}: replayed disparity vs the call path's", out.disparity, disp)
    if not torch.isfinite(out.enhanced_left).all() or not torch.isfinite(out.depth).all():
        raise AssertionError(f"{tag}: non-finite replayed outputs")
    share = "" if match is None else (
        f"; the match ({match[0]}, {1e3 * match[1]:.2f} us by graph replay) "
        f"{100.0 * match[1] / ms_frame:.2f}% of the frame")
    print(f"[{tag}] one CUDA graph a frame, {N_FRAMES} frames: {ms_frame:.3f} ms/frame "
          f"({1000.0 / ms_frame:.1f} frames a second) against "
          f"{statistics.median(call_runs):.3f} ms/frame by calls (median of {len(call_runs)} "
          f"runs); digest {float(digest):.6e}; frame 0's disparity equal to the call "
          f"path's{share}")
    return ms_frame


def phase_stage_times(left_rgb, right_rgb, rig, config) -> None:
    """Call time of each stage of perception_step, one frame at a time (the
    host's enqueue included: most stages are bound by it)."""
    from ocean_perception_tpu_torch.imaging.enhance import enhance_underwater
    from ocean_perception_tpu_torch.stereo.cost import cost_volume, subpixel_refine

    p = pm.PatchMatchParams(max_disp=MAX_DISP // SCALE, right_wta=True, volume_bf16=True)
    st = {}
    st["gray+pyr_down"] = call_ms(lambda: (pyr_down(to_grayscale(left_rgb)), pyr_down(to_grayscale(right_rgb))))
    iml, imr = pyr_down(to_grayscale(left_rgb)), pyr_down(to_grayscale(right_rgb))
    st["sobel"] = call_ms(lambda: (gradient_magnitude(iml), gradient_magnitude(imr)))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    st["cost_volume"] = call_ms(lambda: cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, torch.bfloat16))
    C = cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, torch.bfloat16)
    st["noise"] = call_ms(lambda: pm.unit_noise(iml.shape, p.noise_seed, device=iml.device))
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=iml.device)
    st["sparse_wta_seed"] = call_ms(lambda: pm.sparse_wta_seed(C, p))
    seed = pm.sparse_wta_seed(C, p)
    st["patchmatch"] = call_ms(lambda: pm._match_one_side(C, seed, noise, p))
    disp_l = pm._match_one_side(C, seed, noise, p)

    def post():
        disp_r = pm.right_wta_from_left(C, p)
        int_l = torch.round(disp_l).clamp(0, p.max_disp - 1).long()
        d = torch.where(disp_l > 0, subpixel_refine(C, int_l), 0.0)
        d = pm.mask_occlusions(d, disp_r, p)
        d = resize(d, (H, W), method="nearest") * float(SCALE)
        z = rig.disp_to_depth(d)
        return torch.where(torch.isfinite(z) & (z <= config.max_depth), z, 0.0)

    st["right_wta+subpixel+occlusion+depth"] = call_ms(post)
    depth = post()
    st["enhance"] = call_ms(lambda: enhance_underwater(left_rgb, depth, config.enhance), 10)
    total = sum(st.values())
    for k, v in st.items():
        print(f"[stages] {k}: {v:.4f} ms ({100.0 * v / total:.1f}%)")
    print(f"[stages] sum {total:.4f} ms")


def phase_cpu_parity(left_rgb, right_rgb, rig, config, disp_gpu: torch.Tensor) -> None:
    t0 = time.perf_counter()
    disp_cpu = perception_step(left_rgb.cpu(), right_rgb.cpu(), rig, config, device="cpu").disparity
    diff = (disp_gpu.cpu() - disp_cpu).abs()
    close = float((diff <= 1e-3).float().mean())
    med = float(diff.median())
    print(f"[cpu] one frame on the CPU in {time.perf_counter() - t0:.1f} s: "
          f"{100 * close:.3f}% of pixels within 1e-3 px, median |diff| {med}, max {float(diff.max())}")
    if close < 0.99 or med != 0.0:
        raise AssertionError("card and CPU disparities disagree")


def phase_strip_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor, l2: dict,
                        tag: str = "strips") -> dict:
    """build_volumes (bf16 and float32) and pm_match_strip against their
    plain twins on identical inputs at 720p shapes, the match also against
    the (H, W, D) match. The images may be a batch of cameras, as in
    phase_kernels."""
    dev = left_rgb.device
    iml = pyr_down(to_grayscale(left_rgb))
    imr = pyr_down(to_grayscale(right_rgb))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = MAX_DISP // SCALE
    Hs, Ws = iml.shape[-2:]
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True, use_strip_volumes=True)
    g = sc.strip_geometry(Hs, Ws, D, p.chunks, p.chunks_y)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    print(f"[{tag}] images {tuple(iml.shape)}: V_row {(g.chunk_x, g.chunks_x, D, Hs)}, V_col "
          f"{(g.chunk_y, g.chunks_y, D, Ws)} a camera")
    rows = {}

    vols = {}
    for dtype in (torch.float32, torch.bfloat16):  # bf16, the production dtype, last
        def kernel():
            return cuda.build_volumes(iml, imr, gl, gr, D, a, b, g.chunks_x, g.chunks_y, dtype)

        def plain():
            return sc.build_strip_volumes_plain(iml, imr, gl, gr, D, p.alpha, p.chunks, p.chunks_y,
                                                dtype)

        (vr, vc), (vr_p, vc_p) = kernel(), plain()
        require_equal(f"build_volumes V_row {dtype}", vr, vr_p)
        require_equal(f"build_volumes V_col {dtype}", vc, vc_p)
        vols[dtype] = vr, vc
        rows["build_volumes"] = dict(
            max_abs_err=max(max_abs(vr, vr_p), max_abs(vc, vc_p)),
            **summarize([measure("build_volumes", kernel, plain)]),
            **bound(4 * iml.numel() * 4 + (vr.numel() + vc.numel()) * vr.element_size()))
        print(f"[{tag}] build_volumes {dtype}: {times_line(rows['build_volumes'])}; bound "
              f"{rows['build_volumes']['bound_ms']:.4f} ms")
    C = sc.volume_from_col_strips(vc)
    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape[-2:], p.noise_seed, device=dev)

    def plain_volumes(v):
        return sc.volume_from_row_strips(v[0]), sc.volume_from_col_strips(v[1])

    rows["pm_match_strip"] = check_match(
        "pm_match_strip", vols, seed, noise, p,
        lambda v, s, n: pm._match_one_side_strips(*v, s, n, p), plain_volumes,
        match_bound(*plain_volumes(vols[torch.bfloat16]), seed, noise, p, 1, l2),
        "" if tag == "strips" else f" {tag}")
    full = pm._match_one_side_strips(vr, vc, seed, noise, p)
    require_equal("pm_match_strip vs the (H, W, D) match", full,
                  pm._match_one_side(C, seed, noise, p))
    hwd_ms = call_ms(lambda: pm._match_one_side(C, seed, noise, p))
    hwd_dev = graph_ms(lambda: pm._match_one_side(C, seed, noise, p))
    print(f"[{tag}] pm_match_strip: call {rows['pm_match_strip']['call_ms']:.4f} ms vs the (H, W, "
          f"D) match's {hwd_ms:.4f} ms; device (graph replay) "
          f"{rows['pm_match_strip']['graph_ms']:.4f} vs {hwd_dev:.4f} ms; equal to it, "
          f"valid {(full > 0).float().mean().item():.3f}")
    # The dense half on each layout, in turns (H, W, D), strips, strips,
    # (H, W, D): the volume build, seed, match, right WTA and subpixel.
    p_hwd = dataclasses.replace(p, use_strip_volumes=False)
    turns = [call_ms(lambda q=q: pm.patchmatch_disparity(iml, imr, q), 10)
             for q in (p_hwd, p, p, p_hwd)]
    print(f"[{tag}] patchmatch_disparity at {Hs}x{Ws}, in turns: (H, W, D) {turns[0]:.4f}, "
          f"strips {turns[1]:.4f}, strips {turns[2]:.4f}, (H, W, D) {turns[3]:.4f} ms")
    for name, row in rows.items():
        print(f"[{tag}] {name}: {times_line(row)}; bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), max |diff| {row['max_abs_err']}")
    return rows


def dense_disparity(left_rgb, right_rgb, params: pm.PatchMatchParams, device) -> torch.Tensor:
    """The dense half of perception_step with another PatchMatch
    configuration: grays at half resolution, estimate_disparity, then the
    step's nearest upsampling and doubling."""
    left_rgb = torch.as_tensor(left_rgb, dtype=torch.float32, device=device)
    right_rgb = torch.as_tensor(right_rgb, dtype=torch.float32, device=device)
    gray_l = pyr_down(to_grayscale(left_rgb))
    gray_r = pyr_down(to_grayscale(right_rgb))
    r = estimate_disparity(gray_l, gray_r, engine="patchmatch", patchmatch_params=params)
    return resize(r.left, (H, W), method="nearest") * float(SCALE)


def phase_engines(left_rgb, right_rgb, rig, canvas) -> dict:
    """The other stereo configurations at 720p: N_ENGINE_FRAMES timed frames
    each after a warm-up, launch counts, accuracy, and one frame against
    the CPU (within 1e-3 px on >= 99% of pixels); then the two PatchMatch
    configurations on N_CAMERAS cameras in one call (phase_engines_batched)."""
    D = MAX_DISP // SCALE
    engines = {
        "sgm": (lambda l, r, dev: perception_step(l, r, rig, PerceptionConfig(
            engine="sgm", max_disp=MAX_DISP, internal_scale=SCALE, run_enhance=False),
            device=dev).disparity, {"cost_volume": 1}),
        "wta": (lambda l, r, dev: perception_step(l, r, rig, PerceptionConfig(
            engine="wta", max_disp=MAX_DISP, internal_scale=SCALE, run_enhance=False),
            device=dev).disparity, {"cost_volume": 1}),
        "patchmatch two-sided": (lambda l, r, dev: dense_disparity(l, r, pm.PatchMatchParams(
            max_disp=D, right_wta=False, volume_bf16=True), dev),
            {"cost_volume": 1, "pm_match": 2}),
        "patchmatch zncc": (lambda l, r, dev: dense_disparity(l, r, pm.PatchMatchParams(
            max_disp=D, right_wta=True, cost="zncc"), dev),
            {"pm_match": 1}),
    }
    dev = left_rgb.device
    results = {}
    for name, (run, per_frame) in engines.items():
        frames = [left_rgb + float(i) * 1e-6 for i in range(N_ENGINE_FRAMES)]
        run(frames[0], right_rgb, dev)  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        disps = [run(f, right_rgb, dev) for f in frames]
        end.record()
        end.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        require_launches(name, dict(cuda.LAUNCHES), per_frame, N_ENGINE_FRAMES)
        ms_frame = start.elapsed_time(end) / N_ENGINE_FRAMES
        disp = disps[0]
        if disp.shape != (H, W) or not torch.isfinite(disp).all():
            raise AssertionError(f"{name}: bad disparity")
        med, frac = accuracy(disp)
        t0 = time.perf_counter()
        disp_cpu = run(frames[0].cpu(), right_rgb.cpu(), "cpu")
        cpu_s = time.perf_counter() - t0
        close = float(((disp.cpu() - disp_cpu).abs() <= 1e-3).float().mean())
        results[name] = dict(ms_frame=ms_frame, median_err=med, valid=frac, cpu_close=close)
        print(f"[engines] {name}: {ms_frame:.3f} ms/frame over {N_ENGINE_FRAMES} frames, "
              f"median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}, launches {launches}; "
              f"CPU frame in {cpu_s:.1f} s, "
              f"{100 * close:.3f}% of pixels within 1e-3 px")
        if not med < 1.0:
            raise AssertionError(f"{name}: median |disp - {TRUE_DISP}| = {med} px")
        if not frac > 0.25:
            raise AssertionError(f"{name}: valid fraction {frac}")
        if close < 0.99:
            raise AssertionError(f"{name}: card and CPU disparities disagree")
    phase_engines_batched({k: engines[k] for k in engines if k.startswith("patchmatch")},
                          canvas, results, dev)
    return results


def phase_engines_batched(engines: dict, canvas, results: dict, dev) -> None:
    """Each engine's dense half on N_CAMERAS cameras in one call, each its
    own frame of the sequence: N_ENGINE_FRAMES timed calls after a warm-up,
    each kernel launched as often a call as a one-camera frame launches it
    (the two-sided match once a side), and each camera's disparity equal to
    its one-camera call's bit for bit."""
    B = N_CAMERAS
    pairs = [make_inputs(canvas, i) for i in range(B)]
    left = torch.as_tensor(np.stack([l for l, _ in pairs]), device=dev)
    right = torch.as_tensor(np.stack([r for _, r in pairs]), device=dev)
    for name, (run, per_frame) in engines.items():
        frames = [left + float(i) * 1e-6 for i in range(N_ENGINE_FRAMES)]
        run(frames[0], right, dev)  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        disps = [run(f, right, dev) for f in frames]
        end.record()
        end.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        require_launches(f"{name} B={B}", dict(cuda.LAUNCHES), per_frame, N_ENGINE_FRAMES)
        ms_call = start.elapsed_time(end) / N_ENGINE_FRAMES
        if disps[0].shape != (B, H, W) or not torch.isfinite(disps[0]).all():
            raise AssertionError(f"{name} B={B}: bad disparity")
        accs = []
        for b in range(B):
            require_equal(f"{name} B={B} camera {b} vs its one-camera call", disps[0][b],
                          run(frames[0][b], right[b], dev))
            accs.append(accuracy(disps[0][b]))
            if not (accs[-1][0] < 1.0 and accs[-1][1] > 0.25):
                raise AssertionError(f"{name} B={B} camera {b}: median |disp - {TRUE_DISP}| "
                                     f"{accs[-1][0]} px, valid {accs[-1][1]}")
        one = results[name]["ms_frame"]
        results[name]["batched"] = dict(cameras=B, ms_call=ms_call)
        print(f"[engines B={B}] {name}: {ms_call:.3f} ms a call of {B} cameras over "
              f"{N_ENGINE_FRAMES} calls ({B * 1000.0 / ms_call:.1f} camera frames a second) "
              f"against {one:.3f} ms/frame for one camera ({ms_call / (B * one):.3f} of {B} "
              f"one-camera frames); each camera's disparity equal to its one-camera call's; "
              f"median |disp - {TRUE_DISP}| "
              + ", ".join(f"{m:.4f}" for m, _ in accs) + " px, valid "
              + ", ".join(f"{v:.4f}" for _, v in accs) + f"; launches {launches}")


def lk_bounds(call, steps: list) -> dict:
    """Bound of one lk_track launch (one direction, every level), from its
    recorded arguments and the steps each point took on each level (steps:
    (level, (K,) steps) from lk_track_plain). Bytes: each point's template
    and slack windows a level read, its point, guess and frame indices read,
    its point and status written. Operations (a multiply-add counted as
    two): the two-tap recentring, the gradients, the 5 window sums, the
    2*A*A surface sums of win^2 multiply-adds, and the walk's steps. Its
    chain of dependent operations: the coarsest level's window sums (row,
    then column), then on every level the win^2-long sum of a surface value
    and the most steps any point took times LK_STEP_CHAIN; the levels follow
    one another, since each slack window sits at the coarser level's guess."""
    (tmpl_levels, _, points, *_), kwargs = call[1], call[2]
    # Points of every camera of a batch.
    K, slack, wins = points.shape[:-1].numel(), kwargs["slack"], kwargs["wins"]
    taken = dict(steps)
    nbytes, flops, chain = K * (4 * 2 * 2 + 4 * 2 + 4 * 2 + 1), 0, 0
    for lvl in range(len(tmpl_levels) - 1, -1, -1):
        win = wins[lvl]
        if win is None:
            continue
        ST, P, ws = win + 3, win + 2, win + 2 * (slack + 1)
        A = ws - win + 1
        nbytes += K * 4 * (ST * ST + ws * ws)
        flops += K * (3 * P * ST + 3 * P * P + 4 * win * win + 5 * 2 * win * win
                      + 2 * A * A * 2 * win * win + 20)
        flops += int(taken[lvl].sum()) * 50  # a step's tents, lookups, solve and test
        chain += (2 * win if chain == 0 else 0) + win * win
        chain += int(taken[lvl].max()) * LK_STEP_CHAIN
    return dict(**bound(nbytes, flops), chain_ops=chain,
                chain_ms=1e3 * chain * OP_CYCLES / CLOCK_HZ)


def record_lk_calls(fn) -> list:
    """Run fn() and return, for every lk_track call it made in order, (name,
    args, kwargs, launch): the dispatcher's arguments, the exact inputs the
    main path gives the kernel, for the plain twin; and the arguments the
    dispatcher handed the kernel's wrapper, to time the kernel alone."""
    calls, launches = [], []
    orig, wrapper = lk.lk_track, cuda.lk_track

    def spy(*args, **kwargs):
        calls.append(("lk_track", args, kwargs))
        return orig(*args, **kwargs)

    def spy_wrapper(*args):
        launches.append(args)
        return wrapper(*args)

    try:
        lk.lk_track, cuda.lk_track = spy, spy_wrapper
        fn()
    finally:
        lk.lk_track, cuda.lk_track = orig, wrapper
    if len(launches) != len(calls):
        raise AssertionError(f"{len(calls)} LK calls launched {len(launches)} kernels")
    return [(*call, launch) for call, launch in zip(calls, launches)]


def folded(launch: tuple) -> tuple:
    """lk_track's wrapper arguments with a batch of cameras folded into the
    rings, as the wrapper folds them (ops/windows.py::fold_rings): the same
    launch, without the few small kernels that fold the frame indices, so
    that a timing window holds the LK kernel alone."""
    tmpl, srch, pts, init, src_t, src_s, *rest = launch
    batch = tuple(pts.shape[:-2])
    if not batch:
        return launch
    K = pts.shape[-2]
    tmpl, src_t = fold_rings(tmpl, src_t, batch, K)
    srch, src_s = fold_rings(srch, src_s, batch, K)
    return (tmpl, srch, pts.reshape(-1, 2), init.reshape(-1, 2), src_t, src_s, *rest)


def phase_lk_kernels(calls: list, tag: str = "lk") -> dict:
    """lk_track against its twin on one frontend frame's recorded inputs (4
    levels, forward then backward; one camera, or a batch of them in one
    launch): bit-identical; then each direction's times, bound and chain,
    and the Gauss-Newton steps the points took on each level (from the
    twin)."""
    if [c[0] for c in calls] != ["lk_track"] * 2:
        raise AssertionError(f"expected a forward and a backward lk_track, got {[c[0] for c in calls]}")
    err, times, bounds = 0.0, [], []
    for direction, (name, args, kwargs, launch) in zip(("forward", "backward"), calls):
        got = lk.lk_track(*args, **kwargs)
        steps = []
        want = lk.lk_track_plain(*args, **kwargs, steps=steps)
        for a, b in zip(got, want):
            fa, fb = a.float().nan_to_num(-1e30), b.float().nan_to_num(-1e30)
            require_equal(f"lk_track {direction}", fa, fb)
            err = max(err, max_abs(fa, fb))
        for lvl, moved in steps:
            print(f"[{tag}] {direction} level {lvl} (window {kwargs['wins'][lvl]}): Gauss-Newton "
                  f"steps mean {moved.float().mean().item():.3f}, max {int(moved.max())} "
                  f"over {moved.numel()} points")
        flat = folded(launch)
        times.append(measure("lk_track", lambda: cuda.lk_track(*flat),
                             lambda: lk.lk_track_plain(*args, **kwargs), 5))
        bounds.append(lk_bounds((name, args, kwargs), steps))
        b = bounds[-1]
        print(f"[{tag}] lk_track {direction} ({len(args[0])} levels, points "
              f"{tuple(args[2].shape[:-1])}): "
              f"{times_line(times[-1])}; bound {b['bound_ms']:.5f} ms ({b['bound_by']}), chain of "
              f"{b['chain_ops']} dependent operations ({b['chain_ms']:.5f} ms at {OP_CYCLES} "
              f"cycles an operation, {CLOCK_HZ / 1e9:.2f} GHz)")
    row = dict(max_abs_err=err, **summarize(times),
               bound_ms=statistics.mean(b["bound_ms"] for b in bounds),
               bound_by=bounds[0]["bound_by"],
               chain_ops=statistics.mean(b["chain_ops"] for b in bounds),
               chain_ms=statistics.mean(b["chain_ms"] for b in bounds))
    print(f"[{tag}] lk_track, a launch (mean of the 2): {times_line(row)}; bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}), chain {row['chain_ms']:.5f} ms, "
          f"max |diff| {row['max_abs_err']}; a frame's LK: 2 launches, "
          f"{2 * row['device_ms'] * 1e3:.3f} us of device time")
    return {"lk_track": row}


def sync_sites(fn) -> list:
    """One entry per host sync made by fn(), as torch.cuda.set_sync_debug_mode
    reports it: the port's frames of the Python stack at the sync, innermost
    first."""
    sites = []

    def record(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1]
            # The port's frames, or else the innermost three of any file.
            frames = [f for f in stack if "ocean_perception_tpu_torch" in f.filename] or stack[-3:]
            sites.append(" <- ".join(f"{Path(f.filename).name}:{f.lineno}" for f in frames[::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def print_syncs(tag: str, sites: list) -> None:
    print(f"[{tag}] host syncs per frame: {len(sites)}")
    for site, n in sorted({s: sites.count(s) for s in sites}.items()):
        print(f"[{tag}]   {n} x {site}")


def phase_frontend(canvas, rig, config, dev) -> dict:
    """full_frontend_step over the moving sequence: 4 warm-up frames fill the
    ring (frame 0 is the first keyframe), frame 4 is recorded for the LK
    kernel check, frames 5..12 are timed and checked."""
    params = ObjectMesherDeviceParams()
    frames = [tuple(torch.as_tensor(a, device=dev) for a in make_inputs(canvas, i))
              for i in range(5 + N_FRAMES + 1)]
    state = StereoTrackerState.create(params.tracker, image_shape=(H, W), device=dev)
    graph = LandmarkGraph.create(params.tracker.capacity, device=dev)
    prev = to_grayscale(frames[0][0])

    def step(i):
        nonlocal state, graph, prev
        out, prev = full_frontend_step(state, graph, prev, *frames[i], rig, config, params,
                                       device=dev)
        state, graph = out.tracker_state, out.graph
        return out

    for i in range(4):
        out = step(i)
        if i == 0:
            alive = int(out.tracker_state.table.alive.sum())
            if not (bool(out.mesher.is_keyframe) and alive >= 50):
                raise AssertionError(f"first keyframe: {alive} landmarks alive")
    calls = record_lk_calls(lambda: step(4))
    torch.cuda.synchronize()

    cuda.reset_launches()
    start_state = (state, graph, prev)
    before, outs = [state], []
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(5, 5 + N_FRAMES):
        out = step(i)
        # Consume every stage's output, labels and sizes included, so that no
        # stage's work can be skipped.
        m = out.mesher
        digest += (out.perception.disparity.sum() + out.perception.enhanced_left.sum()
                   + m.disparities.sum() + m.labels.sum() + m.sizes.sum())
        outs.append(out)
        before.append(state)
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) / N_FRAMES
    launches = dict(cuda.LAUNCHES)
    ms_frame = start.elapsed_time(end) / N_FRAMES

    require_launches("frontend", launches, PER_FRONTEND_FRAME, N_FRAMES)
    errs, disps = [], []
    for k, out in enumerate(outs):
        for field, t in (*out.perception._asdict().items(),
                         *((f, v) for f, v in out.mesher._asdict().items() if v.is_floating_point())):
            if not torch.isfinite(t).all():
                raise AssertionError(f"frontend frame {k}: non-finite {field}")
        a, b = before[k].table, before[k + 1].table
        same = (a.ids >= 0) & (a.ids == b.ids) & (b.missed == 0)
        moved = b.pixels[same] - a.pixels[same]
        moved[:, 0] += SHIFT * (a.missed[same].float() + 1)
        errs.append(moved.abs().flatten())
        d = out.mesher.disparities[out.tracker_state.table.alive]
        disps.append(d[d > 0] - TRUE_DISP)
    errs, disps = torch.cat(errs), torch.cat(disps)
    med_err, med_disp = float(errs.median()), float(disps.abs().median())
    alive = int(outs[-1].tracker_state.table.alive.sum())
    clusters = int((outs[-1].mesher.sizes >= 3).sum())
    print(f"[frontend] {N_FRAMES} frames: {ms_frame:.3f} ms/frame ({1000.0 / ms_frame:.1f} fps), "
          f"host {1000.0 * wall:.3f} ms/frame, median |track error| {med_err:.5f} px over "
          f"{errs.numel() // 2} tracks, median |stripe disp - {TRUE_DISP}| {med_disp:.4f} px over "
          f"{disps.numel()} matches, {alive} alive, {clusters} clusters of >= 3, "
          f"digest {float(digest):.6e}, launches {launches}")
    if not med_err < 0.1:
        raise AssertionError(f"median |track error| {med_err} px")
    if not med_disp < 0.5:
        raise AssertionError(f"median |stripe disparity - {TRUE_DISP}| {med_disp} px")
    if alive < 50:
        raise AssertionError(f"{alive} landmarks alive")

    sites = sync_sites(lambda: step(5 + N_FRAMES))
    torch.cuda.synchronize()
    print_syncs("frontend", sites)
    if len(sites) > FRONTEND_SYNCS:
        raise AssertionError(f"frontend: {len(sites)} host syncs a frame, more than the "
                             f"{FRONTEND_SYNCS} PERF.md names")
    return dict(launches=launches, calls=calls, ms_frame=ms_frame, frames=frames, params=params,
                state=before[-2], graph=outs[-2].graph, prev=to_grayscale(frames[4 + N_FRAMES - 1][0]),
                out=outs[-1], start=start_state, first=outs[0])


def _map_tensors(fn, obj):
    """obj (a dataclass, tuple or tensor, nested) with fn applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_map_tensors(fn, o) for o in obj)
    raise TypeError(f"not a tensor tree: {type(obj)}")


def _tensors(obj) -> list:
    out = []
    _map_tensors(out.append, obj)
    return out


def frontend_graph(step, start, frames, first, last, tag: str) -> float:
    """A frontend call, step(state, graph, prev_gray, left, right) -> (out,
    gray), captured whole in one CUDA graph with static state, graph,
    previous-gray and image inputs, then replayed over frames from the
    state start = (state, graph, prev_gray): after each replay the outputs'
    tracker state, landmark graph and gray image are copied into the static
    inputs, and every output is consumed as in phase_frontend. The first
    and the last replayed frames' labels, slot ids and pixels must equal
    first's and last's, the call path's. Returns the replay's ms/frame."""
    state0, graph0, prev0 = start
    dev = prev0.device
    st, gr, prev = (_map_tensors(torch.clone, x) for x in (state0, graph0, prev0))
    left, right = (t.clone() for t in frames[0])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(st, gr, prev, left, right)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, gray = step(st, gr, prev, left, right)

    def load(state, lmk_graph, prev_gray, frame):
        for dst, src in zip(_tensors((st, gr, prev, left, right)),
                            _tensors((state, lmk_graph, prev_gray, *frame))):
            dst.copy_(src)

    def require_frame(which, call_out):
        for field, a, b in (("labels", out.mesher.labels, call_out.mesher.labels),
                            ("slot ids", out.tracker_state.table.ids, call_out.tracker_state.table.ids),
                            ("pixels", out.tracker_state.table.pixels,
                             call_out.tracker_state.table.pixels)):
            require_equal(f"{tag} {which} {field} vs the call path's", a, b)

    load(state0, graph0, prev0, frames[0])
    graph.replay()
    require_frame("frame 0", first)
    load(state0, graph0, prev0, frames[0])
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i, frame in enumerate(frames):
        if i:
            load(out.tracker_state, out.graph, gray, frame)
        graph.replay()
        m = out.mesher
        digest += (out.perception.disparity.sum() + out.perception.enhanced_left.sum()
                   + m.disparities.sum() + m.labels.sum() + m.sizes.sum())
    t1.record()
    t1.synchronize()
    ms_frame = t0.elapsed_time(t1) / len(frames)
    require_frame(f"frame {len(frames) - 1}", last)
    print(f"[{tag}] one CUDA graph a call, {len(frames)} calls: {ms_frame:.3f} ms a call; digest "
          f"{float(digest):.6e}; the first and last calls' labels, slot ids and pixels equal to "
          f"the call path's")
    return ms_frame


def phase_frontend_graph(fe, rig, config, lk_device_ms: float) -> float:
    """full_frontend_step as one CUDA graph a frame (frontend_graph) over the
    timed frames of phase_frontend, from the same start; prints LK's share
    of the replayed frame. Returns the replay's ms/frame."""
    dev = fe["start"][2].device

    def step(st, gr, prev, left, right):
        return full_frontend_step(st, gr, prev, left, right, rig, config, fe["params"], device=dev)

    ms_frame = frontend_graph(step, fe["start"], fe["frames"][5:5 + N_FRAMES], fe["first"],
                              fe["out"], "frontend graph")
    print(f"[frontend graph] {ms_frame:.3f} ms/frame ({1000.0 / ms_frame:.1f} fps) against "
          f"{fe['ms_frame']:.3f} ms/frame by calls; LK (2 lk_track launches, "
          f"{1e3 * lk_device_ms:.3f} us) {100.0 * lk_device_ms / ms_frame:.2f}% of the frame")
    return ms_frame


def phase_frontend_stage_times(fe, rig, config) -> None:
    """Call time of each stage of one frontend frame (the last timed one)."""
    from ocean_perception_tpu_torch.mesher.foreground import estimate_foreground_mask
    from ocean_perception_tpu_torch.mesher.object_mesher import mesher_device_step
    from ocean_perception_tpu_torch.tracking.detector import detect_features
    from ocean_perception_tpu_torch.tracking.stereo_tracker import track_and_triangulate
    from ocean_perception_tpu_torch.tracking.stripe_match import match_rectified

    p, state, graph, prev = fe["params"], fe["state"], fe["graph"], fe["prev"]
    left, right = fe["frames"][4 + N_FRAMES]
    gl, gr = to_grayscale(left), to_grayscale(right)
    fxb = torch.full((), 700.0 * 0.12, device=left.device)
    table = state.table
    pyr = tuple(image_pyramid(gl, p.tracker.lk.max_level + 1))
    st = {}
    st["frame (full_frontend_step)"] = call_ms(
        lambda: full_frontend_step(state, graph, prev, left, right, rig, config, p,
                                   device=left.device), 5)
    st["perception_step"] = call_ms(lambda: perception_step(left, right, rig, config, left.device), 5)
    st["mesher half (mesher_device_step)"] = call_ms(
        lambda: mesher_device_step(state, graph, prev, gl, gr, fxb, p), 5)
    st["  tracker (track_and_triangulate)"] = call_ms(
        lambda: track_and_triangulate(state, prev, gl, gr, fxb, p.tracker), 5)
    st["    image pyramid"] = call_ms(lambda: image_pyramid(gl, p.tracker.lk.max_level + 1))
    st["    LK, forward + backward (track_points_ring)"] = call_ms(
        lambda: lk.track_points_ring(state.ring, pyr, table.pixels, table.alive, table.missed,
                                     p.tracker.lk), 10)
    st["    detector"] = call_ms(lambda: detect_features(gl, p.tracker.detector, table.pixels,
                                                        table.alive), 10)
    st["    stripe matcher"] = call_ms(lambda: match_rectified(gl, gr, table.pixels, table.alive,
                                                              p.tracker.matcher), 10)
    st["  foreground mask"] = call_ms(lambda: estimate_foreground_mask(
        gl, p.foreground_ksize, p.foreground_min_gradient))
    frame = st["frame (full_frontend_step)"]
    for k, v in st.items():
        print(f"[frontend stages] {k}: {v:.4f} ms ({100.0 * v / frame:.1f}% of the frame)")
    syncs = {
        "perception_step": len(sync_sites(lambda: perception_step(left, right, rig, config,
                                                                  left.device))),
        "tracker": len(sync_sites(lambda: track_and_triangulate(state, prev, gl, gr, fxb,
                                                                p.tracker))),
        "mesher half": len(sync_sites(lambda: mesher_device_step(state, graph, prev, gl, gr, fxb,
                                                                 p))),
    }
    torch.cuda.synchronize()
    print(f"[frontend stages] host syncs: {syncs}")
    print(f"[frontend] tracker share of the frame: "
          f"{100.0 * st['  tracker (track_and_triangulate)'] / frame:.1f}%")


def phase_frontend_cpu_parity(fe, rig, config) -> None:
    """The last timed frontend frame again on the CPU, from the same state."""
    cpu = torch.device("cpu")
    state, graph, prev = fe["state"].to(cpu), fe["graph"].to(cpu), fe["prev"].cpu()
    left, right = (t.cpu() for t in fe["frames"][4 + N_FRAMES])
    t0 = time.perf_counter()
    out, _ = full_frontend_step(state, graph, prev, left, right, rig, config, fe["params"],
                                device=cpu)
    took = time.perf_counter() - t0
    g, c = fe["out"], out
    gt, ct = g.tracker_state.table, c.tracker_state.table
    alive_agree = float((g.mesher.alive.cpu() == c.mesher.alive).float().mean())
    both = ((gt.ids.cpu() == ct.ids) & (gt.ids.cpu() >= 0) & (gt.missed.cpu() == 0)
            & (ct.missed == 0))
    px = float((gt.pixels.cpu() - ct.pixels)[both].abs().max()) if both.any() else 0.0
    labels_equal = torch.equal(g.mesher.labels.cpu(), c.mesher.labels)
    print(f"[frontend cpu] one frame on the CPU in {took:.1f} s: alive slots agree on "
          f"{100 * alive_agree:.2f}%, max |pixel diff| {px} over {int(both.sum())} tracks, "
          f"labels equal {labels_equal}")
    if alive_agree < 0.99 or not px <= 1e-3 or not labels_equal:
        raise AssertionError("card and CPU frontends disagree")


def kernel_count(fn, n: int = 2) -> dict:
    """CUDA kernels one call of fn() runs, by name: those ``torch.profiler``
    recorded over n calls (memory copies and sets not counted), over n."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / n for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))}


def count_changes(one: dict, many: dict, top: int = 8) -> str:
    """The kernels whose count a call differs between two kernel_count
    readings, the largest differences first."""
    diff = {k: many.get(k, 0.0) - one.get(k, 0.0) for k in one.keys() | many.keys()}
    diff = sorted(((d, k) for k, d in diff.items() if d), key=lambda t: -abs(t[0]))
    return "; ".join(f"{d:+g} {k[:90]}" for d, k in diff[:top]) or "none"


def graph_kernel_nodes(fn) -> int | None:
    """Kernel nodes of one call of fn() captured in a CUDA graph, as
    libcuda's cuGraphGetNodes and cuGraphNodeGetType list them; None where
    this torch cannot keep the captured graph."""
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    drv.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if drv.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def peak_bytes(fn) -> tuple[int, int]:
    """torch.cuda.max_memory_allocated over one call of fn(), and the part
    of it above what was allocated before the call (the call's own)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def require_enhance_close(tag: str, batched, single, nudged) -> str:
    """The batched enhanced image within the enhance tolerance of the
    one-camera one (see the module docstring); nudged is the one-camera
    enhancement of the input moved by one ulp."""
    diff = (batched - single).abs().flatten().float()
    spread = (nudged - single).abs().flatten().float()
    q = torch.tensor([0.5, 0.999], device=diff.device)
    dq = [float(v) for v in torch.quantile(diff, q)]
    sq = [float(v) for v in torch.quantile(spread, q)]
    line = (f"|batched - single| median {dq[0]:.3e}, 99.9% {dq[1]:.3e}, max {float(diff.max()):.3e}"
            f"; one-ulp spread median {sq[0]:.3e}, 99.9% {sq[1]:.3e}")
    if not (dq[0] <= 2 * sq[0] and dq[1] <= 2 * sq[1]):
        raise AssertionError(f"{tag}: enhanced image outside the enhance tolerance: {line}")
    return line


def phase_batched(canvas, rig, config, rows: dict, l2: dict) -> dict:
    """perception_step on N_CAMERAS cameras in one call (see the module
    docstring, phase 12); returns the batched kernels' rows, each with its
    launches on the batched path."""
    from ocean_perception_tpu_torch.imaging.enhance import enhance_underwater

    dev = torch.device("cuda", 0)
    B = N_CAMERAS
    pairs = [make_inputs(canvas, i) for i in range(B)]
    left = torch.as_tensor(np.stack([l for l, _ in pairs]), device=dev)
    right = torch.as_tensor(np.stack([r for _, r in pairs]), device=dev)
    krows = phase_kernels(left, right, l2, f" B={B}")
    krows.update(phase_strip_kernels(left, right, l2, f"strips B={B}"))
    phase_kernels(left, right, None, f" farm B={B}", FARM_SCALE)
    for name, row in krows.items():
        one = rows[name]
        print(f"[batched kernels] {name}, B={B} in one launch: device {row['device_ms']:.5f} ms "
              f"against {one['device_ms']:.5f} at B=1 ({row['device_ms'] / one['device_ms']:.3f}x); "
              f"bound {row['bound_ms']:.5f} ms against {one['bound_ms']:.5f}"
              + (f"; chain {row['chain_ms']:.5f} ms ({row['chain_trips']} trips) against "
                 f"{one['chain_ms']:.5f}" if "chain_ms" in row else ""))
    configs = {
        "(H, W, D)": (config, PER_FRAME),
        "strips": (dataclasses.replace(config, use_strip_volumes=True), PER_STRIP_FRAME),
        f"farm (internal_scale={FARM_SCALE})": (
            dataclasses.replace(config, internal_scale=FARM_SCALE), PER_FRAME),
    }
    for tag, (cfg, per_call) in configs.items():
        def step(l=left, r=right, cfg=cfg):
            return perception_step(l, r, rig, cfg, device=dev)

        singles = [step(left[b], right[b]) for b in range(B)]
        step()  # warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        out = step()
        launches = dict(cuda.LAUNCHES)
        require_launches(f"batched {tag}", launches, per_call, 1)
        for k, n in launches.items():
            if n:
                krows[k]["launches"] = n
        if out.disparity.shape != (B, H, W) or out.enhanced_left.shape != (B, H, W, 3):
            raise AssertionError(f"batched {tag}: bad output shapes")
        for field, t in out._asdict().items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"batched {tag}: non-finite {field}")
        lines = []
        for b, one in enumerate(singles):
            require_equal(f"batched {tag} camera {b} disparity vs one camera's", out.disparity[b],
                          one.disparity)
            require_equal(f"batched {tag} camera {b} depth vs one camera's", out.depth[b],
                          one.depth)
            nudged, _ = enhance_underwater(left[b] * float(np.float32(1 + 2.0**-23)), one.depth,
                                           cfg.enhance)
            lines.append(require_enhance_close(f"batched {tag} camera {b}", out.enhanced_left[b],
                                               one.enhanced_left, nudged))
            med, frac = accuracy(out.disparity[b])
            lines[-1] += f"; median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}"
            # The farm point's quarter resolution is held to its one-camera
            # step only.
            if cfg.internal_scale == SCALE and not (med < 1.0 and frac > 0.5):
                raise AssertionError(f"batched {tag} camera {b}: median |disp - {TRUE_DISP}| "
                                     f"{med} px, valid {frac}")
        sites = sync_sites(step)
        torch.cuda.synchronize()
        print_syncs(f"batched {tag}", sites)
        if sites:
            raise AssertionError(f"batched {tag}: perception_step made {len(sites)} host syncs")

        calls_b = call_ms(step, 5)
        calls_1 = call_ms(lambda: step(left[0], right[0]), 5)
        graph_b = phase_graph(left, right, rig, cfg, out.disparity, [calls_b], None,
                              f"batched {tag} graph, B={B}")
        graph_1 = phase_graph(left[0], right[0], rig, cfg, singles[0].disparity, [calls_1], None,
                              f"batched {tag} graph, B=1")
        count_1 = kernel_count(lambda: step(left[0], right[0]))
        count_b = kernel_count(step)
        nodes_1 = graph_kernel_nodes(lambda: step(left[0], right[0]))
        nodes_b = graph_kernel_nodes(step)
        mem_1 = peak_bytes(lambda: step(left[0], right[0]))
        mem_b = peak_bytes(step)
        for b, line in enumerate(lines):
            print(f"[batched {tag}] camera {b}: disparity and depth equal to the one-camera "
                  f"step's; enhanced {line}")
        print(f"[batched {tag}] B={B}: {calls_b:.3f} ms a call by calls, {graph_b:.3f} ms by "
              f"graph ({B * 1000.0 / graph_b:.1f} fps per GPU; by calls "
              f"{B * 1000.0 / calls_b:.1f}); B=1: {calls_1:.3f} ms by calls, {graph_1:.3f} ms "
              f"by graph ({1000.0 / graph_1:.1f} fps); graph B={B} / ({B} x B=1) "
              f"{graph_b / (B * graph_1):.3f}; launches {launches}; CUDA kernels a call "
              f"(profiler) B=1 {sum(count_1.values()):.1f}, B={B} {sum(count_b.values()):.1f}, "
              f"kernel nodes of its CUDA graph B=1 {nodes_1}, B={B} {nodes_b}; peak device memory "
              f"(max_memory_allocated) B=1 {mem_1[0] / 2**20:.1f} MiB ({mem_1[1] / 2**20:.1f} the "
              f"call's own), B={B} {mem_b[0] / 2**20:.1f} MiB ({mem_b[1] / 2**20:.1f})")
        print(f"[batched {tag}] kernels a call, B={B} less B=1 (profiler): "
              f"{count_changes(count_1, count_b)}")
    return krows


def phase_fleet(canvas, rig, rows: dict, dev) -> dict:
    """The fleet frontend (see the module docstring, phase 13); returns
    lk_track's row at N_CAMERAS cameras, with its launches a call."""
    B = N_CAMERAS
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=FARM_SCALE)
    params = ObjectMesherDeviceParams()
    frames = []
    for i in range(5 + N_FRAMES + 1):
        pairs = [make_mono_u8(canvas, i + FLEET_PHASE * b) for b in range(B)]
        frames.append(tuple(torch.as_tensor(np.stack(side), device=dev) for side in zip(*pairs)))

    def fleet_step(st, gr, prev, left, right):
        return multi_camera_frontend_step(st, gr, prev, left, right, rig, config, params,
                                          device=dev)

    def one_step(st, gr, prev, left, right):
        """One camera's full_frontend_step on its uint8 mono frames."""
        return full_frontend_step(st, gr, prev, prepare_frames(left[None], dev)[0],
                                  prepare_frames(right[None], dev)[0], rig, config, params,
                                  device=dev)

    state, graph = create_fleet_frontend_state(B, params, image_shape=(H, W), device=dev)
    prev = to_grayscale(prepare_frames(frames[0][0], dev))
    prev0 = prev

    def step(i):
        nonlocal state, graph, prev
        out, prev = fleet_step(state, graph, prev, *frames[i])
        state, graph = out.tracker_state, out.graph
        return out

    for i in range(4):
        out = step(i)
        if i == 0:
            alive = out.tracker_state.table.alive.sum(-1).tolist()
            if not (bool(out.mesher.is_keyframe.all()) and min(alive) >= 50):
                raise AssertionError(f"fleet first keyframe: {alive} landmarks alive")
    calls = record_lk_calls(lambda: step(4))
    torch.cuda.synchronize()
    lk_row = phase_lk_kernels(calls, f"fleet lk B={B}")["lk_track"]
    one = rows["lk_track"]
    print(f"[fleet lk] lk_track, {B} cameras in one launch a direction: device "
          f"{lk_row['device_ms'] * 1e3:.3f} us ({lk_row['device_method']}; graph replay "
          f"{lk_row['graph_ms'] * 1e3:.3f}) against {one['device_ms'] * 1e3:.3f} us for one camera "
          f"(phase 9; {lk_row['device_ms'] / one['device_ms']:.3f}x); bound "
          f"{lk_row['bound_ms'] * 1e3:.3f} us ({lk_row['bound_by']}) against "
          f"{one['bound_ms'] * 1e3:.3f}; chain {lk_row['chain_ms'] * 1e3:.3f} us against "
          f"{one['chain_ms'] * 1e3:.3f}")

    cuda.reset_launches()
    start_state = (state, graph, prev)
    before, outs = [state], []
    digest = torch.zeros((), device=dev, dtype=torch.float64)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    wall0 = time.perf_counter()
    t0.record()
    for i in range(5, 5 + N_FRAMES):
        out = step(i)
        m = out.mesher
        digest += (out.perception.disparity.sum() + out.perception.enhanced_left.sum()
                   + m.disparities.sum() + m.labels.sum() + m.sizes.sum())
        outs.append(out)
        before.append(state)
    t1.record()
    t1.synchronize()
    wall = (time.perf_counter() - wall0) / N_FRAMES
    launches = dict(cuda.LAUNCHES)
    ms_call = t0.elapsed_time(t1) / N_FRAMES
    require_launches(f"fleet B={B}", launches, PER_FRONTEND_FRAME, N_FRAMES)
    if launches["lk_track"] != 2 * N_FRAMES:
        raise AssertionError(f"fleet: lk_track launched {launches['lk_track']} times in "
                             f"{N_FRAMES} calls")

    lines = []
    for b in range(B):
        errs, disps = [], []
        for k, out in enumerate(outs):
            if out.perception.disparity.shape != (B, H, W) or out.mesher.labels.shape[0] != B:
                raise AssertionError("fleet: outputs without the camera axis")
            for field, t in (*out.perception._asdict().items(),
                             *((f, v) for f, v in out.mesher._asdict().items()
                               if v.is_floating_point())):
                if not torch.isfinite(t[b]).all():
                    raise AssertionError(f"fleet camera {b} call {k}: non-finite {field}")
            a, c = before[k].table, before[k + 1].table
            same = (a.ids[b] >= 0) & (a.ids[b] == c.ids[b]) & (c.missed[b] == 0)
            moved = c.pixels[b][same] - a.pixels[b][same]
            moved[:, 0] += SHIFT * (a.missed[b][same].float() + 1)
            errs.append(moved.abs().flatten())
            d = out.mesher.disparities[b][out.tracker_state.table.alive[b]]
            disps.append(d[d > 0] - TRUE_DISP)
        errs, disps = torch.cat(errs), torch.cat(disps)
        med_err, med_disp = float(errs.median()), float(disps.abs().median())
        alive = int(outs[-1].tracker_state.table.alive[b].sum())
        lines.append(f"camera {b}: median |track error| {med_err:.5f} px over "
                     f"{errs.numel() // 2} tracks, median |stripe disp - {TRUE_DISP}| "
                     f"{med_disp:.4f} px, {alive} alive, "
                     f"{int((outs[-1].mesher.sizes[b] >= 3).sum())} clusters of >= 3")
        if not (med_err < 0.1 and med_disp < 0.5 and alive >= 50):
            raise AssertionError(f"fleet {lines[-1]}")

    # Each camera against its one-camera full_frontend_step on the card.
    start_1 = outs_1 = None
    ms_call_1 = []  # each camera's one-camera calls, by calls
    for b in range(B):
        st1 = StereoTrackerState.create(params.tracker, image_shape=(H, W), device=dev)
        gr1 = LandmarkGraph.create(params.tracker.capacity, device=dev)
        prev1, singles = prev0[b], []
        for i in range(5 + N_FRAMES):
            if i == 5:
                start_1 = start_1 or (st1, gr1, prev1)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            o1, prev1 = one_step(st1, gr1, prev1, frames[i][0][b], frames[i][1][b])
            st1, gr1 = o1.tracker_state, o1.graph
            if i >= 5:
                singles.append(o1)
        e1.record()
        e1.synchronize()
        ms_call_1.append(e0.elapsed_time(e1) / N_FRAMES)
        exact_px = exact_disp = exact_enh = 0
        enh_max = [0.0, 0.0]  # max |enhanced| over the calls, batched and one camera
        for k, (out, o1) in enumerate(zip(outs, singles)):
            tag = f"fleet camera {b} call {k}"
            require_equal(f"{tag} disparity map vs one camera's", out.perception.disparity[b],
                          o1.perception.disparity)
            require_equal(f"{tag} depth vs one camera's", out.perception.depth[b],
                          o1.perception.depth)
            require_equal(f"{tag} labels vs one camera's", out.mesher.labels[b], o1.mesher.labels)
            require_equal(f"{tag} slot ids vs one camera's", out.tracker_state.table.ids[b],
                          o1.tracker_state.table.ids)
            require_equal(f"{tag} alive vs one camera's", out.mesher.alive[b], o1.mesher.alive)
            alive = o1.mesher.alive
            dpx = (out.tracker_state.table.pixels[b] - o1.tracker_state.table.pixels)[alive]
            close = float((dpx.abs().amax(-1) <= 1e-3).float().mean()) if alive.any() else 1.0
            if close < 0.99:
                raise AssertionError(f"{tag}: pixels within 1e-3 px on {close} of alive slots")
            exact_px += torch.equal(out.tracker_state.table.pixels[b],
                                    o1.tracker_state.table.pixels)
            exact_disp += torch.equal(out.mesher.disparities[b], o1.mesher.disparities)
            exact_enh += torch.equal(out.perception.enhanced_left[b], o1.perception.enhanced_left)
            enh_max = [max(enh_max[0], float(out.perception.enhanced_left[b].abs().max())),
                       max(enh_max[1], float(o1.perception.enhanced_left.abs().max()))]
        if b == 0:
            outs_1 = singles
        lines[b] += (f"; against its one-camera full_frontend_step ({ms_call_1[-1]:.3f} ms a "
                     f"call by calls): disparity map, depth, labels, slot ids and alive set "
                     f"equal in {N_FRAMES} of {N_FRAMES} calls, pixels bit-identical in "
                     f"{exact_px}, stripe disparities bit-identical in {exact_disp}; enhanced "
                     f"image bit-identical in {exact_enh}, max |enhanced| {enh_max[0]:.6e} "
                     f"batched, {enh_max[1]:.6e} one camera")
    for line in lines:
        print(f"[fleet] {line}")

    sites = sync_sites(lambda: step(5 + N_FRAMES))
    torch.cuda.synchronize()
    print_syncs(f"fleet B={B}", sites)
    if sites:
        raise AssertionError(f"fleet: multi_camera_frontend_step made {len(sites)} host syncs")

    timed = frames[5:5 + N_FRAMES]
    graph_b = frontend_graph(fleet_step, start_state, timed, outs[0], outs[-1],
                             f"fleet graph B={B}")
    graph_1 = frontend_graph(one_step, start_1, [(l[0], r[0]) for l, r in timed], outs_1[0],
                             outs_1[-1], "fleet graph B=1")
    args_b = (*start_state, *timed[0])
    args_1 = (*start_1, timed[0][0][0], timed[0][1][0])
    count_1 = kernel_count(lambda: one_step(*args_1))
    count_b = kernel_count(lambda: fleet_step(*args_b))
    nodes_1 = graph_kernel_nodes(lambda: one_step(*args_1))
    nodes_b = graph_kernel_nodes(lambda: fleet_step(*args_b))
    mem_1 = peak_bytes(lambda: one_step(*args_1))
    mem_b = peak_bytes(lambda: fleet_step(*args_b))
    print(f"[fleet] B={B} (uint8 mono, internal_scale={FARM_SCALE}, mesher_scale=1): "
          f"{ms_call:.3f} ms a call by calls (host {1000.0 * wall:.3f} ms; one camera "
          f"{statistics.mean(ms_call_1):.3f}), {graph_b:.3f} ms by "
          f"graph: {B * 1000.0 / graph_b:.1f} fps per GPU (by calls {B * 1000.0 / ms_call:.1f}); "
          f"one camera, full_frontend_step at the same point: {graph_1:.3f} ms by graph "
          f"({1000.0 / graph_1:.1f} fps); graph B={B} / ({B} x B=1) {graph_b / (B * graph_1):.3f}; "
          f"digest {float(digest):.6e}; launches {launches} over {N_FRAMES} calls; CUDA kernels "
          f"a call (profiler) B=1 {sum(count_1.values()):.1f}, B={B} {sum(count_b.values()):.1f}, "
          f"kernel nodes of its CUDA graph B=1 {nodes_1}, B={B} {nodes_b}; peak device memory "
          f"(max_memory_allocated) B=1 {mem_1[0] / 2**20:.1f} MiB ({mem_1[1] / 2**20:.1f} the "
          f"call's own), B={B} {mem_b[0] / 2**20:.1f} MiB ({mem_b[1] / 2**20:.1f})")
    print(f"[fleet] kernels a call, B={B} less B=1 (profiler): {count_changes(count_1, count_b)}")

    # A call and its two halves by calls, at N_CAMERAS and at one camera,
    # each call's outputs dropped before the next (the timed loop above
    # keeps every call's).
    from ocean_perception_tpu_torch.mesher.object_mesher import mesher_device_step

    fxb = torch.full((), float(np.float32(rig.fx) * np.float32(rig.baseline)), device=dev)
    lefts, rights = (prepare_frames(t, dev) for t in timed[0])
    grays = to_grayscale(lefts), to_grayscale(rights)
    stages = {
        f"multi_camera_frontend_step, B={B}": lambda: fleet_step(*args_b),
        "full_frontend_step, B=1": lambda: one_step(*args_1),
        f"perception_step, B={B}": lambda: perception_step(lefts, rights, rig, config, dev),
        "perception_step, B=1": lambda: perception_step(lefts[0], rights[0], rig, config, dev),
        f"mesher_device_step, B={B}": lambda: mesher_device_step(*start_state, *grays, fxb,
                                                                 params),
        "mesher_device_step, B=1": lambda: mesher_device_step(*start_1, grays[0][0],
                                                              grays[1][0], fxb, params),
    }
    print("[fleet stages] by calls: " + "; ".join(
        f"{name} {call_ms(fn, 5):.3f} ms" for name, fn in stages.items()))
    return dict(lk_row, launches=launches["lk_track"] // N_FRAMES)


def main() -> int:
    name, smi = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    canvas = make_canvas()
    left_np, right_np = make_inputs(canvas)
    left_rgb = torch.as_tensor(left_np, device=dev)
    right_rgb = torch.as_tensor(right_np, device=dev)
    cam = PinholeCamera.create(700.0, 700.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=SCALE)

    l2 = l2_latency(dev)
    rows = phase_kernels(left_rgb, right_rgb, l2)
    launches, disp, runs = phase_end_to_end(left_rgb, right_rgb, rig, config)
    phase_graph(left_rgb, right_rgb, rig, config, disp, runs,
                ("pm_match", rows["pm_match"]["graph_ms"]))
    phase_stage_times(left_rgb, right_rgb, rig, config)
    phase_cpu_parity(left_rgb, right_rgb, rig, config, disp)

    rows.update(phase_strip_kernels(left_rgb, right_rgb, l2))
    strip_config = dataclasses.replace(config, use_strip_volumes=True)
    strip_launches, strip_disp, strip_runs = phase_end_to_end(left_rgb, right_rgb, rig,
                                                              strip_config, "strip e2e",
                                                              PER_STRIP_FRAME)
    require_equal("strip-volume perception disparity vs the (H, W, D) path's", strip_disp, disp)
    phase_graph(left_rgb, right_rgb, rig, strip_config, disp, strip_runs,
                ("pm_match_strip", rows["pm_match_strip"]["graph_ms"]), "strip graph")
    phase_engines(left_rgb, right_rgb, rig, canvas)

    fe = phase_frontend(canvas, rig, config, dev)
    rows.update(phase_lk_kernels(fe["calls"]))
    phase_frontend_graph(fe, rig, config, 2 * rows["lk_track"]["device_ms"])
    phase_frontend_stage_times(fe, rig, config)
    phase_frontend_cpu_parity(fe, rig, config)
    batched = phase_batched(canvas, rig, config, rows, l2)
    fleet_lk = phase_fleet(canvas, rig, rows, dev)

    # Launches on each kernel's own path: cost_volume's and pm_match's from
    # perception_step, build_volumes' and pm_match_strip's from
    # perception_step with strip volumes, LK's from full_frontend_step.
    launches.update({k: strip_launches[k] for k in PER_STRIP_FRAME})
    launches["lk_track"] = fe["launches"]["lk_track"]
    # The batched path's numbers beside each stereo kernel's row (phase 12).
    for k, row in batched.items():
        rows[k]["batched"] = dict(cameras=N_CAMERAS, **row)
    # And lk_track's, from the fleet frontend (phase 13).
    rows["lk_track"]["batched"] = dict(cameras=N_CAMERAS, **fleet_lk)
    kernels = [
        dict(name=k, route="cuda", source=SOURCES[k][0], replaces=SOURCES[k][1],
             launches=launches[k], library_ms=None, **rows[k])
        for k in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
