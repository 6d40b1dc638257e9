#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's entry points at the bench's full width (1280x720 RGB,
max_disp=128, internal_scale=2, enhancement on) on synthetic scenes of known
disparity and motion, in phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels from ``csrc/``;
3. each PatchMatch kernel against its plain PyTorch twin on the card, at the
   shapes the 720p path gives it (bit-identical; each pass on seeded and on
   adversarial fronts, in bf16 and float32), with its times (below);
4. ``perception_step`` end to end: three runs of 8 frames, checking the
   kernels' launch counts, finite outputs and the disparity against the
   scene's truth; its host syncs a frame (there must be none); then the
   whole step captured in one CUDA graph and replayed over the 8 frames
   (ms/frame beside the call path's; its disparity equal to the call
   path's); then the call time of each stage;
5. the same perception frame through the port on the CPU, against the card;
6. ``build_volumes`` (bf16 and float32) and each strip-layout PatchMatch
   kernel against their twins at the 720p shapes (bit-identical, the passes
   as in phase 3), with their times, then the whole strip-volume match;
7. ``perception_step`` with ``use_strip_volumes=True``, as in phase 4 (runs,
   launch counts, no host sync, graph replay), with a disparity equal bit
   for bit to phase 4's on the same frame;
8. the other stereo configurations at 720p: the SGM and WTA engines of
   ``perception_step`` and two-sided and ZNCC PatchMatch (through
   ``estimate_disparity`` at the perception step's half resolution, then
   upsampled as the step does): ms/frame, accuracy, and one frame each
   against the CPU;
9. the two LK kernels against their twins at the 720p shapes of
   ``full_frontend_step`` (K=200 slots, a 4-frame ring, 4 levels, forward
   and backward; bit-identical), with their times;
10. ``full_frontend_step`` end to end (tracker with the pyramid ring, stripe
   matcher, landmark graph) over 8 frames of a sequence that moves -2 px a
   frame with an 8 px stereo disparity: launch counts, finite outputs, the
   track error against the known motion, the stripe disparities, ms/frame,
   the tracker's share, host syncs per frame (at most FRONTEND_SYNCS, each
   printed with its place in the port) and the stage times;
11. the same frontend frame through the port on the CPU, against the card.

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
must do over 67 TFLOP/s (float32), from this run's shapes.

Run: ``python chip_smoke.py`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

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
PER_FRAME = {"cost_volume": 1, "pm_refresh": 3, "pm_propagate": 12, "pm_mask_background": 1}
PER_STRIP_FRAME = {"build_volumes": 1, "pm_refresh_strip": 3, "pm_propagate_strip": 12,
                   "pm_mask_background_strip": 1}
PER_FRONTEND_FRAME = dict(PER_FRAME, lk_prep=8, lk_walk=8)  # 4 levels x forward/backward
SHIFT = 2  # frontend sequence: features move -SHIFT px a frame
PM_CU = "ocean_perception_tpu_torch/csrc/patchmatch.cu"
SOURCES = {
    "cost_volume": ("ocean_perception_tpu_torch/csrc/cost_volume.cu",
                    "ocean_perception_tpu/ops/pallas/cost_volume.py:97"),
    "pm_refresh": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:580"),
    "pm_propagate": (PM_CU, "ocean_perception_tpu/ops/pallas/propagate.py:115"),
    "pm_mask_background": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:580"),
    "build_volumes": ("ocean_perception_tpu_torch/csrc/volume_build.cu",
                      "ocean_perception_tpu/ops/pallas/volume_build.py:242"),
    "pm_refresh_strip": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:634"),
    "pm_propagate_strip": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:634"),
    "pm_mask_background_strip": (PM_CU, "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:634"),
    "lk_prep": ("ocean_perception_tpu_torch/csrc/lk.cu",
                "ocean_perception_tpu/ops/pallas/lk_prep.py:291"),
    "lk_walk": ("ocean_perception_tpu_torch/csrc/lk.cu",
                "ocean_perception_tpu/ops/pallas/lk_iterate.py:160"),
}
# H100 SXM peaks (NVIDIA's data sheet): memory rate and float32 rate outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PASSES = pm.PASSES  # R+ C+ R- C-


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


KERNEL_RE = re.compile(r"(cost_volume|build_volumes|pm_refresh|pm_propagate|pm_mask_background"
                       r"|lk_prep|lk_walk)(?:_rows|_cols)?_kernel")


def launch_name(kernel: str) -> str | None:
    """The launch name of a kernel as the profiler names it, demangled or
    not: ``pm_propagate_rows_kernel<float, (anonymous namespace)::RowStrips<float>>``
    is ``pm_propagate_strip``, its Hwd form ``pm_propagate``; None for a
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


def adversarial_fronts(vol: torch.Tensor, shape, seed: int = 5):
    """Fronts on which a pass's compare flips often: disparities uniform in
    [0, D), half of them on the half-integer grid (rounding ties), and costs
    drawn from the volume's own entries at random, in its dtype."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, vol.shape[2], shape).astype(np.float32)
    half = rng.random(shape) < 0.5
    d[half] = np.floor(d[half] * 2) / 2
    pick = torch.from_numpy(rng.integers(0, vol.numel(), int(np.prod(shape)))).to(vol.device)
    return torch.from_numpy(d).to(vol.device), vol.reshape(-1)[pick].reshape(shape).contiguous()


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


def pm_bounds(H: int, W: int, D: int, esize: int, p) -> dict:
    """Bytes bounds of the three PatchMatch kernels on an (H, W) front: each
    (H, W) input read once and each output written once, plus the volume
    elements the lookups need (one a pixel for the refresh, two for the mask,
    one a scan position for a pass). A pass is also a chain of chunk+2*halo
    dependent loads, which no bytes bound sees."""
    px = H * W
    passes = []
    for _, axis in PASSES:
        dim, lanes = (W, H) if axis == 1 else (H, W)
        chunks = sc._effective_chunks(dim, pm._strips(p, axis))
        steps = chunks * lanes * (dim // chunks + 2 * p.halo)
        passes.append(bound(2 * px * (4 + esize) + steps * esize)["bound_ms"])
    return {
        "refresh": bound(px * (4 + 4 + esize + 4 + esize)),
        "propagate": dict(bound_ms=statistics.mean(passes), bound_by="bytes"),
        "mask": bound(px * (4 + 2 * esize + 4)),
    }


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
    t0 = time.perf_counter()
    path = cuda.build(verbose=True)
    cuda.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")


def check_passes(tag: str, kernel, plain, fronts: dict) -> float:
    """kernel(disp, cost, direction, axis) against plain(...) on every pass
    R+ C+ R- C- and every front of fronts ({name: (disp, cost)}):
    bit-identical. Returns the max |diff| (0)."""
    err = 0.0
    for name, (disp, cost) in fronts.items():
        for direction, axis in PASSES:
            (dk, ck) = kernel(disp, cost, direction, axis)
            (dp, cp) = plain(disp, cost, direction, axis)
            t = f"{tag}, {name} fronts, dir={direction:+d} axis={axis}"
            require_equal(t + " disp", dk, dp)
            require_equal(t + " cost", ck, cp)
            err = max(err, max_abs(dk, dp), max_abs(ck, cp))
    print(f"[passes] {tag}: bit-identical to the plain twin on the {' and '.join(fronts)} "
          f"fronts, 4 passes each")
    return err


def phase_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor) -> dict:
    """Each kernel against its plain twin on identical inputs at 720p shapes,
    then its device time (profiler and graph replay), its call time and its
    twin's."""
    dev = left_rgb.device
    iml = pyr_down(to_grayscale(left_rgb))
    imr = pyr_down(to_grayscale(right_rgb))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = MAX_DISP // SCALE
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    rows = {}

    C = cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16)
    C_plain = cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16)
    require_equal("cost_volume", C, C_plain)
    C32 = cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.float32)
    require_equal("cost_volume float32", C32,
                  cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.float32))
    Hs, Ws = iml.shape
    rows["cost_volume"] = dict(
        max_abs_err=max_abs(C, C_plain),
        **summarize([measure(
            "cost_volume", lambda: cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16),
            lambda: cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16))]),
        **bound(4 * Hs * Ws * 4 + C.numel() * C.element_size()),
    )
    bounds = pm_bounds(Hs, Ws, D, C.element_size(), p)

    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=dev)
    scale, pr = p.noise_scale0, p.patch_radius

    d_k, c_k = cuda.pm_refresh(C, seed, noise, scale, pr)
    d_p, c_p = pm._refresh_plain(C, seed, noise, scale, pr)
    require_equal("pm_refresh disp", d_k, d_p)
    require_equal("pm_refresh cost", c_k, c_p)
    rows["pm_refresh"] = dict(
        max_abs_err=max(max_abs(d_k, d_p), max_abs(c_k, c_p)),
        **summarize([measure("pm_refresh", lambda: cuda.pm_refresh(C, seed, noise, scale, pr),
                             lambda: pm._refresh_plain(C, seed, noise, scale, pr))]),
        **bounds["refresh"],
    )

    def strips(axis):
        return pm._effective_chunks(Ws if axis == 1 else Hs, p.chunks)

    err = 0.0
    for vol in (C, C32):
        seeded = pm._refresh_plain(vol, seed, noise, scale, pr)
        err = max(err, check_passes(
            f"pm_propagate {vol.dtype}",
            lambda d, c, direction, axis: cuda.pm_propagate(vol, d, c, direction, axis,
                                                            strips(axis), p.halo, pr),
            lambda d, c, direction, axis: pm._propagate_plain(vol, d, c, direction, axis, p),
            {"seeded": seeded, "adversarial": adversarial_fronts(vol, (Hs, Ws))}))
    calls = []
    for direction, axis in PASSES:
        calls.append(measure(
            "pm_propagate",
            lambda: cuda.pm_propagate(C, d_p, c_p, direction, axis, strips(axis), p.halo, pr),
            lambda: pm._propagate_plain(C, d_p, c_p, direction, axis, p)))
        print(f"[kernels] pm_propagate dir={direction:+d} axis={axis}: {times_line(calls[-1])}, "
              f"{strips(axis)} strips")
    rows["pm_propagate"] = dict(max_abs_err=err, **summarize(calls), **bounds["propagate"])

    final = pm._propagate_plain(C, d_p, c_p, -1, 0, p)[0]
    m_k = cuda.pm_mask_background(C, final, p.improve_factor, pr)
    m_p = pm.mask_background_plain(C, final, p)
    require_equal("pm_mask_background", m_k, m_p)
    rows["pm_mask_background"] = dict(
        max_abs_err=max_abs(m_k, m_p),
        **summarize([measure("pm_mask_background",
                             lambda: cuda.pm_mask_background(C, final, p.improve_factor, pr),
                             lambda: pm.mask_background_plain(C, final, p))]),
        **bounds["mask"],
    )

    # The whole left-side match (K3's composition): kernels vs plain twins.
    def match_plain():
        disp = seed
        for it in range(p.iters):
            disp = pm.add_foreground_noise(disp, noise, p.noise_scale0 / 2.0**it)
            cost = pm._full_cost_map(C, disp, pr)
            for direction, axis in PASSES:
                disp, cost = pm._propagate_plain(C, disp, cost, direction, axis, p)
        return pm.mask_background_plain(C, disp, p)

    full_k, full_p = pm._match_one_side(C, seed, noise, p), match_plain()
    require_equal("match_one_side", full_k, full_p)
    k_ms = call_ms(lambda: pm._match_one_side(C, seed, noise, p))
    g_ms = graph_ms(lambda: pm._match_one_side(C, seed, noise, p))
    p_ms = call_ms(match_plain)
    print(f"[kernels] match_one_side (3 refresh + 12 passes + mask): call {k_ms:.4f} ms, "
          f"device {g_ms:.4f} ms (graph replay), plain {p_ms:.4f} ms, "
          f"valid {(full_k > 0).float().mean().item():.3f}")
    for name, row in rows.items():
        print(f"[kernels] {name}: {times_line(row)}; bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']}), max |diff| {row['max_abs_err']}")
    return rows


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


def phase_graph(left_rgb, right_rgb, rig, config, disp, call_runs, tag="graph") -> float:
    """perception_step captured whole in one CUDA graph, then replayed over
    N_FRAMES perturbed frames copied into its input, every output consumed
    as in phase_end_to_end; frame 0's replayed disparity must equal the call
    path's bit for bit. Returns the replay's ms/frame."""
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
    print(f"[{tag}] one CUDA graph a frame, {N_FRAMES} frames: {ms_frame:.3f} ms/frame "
          f"({1000.0 / ms_frame:.1f} fps) against {statistics.median(call_runs):.3f} ms/frame "
          f"by calls (median of {len(call_runs)} runs); digest {float(digest):.6e}; "
          f"frame 0's disparity equal to the call path's")
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


def phase_strip_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor) -> dict:
    """build_volumes (bf16 and float32) and each strip-layout PatchMatch
    kernel against its plain twin on identical inputs at 720p shapes, then
    the whole strip-volume match against its twins and the (H, W, D) match."""
    dev = left_rgb.device
    iml = pyr_down(to_grayscale(left_rgb))
    imr = pyr_down(to_grayscale(right_rgb))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = MAX_DISP // SCALE
    Hs, Ws = iml.shape
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True, use_strip_volumes=True)
    g = sc.strip_geometry(Hs, Ws, D, p.chunks, p.chunks_y)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    print(f"[strips] V_row {(g.chunk_x, g.chunks_x, D, Hs)}, V_col {(g.chunk_y, g.chunks_y, D, Ws)}")
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
            **bound(4 * Hs * Ws * 4 + (vr.numel() + vc.numel()) * vr.element_size()))
        print(f"[strips] build_volumes {dtype}: {times_line(rows['build_volumes'])}; bound "
              f"{rows['build_volumes']['bound_ms']:.4f} ms")
    C = sc.volume_from_col_strips(vc)
    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=dev)
    scale, pr = p.noise_scale0, p.patch_radius
    bounds = pm_bounds(Hs, Ws, D, vc.element_size(), p)

    d_k, c_k = cuda.pm_refresh_strip(vc, seed, noise, scale, pr)
    d_p, c_p = pm._refresh_strip_plain(vc, seed, noise, scale, pr)
    require_equal("pm_refresh_strip disp", d_k, d_p)
    require_equal("pm_refresh_strip cost", c_k, c_p)
    rows["pm_refresh_strip"] = dict(
        max_abs_err=max(max_abs(d_k, d_p), max_abs(c_k, c_p)),
        **summarize([measure("pm_refresh_strip",
                             lambda: cuda.pm_refresh_strip(vc, seed, noise, scale, pr),
                             lambda: pm._refresh_strip_plain(vc, seed, noise, scale, pr))]),
        **bounds["refresh"])

    err = 0.0
    for dtype, (v_row, v_col) in vols.items():
        def layout(axis, v_row=v_row, v_col=v_col):
            return v_row if axis == 1 else v_col

        err = max(err, check_passes(
            f"pm_propagate_strip {dtype}",
            lambda d, c, direction, axis: cuda.pm_propagate_strip(layout(axis), d, c, direction,
                                                                  axis, p.halo, pr),
            lambda d, c, direction, axis: pm._propagate_strip_plain(layout(axis), d, c,
                                                                    direction, axis, p),
            {"seeded": pm._refresh_strip_plain(v_col, seed, noise, scale, pr),
             "adversarial": adversarial_fronts(v_col, (Hs, Ws))}))
    calls = []
    for direction, axis in PASSES:
        V = vr if axis == 1 else vc
        calls.append(measure(
            "pm_propagate_strip",
            lambda: cuda.pm_propagate_strip(V, d_p, c_p, direction, axis, p.halo, pr),
            lambda: pm._propagate_strip_plain(V, d_p, c_p, direction, axis, p)))
        print(f"[strips] pm_propagate_strip dir={direction:+d} axis={axis}: "
              f"{times_line(calls[-1])}, {V.shape[1]} strips")
    rows["pm_propagate_strip"] = dict(max_abs_err=err, **summarize(calls), **bounds["propagate"])

    final = pm._propagate_strip_plain(vc, d_p, c_p, -1, 0, p)[0]
    m_k = cuda.pm_mask_background_strip(vc, final, p.improve_factor, pr)
    m_p = pm.mask_background_strip_plain(vc, final, p)
    require_equal("pm_mask_background_strip", m_k, m_p)
    rows["pm_mask_background_strip"] = dict(
        max_abs_err=max_abs(m_k, m_p),
        **summarize([measure("pm_mask_background_strip",
                             lambda: cuda.pm_mask_background_strip(vc, final, p.improve_factor, pr),
                             lambda: pm.mask_background_strip_plain(vc, final, p))]),
        **bounds["mask"])

    # The whole strip-volume match (K3' over K4's layouts): kernels vs twins.
    def match_plain():
        disp = seed
        for it in range(p.iters):
            disp, cost = pm._refresh_strip_plain(vc, disp, noise, p.noise_scale0 / 2.0**it, pr)
            for direction, axis in PASSES:
                V = vr if axis == 1 else vc
                disp, cost = pm._propagate_strip_plain(V, disp, cost, direction, axis, p)
        return pm.mask_background_strip_plain(vc, disp, p)

    full_k, full_p = pm._match_one_side_strips(vr, vc, seed, noise, p), match_plain()
    require_equal("match_one_side_strips", full_k, full_p)
    require_equal("match_one_side_strips vs the (H, W, D) match", full_k,
                  pm._match_one_side(C, seed, noise, p))
    k_ms = call_ms(lambda: pm._match_one_side_strips(vr, vc, seed, noise, p))
    hwd_ms = call_ms(lambda: pm._match_one_side(C, seed, noise, p))
    k_dev = graph_ms(lambda: pm._match_one_side_strips(vr, vc, seed, noise, p))
    hwd_dev = graph_ms(lambda: pm._match_one_side(C, seed, noise, p))
    p_ms = call_ms(match_plain, 5)
    print(f"[strips] match_one_side_strips (3 refresh + 12 passes + mask): call {k_ms:.4f} ms "
          f"vs (H, W, D) match {hwd_ms:.4f} ms; device (graph replay) {k_dev:.4f} vs "
          f"{hwd_dev:.4f} ms; plain {p_ms:.4f} ms, "
          f"valid {(full_k > 0).float().mean().item():.3f}")
    # The dense half on each layout, in turns (H, W, D), strips, strips,
    # (H, W, D): the volume build, seed, match, right WTA and subpixel.
    p_hwd = dataclasses.replace(p, use_strip_volumes=False)
    turns = [call_ms(lambda q=q: pm.patchmatch_disparity(iml, imr, q), 10)
             for q in (p_hwd, p, p, p_hwd)]
    print(f"[strips] patchmatch_disparity at {Hs}x{Ws}, in turns: (H, W, D) {turns[0]:.4f}, "
          f"strips {turns[1]:.4f}, strips {turns[2]:.4f}, (H, W, D) {turns[3]:.4f} ms")
    for name, row in rows.items():
        print(f"[strips] {name}: {times_line(row)}; bound {row['bound_ms']:.5f} ms "
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


def phase_engines(left_rgb, right_rgb, rig) -> dict:
    """The other stereo configurations at 720p: N_ENGINE_FRAMES timed frames
    each after a warm-up, launch counts, accuracy, and one frame against
    the CPU (within 1e-3 px on >= 99% of pixels)."""
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
            {"cost_volume": 1, "pm_refresh": 6, "pm_propagate": 24, "pm_mask_background": 2}),
        "patchmatch zncc": (lambda l, r, dev: dense_disparity(l, r, pm.PatchMatchParams(
            max_disp=D, right_wta=True, cost="zncc"), dev),
            {"pm_refresh": 3, "pm_propagate": 12, "pm_mask_background": 1}),
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
    return results


def lk_bounds(calls: list) -> dict:
    """Bounds of one frame's 8 lk_prep and 8 lk_walk launches, per launch.
    lk_prep: for each point, the two ST^2 and ws^2 windows read and the
    (2, A, A) surfaces and 8 scalars written; its operations are the
    recentring products, the 5 window sums and the 2*A*A surface sums of
    win^2 multiply-adds. lk_walk: corr, scal and pos0 read, pos and hit
    written; at most max_iters steps of 2*A*A multiply-adds a point, which
    never outweighs its bytes, so it is bytes-bound whatever the data."""
    prep, walk = [], []
    for name, args, kwargs, _ in calls:
        if name == "lk_prep":
            K, win, slack = args[2].shape[0], kwargs["win"], kwargs["slack"]
            ST, ws, P = win + 3, win + 2 * (slack + 1), win + 2
            A = ws - win + 1
            nbytes = K * (4 * (ST * ST + ws * ws) + 4 * 6 + 4 * (2 * A * A + 8) + 1)
            flops = K * 2 * (P * ST * ST + P * P * ST + 5 * win * win + 2 * A * A * win * win)
            prep.append(bound(nbytes, flops))
        else:
            corr, scal, pos0 = args[:3]
            K = corr.shape[0]
            nbytes = 4 * (corr.numel() + scal.numel() + 2 * pos0.numel()) + K
            walk.append(bound(nbytes))
    return {name: dict(bound_ms=statistics.mean(b["bound_ms"] for b in rows),
                       bound_by=rows[0]["bound_by"])
            for name, rows in (("lk_prep", prep), ("lk_walk", walk))}


def record_lk_calls(fn) -> list:
    """Run fn() and return, for every lk_prep and lk_walk call it made in
    order, (name, args, kwargs, launch): the dispatcher's arguments, the exact
    inputs the main path gives the two kernels, for the plain twin; and the
    arguments the dispatcher handed its kernel wrapper, to time the kernel
    alone."""
    names = ("lk_prep", "lk_walk")
    calls, launches = [], []
    orig = {name: getattr(lk, name) for name in names}
    wrappers = {name: getattr(cuda, name) for name in names}

    def spy(name):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return orig[name](*args, **kwargs)
        return call

    def spy_wrapper(name):
        def call(*args):
            launches.append(args)
            return wrappers[name](*args)
        return call

    try:
        for name in names:
            setattr(lk, name, spy(name))
            setattr(cuda, name, spy_wrapper(name))
        fn()
    finally:
        for name in names:
            setattr(lk, name, orig[name])
            setattr(cuda, name, wrappers[name])
    if len(launches) != len(calls):
        raise AssertionError(f"{len(calls)} LK calls launched {len(launches)} kernels")
    return [(*call, launch) for call, launch in zip(calls, launches)]


def phase_lk_kernels(calls: list) -> dict:
    """lk_prep and lk_walk against their twins on one frontend frame's
    recorded inputs (4 levels, forward then backward): bit-identical; then
    each call's times, averaged over the frame's 8 launches of each."""
    plain = {"lk_prep": lk.lk_prep_plain, "lk_walk": lk.lk_walk_plain}
    kernel = {"lk_prep": lk.lk_prep, "lk_walk": lk.lk_walk}
    errs, times = {name: 0.0 for name in plain}, {name: [] for name in plain}
    if [c[0] for c in calls] != ["lk_prep", "lk_walk"] * 8:
        raise AssertionError(f"expected 8 prep/walk pairs, got {[c[0] for c in calls]}")
    for i, (name, args, kwargs, launch) in enumerate(calls):
        got = kernel[name](*args, **kwargs)
        want = plain[name](*args, **kwargs)
        for a, b in zip(got, want):
            fa, fb = a.float().nan_to_num(-1e30), b.float().nan_to_num(-1e30)
            require_equal(f"{name} call {i}", fa, fb)
            errs[name] = max(errs[name], max_abs(fa, fb))
        times[name].append(measure(name, lambda: getattr(cuda, name)(*launch),
                                   lambda: plain[name](*args, **kwargs), 5))
        shape = "x".join(str(d) for d in args[0].shape)
        print(f"[lk] {name} call {i} ({shape}): {times_line(times[name][-1])}")
    bounds = lk_bounds(calls)
    rows = {}
    for name in plain:
        rows[name] = row = dict(max_abs_err=errs[name], **summarize(times[name]), **bounds[name])
        print(f"[lk] {name}, a launch (mean of 8): {times_line(row)}; bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), max |diff| {row['max_abs_err']}")
    return rows


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
                out=outs[-1])


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

    rows = phase_kernels(left_rgb, right_rgb)
    launches, disp, runs = phase_end_to_end(left_rgb, right_rgb, rig, config)
    phase_graph(left_rgb, right_rgb, rig, config, disp, runs)
    phase_stage_times(left_rgb, right_rgb, rig, config)
    phase_cpu_parity(left_rgb, right_rgb, rig, config, disp)

    rows.update(phase_strip_kernels(left_rgb, right_rgb))
    strip_config = dataclasses.replace(config, use_strip_volumes=True)
    strip_launches, strip_disp, strip_runs = phase_end_to_end(left_rgb, right_rgb, rig,
                                                              strip_config, "strip e2e",
                                                              PER_STRIP_FRAME)
    require_equal("strip-volume perception disparity vs the (H, W, D) path's", strip_disp, disp)
    phase_graph(left_rgb, right_rgb, rig, strip_config, disp, strip_runs, "strip graph")
    phase_engines(left_rgb, right_rgb, rig)

    fe = phase_frontend(canvas, rig, config, dev)
    rows.update(phase_lk_kernels(fe["calls"]))
    phase_frontend_stage_times(fe, rig, config)
    phase_frontend_cpu_parity(fe, rig, config)

    # Launches on each kernel's own path: the (H, W, D) PatchMatch kernels'
    # from perception_step, the strip kernels' from perception_step with
    # strip volumes, LK's from full_frontend_step.
    launches.update({k: strip_launches[k] for k in PER_STRIP_FRAME})
    launches.update({k: fe["launches"][k] for k in ("lk_prep", "lk_walk")})
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
