#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``ocean_perception_tpu_torch.models.perception.perception_step`` at
the bench's full width (1280x720 RGB, max_disp=128, internal_scale=2,
enhancement on) on a synthetic stereo scene of known disparity, in phases:

1. device: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels from ``csrc/``;
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   720p path gives it (bit-identical), with both times;
4. end to end: 8 frames, checking the kernels' launch counts, finite outputs
   and the disparity against the scene's truth;
5. the same frame through the port on the CPU (plain twins), against the card.

Any failure raises and exits nonzero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit; the one before that lists each kernel with its launches on the
main path, its error against the plain twin and both times.

Run: ``python chip_smoke.py`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gradient_magnitude, pyr_down, to_grayscale
from ocean_perception_tpu_torch.stereo import patchmatch as pm
from ocean_perception_tpu_torch.stereo.cost import cost_volume_plain

H, W = 720, 1280
MAX_DISP, SCALE = 128, 2
TRUE_DISP = 8
N_FRAMES = 8
N_TIMED = 20
# Launches of each kernel per frame of the main path.
PER_FRAME = {"cost_volume": 1, "pm_refresh": 3, "pm_propagate": 12, "pm_mask_background": 1}
SOURCES = {
    "cost_volume": ("ocean_perception_tpu_torch/csrc/cost_volume.cu",
                    "ocean_perception_tpu/ops/pallas/cost_volume.py:97"),
    "pm_refresh": ("ocean_perception_tpu_torch/csrc/patchmatch.cu",
                   "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:580"),
    "pm_propagate": ("ocean_perception_tpu_torch/csrc/patchmatch.cu",
                     "ocean_perception_tpu/ops/pallas/propagate.py:115"),
    "pm_mask_background": ("ocean_perception_tpu_torch/csrc/patchmatch.cu",
                           "ocean_perception_tpu/ops/pallas/fused_patchmatch.py:580"),
}
PASSES = ((+1, 1), (+1, 0), (-1, 1), (-1, 0))  # R+ C+ R- C-


def make_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Synthetic 720p stereo scene (bench.py's recipe): right(y, x - 8) == left(y, x)."""
    rng = np.random.default_rng(0)
    canvas = rng.random((H, W + 200)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)
    left = canvas[:, 100 : 100 + W]
    right = canvas[:, 100 + TRUE_DISP : 100 + TRUE_DISP + W]
    tint = np.array([0.35, 0.75, 0.9], np.float32)
    left_rgb = np.clip(left[..., None] * tint + 0.05, 0, 1).astype(np.float32)
    right_rgb = np.clip(right[..., None] * tint + 0.05, 0, 1).astype(np.float32)
    return left_rgb, right_rgb


def gpu_ms(fn, n: int = N_TIMED) -> float:
    """Median device time of fn() in ms over n runs, after two warm-ups."""
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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def require_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel differs from its plain twin "
                             f"(max |diff| {max_abs(a, b)})")


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


def phase_kernels(left_rgb: torch.Tensor, right_rgb: torch.Tensor) -> dict:
    """Each kernel against its plain twin on identical inputs at 720p shapes."""
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
    rows["cost_volume"] = dict(
        max_abs_err=max_abs(C, C_plain),
        ms=gpu_ms(lambda: cuda.cost_volume(iml, imr, gl, gr, D, a, b, torch.bfloat16)),
        plain_ms=gpu_ms(lambda: cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16)),
    )

    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=dev)
    scale, pr = p.noise_scale0, p.patch_radius

    def refresh_plain(disp):
        disp = pm.add_foreground_noise(disp, noise, scale)
        return disp, pm._full_cost_map(C, disp, pr)

    d_k, c_k = cuda.pm_refresh(C, seed, noise, scale, pr)
    d_p, c_p = refresh_plain(seed)
    require_equal("pm_refresh disp", d_k, d_p)
    require_equal("pm_refresh cost", c_k, c_p)
    rows["pm_refresh"] = dict(
        max_abs_err=max(max_abs(d_k, d_p), max_abs(c_k, c_p)),
        ms=gpu_ms(lambda: cuda.pm_refresh(C, seed, noise, scale, pr)),
        plain_ms=gpu_ms(lambda: refresh_plain(seed)),
    )

    err, ms, plain_ms = 0.0, [], []
    for direction, axis in PASSES:
        dim = W // SCALE if axis == 1 else H // SCALE
        chunks = pm._effective_chunks(dim, p.chunks)

        def kernel():
            return cuda.pm_propagate(C, d_p, c_p, direction, axis, chunks, p.halo, pr)

        def plain():
            return pm._propagate_plain(C, d_p, c_p, direction, axis, p)

        (dk, ck), (dp, cp) = kernel(), plain()
        tag = f"pm_propagate dir={direction:+d} axis={axis}"
        require_equal(tag + " disp", dk, dp)
        require_equal(tag + " cost", ck, cp)
        err = max(err, max_abs(dk, dp), max_abs(ck, cp))
        ms.append(gpu_ms(kernel))
        plain_ms.append(gpu_ms(plain))
        print(f"[kernels] {tag}: {ms[-1]:.4f} ms vs plain {plain_ms[-1]:.4f} ms, {chunks} strips")
    rows["pm_propagate"] = dict(max_abs_err=err, ms=statistics.mean(ms), plain_ms=statistics.mean(plain_ms))

    final = pm._propagate_plain(C, d_p, c_p, -1, 0, p)[0]
    m_k = cuda.pm_mask_background(C, final, p.improve_factor, pr)
    m_p = pm.mask_background_plain(C, final, p)
    require_equal("pm_mask_background", m_k, m_p)
    rows["pm_mask_background"] = dict(
        max_abs_err=max_abs(m_k, m_p),
        ms=gpu_ms(lambda: cuda.pm_mask_background(C, final, p.improve_factor, pr)),
        plain_ms=gpu_ms(lambda: pm.mask_background_plain(C, final, p)),
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
    k_ms = gpu_ms(lambda: pm._match_one_side(C, seed, noise, p))
    p_ms = gpu_ms(match_plain)
    print(f"[kernels] match_one_side (3 refresh + 12 passes + mask): {k_ms:.4f} ms "
          f"vs plain {p_ms:.4f} ms, valid {(full_k > 0).float().mean().item():.3f}")
    for name, row in rows.items():
        print(f"[kernels] {name}: {row['ms']:.4f} ms vs plain {row['plain_ms']:.4f} ms, "
              f"max |diff| {row['max_abs_err']}")
    return rows


def phase_end_to_end(left_rgb, right_rgb, rig, config) -> tuple[dict, torch.Tensor]:
    """N_FRAMES perturbed frames through perception_step; checks launches,
    finiteness and accuracy; returns the launch counts and frame 0's disparity."""
    frames = [left_rgb + float(i) * 1e-6 for i in range(N_FRAMES)]
    perception_step(frames[0], right_rgb, rig, config)  # warm-up
    torch.cuda.synchronize()

    cuda.reset_launches()
    digest = torch.zeros((), device=left_rgb.device, dtype=torch.float64)
    outs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for f in frames:
        out = perception_step(f, right_rgb, rig, config)
        # Consume every output, so no stage's work can be skipped.
        digest += out.disparity.sum() + out.depth.sum() + out.enhanced_left.sum()
        outs.append(out)
    end.record()
    end.synchronize()
    launches = dict(cuda.LAUNCHES)
    ms_frame = start.elapsed_time(end) / N_FRAMES

    for name, per in PER_FRAME.items():
        if launches[name] != per * N_FRAMES:
            raise AssertionError(f"{name}: {launches[name]} launches over {N_FRAMES} frames, "
                                 f"expected {per * N_FRAMES}")
    for i, out in enumerate(outs):
        for field, t in out._asdict().items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"frame {i}: non-finite {field}")
        if out.disparity.shape != (H, W) or out.enhanced_left.shape != (H, W, 3):
            raise AssertionError(f"frame {i}: bad output shapes")
    disp = outs[0].disparity
    valid = disp > 0
    med = float((disp[valid] - TRUE_DISP).abs().median())
    frac = float(valid.float().mean())
    if not med < 1.0:
        raise AssertionError(f"median |disp - {TRUE_DISP}| = {med} px over valid pixels")
    if not frac > 0.5:
        raise AssertionError(f"valid fraction {frac}")
    print(f"[e2e] {N_FRAMES} frames: {ms_frame:.3f} ms/frame ({1000.0 / ms_frame:.1f} fps), "
          f"median |disp - {TRUE_DISP}| {med:.4f} px, valid {frac:.4f}, digest {float(digest):.6e}, "
          f"launches {launches}")
    return launches, disp


def phase_stage_times(left_rgb, right_rgb, rig, config) -> None:
    """Device time of each stage of perception_step, one frame at a time."""
    from ocean_perception_tpu_torch.imaging.enhance import enhance_underwater
    from ocean_perception_tpu_torch.ops.image import resize
    from ocean_perception_tpu_torch.stereo.cost import cost_volume, subpixel_refine

    p = pm.PatchMatchParams(max_disp=MAX_DISP // SCALE, right_wta=True, volume_bf16=True)
    st = {}
    st["gray+pyr_down"] = gpu_ms(lambda: (pyr_down(to_grayscale(left_rgb)), pyr_down(to_grayscale(right_rgb))))
    iml, imr = pyr_down(to_grayscale(left_rgb)), pyr_down(to_grayscale(right_rgb))
    st["sobel"] = gpu_ms(lambda: (gradient_magnitude(iml), gradient_magnitude(imr)))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    st["cost_volume"] = gpu_ms(lambda: cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, torch.bfloat16))
    C = cost_volume(iml, imr, p.max_disp, p.alpha, gl, gr, torch.bfloat16)
    st["noise"] = gpu_ms(lambda: pm.unit_noise(iml.shape, p.noise_seed, device=iml.device))
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=iml.device)
    st["sparse_wta_seed"] = gpu_ms(lambda: pm.sparse_wta_seed(C, p))
    seed = pm.sparse_wta_seed(C, p)
    st["patchmatch"] = gpu_ms(lambda: pm._match_one_side(C, seed, noise, p))
    disp_l = pm._match_one_side(C, seed, noise, p)

    def post():
        disp_r = pm.right_wta_from_left(C, p)
        int_l = torch.round(disp_l).clamp(0, p.max_disp - 1).long()
        d = torch.where(disp_l > 0, subpixel_refine(C, int_l), 0.0)
        d = pm.mask_occlusions(d, disp_r, p)
        d = resize(d, (H, W), method="nearest") * float(SCALE)
        z = rig.disp_to_depth(d)
        return torch.where(torch.isfinite(z) & (z <= config.max_depth), z, 0.0)

    st["right_wta+subpixel+occlusion+depth"] = gpu_ms(post)
    depth = post()
    st["enhance"] = gpu_ms(lambda: enhance_underwater(left_rgb, depth, config.enhance), 10)
    total = sum(st.values())
    for k, v in st.items():
        print(f"[stages] {k}: {v:.4f} ms ({100.0 * v / total:.1f}%)")
    print(f"[stages] sum {total:.4f} ms")


def phase_cpu_parity(left_rgb, right_rgb, rig, config, disp_gpu: torch.Tensor) -> None:
    t0 = time.perf_counter()
    disp_cpu = perception_step(left_rgb.cpu(), right_rgb.cpu(), rig, config).disparity
    diff = (disp_gpu.cpu() - disp_cpu).abs()
    close = float((diff <= 1e-3).float().mean())
    med = float(diff.median())
    print(f"[cpu] one frame on the CPU in {time.perf_counter() - t0:.1f} s: "
          f"{100 * close:.3f}% of pixels within 1e-3 px, median |diff| {med}, max {float(diff.max())}")
    if close < 0.99 or med != 0.0:
        raise AssertionError("card and CPU disparities disagree")


def main() -> int:
    name, smi = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    left_np, right_np = make_inputs()
    left_rgb = torch.as_tensor(left_np, device=dev)
    right_rgb = torch.as_tensor(right_np, device=dev)
    cam = PinholeCamera.create(700.0, 700.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=MAX_DISP, internal_scale=SCALE)

    rows = phase_kernels(left_rgb, right_rgb)
    launches, disp = phase_end_to_end(left_rgb, right_rgb, rig, config)
    phase_stage_times(left_rgb, right_rgb, rig, config)
    phase_cpu_parity(left_rgb, right_rgb, rig, config, disp)

    kernels = [
        dict(name=k, route="cuda", source=SOURCES[k][0], replaces=SOURCES[k][1],
             launches=launches[k], **rows[k])
        for k in PER_FRAME
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
