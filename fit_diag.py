#!/usr/bin/env python
"""Where a camera's Sea-thru fit departs from its one-camera fit in a fleet call.

Runs ``perception_step`` at the farm point (uint8 mono 1280x720 frames,
``internal_scale=4``, ``max_disp=128``) on the fleet of ``chip_smoke.py``
phase 13 (N_CAMERAS cameras, camera b's frame i the sequence's frame
i + FLEET_PHASE * b, frames 5 to 12) once as a batch and once a camera, and
records every Levenberg-Marquardt step of the two Sea-thru fits
(``estimate_backscatter`` and the attenuation multi-start), so that a
camera's steps in the batch can be held to its steps alone:

- for each fit, the first iteration at which the step's inputs differ (the
  damped system for a tree whose LM calls ``torch.linalg.solve_ex``, the
  weighted J, r and lambda for one that calls ``ops/lm.py::lm_step``) and
  the first at which the step differs, with the final error, accepted
  steps, lambda and parameters, batched and alone;
- whether each camera's enhanced image is bit-identical, and its max.

On a tree with ``csrc/lm_solve.cu`` it first holds ``lm_solve_small`` and
``lm_row_sum`` to their twins on the recorded systems, bit for bit. On a
tree whose fits are one ``sea_thru_fit`` launch each, the fits run their
loop with the LM kernels instead (bit for bit the kernel's result,
``chip_smoke.py`` phase 3), so that each step can be recorded.

Run on the GPU: ``python fit_diag.py [--tree DIR] [--save DIR]``: ``--tree``
imports the package from another checkout (say the parent's, unpacked with
``git archive``); ``--save`` writes the depth maps of the frame whose
batched enhanced image strays furthest, for the JAX check below.

Run on the CPU with JAX: ``python fit_diag.py --jax DIR`` runs camera 1's
frame of that save through the JAX package's ``enhance_underwater`` alone
and under ``jax.vmap`` with its neighbours, and prints both.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

FRAMES = range(5, 13)  # chip_smoke.py phase 13's timed calls
_CANVAS: dict = {}


def fleet_frames(i: int):
    """(N, H, W) uint8 left and right frames of fleet call i."""
    import chip_smoke as cs

    if "canvas" not in _CANVAS:
        _CANVAS["canvas"] = cs.make_canvas()
    canvas = _CANVAS["canvas"]
    pairs = [cs.make_mono_u8(canvas, i + cs.FLEET_PHASE * b) for b in range(cs.N_CAMERAS)]
    return tuple(np.stack(side) for side in zip(*pairs))


class Recorder:
    """Records each LM step of the fits, tagged by fit, while on."""

    def __init__(self):
        self.fits: list = []

    def install(self):
        from ocean_perception_tpu_torch.imaging import attenuation, backscatter
        from ocean_perception_tpu_torch.ops import lm
        import torch

        from ocean_perception_tpu_torch.ops import cuda

        rec = self
        if hasattr(cuda, "sea_thru_fit"):
            # On the card a fit is one sea_thru_fit launch, bit for bit its
            # loop with the LM kernels (chip_smoke.py checks it): run the
            # loop, whose steps can be recorded.
            import chip_smoke as cs

            cuda.sea_thru_fit = lambda model, *a: cs.FIT_PLAIN[model](*a, kernels=True)
        for mod, tag in ((backscatter, "backscatter"), (attenuation, "attenuation")):
            inner = mod.lm_solve

            def wrapped(*a, _inner=inner, _tag=tag, **k):
                rec.fits.append(dict(tag=_tag, steps=[]))
                res = _inner(*a, **k)
                rec.fits[-1]["result"] = res
                return res

            mod.lm_solve = wrapped
        if hasattr(lm, "lm_step"):
            step = lm.lm_step

            def lm_step(J, r, lam, marquardt):
                d = step(J, r, lam, marquardt)
                rec.fits[-1]["steps"].append(dict(inputs=(J, r, lam), delta=d,
                                                  marquardt=marquardt))
                return d

            lm.lm_step = lm_step
            return
        solve_ex = torch.linalg.solve_ex

        def recording_solve_ex(A, B, **k):
            d, info = solve_ex(A, B, **k)
            rec.fits[-1]["steps"].append(dict(inputs=(A, B), delta=d))
            return d, info

        torch.linalg.solve_ex = recording_solve_ex


def equal(a, b) -> bool:
    import torch

    return torch.equal(a, b)


def compare_fit(batched: dict, alone: dict, b: int) -> str:
    """Camera b's steps of one fit in the batch against its steps alone."""
    first_in = first_out = None
    for k, (sb, sa) in enumerate(zip(batched["steps"], alone["steps"])):
        if first_in is None and not all(equal(x[b], y) for x, y in zip(sb["inputs"], sa["inputs"])):
            first_in = k
        if first_out is None and not equal(sb["delta"][b], sa["delta"]):
            first_out = k
    rb, ra = batched["result"], alone["result"]

    def fmt(r, sel):
        x = r.x if sel is None else r.x[sel]
        e, n, lam = (t if sel is None else t[sel] for t in (r.error, r.n_accepted, r.lambda_))
        return (f"error {e.cpu().numpy().tolist()}, accepted {n.cpu().numpy().tolist()}, "
                f"lambda {lam.cpu().numpy().tolist()}, x {np.array2string(x.cpu().numpy(), precision=6, max_line_width=400)}")

    return (f"{batched['tag']}: inputs first differ at step {first_in}, step first differs at "
            f"{first_out} of {len(alone['steps'])}; batched {fmt(rb, b)}; alone {fmt(ra, None)}")


def check_kernels(rec: Recorder) -> None:
    """lm_solve_small and lm_row_sum against their twins on the recorded
    systems of one batched call, and each system alone."""
    import torch
    from ocean_perception_tpu_torch.ops import cuda, lm

    for fit in rec.fits:
        for s in fit["steps"][:3]:
            J, r, lam = s["inputs"]
            want = lm.lm_step_plain(J, r, lam, s["marquardt"])
            got = cuda.lm_solve_small(J, r, lam, s["marquardt"])
            if not torch.equal(got, want):
                raise AssertionError(f"lm_solve_small differs from its twin on {fit['tag']}: "
                                     f"max {float((got - want).abs().max())}")
            one = cuda.lm_solve_small(J[1].contiguous(), r[1].contiguous(),
                                      lam[1].contiguous(), s["marquardt"])
            if not torch.equal(one, got[1]):
                raise AssertionError(f"lm_solve_small: system 1 alone differs from its batch")
            rows = (J * J).transpose(-1, -2).contiguous()
            if not torch.equal(cuda.lm_row_sum(rows), lm.tree_sum_plain(rows)):
                raise AssertionError("lm_row_sum differs from its twin")
    print(f"[kernels] lm_solve_small and lm_row_sum bit-identical to their twins on "
          f"{len(rec.fits)} fits' first steps, systems {[tuple(f['steps'][0]['inputs'][0].shape) for f in rec.fits]}")


def run_gpu(save: Path | None, device: str = "cuda") -> int:
    import torch
    import chip_smoke as cs
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
    from ocean_perception_tpu_torch.ops import cuda
    from ocean_perception_tpu_torch.parallel.sharded_pipeline import prepare_frames

    name, smi = cs.phase_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        cuda.build()
    cam = PinholeCamera.create(700.0, 700.0, cs.W / 2, cs.H / 2, cs.H, cs.W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=cs.MAX_DISP,
                              internal_scale=cs.FARM_SCALE)
    rec = Recorder()
    rec.install()
    B = cs.N_CAMERAS
    worst = (-1.0, None)
    summary = []
    for i in FRAMES:
        left, right = (prepare_frames(torch.as_tensor(t, device=dev), dev) for t in fleet_frames(i))
        rec.fits = []
        out = perception_step(left, right, rig, config, dev)
        batched = rec.fits
        if i == FRAMES[0] and hasattr(cuda, "lm_solve_small") and dev.type == "cuda":
            check_kernels(rec)
        for b in range(B):
            rec.fits = []
            one = perception_step(left[b], right[b], rig, config, dev)
            alone = rec.fits
            same = equal(out.enhanced_left[b], one.enhanced_left)
            mb, ma = float(out.enhanced_left[b].abs().max()), float(one.enhanced_left.abs().max())
            summary.append(same)
            print(f"[fit] call {i} camera {b}: enhanced bit-identical {same}, max |enhanced| "
                  f"batched {mb:.6e}, alone {ma:.6e}")
            if not same:
                for fb, fa in zip(batched, alone):
                    print(f"[fit]   {compare_fit(fb, fa, b)}")
            if mb > worst[0]:
                worst = (mb, (i, out.depth))
    print(f"[fit] enhanced images bit-identical to the one-camera call in {sum(summary)} of "
          f"{len(summary)} (camera, call) pairs; {smi}")
    if save is not None:
        i, depth = worst[1]
        save.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(save / "depth.npz", call=i, depth=depth.cpu().numpy())
        print(f"[fit] saved call {i}'s depth maps to {save}")
    print(json.dumps({"ok": True, "identical": sum(summary), "pairs": len(summary)}))
    return 0


def run_jax(save: Path) -> int:
    """Camera 1's frame of the save through the JAX enhance, alone and
    under jax.vmap with its neighbours (on the CPU, float32)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ocean_perception_tpu.imaging.enhance import EnhanceParams, enhance_underwater

    data = np.load(save / "depth.npz")
    i, depth = int(data["call"]), data["depth"].astype(np.float32)
    left, _ = fleet_frames(i)
    img = np.repeat((left.astype(np.float32) / np.float32(255.0))[..., None], 3, -1)
    fn = jax.jit(lambda im, z: enhance_underwater(im, z, EnhanceParams())[0])
    alone = np.asarray(fn(jnp.asarray(img[1]), jnp.asarray(depth[1])))
    many = np.asarray(jax.jit(jax.vmap(lambda im, z: enhance_underwater(im, z, EnhanceParams())[0]))(
        jnp.asarray(img), jnp.asarray(depth)))
    for b in range(len(img)):
        print(f"[jax] call {i} camera {b}: vmap max |enhanced| {np.abs(many[b]).max():.6e}")
    print(f"[jax] call {i} camera 1: alone max |enhanced| {np.abs(alone).max():.6e}, under vmap "
          f"{np.abs(many[1]).max():.6e}, bit-identical {np.array_equal(alone, many[1])}, max "
          f"|diff| {np.abs(alone - many[1]).max():.6e}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, help="import the package from this checkout")
    ap.add_argument("--save", type=Path, help="save the worst call's depth maps here")
    ap.add_argument("--jax", type=Path, help="CPU: the JAX enhance on a saved call")
    args = ap.parse_args()
    if args.jax is not None:
        return run_jax(args.jax)
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    return run_gpu(args.save)


if __name__ == "__main__":
    sys.exit(main())
