"""Multi-device dry run of the sharded step (port of
``__graft_entry__.dryrun_multichip``).

Runs each sharded form once on a mesh over ``devices`` and prints what the
JAX dry run prints: the camera-split dense step and fleet mean, the
camera-split full frontend over two frames, the enhancement with rows split
over a ('cam', 'strip') mesh, and one frame's PatchMatch with its rows
split over every device. Entries may repeat: ``["cpu"] * 8`` plays eight
devices on the CPU, ``["cuda:0"] * 4`` four on one card.

    python -m ocean_perception_tpu_torch.parallel.dryrun --devices cpu cpu cpu cpu
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from ..core.cameras import PinholeCamera, StereoCamera
from ..mesher.object_mesher import ObjectMesherDeviceParams
from ..models.perception import PerceptionConfig
from ..stereo.patchmatch import PatchMatchParams
from ..tracking.detector import DetectorParams
from ..tracking.lk import LKParams
from ..tracking.stereo_tracker import StereoTrackerParams
from ..tracking.stripe_match import StripeMatcherParams
from .mesh import camera_sharding, make_mesh
from .sharded_pipeline import (create_fleet_frontend_state, multi_camera_frontend_step,
                               multi_camera_step)
from .spatial import sharded_enhance
from .stereo_sharded import sharded_patchmatch


def tiny_inputs(n: int | None = None, H: int = 64, W: int = 96):
    """The JAX dry run's synthetic stereo pair (4 px disparity), or n copies."""
    rng = np.random.default_rng(0)
    canvas = rng.random((H, W + 32)).astype(np.float32)
    left = canvas[:, 16:16 + W]
    right = np.roll(canvas, 4, axis=1)[:, 16:16 + W]
    tint = np.array([0.35, 0.75, 0.9], np.float32)
    lf = np.clip(left[..., None] * tint + 0.05, 0, 1)
    rf = np.clip(right[..., None] * tint + 0.05, 0, 1)
    if n is None:
        return torch.from_numpy(lf), torch.from_numpy(rf)
    return (torch.from_numpy(np.broadcast_to(lf, (n,) + lf.shape).copy()),
            torch.from_numpy(np.broadcast_to(rf, (n,) + rf.shape).copy()))


def tiny_rig(H: int = 64, W: int = 96) -> StereoCamera:
    cam = PinholeCamera.create(80.0, 80.0, W / 2, H / 2, H, W)
    return StereoCamera.create(cam, cam, baseline=0.12)


def tiny_mesher_params() -> ObjectMesherDeviceParams:
    """The JAX dry run's small tracker and landmark graph."""
    return ObjectMesherDeviceParams(
        tracker=StereoTrackerParams(
            capacity=32,
            detector=DetectorParams(max_features=32, min_distance=6, border=4),
            lk=LKParams(max_level=1),
            matcher=StripeMatcherParams(max_disp=16, templ_cols=9, templ_rows=7,
                                        max_matching_cost=0.5),
        ),
        min_obs_connect_edge=2.0,
        min_obs_disconnect_edge=1.0,
    )


def dryrun_multichip(devices: Sequence) -> None:
    """Every sharded form once over a mesh of ``devices`` (see the module
    docstring); the outputs' checks are those of the JAX dry run."""
    n_devices = len(devices)
    mesh = make_mesh(axis_names=("cam",), devices=devices)
    rig = tiny_rig()
    config = PerceptionConfig(engine="patchmatch", max_disp=32, internal_scale=1)

    n_cams = 2 * n_devices
    bl, br = tiny_inputs(n_cams)
    out, stats = multi_camera_step(bl, br, rig, config, mesh=mesh)
    assert out.disparity.shape == (n_cams, 64, 96)
    assert stats.global_mean_depth.shape == ()
    print(f"dryrun_multichip ok: {n_devices} devices, {n_cams} cameras, "
          f"global mean depth {float(stats.global_mean_depth):.3f} m, "
          f"valid fraction {float(stats.valid_fraction.mean()):.3f}")

    # The full frontend under the camera split: the state threads between
    # frames, each camera's share on its device.
    mp = tiny_mesher_params()
    lead = mesh.devices.reshape(-1)[0]
    states, graphs = create_fleet_frontend_state(n_devices, mp, device=lead)
    bl1, br1 = tiny_inputs(n_devices)
    prev_grays = bl1.mean(dim=-1)
    fe_config = PerceptionConfig(engine="wta", max_disp=16, internal_scale=1)
    for _ in range(2):
        out_ff, cur_grays = multi_camera_frontend_step(states, graphs, prev_grays, bl1, br1, rig,
                                                       fe_config, mp, mesh=mesh)
        states, graphs, prev_grays = out_ff.tracker_state, out_ff.graph, cur_grays
    n_alive = int(out_ff.mesher.alive.sum())
    print(f"dryrun full-frontend ok: {n_devices} cameras over {n_devices} devices, "
          f"{n_alive} live landmarks, disparity sharding {camera_sharding(mesh).spec}")

    if n_devices % 2 == 0:
        mesh2 = make_mesh(axis_names=("cam", "strip"), shape=(n_devices // 2, 2),
                          devices=devices)
        left, _ = tiny_inputs()
        rng_img = torch.full(left.shape[:2], 2.0)
        enhanced, info = sharded_enhance(left, rng_img, mesh2)
        assert enhanced.shape == left.shape
        print(f"dryrun strip-sharded enhance ok: mesh {dict(cam=n_devices // 2, strip=2)}, "
              f"backscatter err {float(info.error_backscatter):.4f}")

    # One frame's rows solved by all devices (halo exchange between blocks).
    Hs, Ws, d_true = 24 * n_devices, 128, 4
    rng = np.random.default_rng(1)
    canvas = rng.random((Hs, Ws + 32)).astype(np.float32)
    gl = torch.from_numpy(canvas[:, 16:16 + Ws].copy())
    gr = torch.from_numpy(canvas[:, 16 + d_true:16 + d_true + Ws].copy())
    mesh_s = make_mesh(axis_names=("strip",), devices=devices)
    pm = PatchMatchParams(max_disp=16, chunks=4, iters=2, right_wta=True, init_dilate_factor=3)
    res = sharded_patchmatch(gl, gr, mesh_s, pm)
    disp = res.left.cpu().numpy()
    valid = disp > 0
    median = float(np.median(disp[valid])) if valid.any() else -1
    print(f"dryrun strip-sharded patchmatch ok: 1 frame over {n_devices} devices, "
          f"{valid.mean():.2f} valid, median disp {median:.1f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", nargs="+", default=None,
                    help="mesh entries, e.g. cpu cpu cpu cpu (default: every card)")
    args = ap.parse_args(argv)
    devices = args.devices
    if devices is None:
        devices = make_mesh().devices.reshape(-1).tolist()
    dryrun_multichip(devices)


if __name__ == "__main__":
    main()
