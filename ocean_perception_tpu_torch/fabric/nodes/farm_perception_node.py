"""Farm perception node: N synchronized stereo cameras through ONE batched
step on the card, then per-camera obstacle meshes (and optionally enhanced
frames). Port of ``ocean_perception_tpu.fabric.nodes.farm_perception_node``.

A static multi-camera sensor package (a "farm package") sends N stereo
streams; the reference runs one object_mesher_lcm process per camera. Here
the N streams are a leading camera axis of one call,
``parallel/sharded_pipeline.multi_camera_frontend_step``: one dispatch a
fleet frame runs enhance, disparity, depth, feature tracking and landmark
clustering for every camera on one card (every kernel launch carries all
cameras). The host then runs the per-cluster Delaunay of each fresh camera
(``mesher.object_mesher.build_meshes``) and publishes its mesh.

Batching policy: frames are collected per camera and a fleet step fires
when every camera has a fresh frame, or when the oldest waiting frame
exceeds ``max_sync_wait_sec``: a dead camera must not stall the fleet.
Stale slots are filled with the camera's last frame so shapes stay the same;
their outputs are not re-published. Frames that arrive as uint8 or mono stay
compact until the card (``prepare_frames`` casts and broadcasts there).

The node runs on ``device``, the card by default; it raises at construction
without one unless it is given ``device="cpu"``.

Run: ``python -m ocean_perception_tpu_torch.fabric.nodes.farm_perception_node
--config config/nodes/FarmPerceptionNode.yaml --shared config/shared/Farmsim.yaml``
(``--device cpu`` to run without a card, ``--lcm`` for the LCM wire format).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...core.cameras import PinholeCamera, StereoCamera
from ...ops.cuda import entry_device
from ..messages import ImageMessage, MeshMessage, StereoImageMessage
from ..pubsub import PubSub, UdpMulticastBus


def _wire_frame(img) -> np.ndarray:
    """A wire image in its smallest host form: u8 stays u8 and mono stays one
    channel (the fleet step casts and broadcasts on the card, so a u8 mono
    720p frame ships 0.9 MB host->device instead of 11 MB). Float payloads
    pass through as float32."""
    u8 = img.to_array_u8()
    return u8 if u8 is not None else np.asarray(img.to_array(), np.float32)


def _as_rgb_f32(arr: np.ndarray) -> np.ndarray:
    """Fallback normalization when a fleet batch mixes dtypes/layouts."""
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    return arr


class FarmPerceptionNode:
    def __init__(
        self,
        bus: PubSub,
        rig: StereoCamera,
        n_cameras: int = 4,
        perception_config=None,
        mesher_params=None,
        channel_input: str = "sensors/stereo/cam{i}",
        channel_output_mesh: str = "farm/mesh/cam{i}",
        channel_output_enhanced: Optional[str] = None,  # e.g. "farm/enhanced/cam{i}"
        max_sync_wait_sec: float = 0.5,
        disparity_scale: float = 1.0,
        vertex_min_obs: int = 3,
        mesher_scale: int = 1,
        device: torch.device | str = "cuda",
    ):
        from ...mesher.object_mesher import ObjectMesherDeviceParams
        from ...models.perception import PerceptionConfig
        from ...parallel.sharded_pipeline import create_fleet_frontend_state

        self.device = entry_device(device)
        self.bus = bus
        self.rig = rig
        self.n_cameras = n_cameras
        self.config = perception_config or PerceptionConfig()
        self.mesher_params = mesher_params or ObjectMesherDeviceParams()
        self.channel_output_mesh = channel_output_mesh
        self.channel_output_enhanced = channel_output_enhanced
        self.max_sync_wait_sec = max_sync_wait_sec
        self.disparity_scale = disparity_scale
        self.vertex_min_obs = vertex_min_obs

        H, W = int(rig.left.height), int(rig.left.width)
        self._image_shape = (H, W)
        # Tracking/mesher at 1/mesher_scale resolution (the reference mesher
        # node's mesher_input_height downscale); back-projection then uses
        # the rescaled rig.
        self.mesher_scale = int(mesher_scale)
        s = self.mesher_scale
        self._mesher_rig = rig.rescale(1.0 / s) if s > 1 else rig
        self._states, self._graphs = create_fleet_frontend_state(
            n_cameras, self.mesher_params,
            image_shape=(H // s, W // s) if s > 1 else (H, W), device=self.device,
        )
        self._prev_grays = None  # set on the first fleet step

        # Latest frame per camera: cam -> [timestamp, left, right, fresh].
        self._frames: Dict[int, list] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._first_fresh_wall = time.monotonic()
        self._running = True
        self.fleet_steps = 0
        self.frames_in = 0
        self.stale_fills = 0
        self.rejected_frames = 0
        self.step_failures = 0
        self.busy_seconds = 0.0  # in fleet steps done, to their last publish

        for i in range(n_cameras):
            bus.subscribe(channel_input.format(i=i), self._make_handler(i))
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- ingest ------------------------------------------------------------

    def _make_handler(self, cam: int):
        def handler(_ch, m: StereoImageMessage):
            left = _wire_frame(m.left)
            right = _wire_frame(m.right)
            # A frame at the wrong resolution must not reach the batch stack
            # (np.stack would throw on the fleet thread).
            if left.shape[:2] != self._image_shape or right.shape[:2] != self._image_shape:
                with self._lock:
                    self.rejected_frames += 1
                return
            with self._wake:
                if not any(f[3] for f in self._frames.values()):
                    # The first fresh frame of this fleet batch starts the
                    # sync-wait clock for stragglers.
                    self._first_fresh_wall = time.monotonic()
                self._frames[cam] = [m.timestamp, left, right, True]
                self.frames_in += 1
                self._wake.notify()

        return handler

    # -- fleet stepping ------------------------------------------------------

    def _ready(self) -> bool:
        n_fresh = sum(1 for f in self._frames.values() if f[3])
        if n_fresh == 0:
            return False
        if n_fresh == self.n_cameras:
            return True
        # Partial fleet: fire once the first waiting frame has aged out.
        return (time.monotonic() - self._first_fresh_wall) > self.max_sync_wait_sec

    def _loop(self) -> None:
        while True:
            with self._wake:
                while self._running and not self._ready():
                    self._wake.wait(0.05)
                if not self._running:
                    return
                batch = self._collect_locked()
            t0 = time.perf_counter()
            try:
                self._step(*batch)
                failed = False
            except Exception as e:  # a poisoned frame must not kill the fleet
                failed = True
                print(f"farm_perception: step failed: {e!r}", flush=True)
            with self._wake:
                # Counted once its meshes are out: a reader that waits for a
                # step has every mesh of it, and its busy time.
                if failed:
                    self.step_failures += 1
                else:
                    self.busy_seconds += time.perf_counter() - t0
                    self.fleet_steps += 1
                self._wake.notify_all()

    def wait_steps(self, n: int, timeout: Optional[float] = None) -> bool:
        """Block until n fleet steps are done (True) or one has failed or the
        timeout has passed (False)."""
        with self._wake:
            self._wake.wait_for(lambda: self.fleet_steps >= n or self.step_failures > 0, timeout)
            return self.fleet_steps >= n

    def _collect_locked(self):
        H, W = self._image_shape
        stamps, fresh_mask, pairs = [], [], []
        for i in range(self.n_cameras):
            f = self._frames.get(i)
            if f is None:
                stamps.append(0)
                fresh_mask.append(False)
                pairs.append(None)
                self.stale_fills += 1
            else:
                stamps.append(f[0])
                pairs.append((f[1], f[2]))
                fresh_mask.append(f[3])
                if not f[3]:
                    self.stale_fills += 1
                f[3] = False  # consumed
        # A uniform batch keeps the compact wire form (u8/mono), cast on the
        # card; a mixed fleet falls back to float32 RGB on the host.
        present = [a for p in pairs if p is not None for a in p]
        uniform = present and all(
            a.dtype == present[0].dtype and a.shape == present[0].shape for a in present
        )
        if uniform:
            zero = np.zeros_like(present[0])
            lefts = [p[0] if p is not None else zero for p in pairs]
            rights = [p[1] if p is not None else zero for p in pairs]
        else:
            zero = np.zeros((H, W, 3), np.float32)
            lefts = [_as_rgb_f32(p[0]) if p is not None else zero for p in pairs]
            rights = [_as_rgb_f32(p[1]) if p is not None else zero for p in pairs]
        return np.stack(lefts), np.stack(rights), stamps, fresh_mask

    def _first_grays(self, lefts: torch.Tensor) -> torch.Tensor:
        """The first fleet step's previous grays: the left frames as gray
        (uint8 / 255; RGB through to_grayscale, mono as it is), pyr_down'ed
        to mesher scale, on the device."""
        from ...ops.image import pyr_down, to_grayscale

        pg = lefts
        if pg.dtype == torch.uint8:
            pg = pg.float() / torch.full((), 255.0, device=pg.device)
        pg = pg.float()
        if pg.ndim == 4:  # (B, H, W, 3) -> gray; (B, H, W) mono is gray
            pg = to_grayscale(pg)
        for _ in range(self.mesher_scale.bit_length() - 1):
            pg = pyr_down(pg)
        return pg

    def _step(self, lefts, rights, stamps, fresh_mask) -> None:
        from ...mesher.object_mesher import MesherDeviceOutput, build_meshes
        from ...parallel.sharded_pipeline import multi_camera_frontend_step

        bl = torch.from_numpy(lefts).to(self.device)
        br = torch.from_numpy(rights).to(self.device)
        if self._prev_grays is None:
            self._prev_grays = self._first_grays(bl)
        out, cur_grays = multi_camera_frontend_step(
            self._states, self._graphs, self._prev_grays, bl, br, self.rig, self.config,
            self.mesher_params, mesher_scale=self.mesher_scale, device=self.device,
        )
        self._states = out.tracker_state
        self._graphs = out.graph
        self._prev_grays = cur_grays

        # One device->host copy a tensor for all cameras.
        mesher = MesherDeviceOutput(*(t.cpu() for t in out.mesher))
        enhanced = (out.perception.enhanced_left.cpu().numpy()
                    if self.channel_output_enhanced else None)
        del out
        for i in range(self.n_cameras):
            if not fresh_mask[i]:
                continue  # stale fill: its outputs were published last time
            mesh = build_meshes(MesherDeviceOutput(*(t[i] for t in mesher)), self._mesher_rig,
                                self.disparity_scale, self.vertex_min_obs)
            if mesh.num_triangles > 0:
                self.bus.publish(
                    self.channel_output_mesh.format(i=i),
                    MeshMessage(timestamp=stamps[i], vertices=mesh.vertices,
                                triangles=mesh.triangles),
                )
            if enhanced is not None:
                self.bus.publish(
                    self.channel_output_enhanced.format(i=i),
                    ImageMessage.from_array_jpg(stamps[i], enhanced[i]),
                )

    def close(self) -> None:
        """Stop the fleet thread and wait for it (its step included)."""
        with self._wake:
            self._running = False
            self._wake.notify()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("farm_perception: the fleet thread did not stop")


def from_config(bus: PubSub, node_config_path: str, shared_config_path: str,
                device: torch.device | str = "cuda") -> FarmPerceptionNode:
    from ...config.bindings import load_mesher_params, load_rig
    from ...config.yaml_parser import YamlParser
    from ...models.perception import PerceptionConfig

    parser = YamlParser(node_path=node_config_path, shared_path=shared_config_path)
    rig = load_rig(parser)
    cfg = PerceptionConfig(
        max_disp=int(parser.get("max_disp", 128)),
        internal_scale=int(parser.get("internal_scale", 4)),
        engine=str(parser.get("engine", "patchmatch")),
    )
    mp = load_mesher_params(parser)
    return FarmPerceptionNode(
        bus, rig,
        n_cameras=int(parser.get("n_cameras", 4)),
        perception_config=cfg,
        mesher_params=mp.device,
        channel_input=str(parser.get("channel_input_stereo", "sensors/stereo/cam{i}")),
        channel_output_mesh=str(parser.get("channel_output_mesh", "farm/mesh/cam{i}")),
        channel_output_enhanced=parser.get("channel_output_enhanced", None),
        max_sync_wait_sec=float(parser.get("max_sync_wait_sec", 0.5)),
        disparity_scale=float(mp.disparity_scale),
        vertex_min_obs=int(mp.vertex_min_obs),
        mesher_scale=int(parser.get("mesher_scale", 1)),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="node YAML (FarmPerceptionNode.yaml)")
    ap.add_argument("--shared", default=None, help="shared rig YAML")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--fx", type=float, default=336.0)
    ap.add_argument("--baseline", type=float, default=0.2)
    ap.add_argument("--width", type=int, default=672)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--internal-scale", type=int, default=4, help="the farm operating point")
    ap.add_argument("--engine", default="patchmatch", choices=["patchmatch", "sgm", "wta"],
                    help="dense stereo engine")
    ap.add_argument("--no-enhance", action="store_true")
    ap.add_argument("--mesher-scale", type=int, default=2,
                    help="tracking/mesher at 1/s resolution (reference "
                         "mesher_input_height parity; 2 = 360p from 720p)")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="print fleet step/frame counters every N seconds")
    ap.add_argument("--enhanced-out", default=None,
                    help="per-camera enhanced jpg channel template, e.g. farm/enhanced/cam{i}")
    ap.add_argument("--lcm", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    bus_cls = UdpMulticastBus
    if args.lcm:
        from ..lcm_wire import LcmUdpBus as bus_cls
    bus = bus_cls(port=args.port) if args.port else bus_cls()
    if args.config and args.shared:
        node = from_config(bus, args.config, args.shared, device=args.device)
    else:
        from ...models.perception import PerceptionConfig

        cam = PinholeCamera.create(
            args.fx, args.fx, args.width / 2, args.height / 2, args.height, args.width
        )
        rig = StereoCamera.create(cam, cam, args.baseline)
        node = FarmPerceptionNode(
            bus, rig, n_cameras=args.cameras,
            perception_config=PerceptionConfig(
                engine=args.engine, internal_scale=args.internal_scale,
                run_enhance=not args.no_enhance,
            ),
            channel_output_enhanced=args.enhanced_out,
            mesher_scale=args.mesher_scale,
            device=args.device,
        )
    print(f"farm_perception_node listening ({node.n_cameras} cameras on {node.device})...",
          flush=True)
    try:
        if args.stats_every > 0:
            last = (0, time.monotonic(), 0.0)
            while True:
                time.sleep(args.stats_every)
                now = time.monotonic()
                steps, busy = node.fleet_steps, node.busy_seconds
                span = max(now - last[1], 1e-9)
                rate = (steps - last[0]) / span
                print(
                    f"fleet_steps={steps} ({rate:.2f}/s = "
                    f"{rate * node.n_cameras:.1f} cam-fps, busy {(busy - last[2]) / span:.0%})"
                    f" frames_in={node.frames_in} stale={node.stale_fills}"
                    f" rejected={node.rejected_frames} failed={node.step_failures}",
                    flush=True,
                )
                last = (steps, now, busy)
        else:
            threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
