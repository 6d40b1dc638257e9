"""Fiducial localizer node: stereo frames in → absolute pose fixes out (port
of ``ocean_perception_tpu.fabric.nodes.fiducial_localizer_node``).

Watches the stereo channel, detects AprilTags in the left image, localizes
the camera against a surveyed tag map (``tracking.apriltags
.estimate_camera_pose`` — multi-tag Cauchy-LM on all detected corners),
composes into body frame via ``body_T_cam``, and publishes a
``PoseStampedMessage`` on ``vio/external_pose`` — which the state estimator
consumes as a filter aiding update (``StateEstimator.receive_pose``).

This closes the loop the reference left open: it vendors an AprilTags
library (src/external/apriltags) but never wires it into the vehicle
(SURVEY §2.3). Together with the estimator's external-pose channel this is
drift-free relocalization whenever a surveyed tag (dock, cage corner,
calibration board) enters view.

The detector runs on the host; the pose solve runs on ``device``, the card
by default (one upload and one read-back a fix, the solver replayed from a
CUDA graph), and the node raises at construction without one unless it is
given ``device="cpu"``.

Run: ``python -m ocean_perception_tpu_torch.fabric.nodes.fiducial_localizer_node
--config config/nodes/FiducialLocalizerNode.yaml --shared config/shared/Farmsim.yaml``
(``--device cpu`` without a card, ``--lcm`` for the LCM wire format,
``--native-bus`` for the C++ transport).
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ...core.quaternion import matrix_to_quat
from ...ops.cuda import entry_device
from ...tracking.apriltags import TagDetectorParams, detect_tags, estimate_camera_pose
from ..messages import PoseStampedMessage, ShmImageHeader, StereoImageMessage
from ..native_bus import bus_class
from ..pubsub import PubSub
from ..shm_ring import ShmRingReader


def _matrix_to_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → unit quaternion [w x y z] (host-side, float64)."""
    return matrix_to_quat(torch.as_tensor(np.asarray(R, np.float64))).numpy()


class FiducialLocalizerNode:
    """Bus node turning tag sightings into absolute pose fixes.

    The detector runs on the host (numpy/scipy — this is a low-rate aiding
    loop, gated by ``min_period_sec``, not a per-frame hot path). Pose fix
    covariance uses configured sigmas; the LM solver must report success
    AND a mean corner reprojection error below ``max_error_px`` for a fix
    to be published (a mis-decoded or barely-visible tag stays silent
    rather than feeding the filter a bad absolute). The solve runs on
    ``device`` (the card unless told otherwise).
    """

    def __init__(
        self,
        bus: PubSub,
        fx: float,
        fy: float,
        cx: float,
        cy: float,
        tag_map: Dict[int, np.ndarray],
        tag_size_m: float,
        family: str = "tag36h11",
        body_T_cam: Optional[np.ndarray] = None,
        min_period_sec: float = 0.5,
        # Single-tag homography poses carry the classic two-fold planar
        # ambiguity that the LM refinement cannot escape (it only polishes
        # the branch it started on), so by default a fix needs >=2 mapped
        # tags in view. Drop to 1 only with large/close tags where the
        # wrong branch can't pass max_error_px.
        min_tags: int = 2,
        max_error_px: float = 2.0,
        corner_sigma_px: float = 0.5,
        pose_sigma_t: float = 0.02,
        pose_sigma_r: float = 0.02,
        detector_params: Optional[TagDetectorParams] = None,
        channel_input: str = "sensors/stereo",
        channel_output: str = "vio/external_pose",
        device: torch.device | str = "cuda",
    ):
        self.device = entry_device(device)
        self.bus = bus
        self.intrinsics = (float(fx), float(fy), float(cx), float(cy))
        self.tag_map = {int(k): np.asarray(v, np.float64).reshape(4, 4) for k, v in tag_map.items()}
        self.tag_size_m = float(tag_size_m)
        self.family = family
        self.cam_T_body = np.linalg.inv(
            np.eye(4) if body_T_cam is None else np.asarray(body_T_cam, np.float64)
        )
        self.min_period_ns = int(min_period_sec * 1e9)
        self.min_tags = int(min_tags)
        self.max_error_px = float(max_error_px)
        self.corner_sigma_px = float(corner_sigma_px)
        self.pose_sigma = np.concatenate(
            [np.full(3, pose_sigma_t ** 2), np.full(3, pose_sigma_r ** 2)]
        )
        self.detector_params = detector_params or TagDetectorParams()
        self.channel_output = channel_output
        self._last_fix_t = -(1 << 62)
        self._lock = threading.Lock()
        self.num_fixes = 0
        self._shm_readers: Dict[str, ShmRingReader] = {}
        bus.subscribe(channel_input, self._on_stereo)
        bus.subscribe(channel_input + "_shm_left", self._on_shm_left)

    # -- frame intake -------------------------------------------------------

    def _on_stereo(self, _ch, m: StereoImageMessage) -> None:
        self._process(m.timestamp, m.left.to_array())

    def _on_shm_left(self, _ch, hdr: ShmImageHeader) -> None:
        reader = self._shm_readers.get(hdr.shm_path)
        if reader is None:
            reader = ShmRingReader(hdr.shm_path)
            self._shm_readers[hdr.shm_path] = reader
        frame = reader.read(hdr.seq)
        if frame is not None:
            self._process(hdr.timestamp, frame[1])

    # -- localization -------------------------------------------------------

    def _process(self, timestamp: int, left: np.ndarray) -> None:
        with self._lock:
            if timestamp - self._last_fix_t < self.min_period_ns:
                return
            self._last_fix_t = timestamp  # gate on ATTEMPTS, not successes:
            # a tag-free stream must not make every frame pay the detector.
        fix = self.localize(left)
        if fix is None:
            return
        world_T_body = fix
        q = _matrix_to_wxyz(world_T_body[:3, :3])
        self.bus.publish(
            self.channel_output,
            PoseStampedMessage(
                timestamp=timestamp,
                pose=np.concatenate([q, world_T_body[:3, 3]]),
                covariance=np.diag(self.pose_sigma),
            ),
        )
        self.num_fixes += 1

    def localize(self, left: np.ndarray) -> Optional[np.ndarray]:
        """One frame → ``world_T_body`` or None (no/ambiguous tags)."""
        if left.ndim == 3:
            left = left.mean(axis=2)
        dets = detect_tags(left, self.family, self.detector_params)
        known = [d for d in dets if d.tag_id in self.tag_map]
        if len(known) < self.min_tags:
            return None
        fx, fy, cx, cy = self.intrinsics
        out = estimate_camera_pose(
            known, self.tag_map, self.tag_size_m, fx, fy, cx, cy,
            sigma_px=self.corner_sigma_px, device=self.device,
        )
        if out is None:
            return None
        world_T_cam, res = out
        # res.error is the mean residual in SIGMA units (vio/odometry.py:43);
        # convert to pixels for the gate.
        if not bool(res.success) or float(res.error) * self.corner_sigma_px > self.max_error_px:
            return None
        return world_T_cam @ self.cam_T_body


def from_config(bus: PubSub, node_config_path: str, shared_config_path: str,
                device: torch.device | str = "cuda") -> "FiducialLocalizerNode":
    """Build from the two-file YAML model: tag map + detector knobs from the
    node YAML, intrinsics + ``body_T_cam`` from the shared rig file (same
    split as the estimator/mesher nodes)."""
    from ...config.bindings import load_rig
    from ...config.yaml_parser import YamlParser

    p = YamlParser(node_path=node_config_path, shared_path=shared_config_path)
    rig = load_rig(p)
    cam = rig.left
    body_T_cam = None
    if p.has("/shared/stereo_forward/camera_left/body_T_cam"):
        body_T_cam = np.asarray(
            p.get("/shared/stereo_forward/camera_left/body_T_cam"), np.float64
        ).reshape(4, 4)
    tag_map = {}
    for entry in p.get("tag_map", []):
        tag_map[int(entry["id"])] = np.asarray(entry["world_T_tag"], np.float64).reshape(4, 4)
    return FiducialLocalizerNode(
        bus,
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        tag_map,
        tag_size_m=float(p.get("tag_size_m", 0.19)),
        family=p.get("family", "tag36h11"),
        body_T_cam=body_T_cam,
        min_period_sec=float(p.get("min_period_sec", 0.5)),
        min_tags=int(p.get("min_tags", 2)),
        max_error_px=float(p.get("max_error_px", 2.0)),
        pose_sigma_t=float(p.get("pose_sigma_t", 0.02)),
        pose_sigma_r=float(p.get("pose_sigma_r", 0.02)),
        channel_input=p.get("channel_input_stereo", "sensors/stereo"),
        channel_output=p.get("channel_output_pose", "vio/external_pose"),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="node YAML (FiducialLocalizerNode.yaml)")
    ap.add_argument("--shared", required=True, help="shared rig YAML (config/shared/*.yaml)")
    ap.add_argument("--port", type=int, default=None, help="UDP multicast port")
    ap.add_argument(
        "--lcm", action="store_true",
        help="speak real LCM wire format (interop with reference-era peers)",
    )
    ap.add_argument(
        "--native-bus", action="store_true",
        help="use the C++ UDP transport (same wire format)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    bus_cls = bus_class(args.native_bus, args.lcm)
    bus = bus_cls(port=args.port) if args.port else bus_cls()
    node = from_config(bus, args.config, args.shared, device=args.device)
    print(f"fiducial_localizer listening on {node.device} ({len(node.tag_map)} mapped tags)...",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
