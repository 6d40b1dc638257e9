"""StateEstimator node: bus-driven VIO service (port of
``ocean_perception_tpu.fabric.nodes.state_estimator_node``).

Reference parity: lcm_nodes/state_estimator_lcm.cpp — waits for an initial
pose message, subscribes imu/depth/range/stereo channels (stereo may arrive
via the shm ring), republishes the filter pose (rate-limited) and the
smoother pose.

Channels (configurable): vio/init_pose, sensors/imu, sensors/depth,
sensors/range, sensors/stereo (StereoImageMessage) or sensors/stereo_shm
(ShmImageHeader pairs), outputs vio/pose/filter + vio/pose/smoother.

The estimator runs on ``device``, the card by default; the node raises at
construction without one unless it is given ``device="cpu"``. An IMU sample
reads nothing back from the card unless its filter pose is published: the
publish rate is tested on the filter's host timestamp, and the state is
read only for a pose that goes out (``filter_publish_hz``, 1 in 10 samples
at 20 Hz of 200 Hz).

Run: ``python -m ocean_perception_tpu_torch.fabric.nodes.state_estimator_node
--config config/nodes/StateEstimatorNode.yaml --shared config/shared/Farmsim.yaml``
(``--device cpu`` without a card, ``--lcm`` for the LCM wire format,
``--native-bus`` for the C++ transport).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import Optional

import numpy as np
import torch

from ...core.cameras import PinholeCamera, StereoCamera
from ...core.measurements import (
    DepthMeasurement,
    ImuMeasurement,
    MagMeasurement,
    PoseMeasurement,
    RangeMeasurement,
    StereoImage,
)
from ...core.quaternion import matrix_to_quat, quat_to_matrix
from ...utils.timing import DataSubsampler
from ...vio.state_estimator import StateEstimator, StateEstimatorParams
from ..messages import (
    DepthMessage,
    ImuMessage,
    MagMessage,
    PoseStampedMessage,
    RangeMessage,
    ShmImageHeader,
    StereoImageMessage,
)
from ..native_bus import bus_class
from ..pubsub import PubSub
from ..shm_ring import ShmRingReader

# Default channel names; overridden by config/nodes/StateEstimatorNode.yaml
# (reference: StateEstimatorLcm.yaml channel_* keys).
DEFAULT_CHANNELS = {
    "channel_initial_pose": "vio/init_pose",
    "channel_input_imu": "sensors/imu",
    "channel_input_depth": "sensors/depth",
    "channel_input_range": "sensors/range",
    "channel_input_mag": "sensors/mag",
    "channel_input_stereo": "sensors/stereo",
    "channel_input_pose": "vio/external_pose",
    "channel_output_filter_pose": "vio/pose/filter",
    "channel_output_smoother_pose": "vio/pose/smoother",
}


def pose_matrix(pose) -> np.ndarray:
    """A message's [qw, qx, qy, qz, tx, ty, tz] as a 4x4 world_T_body."""
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(torch.as_tensor(np.asarray(pose[:4], np.float64))).numpy()
    T[:3, 3] = pose[4:7]
    return T


def matrix_quat(R: np.ndarray) -> np.ndarray:
    """[qw, qx, qy, qz] of a 3x3 rotation (float64, on the CPU)."""
    return matrix_to_quat(torch.as_tensor(np.asarray(R, np.float64))).numpy()


class StateEstimatorNode:
    def __init__(
        self,
        bus: PubSub,
        rig: StereoCamera,
        params: Optional[StateEstimatorParams] = None,
        filter_pose_hz: float = 20.0,
        channel_prefix: str = "",
        channels: Optional[dict] = None,
        device: torch.device | str = "cuda",
    ):
        self.bus = bus
        self.est = StateEstimator(params or StateEstimatorParams(), rig, device=device)
        self._init = threading.Event()
        self._subsampler = DataSubsampler(filter_pose_hz)
        self._shm_readers = {}
        p = channel_prefix
        ch = dict(DEFAULT_CHANNELS)
        ch.update(channels or {})
        self._channels = ch

        bus.subscribe(p + ch["channel_initial_pose"], self._on_init)
        bus.subscribe(p + ch["channel_input_imu"], self._on_imu)
        bus.subscribe(p + ch["channel_input_depth"], self._on_depth)
        bus.subscribe(p + ch["channel_input_range"], self._on_range)
        bus.subscribe(p + ch["channel_input_mag"], self._on_mag)
        bus.subscribe(p + ch["channel_input_pose"], self._on_pose)
        bus.subscribe(p + ch["channel_input_stereo"], self._on_stereo)
        bus.subscribe(p + ch["channel_input_stereo"] + "_shm_left", self._on_shm("left"))
        bus.subscribe(p + ch["channel_input_stereo"] + "_shm_right", self._on_shm("right"))
        self._pending_shm = {}
        self._out_prefix = p

        self.est.smoother_callbacks.append(self._publish_smoother)

    @property
    def device(self) -> torch.device:
        return self.est.device

    @classmethod
    def from_config(
        cls,
        bus: PubSub,
        node_config_path: str,
        shared_config_path: str,
        channel_prefix: str = "",
        device: torch.device | str = "cuda",
    ) -> "StateEstimatorNode":
        """Build the COMPLETE node from the two-file YAML model — rig,
        estimator params, channels, publish rate — with zero Python-side
        parameter literals (reference: state_estimator_lcm.cpp params
        cascade + StateEstimatorLcm.yaml)."""
        from ...config.bindings import load_rig, load_state_estimator_params
        from ...config.yaml_parser import YamlParser

        parser = YamlParser(node_path=node_config_path, shared_path=shared_config_path)
        rig = load_rig(parser)
        params = load_state_estimator_params(parser)
        channels = {k: parser.get(k, v) for k, v in DEFAULT_CHANNELS.items()}
        return cls(
            bus,
            rig,
            params=params,
            filter_pose_hz=float(parser.get("filter_publish_hz", 20.0)),
            channel_prefix=channel_prefix,
            channels=channels,
            device=device,
        )

    # -- handlers -------------------------------------------------------------

    def _on_init(self, _ch, msg: PoseStampedMessage):
        self.est.initialize(msg.timestamp, pose_matrix(msg.pose))
        self._init.set()

    def _on_imu(self, _ch, m: ImuMessage):
        if not self._init.is_set():
            return
        self.est.receive_imu(
            ImuMeasurement(m.timestamp, m.angular_velocity, m.linear_acceleration)
        )
        # The filter's timestamp is host state: only a published pose reads
        # the card.
        if self._subsampler.should_sample(self.est._ekf_time * 1e-9):
            self._publish_filter(self.est.filter_state())

    def _on_depth(self, _ch, m: DepthMessage):
        if self._init.is_set():
            self.est.receive_depth(DepthMeasurement(m.timestamp, m.depth))

    def _on_range(self, _ch, m: RangeMessage):
        if self._init.is_set():
            self.est.receive_range(
                RangeMeasurement(m.timestamp, m.range, m.point, m.beacon_id)
            )

    def _on_mag(self, _ch, m: MagMessage):
        if self._init.is_set():
            self.est.receive_mag(MagMeasurement(m.timestamp, m.field))

    def _on_pose(self, _ch, msg: PoseStampedMessage):
        """External absolute pose fix (fiducial relocalization / USBL):
        applied as a filter pose measurement (core receive_pose)."""
        if not self._init.is_set():
            return
        self.est.receive_pose(PoseMeasurement(msg.timestamp, pose_matrix(msg.pose),
                                              msg.covariance))

    def _on_stereo(self, _ch, m: StereoImageMessage):
        if not self._init.is_set():
            return
        self.est.receive_stereo(
            StereoImage(m.timestamp, m.camera_id, m.left.to_array(), m.right.to_array())
        )

    def _on_shm(self, side: str):
        def handler(_ch, hdr: ShmImageHeader):
            if not self._init.is_set():
                return
            reader = self._shm_readers.get(hdr.shm_path)
            if reader is None:
                reader = ShmRingReader(hdr.shm_path)
                self._shm_readers[hdr.shm_path] = reader
            frame = reader.read(hdr.seq)
            if frame is None:
                return
            ts, img = frame
            pending = self._pending_shm.setdefault(hdr.timestamp, {})
            pending[side] = img
            if "left" in pending and "right" in pending:
                del self._pending_shm[hdr.timestamp]
                self.est.receive_stereo(
                    StereoImage(hdr.timestamp, 0, pending["left"], pending["right"])
                )

        return handler

    # -- outputs --------------------------------------------------------------

    def _pose_message(self, s) -> PoseStampedMessage:
        return PoseStampedMessage(
            timestamp=s.timestamp,
            pose=np.concatenate([matrix_quat(s.world_T_body[:3, :3]), s.world_T_body[:3, 3]]),
            covariance=s.covariance[:6, :6] if s.covariance is not None else None,
        )

    def _publish_filter(self, fs) -> None:
        self.bus.publish(
            self._out_prefix + self._channels["channel_output_filter_pose"],
            self._pose_message(fs),
        )

    def _publish_smoother(self, _result) -> None:
        s = self.est.smoother_state()
        if s is not None:
            self.bus.publish(
                self._out_prefix + self._channels["channel_output_smoother_pose"],
                self._pose_message(s),
            )


def trajectory_logger(est: StateEstimator, path: str):
    """A smoother callback that appends each smoother pose to the CSV at
    ``path`` (EuRoC state format: ns, qw, qx, qy, qz, tx, ty, tz), line-
    buffered, with the header when the file is new; and the open file."""
    traj_f = open(path, "a", buffering=1)
    if traj_f.tell() == 0:
        traj_f.write("#timestamp, qw, qx, qy, qz, tx, ty, tz\n")

    def log_pose(_result) -> None:
        s = est.smoother_state()
        if s is None:
            return
        q = matrix_quat(s.world_T_body[:3, :3])
        t = s.world_T_body[:3, 3]
        traj_f.write(f"{s.timestamp},{q[0]},{q[1]},{q[2]},{q[3]},{t[0]},{t[1]},{t[2]}\n")

    return log_pose, traj_f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="node YAML (StateEstimatorNode.yaml)")
    ap.add_argument("--shared", default=None, help="shared rig YAML (config/shared/*.yaml)")
    ap.add_argument("--port", type=int, default=None, help="UDP multicast port")
    ap.add_argument(
        "--native-bus", action="store_true",
        help="use the C++ UDP transport (same wire format; with --lcm, the LCM wire)",
    )
    ap.add_argument(
        "--lcm", action="store_true",
        help="speak real LCM wire format (fabric/lcm_wire.py) — "
             "interoperates with reference-era LCM peers and lcm-spy",
    )
    ap.add_argument(
        "--checkpoint", default=None,
        help="checkpoint .npz path: resumed from at startup if it exists, "
             "written on every smoother update (mid-mission restart support; "
             "the reference has no checkpointing — SURVEY §5.4)",
    )
    ap.add_argument(
        "--trajectory-out", default=None,
        help="append smoother poses to this CSV (EuRoC state format: "
             "ns, qw, qx, qy, qz, tx, ty, tz) for offline scoring with "
             "python -m ocean_perception_tpu_torch.vio.evaluation",
    )
    ap.add_argument("--fx", type=float, default=336.0)
    ap.add_argument("--baseline", type=float, default=0.2)
    ap.add_argument("--width", type=int, default=672)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    bus_cls = bus_class(args.native_bus, args.lcm)
    bus = bus_cls(port=args.port) if args.port else bus_cls()
    if args.config and args.shared:
        node = StateEstimatorNode.from_config(bus, args.config, args.shared, device=args.device)
    else:
        cam = PinholeCamera.create(args.fx, args.fx, args.width / 2, args.height / 2,
                                   args.height, args.width)
        rig = StereoCamera.create(cam, cam, args.baseline)
        node = StateEstimatorNode(bus, rig, device=args.device)
    if args.checkpoint:
        from ...vio.checkpoint import load_estimator, save_estimator

        if os.path.isfile(args.checkpoint):
            load_estimator(node.est, args.checkpoint)
            node._init.set()  # resumed state replaces the init-pose wait
            print(f"resumed estimator from {args.checkpoint}")
        node.est.smoother_callbacks.append(
            lambda _result: save_estimator(node.est, args.checkpoint)
        )
    if args.trajectory_out:
        log_pose, _ = trajectory_logger(node.est, args.trajectory_out)
        node.est.smoother_callbacks.append(log_pose)
    print(f"state_estimator_node listening on {node.device} (waiting for vio/init_pose)...",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
