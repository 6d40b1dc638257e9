"""Dataset player: offline dataset → StateEstimator → pose output (port of
``ocean_perception_tpu.fabric.nodes.dataset_player``).

Reference parity: tools/vio_dataset_player/main.cpp — wires a dataset's
callbacks into the estimator, plays back at a speed factor, publishes filter
and smoother poses on the bus, and optionally dumps a trajectory CSV.

The estimator runs on ``device``, the card by default (``run`` raises
without one unless it is given ``device="cpu"``). The filter pose published
after every frame is one read-back of the card a frame beside the engine's
own (``vio/state_estimator.py``'s ``FRAME_SYNCS``).

Usage:
    python -m ocean_perception_tpu_torch.fabric.nodes.dataset_player \
        --dataset euroc --path /data/farmsim_seq --speed 2.0 \
        --out-trajectory /tmp/traj.csv
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import List, Optional

import numpy as np
import torch

from ...core.measurements import StereoImage
from ...datasets import get_dataset_by_name
from ...vio.state_estimator import StateEstimator, StateEstimatorParams, StateStamped
from ..messages import PoseStampedMessage
from ..native_bus import bus_class
from ..pubsub import InProcessBus, PubSub
from ...core.cameras import PinholeCamera, StereoCamera
from .state_estimator_node import matrix_quat


def _pose_msg(s: StateStamped) -> PoseStampedMessage:
    q = matrix_quat(s.world_T_body[:3, :3])
    pose = np.concatenate([q, s.world_T_body[:3, 3]])
    cov = None
    if s.covariance is not None and s.covariance.shape[0] >= 6:
        cov = s.covariance[:6, :6]
    return PoseStampedMessage(timestamp=s.timestamp, pose=pose, covariance=cov)


def _first_frame_shape(dataset):
    """(H, W) of the first stereo frame without dispatching it."""
    if not dataset.stereo_data:
        return 376, 672  # sensorless dataset: keep the historical default
    item = dataset.stereo_data[0]
    if hasattr(item, "load"):
        img = item.load(dataset.grayscale)
        return np.asarray(img.left).shape[:2]
    from ...utils.image_io import load_image

    return load_image(item.left_path, grayscale=True).shape[:2]


def run(
    dataset_name: str,
    path: str,
    rig: Optional[StereoCamera] = None,
    speed: float = 0.0,
    bus: Optional[PubSub] = None,
    params: Optional[StateEstimatorParams] = None,
    out_trajectory: Optional[str] = None,
    max_steps: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> List[StateStamped]:
    dataset = get_dataset_by_name(dataset_name, path)
    if rig is None:
        # Derive the rig from the dataset's first frame (fx = W/2, centered
        # principal point — the historical 376x672 default scaled to the
        # data) so any resolution plays without flags.
        H, W = _first_frame_shape(dataset)
        cam = PinholeCamera.create(W / 2.0, W / 2.0, W / 2.0, H / 2.0, H, W)
        rig = StereoCamera.create(cam, cam, baseline=0.2)
    params = params or StateEstimatorParams()
    est = StateEstimator(params, rig, device=device)
    bus = bus or InProcessBus()

    trajectory: List[StateStamped] = []

    def on_smoother(result):
        s = est.smoother_state()
        if s is not None:
            trajectory.append(s)
            bus.publish("vio/pose/smoother", _pose_msg(s))

    est.smoother_callbacks.append(on_smoother)

    initialized = [False]

    def on_stereo(img: StereoImage):
        if not initialized[0]:
            # Initialize from groundtruth if available, else identity
            # (vio_dataset_player main.cpp:156-157).
            T0 = dataset.pose_data[0].world_T_body if dataset.pose_data else np.eye(4)
            est.initialize(img.timestamp, T0)
            initialized[0] = True
        est.receive_stereo(img)
        fs = est.filter_state() if est.ekf_state is not None else None
        if fs is not None:
            bus.publish("vio/pose/filter", _pose_msg(fs))

    dataset.register_stereo_callback(on_stereo)
    dataset.register_imu_callback(est.receive_imu)
    dataset.register_depth_callback(est.receive_depth)
    dataset.register_range_callback(est.receive_range)

    if speed > 0:
        dataset.playback(speed, block=True, max_steps=max_steps)
    else:
        n = 0
        while dataset.step():
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    if out_trajectory:
        # EuRoC state format — scoreable directly by
        # `python -m ocean_perception_tpu_torch.vio.evaluation --est <csv> --gt ...`.
        with open(out_trajectory, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["#timestamp [ns]", "qw", "qx", "qy", "qz", "tx", "ty", "tz"])
            for s in trajectory:
                q = matrix_quat(s.world_T_body[:3, :3])
                w.writerow([s.timestamp, *q.tolist(), *s.world_T_body[:3, 3].tolist()])
    return trajectory


def publish_sensors(
    dataset_name: str,
    path: str,
    bus: PubSub,
    speed: float = 1.0,
    channel_prefix: str = "",
    publish_init_pose: bool = True,
    max_steps: Optional[int] = None,
    image_encoding: str = "f32",
) -> int:
    """Replay the dataset as raw SENSOR messages on the bus (no estimator in
    this process) — the multi-process half of the reference's
    vio_dataset_player → LCM → state_estimator_lcm wiring. Channels match
    StateEstimatorNode defaults. Returns the number of steps published.

    image_encoding: "f32" ships lossless float frames (default; 4x the
    bytes), "u8" quantizes to 8-bit (the reference's own image depth),
    "jpg" compresses (the reference's mmf default, ~20x smaller)."""
    from ..messages import DepthMessage, ImuMessage, RangeMessage, StereoImageMessage
    from ..messages import ImageMessage, PoseStampedMessage

    dataset = get_dataset_by_name(dataset_name, path)
    p = channel_prefix
    n = [0]

    if publish_init_pose:
        T0 = dataset.pose_data[0].world_T_body if dataset.pose_data else np.eye(4)
        q = matrix_quat(T0[:3, :3])
        t0 = dataset.next_timestamp() or 0
        bus.publish(
            p + "vio/init_pose",
            PoseStampedMessage(timestamp=t0, pose=np.concatenate([q, T0[:3, 3]])),
        )

    if image_encoding == "jpg":
        pack_image = ImageMessage.from_array_jpg
    elif image_encoding == "u8":
        def pack_image(ts, arr):
            u8 = (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
            c = 1 if u8.ndim == 2 else u8.shape[2]
            return ImageMessage(ts, u8.shape[1], u8.shape[0], c, "u8", u8.tobytes())
    elif image_encoding == "f32":
        pack_image = ImageMessage.from_array
    else:
        raise ValueError(f"image_encoding {image_encoding!r}")

    def on_stereo(img: StereoImage):
        bus.publish(
            p + "sensors/stereo",
            StereoImageMessage(
                timestamp=img.timestamp, camera_id=img.camera_id,
                left=pack_image(img.timestamp, np.asarray(img.left)),
                right=pack_image(img.timestamp, np.asarray(img.right)),
            ),
        )
        n[0] += 1

    dataset.register_stereo_callback(on_stereo)
    dataset.register_imu_callback(
        lambda m: bus.publish(
            p + "sensors/imu",
            ImuMessage(m.timestamp, np.asarray(m.angular_velocity), np.asarray(m.linear_acceleration)),
        )
    )
    dataset.register_depth_callback(
        lambda m: bus.publish(p + "sensors/depth", DepthMessage(m.timestamp, m.depth))
    )
    dataset.register_range_callback(
        lambda m: bus.publish(
            p + "sensors/range",
            RangeMessage(m.timestamp, m.range, np.asarray(m.point), m.beacon_id),
        )
    )

    if speed > 0:
        dataset.playback(speed, block=True, max_steps=max_steps)
    else:
        k = 0
        while dataset.step():
            k += 1
            if max_steps is not None and k >= max_steps:
                break
    return n[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="euroc")
    ap.add_argument("--path", required=True)
    ap.add_argument("--speed", type=float, default=0.0, help="0 = as fast as possible")
    ap.add_argument("--udp", action="store_true", help="publish on UDP multicast")
    ap.add_argument("--native-bus", action="store_true",
                    help="use the C++ UDP transport (same wire format; with --lcm, the LCM wire)")
    ap.add_argument(
        "--lcm", action="store_true",
        help="publish real LCM wire format (interop with reference-era peers)",
    )
    ap.add_argument("--port", type=int, default=None, help="UDP multicast port")
    ap.add_argument("--out-trajectory", default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument(
        "--publish-sensors", action="store_true",
        help="publish raw sensor messages instead of running the estimator inline",
    )
    ap.add_argument(
        "--image-encoding", default="f32", choices=["f32", "u8", "jpg"],
        help="stereo frame wire encoding (f32 lossless, u8 = the reference's "
             "8-bit depth, jpg = the reference's mmf default)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import os

    if args.dataset == "euroc" and os.path.isfile(args.path):
        # Directory layouts are datasets; a FILE is a recorded session log
        # (ocean-channel-logger / stock lcm-logger output).
        args.dataset = "lcmlog"

    if args.udp or args.native_bus or args.lcm:
        bus_cls = bus_class(args.native_bus, args.lcm)
        bus = bus_cls(port=args.port) if args.port else bus_cls()
    else:
        bus = InProcessBus()
    if args.publish_sensors:
        n = publish_sensors(
            args.dataset, args.path, bus, speed=args.speed,
            max_steps=args.max_steps, image_encoding=args.image_encoding,
        )
        print(f"published dataset; {n} stereo frames")
        return 0
    traj = run(
        args.dataset, args.path, speed=args.speed, bus=bus,
        out_trajectory=args.out_trajectory, max_steps=args.max_steps, device=args.device,
    )
    print(f"played dataset; {len(traj)} smoother poses")
    return 0


if __name__ == "__main__":
    sys.exit(main())
