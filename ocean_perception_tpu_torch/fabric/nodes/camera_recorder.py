"""Camera recorder: live stereo source → EuRoC-layout dataset on disk (port of
``ocean_perception_tpu.fabric.nodes.camera_recorder``).

Reference parity: tools/zed_recorder (zed_recorder.cpp:95-215 — SDK capture
loop, 30 Hz camera / 100 Hz IMU DataSubsamplers, max-duration bound,
EurocDataWriter persistence). This package does not depend on the ZED SDK,
so this recorder supports the two capture paths that exist without it:

- ``--source bus`` (default): subscribe stereo/imu/depth bus channels and
  persist them — any sensor node becomes a recordable source.
- ``--source uvc``: capture directly from a UVC device or video file via
  OpenCV. A ZED/ZED-M enumerated WITHOUT its SDK is exactly this — a UVC
  camera delivering side-by-side stereo frames — so ``--sbs`` splits each
  frame into the left/right halves. Frames are rate-limited to
  ``--camera-hz`` (reference cam_sampler_ 30 Hz) and optionally republished
  on the bus so a live estimator can consume them while recording.

Only the SDK-specific extras (factory calibration readout, onboard
IMU/mag/baro streams) remain unavailable; record those via ``--source bus``
from whatever sensor node publishes them.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

from ...core.measurements import DepthMeasurement, ImuMeasurement
from ...datasets.euroc import EurocDataWriter
from ...utils.timing import DataSubsampler
from ..messages import DepthMessage, ImageMessage, ImuMessage, StereoImageMessage
from ..pubsub import UdpMulticastBus


class CameraRecorderNode:
    def __init__(self, bus, out_folder: str, channel_prefix: str = "sensors/"):
        self.writer = EurocDataWriter(out_folder)
        bus.subscribe(channel_prefix + "stereo", self._on_stereo)
        bus.subscribe(channel_prefix + "imu", self._on_imu)
        bus.subscribe(channel_prefix + "depth", self._on_depth)

    def _on_stereo(self, _ch, m: StereoImageMessage):
        self.writer.write_stereo(m.timestamp, m.left.to_array(), m.right.to_array())

    def _on_imu(self, _ch, m: ImuMessage):
        self.writer.write_imu(
            ImuMeasurement(m.timestamp, m.angular_velocity, m.linear_acceleration)
        )

    def _on_depth(self, _ch, m: DepthMessage):
        self.writer.write_depth(DepthMeasurement(m.timestamp, m.depth))

    def finish(self) -> None:
        self.writer.finish()


class UvcStereoSource:
    """OpenCV capture loop: UVC stereo device (or replayed video file) →
    EurocDataWriter, with optional bus republish.

    Mirrors the reference capture loop's shape (zed_recorder.cpp:174-215):
    poll as fast as the source delivers, DataSubsampler-gate the camera rate,
    stop at max_duration_sec or an explicit shutdown.
    """

    def __init__(
        self,
        device: "int | str",
        sbs: bool = True,
        camera_hz: float = 30.0,
        max_duration_sec: float = 120.0,
        grayscale: bool = True,
    ):
        self.device = device
        self.sbs = sbs
        self.camera_hz = camera_hz
        self.max_duration_sec = max_duration_sec
        self.grayscale = grayscale
        self._shutdown = threading.Event()

    def shutdown(self) -> None:
        self._shutdown.set()

    def _split(self, frame: np.ndarray):
        if self.grayscale and frame.ndim == 3:
            import cv2

            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        elif frame.ndim == 3:
            frame = frame[..., ::-1]  # BGR → RGB
        frame = frame.astype(np.float32) / 255.0
        if self.sbs:
            w = frame.shape[1] // 2
            return frame[:, :w], frame[:, w : 2 * w]
        return frame, frame

    def capture(self, writer: EurocDataWriter, bus=None, channel="sensors/stereo",
                max_frames: int | None = None) -> int:
        """Run the capture loop; returns the number of stereo frames written."""
        import cv2

        cap = cv2.VideoCapture(self.device)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open capture source {self.device!r}")
        # File-replay semantics (EOF ends capture, container clock) apply
        # only to actual video FILES. A V4L2 device path ("/dev/video0") is
        # a live camera: a failed read is a transient hiccup, and POS_MSEC
        # is unsupported on many live backends (returns 0/-1, which would
        # starve the rate sampler after the first frame).
        is_file = (
            isinstance(self.device, str)
            and not self.device.isdigit()
            and not self.device.startswith("/dev/")
        )
        sampler = DataSubsampler(self.camera_hz)
        t_start = time.monotonic()
        n = 0
        self.frames_written = 0
        try:
            while not self._shutdown.is_set():
                if (time.monotonic() - t_start) > self.max_duration_sec:
                    break
                ok, frame = cap.read()
                if not ok:
                    if is_file:
                        break  # end of file
                    continue  # transient device hiccup: poll again
                if is_file:
                    # File replay: trust the container's clock.
                    t_sec = cap.get(cv2.CAP_PROP_POS_MSEC) * 1e-3
                else:
                    t_sec = time.monotonic() - t_start
                if not sampler.should_sample(t_sec):
                    continue
                timestamp = int(round(t_sec * 1e9))
                left, right = self._split(frame)
                writer.write_stereo(timestamp, left, right)
                if bus is not None:
                    bus.publish(
                        channel,
                        StereoImageMessage(
                            timestamp=timestamp,
                            camera_id=0,
                            left=ImageMessage.from_array(timestamp, left),
                            right=ImageMessage.from_array(timestamp, right),
                        ),
                    )
                n += 1
                self.frames_written = n  # survives a KeyboardInterrupt
                if max_frames is not None and n >= max_frames:
                    break
        finally:
            cap.release()
        return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--source", default="bus", choices=["bus", "uvc", "zed"])
    ap.add_argument("--device", default="0",
                    help="uvc: device index or video file path")
    ap.add_argument("--sbs", action="store_true", default=True,
                    help="split side-by-side stereo frames (ZED-over-UVC layout)")
    ap.add_argument("--no-sbs", dest="sbs", action="store_false")
    ap.add_argument("--camera-hz", type=float, default=30.0)
    ap.add_argument("--max-duration-sec", type=float, default=120.0)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--publish", action="store_true",
                    help="uvc: also publish captured frames on the bus")
    ap.add_argument(
        "--lcm", action="store_true",
        help="speak real LCM wire format (record from reference-era publishers)",
    )
    args = ap.parse_args(argv)

    def _bus():
        if args.lcm:
            from ..lcm_wire import LcmUdpBus

            return LcmUdpBus()
        return UdpMulticastBus()

    if args.source == "zed":
        print("ZED SDK capture is not available in this environment; a ZED "
              "without the SDK is a UVC side-by-side device: use --source uvc "
              "(or publish frames on the bus and use --source bus).",
              file=sys.stderr)
        return 2

    if args.source == "uvc":
        device = int(args.device) if args.device.isdigit() else args.device
        writer = EurocDataWriter(args.out)
        src = UvcStereoSource(device, sbs=args.sbs, camera_hz=args.camera_hz,
                              max_duration_sec=args.max_duration_sec)
        bus = _bus() if args.publish else None
        print(f"recording {device!r} to {args.out}")
        try:
            n = src.capture(writer, bus=bus, max_frames=args.max_frames)
        except KeyboardInterrupt:
            # capture() counts as it writes; report the real total.
            n = getattr(src, "frames_written", 0)
        writer.finish()
        print(f"wrote {n} stereo frames")
        return 0

    bus = _bus()
    node = CameraRecorderNode(bus, args.out)
    print(f"recording bus sensors to {args.out} (ctrl-c to stop)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        node.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
