"""Image viewer node: subscribes image channels, writes frames to disk (port
of ``ocean_perception_tpu.fabric.nodes.image_viewer``).

Reference parity: tools/lcm_image_viewer (cv::imshow windows). Headless GPU
hosts have no display, so frames land as PNGs in an output directory
(optionally only every Nth frame).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

from ...utils.image_io import save_image
from ..messages import ImageMessage, ShmImageHeader, StereoImageMessage
from ..pubsub import PubSub, UdpMulticastBus
from ..shm_ring import ShmRingReader


class ImageViewerNode:
    def __init__(self, bus: PubSub, channel: str, out_dir: str, every_n: int = 1):
        self.out_dir = out_dir
        self.every_n = max(1, every_n)
        self._count = 0
        self._readers = {}
        os.makedirs(out_dir, exist_ok=True)
        bus.subscribe(channel, self._on_message)

    def _save(self, name: str, img) -> None:
        self._count += 1
        if self._count % self.every_n:
            return
        save_image(os.path.join(self.out_dir, name), img)

    def _on_message(self, channel, msg) -> None:
        safe_ch = channel.replace("/", "_")
        if isinstance(msg, ImageMessage):
            # LCM image_t carries no timestamp (always 0): fall back to the
            # frame counter so frames don't overwrite one file.
            stamp = msg.timestamp if msg.timestamp else f"n{self._count:06d}"
            self._save(f"{safe_ch}_{stamp}.png", msg.to_array())
        elif isinstance(msg, StereoImageMessage):
            self._save(f"{safe_ch}_{msg.timestamp}_L.png", msg.left.to_array())
            self._save(f"{safe_ch}_{msg.timestamp}_R.png", msg.right.to_array())
        elif isinstance(msg, ShmImageHeader):
            reader = self._readers.setdefault(msg.shm_path, ShmRingReader(msg.shm_path))
            frame = reader.read(msg.seq)
            if frame is not None:
                self._save(f"{safe_ch}_{msg.timestamp}.png", frame[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--channel", required=True)
    ap.add_argument("--out-dir", default="/tmp/ocean_viewer")
    ap.add_argument("--every-n", type=int, default=1)
    ap.add_argument(
        "--lcm", action="store_true",
        help="subscribe on real LCM wire format (reference-era publishers)",
    )
    args = ap.parse_args(argv)
    if args.lcm:
        from ..lcm_wire import LcmUdpBus

        bus = LcmUdpBus()
    else:
        bus = UdpMulticastBus()
    ImageViewerNode(bus, args.channel, args.out_dir, args.every_n)
    print(f"saving {args.channel} frames to {args.out_dir}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
