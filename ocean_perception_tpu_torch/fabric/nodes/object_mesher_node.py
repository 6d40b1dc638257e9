"""ObjectMesher node: stereo frames in, obstacle meshes out (port of
``ocean_perception_tpu.fabric.nodes.object_mesher_node``).

Reference parity: lcm_nodes/object_mesher_lcm.cpp: subscribes the stereo
channel (and its shared-memory form), optionally downscales to
``mesher_input_height``, publishes a MeshMessage on the mesh channel.

The mesher runs on ``device``, the card by default; the node raises at
construction without one unless it is given ``device="cpu"``. The downscale
runs there too, bilinear with half-pixel centres and no antialias (OpenCV's
INTER_LINEAR on float32 frames, :func:`downscale`), so the node needs no
OpenCV.

Run: ``python -m ocean_perception_tpu_torch.fabric.nodes.object_mesher_node
--config config/nodes/ObjectMesherNode.yaml --shared config/shared/Farmsim.yaml``
(``--device cpu`` to run without a card, ``--lcm`` for the LCM wire format).
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import Optional

import numpy as np
import torch

from ...core.cameras import PinholeCamera, StereoCamera
from ...mesher.object_mesher import ObjectMesher, ObjectMesherParams
from ...ops.cuda import entry_device
from ..messages import MeshMessage, ShmImageHeader, StereoImageMessage
from ..pubsub import PubSub, UdpMulticastBus
from ..shm_ring import ShmRingReader


def _linear_taps(n_in: int, n_out: int, device):
    """Source rows (or columns) and weights of each output of a linear resize
    with half-pixel centres, computed in double precision as OpenCV does: a
    float32 source coordinate (torch's ``interpolate``) is off by up to
    1e-4 px at 1280 columns, enough to move a textured frame's samples by
    as much."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f)
    w = f - i0
    w[i0 < 0] = 0.0
    w[i0 >= n_in - 1] = 0.0
    i0 = np.clip(i0, 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return (torch.from_numpy(i0).to(device), torch.from_numpy(i1).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device))


def downscale(img: torch.Tensor, height: int) -> torch.Tensor:
    """An (H, W) or (H, W, C) float32 image resized to ``height`` rows and
    round(W * height / H) columns: bilinear with half-pixel centres and no
    antialias, along the rows and then the columns (``cv2.resize``'s
    INTER_LINEAR on float32)."""
    width = int(round(img.shape[1] * height / img.shape[0]))
    c0, c1, wx = _linear_taps(img.shape[1], width, img.device)
    r0, r1, wy = _linear_taps(img.shape[0], height, img.device)
    if img.ndim == 3:
        wx = wx[:, None]
    rows = img[:, c0] * (1 - wx) + img[:, c1] * wx
    wy = wy.reshape(-1, *([1] * (img.ndim - 1)))
    return rows[r0] * (1 - wy) + rows[r1] * wy


class ObjectMesherNode:
    def __init__(
        self,
        bus: PubSub,
        rig: StereoCamera,
        params: Optional[ObjectMesherParams] = None,
        mesher_input_height: Optional[int] = None,
        channel_input: str = "sensors/stereo",
        channel_output: str = "object_mesher/mesh",
        device: torch.device | str = "cuda",
    ):
        self.device = entry_device(device)
        self.bus = bus
        self.rig = rig
        self.input_height = mesher_input_height
        self.channel_output = channel_output
        # Downscaled processing (object_mesher_lcm.cpp mesher_input_height):
        # the mesher's camera is rescaled to the processing resolution, so
        # pixels, disparities and the depth gates stay consistent.
        self._scale = 1.0
        mesher_rig = rig
        if mesher_input_height is not None and int(rig.left.height) > mesher_input_height:
            self._scale = mesher_input_height / float(rig.left.height)
            mesher_rig = rig.rescale(self._scale)
        self.mesher = ObjectMesher(params or ObjectMesherParams(), mesher_rig, device=self.device)
        self.frames_in = 0
        self.meshes_out = 0
        self._shm_readers = {}
        bus.subscribe(channel_input, self._on_stereo)
        bus.subscribe(channel_input + "_shm_left", self._on_shm("left"))
        bus.subscribe(channel_input + "_shm_right", self._on_shm("right"))
        self._pending = {}

    def _maybe_downscale(self, img: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.array(img, dtype=np.float32)).to(self.device)
        if self.input_height is None or img.shape[0] <= self.input_height:
            return x
        return downscale(x, self.input_height)

    def _process(self, timestamp: int, left: np.ndarray, right: np.ndarray) -> None:
        self.frames_in += 1
        mesh = self.mesher.process_stereo(self._maybe_downscale(left),
                                          self._maybe_downscale(right))
        if mesh.num_triangles > 0:
            self.meshes_out += 1
            self.bus.publish(
                self.channel_output,
                MeshMessage(timestamp=timestamp, vertices=mesh.vertices, triangles=mesh.triangles),
            )

    def _on_stereo(self, _ch, m: StereoImageMessage):
        self._process(m.timestamp, m.left.to_array(), m.right.to_array())

    def _on_shm(self, side: str):
        def handler(_ch, hdr: ShmImageHeader):
            reader = self._shm_readers.get(hdr.shm_path)
            if reader is None:
                reader = ShmRingReader(hdr.shm_path)
                self._shm_readers[hdr.shm_path] = reader
            frame = reader.read(hdr.seq)
            if frame is None:
                return
            _, img = frame
            pending = self._pending.setdefault(hdr.timestamp, {})
            pending[side] = img
            if "left" in pending and "right" in pending:
                del self._pending[hdr.timestamp]
                self._process(hdr.timestamp, pending["left"], pending["right"])

        return handler


def from_config(bus: PubSub, node_config_path: str, shared_config_path: str,
                device: torch.device | str = "cuda") -> ObjectMesherNode:
    """The node from the two-file YAML model (reference: object_mesher_lcm.cpp
    params + config/auv/lcm_nodes/ObjectMesherLcm.yaml)."""
    from ...config.bindings import load_mesher_params, load_rig
    from ...config.yaml_parser import YamlParser

    parser = YamlParser(node_path=node_config_path, shared_path=shared_config_path)
    rig = load_rig(parser)
    params = load_mesher_params(parser)
    h = parser.get("mesher_input_height", None)
    return ObjectMesherNode(
        bus, rig, params=params,
        mesher_input_height=int(h) if h is not None else None,
        channel_input=parser.get("channel_input_stereo", "sensors/stereo"),
        channel_output=parser.get("channel_output_mesh", "object_mesher/mesh"),
        device=device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="node YAML (ObjectMesherNode.yaml)")
    ap.add_argument("--shared", default=None, help="shared rig YAML (config/shared/*.yaml)")
    ap.add_argument("--port", type=int, default=None, help="UDP multicast port")
    ap.add_argument("--fx", type=float, default=336.0)
    ap.add_argument("--baseline", type=float, default=0.2)
    ap.add_argument("--width", type=int, default=672)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--mesher-input-height", type=int, default=None)
    ap.add_argument("--lcm", action="store_true",
                    help="speak the LCM wire format (interop with reference-era peers)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    bus_cls = UdpMulticastBus
    if args.lcm:
        from ..lcm_wire import LcmUdpBus as bus_cls
    bus = bus_cls(port=args.port) if args.port else bus_cls()
    if args.config and args.shared:
        node = from_config(bus, args.config, args.shared, device=args.device)
    else:
        cam = PinholeCamera.create(args.fx, args.fx, args.width / 2, args.height / 2,
                                   args.height, args.width)
        rig = StereoCamera.create(cam, cam, args.baseline)
        node = ObjectMesherNode(bus, rig, mesher_input_height=args.mesher_input_height,
                                device=args.device)
    print(f"object_mesher_node listening on {node.device}...", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
