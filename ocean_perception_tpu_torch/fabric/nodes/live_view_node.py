"""Live operator view: serve a running mission over HTTP from bus channels
(port of ``ocean_perception_tpu.fabric.nodes.live_view_node``).

Reference parity: the reference's Visualizer3D is a live operational window —
camera frustums, trajectory, landmarks, covariance ellipsoids redrawn on
their own render thread while the vehicle runs
(vio/visualizer_3d.hpp:70-160) — and lcm_image_viewer shows the camera
streams. Headless hosts have no display, so the equivalent here
is a zero-GUI-dependency HTTP dashboard an operator opens in any browser:

  /            HTML dashboard (auto-refreshing stats, live image, map)
  /frame.jpg   latest frame of an image channel (?channel=... selects)
  /stream.mjpg the same as motion-JPEG (multipart/x-mixed-replace)
  /map.png     top-down (x, y) trajectory per pose channel, with 3-sigma
               covariance ellipses when the poses carry covariance
  /stats.json  per-channel message counts and rates

Everything renders on demand from the latest bus state — an idle dashboard
costs nothing. Images are JPEG-encoded with OpenCV; the map is drawn with
OpenCV primitives. Works on any PubSub transport (in-process, UDP
multicast, native, real LCM wire via --lcm).

Two departures from the JAX node: a mesh vertex at or behind the camera
(or one whose projection does not fit a pixel coordinate) is not drawn, nor
is any triangle that uses it, where the JAX node clamps its depth to 1e-3
and can overflow the int32 cast; and a shared-memory ring's reader is made
under the node's lock, so two bus threads cannot both make (and leak) one.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..messages import (
    ImageMessage,
    MeshMessage,
    PoseStampedMessage,
    ShmImageHeader,
    StereoImageMessage,
)
from ..native_bus import bus_class
from ..pubsub import PubSub
from ..shm_ring import ShmRingReader


def _quat_to_yaw(q: np.ndarray) -> float:
    """Yaw (heading about +z) of [qw qx qy qz]."""
    w, x, y, z = q
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


def _to_u8(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a
    return np.clip(a * 255.0, 0, 255).astype(np.uint8)


class _ChannelStats:
    def __init__(self):
        self.count = 0
        self.stamps: deque = deque(maxlen=50)

    def tick(self) -> None:
        self.count += 1
        self.stamps.append(time.monotonic())

    def rate_hz(self) -> float:
        if len(self.stamps) < 2:
            return 0.0
        dt = self.stamps[-1] - self.stamps[0]
        return (len(self.stamps) - 1) / dt if dt > 0 else 0.0


class LiveViewNode:
    """Subscribe image + pose channels; serve the dashboard on host:port."""

    def __init__(
        self,
        bus: PubSub,
        image_channels: list[str],
        pose_channels: list[str],
        mesh_channels: list[str] | None = None,
        host: str = "127.0.0.1",
        port: int = 8642,
        max_traj: int = 20000,
        intrinsics: tuple[float, float, float, float] | None = None,
    ):
        self._lock = threading.Lock()
        self._frames: dict[str, np.ndarray] = {}
        self._frame_seq: dict[str, int] = {}
        self._traj: dict[str, deque] = {}
        self._stats: dict[str, _ChannelStats] = {}
        self._readers: dict[str, ShmRingReader] = {}
        # New-frame wakeup for MJPEG streamers. A Condition (not a bare
        # set()/clear() Event pair) so a client between its seq check and
        # wait() cannot miss the notify and sleep a full timeout.
        self._frame_cond = threading.Condition(self._lock)
        self._max_traj = max_traj
        self.image_channels = list(image_channels)
        self.pose_channels = list(pose_channels)
        self.mesh_channels = list(mesh_channels or [])
        self._meshes: dict[str, MeshMessage] = {}
        self._intrinsics = intrinsics

        for ch in image_channels:
            bus.subscribe(ch, self._on_image)
        for ch in pose_channels:
            self._traj[ch] = deque(maxlen=max_traj)
            bus.subscribe(ch, self._on_pose)
        for ch in self.mesh_channels:
            bus.subscribe(ch, self._on_mesh)

        node = self
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                node._handle(self)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="live-view-http", daemon=True
        )
        self._thread.start()

    # -- bus callbacks --------------------------------------------------------

    def _stat(self, channel: str) -> _ChannelStats:
        return self._stats.setdefault(channel, _ChannelStats())

    def _on_image(self, channel, msg) -> None:
        frame = None
        if isinstance(msg, ImageMessage):
            frame = msg.to_array()
        elif isinstance(msg, StereoImageMessage):
            l, r = msg.left.to_array(), msg.right.to_array()
            frame = np.concatenate([l, r], axis=1) if l.shape == r.shape else l
        elif isinstance(msg, ShmImageHeader):
            # get-then-construct under the lock: setdefault would build (and
            # leak) a fresh native mapping on every message after the first,
            # and two bus threads outside the lock could each build one.
            with self._lock:
                reader = self._readers.get(msg.shm_path)
                if reader is None:
                    reader = ShmRingReader(msg.shm_path)
                    self._readers[msg.shm_path] = reader
            got = reader.read(msg.seq)
            if got is not None:
                frame = got[1]
        if frame is None:
            return
        with self._frame_cond:
            self._frames[channel] = np.asarray(frame)
            self._frame_seq[channel] = self._frame_seq.get(channel, 0) + 1
            self._stat(channel).tick()
            self._frame_cond.notify_all()

    def _on_pose(self, channel, msg) -> None:
        if not isinstance(msg, PoseStampedMessage):
            return
        pose = np.asarray(msg.pose, float)
        cov_xy = None
        if msg.covariance is not None:
            # Estimator covariance leads with translation ([t v a theta w]
            # error order, vio/ekf.py:59): top-left 2x2 is the xy block.
            cov_xy = np.asarray(msg.covariance, float)[0:2, 0:2]
        with self._lock:
            self._traj[channel].append(
                (msg.timestamp, pose[4], pose[5], _quat_to_yaw(pose[0:4]), cov_xy)
            )
            self._stat(channel).tick()

    def _on_mesh(self, channel, msg) -> None:
        if not isinstance(msg, MeshMessage):
            return
        with self._lock:
            self._meshes[channel] = msg
            self._stat(channel).tick()

    # -- rendering ------------------------------------------------------------

    def mesh_png(self, channel: str | None = None, size_fallback=(480, 640)) -> bytes:
        """Live mesh wireframe + landmark dots, projected onto the newest
        camera frame (reference Visualizer3D AddCameraPose/landmark-cloud
        parity, visualizer_3d.hpp:70-160; the mesher's live mesh feed,
        object_mesher_lcm.cpp:92-95). Vertices are camera-frame 3D; the
        overlay uses the configured intrinsics, else a pinhole guess
        (fx = fy = W/2, principal point at center) good enough to situate
        the wireframe for an operator. A vertex at or behind the camera, or
        one whose projection does not fit a pixel coordinate, is not drawn,
        nor is any triangle that uses it."""
        import cv2

        with self._lock:
            if channel is None:
                channel = self.mesh_channels[0] if self.mesh_channels else None
            mesh = self._meshes.get(channel) if channel else None
            base = None
            for ch in self.image_channels:  # newest frame as the backdrop
                if ch in self._frames:
                    base = _to_u8(self._frames[ch]).copy()
                    break
        if base is None:
            base = np.full(size_fallback + (3,), 24, np.uint8)
        if base.ndim == 2:
            base = cv2.cvtColor(base, cv2.COLOR_GRAY2BGR)
        elif base.shape[2] == 3:
            base = cv2.cvtColor(base, cv2.COLOR_RGB2BGR)
        H, W = base.shape[:2]
        if mesh is not None and len(mesh.vertices):
            fx, fy, cx, cy = self._intrinsics or (W * 0.5, W * 0.5, W / 2, H / 2)
            v = np.asarray(mesh.vertices, np.float32)
            z = np.maximum(v[:, 2], 1e-3)
            with np.errstate(all="ignore"):
                fpx = v[:, 0] / z * fx + cx
                fpy = v[:, 1] / z * fy + cy
            drawn = (v[:, 2] > 1e-3) & (np.abs(fpx) < 2 ** 30) & (np.abs(fpy) < 2 ** 30)
            px = np.where(drawn, fpx, 0).astype(np.int32)
            py = np.where(drawn, fpy, 0).astype(np.int32)
            # Depth-colored: near = warm, far = cool (3..30 m ramp).
            t = np.clip((z - 3.0) / 27.0, 0.0, 1.0)
            for tri in np.asarray(mesh.triangles, np.int32):
                if not drawn[tri].all():
                    continue
                pts = [(int(px[i]), int(py[i])) for i in tri]
                c = float(np.mean(t[tri]))
                col = (int(255 * c), int(160 * (1 - c) + 60 * c), int(255 * (1 - c)))
                for a, b in ((0, 1), (1, 2), (2, 0)):
                    cv2.line(base, pts[a], pts[b], col, 1, cv2.LINE_AA)
            for i in np.flatnonzero(drawn):
                cv2.circle(base, (int(px[i]), int(py[i])), 2,
                           (80, 255, 120), -1, cv2.LINE_AA)
            cv2.putText(base, f"{len(v)} verts / {len(mesh.triangles)} tris  "
                        f"z median {np.median(z):.1f} m",
                        (8, H - 10), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                        (200, 200, 200), 1, cv2.LINE_AA)
        else:
            cv2.putText(base, "no mesh yet", (W // 2 - 50, H // 2),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (160, 160, 160), 1, cv2.LINE_AA)
        ok, buf = cv2.imencode(".png", base)
        return buf.tobytes()

    def latest_jpeg(self, channel: str | None = None) -> bytes | None:
        import cv2

        with self._lock:
            if channel is None:
                channel = self.image_channels[0] if self.image_channels else None
            frame = self._frames.get(channel) if channel else None
            if frame is None:
                return None
            img = _to_u8(frame)
        if img.ndim == 3 and img.shape[2] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])
        return buf.tobytes() if ok else None

    def map_png(self, size: int = 640) -> bytes:
        """Top-down x/y trajectory plot with 3-sigma covariance ellipses."""
        import cv2

        with self._lock:
            trails = {ch: list(d) for ch, d in self._traj.items()}
        img = np.full((size, size, 3), 24, np.uint8)
        pts_all = [(x, y) for d in trails.values() for (_, x, y, _, _) in d]
        if pts_all:
            xs = np.array([p[0] for p in pts_all])
            ys = np.array([p[1] for p in pts_all])
            cx, cy = (xs.min() + xs.max()) / 2, (ys.min() + ys.max()) / 2
            span = max(xs.max() - xs.min(), ys.max() - ys.min(), 1.0) * 1.2
            scale = size / span

            def to_px(x, y):
                # +x right, +y up (ENU-style top-down view).
                return (int(size / 2 + (x - cx) * scale),
                        int(size / 2 - (y - cy) * scale))

            # Metric grid every 10^k chosen near span/8.
            step = 10.0 ** np.floor(np.log10(span / 8 + 1e-9))
            gx = np.arange(np.floor(xs.min() / step) * step, xs.max() + step, step)
            gy = np.arange(np.floor(ys.min() / step) * step, ys.max() + step, step)
            for x in gx:
                cv2.line(img, to_px(x, ys.min() - span), to_px(x, ys.max() + span), (44, 44, 44), 1)
            for y in gy:
                cv2.line(img, to_px(xs.min() - span, y), to_px(xs.max() + span, y), (44, 44, 44), 1)
            colors = [(80, 200, 255), (120, 255, 120), (255, 160, 80), (255, 120, 255)]
            for idx, (ch, d) in enumerate(trails.items()):
                color = colors[idx % len(colors)]
                px = [to_px(x, y) for (_, x, y, _, _) in d]
                for a, b in zip(px[:-1], px[1:]):
                    cv2.line(img, a, b, color, 1, cv2.LINE_AA)
                # Covariance ellipses on a thinned subset + the newest pose.
                ell_idx = list(range(0, len(d), max(1, len(d) // 12)))
                if d and (len(d) - 1) not in ell_idx:
                    ell_idx.append(len(d) - 1)
                for i in ell_idx:
                    _, x, y, _, cov = d[i]
                    if cov is None:
                        continue
                    evals, evecs = np.linalg.eigh(0.5 * (cov + cov.T))
                    evals = np.clip(evals, 0.0, None)
                    ax = max(int(3.0 * np.sqrt(evals[1]) * scale), 1)
                    bx = max(int(3.0 * np.sqrt(evals[0]) * scale), 1)
                    ang = np.degrees(np.arctan2(evecs[1, 1], evecs[0, 1]))
                    cv2.ellipse(img, to_px(x, y), (ax, bx), -ang, 0, 360,
                                (90, 90, 180), 1, cv2.LINE_AA)
                if d:
                    _, x, y, yaw, _ = d[-1]
                    p0 = to_px(x, y)
                    p1 = to_px(x + 0.06 * span * np.cos(yaw), y + 0.06 * span * np.sin(yaw))
                    cv2.arrowedLine(img, p0, p1, color, 2, cv2.LINE_AA, tipLength=0.35)
                cv2.putText(img, ch, (8, 18 + 16 * idx), cv2.FONT_HERSHEY_SIMPLEX,
                            0.45, color, 1, cv2.LINE_AA)
            cv2.putText(img, f"grid {step:g} m", (8, size - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.45, (160, 160, 160), 1, cv2.LINE_AA)
        else:
            cv2.putText(img, "no poses yet", (size // 2 - 60, size // 2),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (160, 160, 160), 1, cv2.LINE_AA)
        ok, buf = cv2.imencode(".png", img)
        return buf.tobytes()

    def stats_json(self) -> bytes:
        with self._lock:
            out = {
                ch: {"count": s.count, "rate_hz": round(s.rate_hz(), 2)}
                for ch, s in self._stats.items()
            }
            out["_trajectory_points"] = {ch: len(d) for ch, d in self._traj.items()}
        return json.dumps(out).encode()

    # -- HTTP -----------------------------------------------------------------

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        url = urlparse(h.path)
        q = parse_qs(url.query)
        channel = q.get("channel", [None])[0]
        try:
            if url.path == "/":
                self._send(h, 200, "text/html", self._index_html())
            elif url.path == "/frame.jpg":
                data = self.latest_jpeg(channel)
                if data is None:
                    self._send(h, 404, "text/plain", b"no frame yet")
                else:
                    self._send(h, 200, "image/jpeg", data)
            elif url.path == "/map.png":
                self._send(h, 200, "image/png", self.map_png())
            elif url.path == "/mesh.png":
                self._send(h, 200, "image/png", self.mesh_png(channel))
            elif url.path == "/stats.json":
                self._send(h, 200, "application/json", self.stats_json())
            elif url.path == "/stream.mjpg":
                self._stream_mjpeg(h, channel)
            else:
                self._send(h, 404, "text/plain", b"not found")
        except (BrokenPipeError, ConnectionResetError):
            pass

    @staticmethod
    def _send(h, code, ctype, body: bytes) -> None:
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.send_header("Cache-Control", "no-store")
        h.end_headers()
        h.wfile.write(body)

    def _stream_mjpeg(self, h, channel: str | None) -> None:
        h.send_response(200)
        h.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
        h.end_headers()
        last_seq = -1
        while True:
            ch = channel or (self.image_channels[0] if self.image_channels else None)
            with self._frame_cond:
                seq = self._frame_seq.get(ch, 0) if ch else 0
                if seq == last_seq:
                    # Block on the next frame under the condition (re-checking
                    # seq first) so the notify can't slip between check and
                    # wait; cap the wait so a silent camera still lets the
                    # client disconnect cleanly.
                    self._frame_cond.wait(timeout=0.5)
                    continue
            data = self.latest_jpeg(ch)
            if data is None:
                time.sleep(0.1)
                continue
            last_seq = seq
            h.wfile.write(b"--frame\r\nContent-Type: image/jpeg\r\n"
                          + f"Content-Length: {len(data)}\r\n\r\n".encode())
            h.wfile.write(data)
            h.wfile.write(b"\r\n")

    def _index_html(self) -> bytes:
        img_tags = "".join(
            f'<div class="card"><h3>{ch}</h3>'
            f'<img src="/stream.mjpg?channel={ch}" alt="{ch}"></div>'
            for ch in self.image_channels
        )
        img_tags += "".join(
            f'<div class="card"><h3>{ch} (live mesh)</h3>'
            f'<img class="mesh" src="/mesh.png?channel={ch}" alt="{ch}"></div>'
            for ch in self.mesh_channels
        )
        html = f"""<!doctype html><html><head><title>ocean live view</title>
<style>
 body {{ background:#141618; color:#ddd; font-family: sans-serif; margin: 1em; }}
 .card {{ display:inline-block; vertical-align:top; margin:0.5em; }}
 img {{ max-width: 640px; border:1px solid #333; }}
 pre {{ background:#1d2022; padding:0.6em; }}
</style></head><body>
<h2>ocean-perception live mission view</h2>
{img_tags}
<div class="card"><h3>top-down map</h3><img id="map" src="/map.png"></div>
<div class="card"><h3>channel rates</h3><pre id="stats">loading...</pre></div>
<script>
 setInterval(() => {{
   fetch('/stats.json').then(r => r.json()).then(s =>
     document.getElementById('stats').textContent = JSON.stringify(s, null, 1));
   const m = document.getElementById('map');
   m.src = '/map.png?t=' + Date.now();
   document.querySelectorAll('img.mesh').forEach(el => {{
     const u = new URL(el.src); u.searchParams.set('t', Date.now()); el.src = u;
   }});
 }}, 1000);
</script></body></html>"""
        return html.encode()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
        with self._lock:
            readers, self._readers = dict(self._readers), {}
        for reader in readers.values():
            try:
                reader.close()
            except Exception:
                pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image-channel", action="append", default=[],
                    help="image/stereo channel to show (repeatable)")
    ap.add_argument("--pose-channel", action="append", default=[],
                    help="PoseStamped channel for the map (repeatable)")
    ap.add_argument("--mesh-channel", action="append", default=[],
                    help="MeshMessage channel for the live wireframe (repeatable)")
    ap.add_argument("--intrinsics", default=None,
                    help="fx,fy,cx,cy for the mesh overlay projection "
                         "(default: pinhole guess from the frame size)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--lcm", action="store_true",
                    help="subscribe on real LCM wire format")
    ap.add_argument("--native-bus", action="store_true",
                    help="C++ UDP transport (composable with --lcm)")
    args = ap.parse_args(argv)
    if not args.image_channel and not args.pose_channel and not args.mesh_channel:
        ap.error("give at least one --image-channel / --pose-channel / --mesh-channel")

    bus = bus_class(args.native_bus, args.lcm)()
    intr = None
    if args.intrinsics:
        intr = tuple(float(x) for x in args.intrinsics.split(","))
        if len(intr) != 4:
            ap.error("--intrinsics wants fx,fy,cx,cy")
    node = LiveViewNode(bus, args.image_channel, args.pose_channel,
                        mesh_channels=args.mesh_channel,
                        host=args.host, port=args.port, intrinsics=intr)
    print(f"live view on http://{args.host}:{node.port}/  "
          f"(images: {args.image_channel}, poses: {args.pose_channel}, "
          f"meshes: {args.mesh_channel})")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
