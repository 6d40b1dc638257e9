"""The port's tool nodes against the JAX package's (host code, no device):

- the live view's endpoints (dashboard, frame, map, mesh, stats) give the
  same bytes as JAX's node on the same messages;
- its two repairs, each shown failing on JAX's node: a mesh vertex behind
  the camera is not drawn (JAX's clamps its depth and draws lines across
  the image), and a shared-memory ring's reader is made once when two bus
  threads ask for it together (JAX's makes two);
- the channel logger's ``info`` lines, its replay and the log it records,
  and the channel spy's table, equal JAX's;
- the image viewer's files and the camera recorder's EuRoC folders (from
  the bus, and from a side-by-side video) equal JAX's byte for byte.
"""

import contextlib
import io
import json
import os
import threading
import time
import urllib.request
import warnings

import cv2
import numpy as np
import pytest
import torch

from ocean_perception_tpu.fabric import messages as jms
from ocean_perception_tpu.fabric import pubsub as jps
from ocean_perception_tpu.fabric.nodes import camera_recorder as jrec
from ocean_perception_tpu.fabric.nodes import channel_logger as jlog
from ocean_perception_tpu.fabric.nodes import channel_spy as jspy
from ocean_perception_tpu.fabric.nodes import image_viewer as jview
from ocean_perception_tpu.fabric.nodes import live_view_node as jlive
from ocean_perception_tpu_torch.fabric import lcm_log as tlog_io
from ocean_perception_tpu_torch.fabric import lcm_wire as tlw
from ocean_perception_tpu_torch.fabric import messages as tms
from ocean_perception_tpu_torch.fabric import pubsub as tps
from ocean_perception_tpu_torch.fabric.nodes import camera_recorder as trec
from ocean_perception_tpu_torch.fabric.nodes import channel_logger as tlog
from ocean_perception_tpu_torch.fabric.nodes import channel_spy as tspy
from ocean_perception_tpu_torch.fabric.nodes import image_viewer as tview
from ocean_perception_tpu_torch.fabric.nodes import live_view_node as tlive

PKGS = {"jax": (jms, jps, jlive), "port": (tms, tps, tlive)}
SPY_PORT, PLAY_PORT, RECORD_PORT = 7951, 7952, 7953


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _mission(ms, bus):
    """tests/test_live_view.py's mission, a mesh and a grayscale frame."""
    rng = np.random.default_rng(0)
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    bus.publish("camera/stereo", ms.StereoImageMessage(
        left=ms.ImageMessage.from_array(1, img), right=ms.ImageMessage.from_array(1, img),
        timestamp=1))
    bus.publish("camera/gray", ms.ImageMessage.from_array(2, rng.random((40, 56)).astype(np.float32)))
    for i in range(30):
        th = 0.1 * i
        q = np.array([np.cos(th / 2), 0.0, 0.0, np.sin(th / 2)])
        bus.publish("vio/filter_pose", ms.PoseStampedMessage(
            timestamp=i, pose=np.concatenate([q, [np.cos(th), np.sin(th), -1.0]]),
            covariance=np.eye(6) * (0.01 + 0.002 * i)))
    verts = np.array([[-1, -1, 5], [1, -1, 5], [1, 1, 5], [-1, 1, 5], [0, 0, 30]], np.float32)
    bus.publish("mesher/mesh", ms.MeshMessage(3, verts, np.array([[0, 1, 2], [0, 2, 3], [2, 3, 4]],
                                                                 np.int32)))


def test_live_view_endpoints_equal_jax():
    got = {}
    for name, (ms, ps, mod) in PKGS.items():
        bus = ps.InProcessBus()
        node = mod.LiveViewNode(bus, ["camera/stereo", "camera/gray"], ["vio/filter_pose"],
                                mesh_channels=["mesher/mesh"], host="127.0.0.1", port=0,
                                intrinsics=(60.0, 60.0, 64.0, 24.0))
        try:
            _mission(ms, bus)
            got[name] = {path: _get(node.port, path) for path in
                         ("/", "/frame.jpg", "/frame.jpg?channel=camera/gray", "/map.png",
                          "/mesh.png")}
            stats = json.loads(_get(node.port, "/stats.json")[2])
        finally:
            node.close()
        for ch in ("camera/stereo", "camera/gray", "vio/filter_pose", "mesher/mesh"):
            stats[ch].pop("rate_hz")  # the host clock's
        got[name]["stats"] = stats
    assert got["port"] == got["jax"]
    assert got["port"]["stats"]["vio/filter_pose"]["count"] == 30


def _drawn_outside(name, H=120, W=160):
    """Pixels of /mesh.png outside the in-front triangle's box and the
    caption strip that change when a second triangle is added: one triangle
    at z = 5 m, the other sharing two of its vertices with one behind the
    camera."""
    ms, ps, mod = PKGS[name]
    verts = np.array([[-0.5, -0.5, 5], [0.5, -0.5, 5], [0.0, 0.5, 5], [-3.0, 0.2, -1.0]],
                     np.float32)
    renders = []
    for tris in ([[0, 1, 2]], [[0, 1, 2], [0, 2, 3]]):
        bus = ps.InProcessBus()
        node = mod.LiveViewNode(bus, ["cam"], [], mesh_channels=["mesh"], host="127.0.0.1", port=0)
        try:
            bus.publish("cam", ms.ImageMessage.from_array(1, np.full((H, W), 0.2, np.float32)))
            bus.publish("mesh", ms.MeshMessage(2, verts, np.array(tris, np.int32)))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # JAX's int32 cast of the clamped vertex
                png = node.mesh_png()
            renders.append(cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR).astype(int))
        finally:
            node.close()
    changed = np.abs(renders[1] - renders[0]).sum(-1) > 0
    fx, cx, cy = W * 0.5, W / 2, H / 2
    x0, x1 = int(-0.5 / 5 * fx + cx) - 4, int(0.5 / 5 * fx + cx) + 4
    y0, y1 = int(-0.5 / 5 * fx + cy) - 4, int(0.5 / 5 * fx + cy) + 4
    changed[y0:y1, x0:x1] = False
    changed[H - 25:] = False  # the caption
    return int(changed.sum())


def test_live_view_skips_triangles_behind_the_camera():
    assert _drawn_outside("jax") > 50  # JAX's node draws lines to a clamped vertex
    assert _drawn_outside("port") == 0


@pytest.mark.parametrize("name", ["jax", "port"])
def test_live_view_makes_one_ring_reader(monkeypatch, name):
    """Two bus threads deliver the first frame of a ring together: the port
    makes one reader; JAX's node, which makes it outside its lock, two."""
    ms, ps, mod = PKGS[name]
    made = []
    barrier = threading.Barrier(2)

    class SlowReader:
        def __init__(self, path):
            made.append(path)
            time.sleep(0.2)  # a mapping takes a while: both threads get here

        def read(self, seq):
            return seq, np.zeros((4, 6), np.float32)

        def close(self):
            pass

    monkeypatch.setattr(mod, "ShmRingReader", SlowReader)
    node = mod.LiveViewNode(ps.InProcessBus(), ["cam"], [], host="127.0.0.1", port=0)
    try:
        def deliver(seq):
            barrier.wait()
            node._on_image("cam", ms.ShmImageHeader(seq, 6, 4, 1, seq, "/ring"))

        threads = [threading.Thread(target=deliver, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert node._stats["cam"].count == 2
    finally:
        node.close()
    assert len(made) == (1 if name == "port" else 2)


def _mission_log(path):
    events = [("vio/init_pose", tms.PoseStampedMessage(0, pose=np.array([1.0, 0, 0, 0, 0.5, -0.25, 2.0])))]
    events += [("sensors/imu", tms.ImuMessage(i * 10_000_000, np.zeros(3), np.array([0.0, 0, 9.81])))
               for i in range(20)]
    events += [("sensors/depth", tms.DepthMessage(i * 50_000_000, 2.0 + i)) for i in range(4)]
    with tlog_io.LcmLogWriter(path) as w:
        for ch, m in events:
            sd, v = tlw.to_lcm(m)
            w.write(ch, sd.encode(v), timestamp_us=m.timestamp // 1000)
    return events


def _captured(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


def test_channel_logger_info_play_record_equal_jax(tmp_path):
    path = str(tmp_path / "mission.lcmlog")
    events = _mission_log(path)
    assert _captured(tlog.main, ["info", "--path", path]) == _captured(jlog.main,
                                                                      ["info", "--path", path])
    # Both packages record one replay of the log (--lcm: the exact wire
    # payloads), each a log equal to the source's events.
    outs = {k: str(tmp_path / f"{k}.lcmlog") for k in ("jax", "port")}
    recorders = [threading.Thread(target=_captured, args=(m.main, [
        "record", "--out", outs[k], "--lcm", "--port", str(RECORD_PORT), "--duration", "1.5"]))
        for k, m in (("jax", jlog), ("port", tlog))]
    for t in recorders:
        t.start()
    time.sleep(0.4)
    played = {}
    for k, m in (("port", tlog), ("jax", jlog)):
        played[k] = _captured(m.main, ["play", "--path", path, "--lcm", "--port",
                                       str(PLAY_PORT if k == "jax" else RECORD_PORT),
                                       "--speed", "0"])
    for t in recorders:
        t.join()
    assert played["port"] == played["jax"] == (0, f"published {len(events)} events\n")
    logs = {k: [(e.channel, e.data) for e in tlog_io.LcmLogReader(p)] for k, p in outs.items()}
    assert logs["port"] == logs["jax"] == [(e.channel, e.data) for e in tlog_io.LcmLogReader(path)]


def test_channel_spy_table_equals_jax(monkeypatch):
    tables = {"jax": [], "port": []}
    for k, mod in (("jax", jspy), ("port", tspy)):
        monkeypatch.setattr(mod, "print", lambda *a, out=tables[k], **kw: out.append(a[0]),
                            raising=False)
    spies = [threading.Thread(target=m.main, args=([
        "--lcm", "--port", str(SPY_PORT), "--interval", "0.6", "--duration", "1.1"],))
        for m in (jspy, tspy)]
    for t in spies:
        t.start()
    tx = tlw.LcmUdpBus(port=SPY_PORT)
    try:
        time.sleep(0.2)
        for i in range(5):
            tx.publish("sensors/imu", tms.ImuMessage(i, np.zeros(3), np.zeros(3)))
        tx.publish("sensors/depth", tms.DepthMessage(9, 1.5))
        for t in spies:
            t.join(timeout=10)
    finally:
        tx.close()

    def rows(table):  # every column but the rate (the host clock's)
        return [line.split()[:3] + line.split()[4:] for line in table.strip().splitlines()]

    assert rows(tables["port"][-1]) == rows(tables["jax"][-1])
    assert rows(tables["port"][-1])[1:] == [
        ["sensors/depth", "vehicle.depth_measurement_t", "1", "9"],
        ["sensors/imu", "vehicle.imu_measurement_t", "5", "4"]]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_image_viewer_and_camera_recorder_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    gray = rng.random((16, 20)).astype(np.float32)
    rgb = rng.random((8, 10, 3)).astype(np.float32)
    trees = {}
    for k, ms, ps, view, rec in (("jax", jms, jps, jview, jrec), ("port", tms, tps, tview, trec)):
        bus = ps.InProcessBus()
        view.ImageViewerNode(bus, "viz", str(tmp_path / k / "viewer"))
        recorder = rec.CameraRecorderNode(bus, str(tmp_path / k / "euroc"))
        for i in range(3):
            bus.publish("viz", ms.ImageMessage.from_array(0, rgb * (i + 1) / 3))  # no timestamp
        bus.publish("viz", ms.StereoImageMessage(5, 0, ms.ImageMessage.from_array(5, gray),
                                                 ms.ImageMessage.from_array(5, gray[::-1].copy())))
        for i in range(2):
            t = int((i + 1) * 1e8)
            bus.publish("sensors/stereo", ms.StereoImageMessage(
                t, 0, ms.ImageMessage.from_array(t, gray), ms.ImageMessage.from_array(t, gray)))
            bus.publish("sensors/imu", ms.ImuMessage(t, np.zeros(3), np.array([0, 0, 9.81])))
            bus.publish("sensors/depth", ms.DepthMessage(t, 2.0 + i))
        recorder.finish()
        trees[k] = _tree(tmp_path / k)
    assert trees["port"] == trees["jax"]
    assert sum(n.startswith("viewer") for n in trees["port"]) == 5


def test_uvc_capture_equals_jax(tmp_path):
    H, W = 32, 48
    path = str(tmp_path / "sbs.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (2 * W, H))
    for k in range(6):
        frame = np.zeros((H, 2 * W, 3), np.uint8)
        frame[:, :W] = 200 - 5 * k
        frame[:, W:] = 40 + 5 * k
        vw.write(frame)
    vw.release()
    trees, counts = {}, {}
    for k, rec in (("jax", jrec), ("port", trec)):
        for grayscale in (True, False):
            out = str(tmp_path / k / str(grayscale))
            writer = rec.EurocDataWriter(out)
            src = rec.UvcStereoSource(path, sbs=True, camera_hz=100.0, max_duration_sec=30.0,
                                      grayscale=grayscale)
            counts[k, grayscale] = src.capture(writer, max_frames=4)
            writer.finish()
        trees[k] = _tree(tmp_path / k)
    assert trees["port"] == trees["jax"]
    assert counts["port", True] == counts["jax", True] == 4
