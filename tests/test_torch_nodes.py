"""The port's farm perception node and object mesher node on the CPU
(``device="cpu"``), mirroring ``tests/test_farm_node.py`` and the object
mesher node tests of ``tests/test_coverage_extras.py`` and
``tests/test_config_bindings.py``, and held to the JAX nodes.

Scenes: a textured box over a flat background (test_farm_node.py's, 120x160,
the box 12 px nearer in the right image), the farm node on the cheap dense
pass (WTA, max_disp 16, internal_scale 1, no enhancement: the mesher reads
the gray images, not the disparity) and a small tracker (K=64, 3 pyramid
levels). Port and JAX nodes take the same frames over an ``InProcessBus``.

- both cameras meshed, each equal to a one-camera ``ObjectMesher`` on its
  frames (vertices within 1e-3, triangles equal, as test_farm_node.py);
- a dead camera: the fleet keeps stepping on stale fills;
- ``mesher_scale=2`` keeps the metric depth (5 m);
- uint8 wire frames give the meshes of their float32 payload, bit for bit;
- wrong-size frames are rejected at ingest;
- ``from_config`` on the shipped YAML;
- the port node's meshes equal the JAX node's over 2 fleet steps, vertices
  within 1e-3 (tests/test_torch_fleet.py's pixel tolerance) and triangles
  equal as sets but for at most 2 (a Delaunay flip under such a move);
- the object mesher node: a mesh at the scene's depth, equal to the JAX
  node's; ``from_config``; and its bilinear downscale against
  ``cv2.resize`` on float32 frames at the shipped 720 -> 376 ratio, within
  1e-5.
"""

import time

import cv2
import numpy as np
import pytest
import torch

from ocean_perception_tpu.core import cameras as jcam
from ocean_perception_tpu.fabric import messages as jms
from ocean_perception_tpu.fabric import pubsub as jbus
from ocean_perception_tpu.mesher.object_mesher import ObjectMesherDeviceParams as JDeviceParams
from ocean_perception_tpu.mesher.object_mesher import ObjectMesherParams as JMesherParams
from ocean_perception_tpu.models.perception import PerceptionConfig as JPerceptionConfig
from ocean_perception_tpu.tracking import DetectorParams, LKParams, StripeMatcherParams
from ocean_perception_tpu.tracking.stereo_tracker import StereoTrackerParams
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.fabric.messages import ImageMessage, StereoImageMessage
from ocean_perception_tpu_torch.fabric.nodes import farm_perception_node as fpn
from ocean_perception_tpu_torch.fabric.nodes import object_mesher_node as omn
from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus
from ocean_perception_tpu_torch.mesher.object_mesher import ObjectMesher, ObjectMesherParams
from ocean_perception_tpu_torch.mesher.triangle_mesh import TriangleMesh
from ocean_perception_tpu_torch.models.perception import PerceptionConfig
from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerState


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's thread pool in each would oversubscribe
    the cores (these tests launch many small ops; under the suite's load
    the pools' spinning threads slow every worker's tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

H, W = 120, 160
CPU = "cpu"


def _scene(seed: int, d_obj: float = 12.0):
    """Textured box over flat background (test_farm_node.py's scene)."""
    rng = np.random.default_rng(seed)
    bg = np.full((H, W + 20), 0.45, np.float32)
    bg += rng.normal(0, 0.004, bg.shape).astype(np.float32)
    obj = (rng.random((60, 70)) * 0.8 + 0.1).astype(np.float32)
    obj = cv2.GaussianBlur(obj, (3, 3), 0.7)
    left = bg[:, :W].copy()
    left[30:90, 60:130] = obj
    right = bg[:, :W].copy()
    x0r = 60 - int(d_obj)
    right[30:90, x0r : x0r + 70] = obj
    return left, right


def _jax_rig():
    cam = jcam.PinholeCamera.create(200.0, 200.0, W / 2, H / 2, H, W)
    return jcam.StereoCamera.create(cam, cam, baseline=0.3)


def _rig():
    return convert.stereo_camera_from_jax(_jax_rig())


def _jax_device_params(connect=3.0, disconnect=2.0):
    return JDeviceParams(
        tracker=StereoTrackerParams(
            capacity=64,
            detector=DetectorParams(max_features=64, min_distance=8, border=6),
            lk=LKParams(max_level=2),
            matcher=StripeMatcherParams(max_disp=24, templ_cols=11, templ_rows=11,
                                        max_matching_cost=0.4),
            trigger_keyframe_k=2,
        ),
        min_obs_connect_edge=connect,
        min_obs_disconnect_edge=disconnect,
        neighbor_radius_px=60.0,
    )


def _device_params(**kw):
    return convert.object_mesher_device_params_from_jax(_jax_device_params(**kw))


def _fast_config():
    return PerceptionConfig(engine="wta", max_disp=16, internal_scale=1, run_enhance=False)


def _stereo_msg(ms, ts, left, right):
    return ms.StereoImageMessage(timestamp=ts, camera_id=0,
                                 left=ms.ImageMessage.from_array(ts, left),
                                 right=ms.ImageMessage.from_array(ts, right))


def _msg(ts, left, right):
    return StereoImageMessage(timestamp=ts, camera_id=0,
                              left=ImageMessage.from_array(ts, left),
                              right=ImageMessage.from_array(ts, right))


def _wait(cond, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _farm(bus, n_cameras, **kw):
    kw.setdefault("perception_config", _fast_config())
    kw.setdefault("mesher_params", _device_params())
    return fpn.FarmPerceptionNode(bus, _rig(), n_cameras=n_cameras, device=CPU, **kw)


def _collect(bus, channels):
    out = {c: [] for c in channels}
    for c in channels:
        bus.subscribe(c, lambda _c, m, c=c: out[c].append(m))
    return out


def test_farm_node_needs_a_device_it_has():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fpn.FarmPerceptionNode(InProcessBus(), _rig(), n_cameras=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        omn.ObjectMesherNode(InProcessBus(), _rig())


def test_farm_node_meshes_both_cameras_and_matches_single_camera():
    bus = InProcessBus()
    node = _farm(bus, 2, max_sync_wait_sec=30.0)  # the all-fresh path
    meshes = _collect(bus, ["farm/mesh/cam0", "farm/mesh/cam1"])
    frames = {0: _scene(3), 1: _scene(7)}
    n_steps = 6
    try:
        for k in range(n_steps):
            ts = (k + 1) * 100_000_000
            for cam in (0, 1):
                bus.publish(f"sensors/stereo/cam{cam}", _msg(ts, *frames[cam]))
            assert node.wait_steps(k + 1, 120.0), f"fleet step {k + 1} never fired"
    finally:
        node.close()
    assert node.stale_fills == 0
    for cam in (0, 1):
        got = meshes[f"farm/mesh/cam{cam}"]
        assert got, f"camera {cam} published no mesh"
        single = ObjectMesher(ObjectMesherParams(device=_device_params()), _rig(), device=CPU)
        single.tracker_state = StereoTrackerState.create(_device_params().tracker,
                                                         image_shape=(H, W), device=CPU)
        for _ in range(n_steps):
            ref = single.process_stereo(*frames[cam])
        assert got[-1].vertices.shape == ref.vertices.shape
        np.testing.assert_allclose(got[-1].vertices, ref.vertices, atol=1e-3)
        np.testing.assert_array_equal(got[-1].triangles, ref.triangles)
        assert abs(np.median(got[-1].vertices[:, 2]) - 5.0) < 0.6


def test_farm_node_survives_dead_camera():
    bus = InProcessBus()
    node = _farm(bus, 2, max_sync_wait_sec=0.3)
    meshes = _collect(bus, ["farm/mesh/cam0", "farm/mesh/cam1"])
    l, r = _scene(3)
    try:
        for k in range(3):
            for cam in (0, 1):
                bus.publish(f"sensors/stereo/cam{cam}", _msg((k + 1) * 100_000_000, l, r))
            assert node.wait_steps(k + 1, 120.0)
        for k in range(3, 6):  # camera 1 dies
            bus.publish("sensors/stereo/cam0", _msg((k + 1) * 100_000_000, l, r))
            assert node.wait_steps(k + 1, 120.0), "fleet stalled on the dead camera"
    finally:
        node.close()
    assert node.stale_fills >= 3
    assert len(meshes["farm/mesh/cam0"]) > len(meshes["farm/mesh/cam1"])


def test_farm_node_mesher_scale_depth_invariant():
    bus = InProcessBus()
    node = _farm(bus, 1, max_sync_wait_sec=30.0, mesher_scale=2)
    meshes = _collect(bus, ["farm/mesh/cam0"])["farm/mesh/cam0"]
    l, r = _scene(3)
    try:
        for k in range(8):
            bus.publish("sensors/stereo/cam0", _msg((k + 1) * 100_000_000, l, r))
            assert node.wait_steps(k + 1, 120.0)
    finally:
        node.close()
    assert meshes, "downscaled tracking must still produce meshes"
    z = np.median(meshes[-1].vertices[:, 2])
    assert abs(z - 5.0) < 0.8, f"depth {z} != 5.0 (rig/fxb scale mismatch)"


def test_farm_node_u8_wire_path_matches_f32():
    l, r = _scene(3)
    u8l = (np.clip(l, 0, 1) * 255 + 0.5).astype(np.uint8)
    u8r = (np.clip(r, 0, 1) * 255 + 0.5).astype(np.uint8)
    f32l, f32r = u8l.astype(np.float32) / 255.0, u8r.astype(np.float32) / 255.0

    def run(encoding):
        bus = InProcessBus()
        node = _farm(bus, 1)
        meshes = _collect(bus, ["farm/mesh/cam0"])["farm/mesh/cam0"]
        try:
            for k in range(6):
                ts = (k + 1) * 100_000_000
                if encoding == "u8":
                    msg = StereoImageMessage(
                        ts, 0, ImageMessage(ts, W, H, 1, "u8", u8l.tobytes()),
                        ImageMessage(ts, W, H, 1, "u8", u8r.tobytes()))
                else:
                    msg = _msg(ts, f32l, f32r)
                bus.publish("sensors/stereo/cam0", msg)
                assert node.wait_steps(k + 1, 120.0)
        finally:
            node.close()
        return meshes

    m_u8, m_f32 = run("u8"), run("f32")
    assert m_u8 and len(m_u8) == len(m_f32)
    np.testing.assert_array_equal(m_u8[-1].vertices, m_f32[-1].vertices)
    np.testing.assert_array_equal(m_u8[-1].triangles, m_f32[-1].triangles)


def test_farm_node_rejects_wrong_size_frames():
    bus = InProcessBus()
    node = _farm(bus, 1)
    try:
        bad = np.zeros((H // 2, W // 2), np.float32)
        bus.publish("sensors/stereo/cam0", _msg(1, bad, bad))
        assert _wait(lambda: node.rejected_frames == 1, timeout=5.0)
        assert node.frames_in == 0
        l, r = _scene(3)
        bus.publish("sensors/stereo/cam0", _msg(2, l, r))
        assert node.wait_steps(1, 120.0)
    finally:
        node.close()


def test_farm_node_from_config():
    node = fpn.from_config(InProcessBus(), "config/nodes/FarmPerceptionNode.yaml",
                           "config/shared/Farmsim.yaml", device=CPU)
    try:
        assert node.n_cameras == 4
        assert (node.config.internal_scale, node.config.max_disp) == (4, 128)
        assert node.mesher_scale == 2
        assert node.mesher_params.tracker.capacity == 200
        assert node._image_shape == (376, 672)
    finally:
        node.close()


def test_farm_node_enhanced_tap_publishes_jpegs():
    bus = InProcessBus()
    node = _farm(bus, 1, perception_config=PerceptionConfig(
        engine="wta", max_disp=16, internal_scale=1, run_enhance=True),
        channel_output_enhanced="farm/enhanced/cam{i}")
    got = _collect(bus, ["farm/enhanced/cam0"])["farm/enhanced/cam0"]
    l, r = _scene(3)
    try:
        bus.publish("sensors/stereo/cam0", _msg(5, l, r))
        assert node.wait_steps(1, 120.0)
    finally:
        node.close()
    assert len(got) == 1 and got[0].encoding == "jpg" and got[0].timestamp == 5
    assert got[0].to_array().shape == (H, W, 3)


def test_farm_node_equals_jax_node():
    """Two cameras of unlike scenes, 2 fleet steps, through both nodes; edges
    connect at the first observation so both steps mesh."""
    from ocean_perception_tpu.fabric.nodes.farm_perception_node import (
        FarmPerceptionNode as JFarm)

    frames = {0: _scene(3), 1: _scene(7)}
    jbus_, tbus = jbus.InProcessBus(), InProcessBus()
    chans = ["farm/mesh/cam0", "farm/mesh/cam1"]
    jm, tm = _collect(jbus_, chans), _collect(tbus, chans)
    jnode = JFarm(jbus_, _jax_rig(), n_cameras=2,
                  perception_config=JPerceptionConfig(engine="wta", max_disp=16,
                                                      internal_scale=1, run_enhance=False),
                  mesher_params=_jax_device_params(connect=1.0, disconnect=0.0),
                  max_sync_wait_sec=60.0, vertex_min_obs=3)
    tnode = _farm(tbus, 2, mesher_params=_device_params(connect=1.0, disconnect=0.0),
                  max_sync_wait_sec=60.0, vertex_min_obs=3)
    try:
        for k in range(2):
            ts = (k + 1) * 100_000_000
            for cam in (0, 1):
                jbus_.publish(f"sensors/stereo/cam{cam}", _stereo_msg(jms, ts, *frames[cam]))
                tbus.publish(f"sensors/stereo/cam{cam}", _msg(ts, *frames[cam]))
            assert _wait(lambda: jnode.fleet_steps == k + 1, timeout=300.0)
            assert tnode.wait_steps(k + 1, 120.0)
    finally:
        jnode.close()
        tnode.close()
    for c in chans:
        assert len(tm[c]) == len(jm[c]) >= 1, c
        for t, j in zip(tm[c], jm[c]):
            assert t.timestamp == j.timestamp
            np.testing.assert_allclose(t.vertices, j.vertices, atol=1e-3)
            assert _triangle_flips(t.triangles, j.triangles) <= 2


def _triangle_flips(a, b) -> int:
    """Triangles in one mesh and not the other, as vertex sets. Tracked
    pixels agree within 1e-3 px, not bit for bit, and a move that small
    can flip a near-cocircular pair of Delaunay triangles or add a sliver
    on the hull; the triangles also come out of Qhull in another order."""
    sa, sb = (set(map(tuple, np.sort(t, axis=1))) for t in (a, b))
    return len(sa ^ sb)


# --- the object mesher node -------------------------------------------------


def _textured(seed=0, disp=8, h=120, w=160):
    rng = np.random.default_rng(seed)
    canvas = cv2.GaussianBlur(rng.random((h, w + 40)).astype(np.float32), (5, 5), 1.0)
    return canvas[:, 20 : 20 + w], canvas[:, 20 + disp : 20 + disp + w]


def _jax_mesher_params():
    return JMesherParams(
        device=JDeviceParams(
            tracker=StereoTrackerParams(
                capacity=48,
                detector=DetectorParams(max_features=48, min_distance=8, border=6),
                lk=LKParams(max_level=1),
                matcher=StripeMatcherParams(max_disp=16, templ_cols=11, templ_rows=9,
                                            max_matching_cost=0.5),
            ),
            foreground_min_gradient=0.0,  # the whole textured scene is foreground
            edge_max_depth_change=10.0,
            min_obs_connect_edge=1.0,
            min_obs_disconnect_edge=0.0,
        ),
        vertex_min_obs=1,
    )


def test_object_mesher_node_publishes_the_jax_nodes_mesh():
    """tests/test_coverage_extras.py's scene (fx 150, baseline 0.2, an 8 px
    disparity: 3.75 m) through the port node and the JAX node."""
    from ocean_perception_tpu.fabric.nodes.object_mesher_node import (
        ObjectMesherNode as JNode)

    left, right = _textured()
    jc = jcam.PinholeCamera.create(150.0, 150.0, W / 2, H / 2, H, W)
    jrig = jcam.StereoCamera.create(jc, jc, 0.2)
    jbus_, tbus = jbus.InProcessBus(), InProcessBus()
    jm = _collect(jbus_, ["object_mesher/mesh"])["object_mesher/mesh"]
    tm = _collect(tbus, ["object_mesher/mesh"])["object_mesher/mesh"]
    JNode(jbus_, jrig, params=_jax_mesher_params())
    node = omn.ObjectMesherNode(tbus, convert.stereo_camera_from_jax(jrig),
                                params=convert.object_mesher_params_from_jax(_jax_mesher_params()),
                                device=CPU)
    for k in range(3):
        t = int((k + 1) * 1e8)
        jbus_.publish("sensors/stereo", _stereo_msg(jms, t, left, right))
        tbus.publish("sensors/stereo", _msg(t, left, right))
    assert tm, "mesher node published no mesh"
    assert node.frames_in == 3 and node.meshes_out == len(tm)
    assert 2.0 < np.median(tm[-1].vertices[:, 2]) < 6.0
    assert len(tm) == len(jm)
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t.vertices, j.vertices, atol=1e-3)
        assert _triangle_flips(t.triangles, j.triangles) <= 2


def test_object_mesher_node_from_config():
    """tests/test_config_bindings.py's check on the port: the shipped YAML
    pair, channel names, no rescale on the 376-row Farmsim rig."""
    node = omn.from_config(InProcessBus(), "config/nodes/ObjectMesherNode.yaml",
                           "config/shared/Farmsim.yaml", device=CPU)
    assert node.channel_output == "object_mesher/mesh"
    assert node.input_height == 376
    assert node.mesher.rig.left.height == 376
    assert node.mesher.params.device.foreground_ksize == 15
    assert node.mesher.device == torch.device("cpu")


def test_object_mesher_node_downscales_and_rescales_the_rig():
    """A 720-row rig with mesher_input_height 376: the mesher's rig is
    rescaled, and frames reach it at 376 rows."""
    cam = PinholeCamera.create(700.0, 700.0, 640.0, 360.0, 720, 1280)
    node = omn.ObjectMesherNode(InProcessBus(), StereoCamera.create(cam, cam, 0.12),
                                mesher_input_height=376, device=CPU)
    assert node.mesher.rig.left.height == 376 and node.mesher.rig.left.width == 668
    seen = []
    node.mesher.process_stereo = lambda l, r: seen.append((l.shape, r.shape)) or \
        TriangleMesh.merge([])
    node._process(1, np.zeros((720, 1280), np.float32), np.zeros((720, 1280), np.float32))
    assert seen == [((376, 668), (376, 668))]


@pytest.mark.parametrize("shape", [(720, 1280), (720, 1280, 3), (376, 672)])
def test_downscale_matches_cv2_resize(shape):
    img = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    height = 376 if shape[0] == 720 else 200
    width = int(round(shape[1] * height / shape[0]))
    ref = cv2.resize(img, (width, height))  # INTER_LINEAR
    got = omn.downscale(torch.from_numpy(img), height).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
