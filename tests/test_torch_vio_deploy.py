"""The port's VIO deployment layer against the JAX package on the CPU.

Each module gets the JAX test's inputs, made from numpy seeds, through the
JAX function and its port:

- ``core/{uids,math_util,grid}.py``, ``vio/odometry_manager.py`` and
  ``vio/visualizer.py``: equal outputs (the PLY files equal);
- ``vio/trilateration.py`` (float64): position within 1e-9, covariance
  within 1e-9 of its scale, ``success`` equal;
- ``vio/checkpoint.py``: the same key set and dtypes for the same window
  geometry, with and without landmark columns; a JAX checkpoint loads into
  the port and a port checkpoint into JAX, window, EKF and counters equal
  bit for bit; the landmark migration and the round trip on the port;
- ``fabric/nodes/state_estimator_node.py``: ``from_config`` on the shipped
  ``StateEstimatorNode.yaml`` with ``ZEDMini.yaml``, an IMU + depth mission
  over an ``InProcessBus``: the filter and smoother pose messages equal
  JAX's node's in count and timestamps, poses and covariances within 1e-8
  (``tests/test_torch_state_estimator.py``'s tolerance for this engine);
  the resume from a checkpoint; the ``--trajectory-out`` CSV;
- ``vio/threaded_estimator.py``: the JAX tests' drain and poison-pill
  missions (the heap frozen while the threads run), and ``sync_lock``: a
  thread that holds it blocks the smoother's filter sync, which the solve
  does not wait for; the keypose's EKF state and the camera's last frame
  time follow JAX's rules unless the wrapper's ``vision_lags_filter`` is set.

The JAX node runs once, in a module-scoped fixture.
"""

import gc
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.core.measurements import (ImuMeasurement, PoseMeasurement,
                                                            StereoImage)
from ocean_perception_tpu_torch.fabric.messages import (DepthMessage, ImuMessage,
                                                        PoseStampedMessage)
from ocean_perception_tpu_torch.fabric.nodes import state_estimator_node as tnode
from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus
from ocean_perception_tpu_torch.vio import checkpoint as tck
from ocean_perception_tpu_torch.vio import state_estimator as tse
from ocean_perception_tpu_torch.vio import threaded_estimator
from ocean_perception_tpu_torch.vio.smoother import SmootherConfig
from ocean_perception_tpu_torch.vio.threaded_estimator import ThreadedStateEstimator

REPO = Path(__file__).resolve().parent.parent
NODE_YAML = str(REPO / "config" / "nodes" / "StateEstimatorNode.yaml")
ZED_YAML = str(REPO / "config" / "shared" / "ZEDMini.yaml")
GRAVITY = np.array([0.0, 0.0, -9.81])
NODE_IMU = 200        # 1 s at 200 Hz: two smoother updates
NODE_TOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's thread pool in each would oversubscribe
    the cores (these tests launch many small ops; under the suite's load a
    mission took ten times as long with the pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- core and odometry manager ----------------------------------------------


def test_uid_generator_threaded():
    from ocean_perception_tpu.core.uids import UidGenerator as JaxUids

    from ocean_perception_tpu_torch.core.uids import INVALID_UID, UidGenerator

    gen = UidGenerator()
    out = []
    lock = threading.Lock()

    def worker():
        for _ in range(100):
            v = gen.next()
            with lock:
                out.append(v)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert sorted(out) == list(range(400))
    ref = JaxUids(7)
    port = UidGenerator(7)
    assert [port.next() for _ in range(5)] == [ref.next() for _ in range(5)]
    assert INVALID_UID == -1


def test_grid_lookup_matches_jax():
    from ocean_perception_tpu.core import grid as jgrid

    from ocean_perception_tpu_torch.core import grid as tgrid

    pts = np.random.default_rng(4).uniform(0, 64, (40, 2))
    cells = {}
    grids = {}
    for name, mod in (("jax", jgrid), ("port", tgrid)):
        cells[name] = mod.map_to_grid_cells(pts, 64, 64, 4, 4)
        grids[name] = mod.GridLookup(4, 4)
        mod.populate_grid(cells[name], grids[name])
    np.testing.assert_array_equal(cells["port"], cells["jax"])
    for lo, hi in (((0, 0), (1, 2)), ((3, 3), (3, 3)), ((-1, 1), (9, 2)), ((2, 0), (2, 3))):
        assert grids["port"].get_roi(lo, hi) == grids["jax"].get_roi(lo, hi)
    assert grids["port"].get_cell((1, 1)) == grids["jax"].get_cell((1, 1))
    # The JAX test's three points.
    grid = tgrid.GridLookup(4, 4)
    tgrid.populate_grid(tgrid.map_to_grid_cells(
        np.array([[5.0, 5.0], [35.0, 5.0], [60.0, 60.0]]), 64, 64, 4, 4), grid)
    assert set(grid.get_roi((0, 0), (1, 2))) == {0, 1}
    assert grid.get_roi((3, 3), (3, 3)) == [2]


def test_math_util_matches_jax():
    from ocean_perception_tpu.core import math_util as jm

    from ocean_perception_tpu_torch.core import math_util as tm

    cases = [
        ("wrap_int", (-1, 5)), ("wrap_int", (7, 5)), ("next_even_int", (3,)),
        ("next_even_int", (4,)), ("next_odd_int", (4,)), ("next_odd_int", (5,)),
        ("deg_to_rad", (57.0,)), ("rad_to_deg", (1.25,)),
        ("subset", ([10, 20, 30], [2, 0])), ("subset_from_mask", ([1, 2, 3], [True, False, True])),
        ("average", ([1.0, 3.0],)), ("average", ([],)),
    ]
    for name, args in cases:
        assert getattr(tm, name)(*args) == getattr(jm, name)(*args), name
    assert abs(tm.rad_to_deg(tm.deg_to_rad(57.0)) - 57.0) < 1e-9


def test_odometry_manager_matches_jax():
    from ocean_perception_tpu.vio.odometry_manager import OdometryManager as JaxOM

    from ocean_perception_tpu_torch.core.se3 import se3_exp
    from ocean_perception_tpu_torch.vio.odometry_manager import OdometryManager

    rng = np.random.default_rng(11)
    poses = [se3_exp(torch.as_tensor(rng.normal(0, 0.5, 6))).numpy() for _ in range(6)]
    port, ref = OdometryManager(), JaxOM()
    for k, T in enumerate(poses):
        port.add_pose(100 * (k + 1), T)
        ref.add_pose(100 * (k + 1), T)
    for t0, t1 in ((100, 200), (150, 620), (300, 300), (50, 200), (600, 100)):
        a, b = port.relative(t0, t1), ref.relative(t0, t1)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(port.relative(100, 200), np.linalg.inv(poses[0]) @ poses[1],
                               atol=1e-12)
    assert port.pose_at(250)[0] == ref.pose_at(250)[0] == 200


def test_visualizer_matches_jax(tmp_path):
    """tests/test_extras.py's ellipsoid and trajectory artifacts: the same
    points and the same PLY files as the JAX package writes."""
    from ocean_perception_tpu.vio import visualizer as jviz

    from ocean_perception_tpu_torch.vio import visualizer as tviz

    cov = np.diag([4.0, 1.0, 0.25])
    pts = tviz.covariance_ellipsoid_points(cov, np.array([1.0, 2.0, 3.0]), n_sigma=1.0)
    np.testing.assert_array_equal(
        pts, jviz.covariance_ellipsoid_points(cov, np.array([1.0, 2.0, 3.0]), n_sigma=1.0))
    assert abs(np.abs(pts[:, 0] - 1.0).max() - 2.0) < 0.2
    landmarks = np.random.default_rng(6).random((20, 3))
    written = {}
    for name, mod in (("jax", jviz), ("port", tviz)):
        viz = mod.TrajectoryVisualizer(str(tmp_path / name))
        T = np.eye(4)
        for i in range(10):
            T = T.copy()
            T[:3, 3] = [i * 0.1, np.sin(i * 0.3), 0.0]
            viz.add_pose(T, np.eye(3) * 0.01)
        viz.add_landmarks(landmarks)
        written[name] = viz.save()
    assert [os.path.basename(f) for f in written["port"]] == \
        [os.path.basename(f) for f in written["jax"]]
    for a, b in zip(written["port"], written["jax"]):
        if a.endswith(".ply"):
            assert open(a).read() == open(b).read()
        else:
            assert os.path.getsize(a) > 0


# -- trilateration ------------------------------------------------------------


@pytest.mark.parametrize("case", ["five", "noisy_eight_one_masked", "too_few"])
def test_trilateration_matches_jax(case):
    import jax.numpy as jnp
    from ocean_perception_tpu.vio.trilateration import trilaterate as jax_trilaterate

    from ocean_perception_tpu_torch.vio.trilateration import trilaterate

    rng = np.random.default_rng({"five": 1, "noisy_eight_one_masked": 2, "too_few": 3}[case])
    p_true = np.array([1.0, -2.0, 3.0])
    if case == "five":  # tests/test_vio.py:288
        beacons = np.array([[10, 0, 0], [0, 10, 0], [0, 0, 10], [-10, -10, 0], [5, 5, 5]],
                           np.float64)
        mask = np.ones(5, bool)
    elif case == "noisy_eight_one_masked":
        beacons = rng.uniform(-20, 20, (8, 3))
        mask = np.ones(8, bool)
        mask[5] = False
    else:  # tests/test_vio.py:301
        beacons = np.eye(3) * 10
        mask = np.array([True, True, False])
    ranges = np.linalg.norm(beacons - p_true, axis=1) + rng.normal(0, 0.01, len(beacons))
    sigmas = np.full(len(beacons), 0.01)
    if case == "too_few":
        ranges, sigmas = np.full(3, 10.0), np.ones(3)
    ref = jax_trilaterate(jnp.asarray(beacons), jnp.asarray(ranges), jnp.asarray(sigmas),
                          jnp.asarray(mask))
    got = trilaterate(torch.as_tensor(beacons), torch.as_tensor(ranges), torch.as_tensor(sigmas),
                      torch.as_tensor(mask))
    assert got.position.dtype == torch.float64
    np.testing.assert_allclose(got.position.numpy(), np.asarray(ref.position), rtol=0, atol=1e-9)
    # Within 1e-9 of the covariance's scale: with two beacons (too_few) H is
    # singular and the covariance is ~1e9 (the inverse of the 1e-9 ridge).
    cov_ref = np.asarray(ref.covariance)
    np.testing.assert_allclose(got.covariance.numpy(), cov_ref, rtol=0,
                               atol=1e-9 * max(1.0, float(np.abs(cov_ref).max())))
    assert bool(got.success) == bool(ref.success) == (case != "too_few")
    if case == "five":
        np.testing.assert_allclose(got.position.numpy(), p_true, atol=0.05)


# -- the node and checkpoints -------------------------------------------------


def drive_node(node, bus, n_imu=NODE_IMU, start=1):
    """Publish the init pose (at start == 1), then n_imu IMU samples at
    200 Hz and 2 Hz depth; the filter and smoother messages published."""
    out = {"filter": [], "smoother": []}
    bus.subscribe("vio/pose/filter", lambda _c, m: out["filter"].append(m))
    bus.subscribe("vio/pose/smoother", lambda _c, m: out["smoother"].append(m))
    if start == 1:
        bus.publish("vio/init_pose",
                    PoseStampedMessage(timestamp=0, pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))
    g = np.asarray(node.est.params.n_gravity, np.float64)
    rng = np.random.default_rng(17)
    noise = rng.normal(0, 1e-3, (start + n_imu, 6))
    for k in range(start, start + n_imu):
        t_ns = k * 5_000_000
        if k % 100 == 0:
            bus.publish("sensors/depth", DepthMessage(t_ns - 1, 0.01 * k / 200))
        bus.publish("sensors/imu", ImuMessage(t_ns, noise[k, :3], -g + noise[k, 3:]))
    return out


@pytest.fixture(scope="module")
def jax_node(tmp_path_factory):
    from ocean_perception_tpu.fabric.nodes.state_estimator_node import StateEstimatorNode
    from ocean_perception_tpu.fabric.pubsub import InProcessBus as JaxBus
    from ocean_perception_tpu.vio.checkpoint import save_estimator

    bus = JaxBus()
    node = StateEstimatorNode.from_config(bus, NODE_YAML, ZED_YAML)
    out = drive_node(node, bus)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.npz")
    save_estimator(node.est, path)
    return dict(node=node, out=out, ckpt=path)


@pytest.fixture(scope="module")
def port_node():
    bus = InProcessBus()
    node = tnode.StateEstimatorNode.from_config(bus, NODE_YAML, ZED_YAML, device="cpu")
    traj = []
    node.est.smoother_callbacks.append(lambda _r: traj.append(node.est.smoother_state()))
    out = drive_node(node, bus)
    return dict(node=node, out=out, traj=traj)


def messages_close(got, want):
    assert [m.timestamp for m in got] == [m.timestamp for m in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=NODE_TOL)
        np.testing.assert_allclose(a.covariance, b.covariance, rtol=0, atol=NODE_TOL)


def test_node_matches_jax_node(jax_node, port_node):
    node = port_node["node"]
    assert node.device.type == "cpu"
    p = node.est.params
    assert (p.smoother.window, p.smoother.max_landmarks, p.max_imu_per_keypose) == (40, 16, 256)
    got, want = port_node["out"], jax_node["out"]
    assert len(got["smoother"]) == len(want["smoother"]) >= 2
    # 20 Hz of 200 Hz.
    assert len(got["filter"]) == len(want["filter"]) >= NODE_IMU // 10 - 1
    messages_close(got["filter"], want["filter"])
    messages_close(got["smoother"], want["smoother"])


def test_node_publishes_filter_pose_without_reading_the_state_between(port_node):
    """The publish rate is tested on the filter's host timestamp: an IMU
    sample whose pose is not published never calls filter_state()."""
    bus = InProcessBus()
    node = tnode.StateEstimatorNode.from_config(bus, NODE_YAML, ZED_YAML, device="cpu")
    reads = []
    orig = node.est.filter_state
    node.est.filter_state = lambda: reads.append(1) or orig()
    out = drive_node(node, bus, n_imu=40)
    assert len(reads) == len(out["filter"]) == 4


@pytest.mark.parametrize("landmarks", [0, 16])
def test_checkpoint_keys_match_jax(tmp_path, landmarks):
    """The same key set and dtypes for the same window geometry, saved by
    each package from a freshly initialized engine."""
    from ocean_perception_tpu.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu.vio import state_estimator as jse
    from ocean_perception_tpu.vio.checkpoint import save_estimator
    from ocean_perception_tpu.vio.smoother import SmootherConfig as JaxSmootherConfig

    from ocean_perception_tpu_torch import convert

    cam = PinholeCamera.create(300.0, 300.0, 320.0, 240.0, 480, 640)
    rig = StereoCamera.create(cam, cam, 0.2)
    params = jse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(), max_imu_per_keypose=16,
        smoother=JaxSmootherConfig(window=4, iterations=2, max_landmarks=landmarks))
    ref = jse.StateEstimator(params, rig)
    port = tse.StateEstimator(convert.state_estimator_params_from_jax(params),
                              convert.stereo_camera_from_jax(rig), device="cpu")
    for est in (ref, port):
        est.initialize(10, np.eye(4))
    save_estimator(ref, str(tmp_path / "jax.npz"))
    tck.save_estimator(port, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        assert "window.lmk_uv" in zt.files and "ekf.S" in zt.files
        for k in zj.files:
            assert (zt[k].dtype, zt[k].shape) == (zj[k].dtype, zj[k].shape), k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


def assert_state_equals_file(est, path):
    with np.load(path) as z:
        for name, t in est.window._asdict().items():
            assert torch.equal(t, torch.as_tensor(z["window." + name]).to(t.dtype)), name
        for name, t in est.ekf_state._asdict().items():
            assert torch.equal(t, torch.as_tensor(z["ekf." + name]).to(t.dtype)), name
        assert est._n_keyposes == int(z["n_keyposes"])
        assert est._keypose_times_ns == [int(v) for v in z["keypose_times_ns"]]
        assert est._ekf_time == int(z["ekf_time"])
        assert est._last_keypose_t == int(z["last_keypose_t"])
        assert est.mode.value == int(z["mode"])


def test_checkpoint_jax_to_port(jax_node, port_node):
    """A checkpoint saved by the JAX node loads into a fresh port node bit
    for bit, and the port's resumed mission agrees with the JAX node's."""
    bus = InProcessBus()
    node = tnode.StateEstimatorNode.from_config(bus, NODE_YAML, ZED_YAML, device="cpu")
    tck.load_estimator(node.est, jax_node["ckpt"])
    assert_state_equals_file(node.est, jax_node["ckpt"])
    assert node.est._imu_rows == [int(n) for n in
                                  node.est.window.imu_mask.sum(dim=1).tolist()]
    # Agrees with the port node that ran the same mission.
    ran = port_node["node"].est
    for a, b in zip(node.est.window, ran.window):
        assert torch.allclose(a.double(), b.double(), rtol=0, atol=NODE_TOL)
    assert node.est._imu_rows == ran._imu_rows


def test_checkpoint_port_to_jax(tmp_path, jax_node, port_node):
    from ocean_perception_tpu.fabric.nodes.state_estimator_node import StateEstimatorNode
    from ocean_perception_tpu.fabric.pubsub import InProcessBus as JaxBus
    from ocean_perception_tpu.vio.checkpoint import load_estimator

    path = str(tmp_path / "port.npz")
    tck.save_estimator(port_node["node"].est, path)
    with np.load(path) as zt, np.load(jax_node["ckpt"]) as zj:
        assert sorted(zt.files) == sorted(zj.files)
    ref = StateEstimatorNode.from_config(JaxBus(), NODE_YAML, ZED_YAML)
    load_estimator(ref.est, path)
    with np.load(path) as z:
        for name, t in ref.est.window._asdict().items():
            np.testing.assert_array_equal(np.asarray(t), z["window." + name], err_msg=name)
        for name, t in ref.est.ekf_state._asdict().items():
            np.testing.assert_array_equal(np.asarray(t), z["ekf." + name], err_msg=name)
        assert ref.est._keypose_times_ns == [int(v) for v in z["keypose_times_ns"]]
        assert ref.est._ekf_time == int(z["ekf_time"])


def small_estimator(max_landmarks=0, window=6):
    """tests/test_checkpoint.py's engine."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera

    cam = PinholeCamera.create(300.0, 300.0, 320.0, 240.0, 480, 640)
    rig = StereoCamera.create(cam, cam, 0.2)
    params = tse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(),
        smoother=SmootherConfig(window=window, iterations=3, max_landmarks=max_landmarks),
        max_imu_per_keypose=64,
    )
    return tse.StateEstimator(params, rig, device="cpu")


def imu_mission(est, first, last):
    for i in range(first, last):
        est.receive_imu(ImuMeasurement(int(i * 1e7), np.zeros(3), -GRAVITY))


def test_checkpoint_landmark_geometry_migration(tmp_path):
    """tests/test_checkpoint.py:28 on the port: a max_landmarks=0 checkpoint
    loads into a 16-column engine with empty columns; a core geometry change
    refuses."""
    est = small_estimator(max_landmarks=0)
    est.initialize(0, np.eye(4))
    imu_mission(est, 1, 120)
    path = str(tmp_path / "state.npz")
    tck.save_estimator(est, path)

    est16 = small_estimator(max_landmarks=16)
    tck.load_estimator(est16, path)
    assert est16._n_keyposes == est._n_keyposes
    assert est16.window.lmk_valid.shape[1] == 16
    assert not est16.window.lmk_valid.any()
    assert torch.equal(est16.window.p, est.window.p)

    bad = small_estimator(window=8)
    with pytest.raises(ValueError, match="window geometry"):
        tck.load_estimator(bad, path)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_checkpoint.py:53 on the port, and the resumed engine equals
    the one that never stopped."""
    est = small_estimator()
    est.initialize(0, np.eye(4))
    imu_mission(est, 1, 120)
    path = str(tmp_path / "state.npz")
    tck.save_estimator(est, path)

    est2 = small_estimator()
    tck.load_estimator(est2, path)
    assert_state_equals_file(est2, path)
    assert est2._last_keypose_t == est._last_keypose_t
    assert est2.window.p.device.type == "cpu" and est2.window.p.dtype == torch.float64
    imu_mission(est2, 120, 180)
    imu_mission(est, 120, 180)
    fs, fs_ref = est2.filter_state(), est.filter_state()
    assert np.isfinite(fs.world_T_body).all()
    np.testing.assert_allclose(fs.world_T_body, fs_ref.world_T_body, rtol=0, atol=1e-12)


def test_node_resume_from_checkpoint(tmp_path):
    """tests/test_checkpoint.py:75 on the port: a fresh node restored from a
    checkpoint filters on without waiting for an init pose."""
    ckpt = str(tmp_path / "est.npz")
    bus1 = InProcessBus()
    node1 = tnode.StateEstimatorNode.from_config(bus1, NODE_YAML, ZED_YAML, device="cpu")
    bus1.publish("vio/init_pose",
                 PoseStampedMessage(timestamp=0, pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))
    for k in range(5):
        bus1.publish("sensors/imu", ImuMessage(int((k + 1) * 1e7), np.zeros(3),
                                               np.array([0.0, -9.81, 0.0])))
    tck.save_estimator(node1.est, ckpt)

    bus2 = InProcessBus()
    node2 = tnode.StateEstimatorNode.from_config(bus2, NODE_YAML, ZED_YAML, device="cpu")
    tck.load_estimator(node2.est, ckpt)
    node2._init.set()
    poses = []
    bus2.subscribe("vio/pose/filter", lambda _c, m: poses.append(m))
    for k in range(5, 10):
        bus2.publish("sensors/imu", ImuMessage(int((k + 1) * 1e7), np.zeros(3),
                                               np.array([0.0, -9.81, 0.0])))
    assert node2.est.ekf_state is not None
    assert node2.est._ekf_time == int(1e8)
    assert len(poses) >= 1


def test_trajectory_csv(tmp_path, port_node):
    """--trajectory-out: the EuRoC state format (ns, qw, qx, qy, qz, tx, ty,
    tz) of each smoother pose, appended with one header."""
    est = port_node["node"].est
    path = tmp_path / "traj.csv"
    log_pose, f = tnode.trajectory_logger(est, str(path))
    log_pose(None)
    f.close()
    log_pose, f = tnode.trajectory_logger(est, str(path))  # reopened: appends, no header
    log_pose(None)
    f.close()
    lines = path.read_text().splitlines()
    assert lines[0] == "#timestamp, qw, qx, qy, qz, tx, ty, tz" and len(lines) == 3
    s = est.smoother_state()
    msg = port_node["out"]["smoother"][-1]
    for line in lines[1:]:
        row = line.split(",")
        assert int(row[0]) == s.timestamp == msg.timestamp
        np.testing.assert_array_equal(np.array(row[1:], np.float64), msg.pose)


def test_node_main_refuses_the_native_bus(monkeypatch):
    """``--native-bus`` no longer exits (the transport is ported): the node
    comes up on the C++ bus, and with ``--lcm`` on its LCM mode, as JAX's."""
    import threading

    from ocean_perception_tpu_torch.fabric import native_bus

    made = []

    def bus_class(native, lcm):
        cls = native_bus.bus_class(native, lcm)
        return lambda **kw: made.append(cls(**kw)) or made[-1]

    class Event(threading.Event):
        def wait(self, timeout=None):
            if timeout is None:  # main's wait for ctrl-c
                raise KeyboardInterrupt
            return super().wait(timeout)

    monkeypatch.setattr(tnode, "bus_class", bus_class)
    patched = type(threading)("threading")  # the node module's threading, its Event patched
    patched.__dict__.update(threading.__dict__, Event=Event)
    monkeypatch.setattr(tnode, "threading", patched)
    try:
        for flags, cls in ((["--native-bus"], native_bus.NativeUdpBus),
                           (["--native-bus", "--lcm"], native_bus.NativeLcmBus)):
            assert tnode.main([*flags, "--port", "7947", "--device", "cpu"]) == 0
            assert type(made[-1]) is cls
    finally:
        for bus in made:
            bus.close()


# -- the threaded estimator ---------------------------------------------------


def threaded(**kw):
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera

    cam = PinholeCamera.create(300.0, 300.0, 320.0, 240.0, 480, 640)
    rig = StereoCamera.create(cam, cam, 0.2)
    params = tse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(), smoother=SmootherConfig(window=6, iterations=3),
        max_imu_per_keypose=128)
    return ThreadedStateEstimator(params, rig, **kw)


def test_threaded_estimator_drains_and_tracks():
    """tests/test_threaded_misc.py:19 on the port."""
    est = threaded(device="cpu")
    assert est.core.sync_lock is est._filter_lock
    est.initialize(0, np.eye(4))
    # The heap that existed when the threads started is out of the
    # collector's full collections until the last wrapper shuts down.
    assert gc.get_freeze_count() > 0
    results = []
    est.smoother_callbacks.append(results.append)
    for i in range(1, 200):
        est.receive_imu(ImuMeasurement(int(i * 1e7), np.zeros(3), -GRAVITY))
    assert est.wait_idle(timeout=120)
    fs = est.filter_state()
    assert fs.timestamp == int(199 * 1e7)
    assert np.isfinite(fs.world_T_body).all()
    assert len(results) >= 1
    est.shutdown()
    assert gc.get_freeze_count() == 0 or threaded_estimator._running[0] > 0


def test_threaded_estimator_survives_malformed_measurement():
    """tests/test_threaded_misc.py:42 on the port: a poisoned pose fix is
    printed and the filter thread goes on."""
    est = threaded(device="cpu")
    est.initialize(0, np.eye(4))
    for i in range(1, 50):
        est.receive_imu(ImuMeasurement(int(i * 1e7), np.zeros(3), -GRAVITY))
    est.receive_pose(PoseMeasurement(int(50 * 1e7), np.eye(4), covariance=np.zeros((2, 3))))
    for i in range(51, 120):
        est.receive_imu(ImuMeasurement(int(i * 1e7), np.zeros(3), -GRAVITY))
    assert est.wait_idle(timeout=120)
    fs = est.filter_state()
    assert fs.timestamp == int(119 * 1e7)
    assert np.isfinite(fs.world_T_body).all()
    est.shutdown()


def test_sync_lock_blocks_the_filter_sync(monkeypatch):
    """The JAX engine's contract (vio/state_estimator.py:790-795): a thread
    that holds sync_lock blocks the smoother's filter sync from the rewind
    lookup through the commit, while the solve itself runs without it."""
    est = small_estimator()
    lock = threading.Lock()
    est.sync_lock = lock
    solve_locked = []
    orig_update = tse._smoother_update

    def spy_update(*a, **k):
        solve_locked.append(lock.locked())
        return orig_update(*a, **k)

    monkeypatch.setattr(tse, "_smoother_update", spy_update)
    calls = []
    orig_sync = est._sync_filter
    est._sync_filter = lambda *a: calls.append(a) or orig_sync(*a)
    est.initialize(0, np.eye(4))
    imu_mission(est, 1, 60)
    assert calls and solve_locked and not any(solve_locked)

    entered = threading.Event()
    orig_locked = est._sync_filter_locked

    def spy_locked(*a):
        assert lock.locked()
        entered.set()
        return orig_locked(*a)

    est._sync_filter_locked = spy_locked
    lock.acquire()
    worker = threading.Thread(target=orig_sync, args=calls[-1])
    worker.start()
    try:
        assert not entered.wait(timeout=0.5)  # blocked on the held lock
    finally:
        lock.release()
    worker.join(timeout=30)
    assert entered.is_set() and not worker.is_alive()


@pytest.mark.parametrize("lags", [False, True])
def test_keypose_state_behind_the_filter(lags):
    """A keypose older than the filter's newest sample (a frame delivered
    after later IMU samples): the synchronous engine starts it from the
    current EKF state, as the JAX engine does (vio/state_estimator.py:457,
    :507), and takes the frame's own time as the camera's last; with
    ``vision_lags_filter``, which only the threaded wrapper sets, from the
    snapshot closest before it, and the newest arrival stays the last."""
    est = small_estimator()
    assert not est.vision_lags_filter
    assert threaded(device="cpu").core.vision_lags_filter
    est.vision_lags_filter = lags
    est.initialize(0, np.eye(4))
    for i in range(1, 60):
        est.receive_imu(ImuMeasurement(int(i * 1e7), np.zeros(3), -GRAVITY), check_keypose=False)
    t_frame = int(30.5e7)
    want = est._ekf_history.closest_before(t_frame)[1] if lags else est.ekf_state
    assert want is not est.ekf_state or not lags
    assert est._state_at(t_frame) is want

    class Stop(Exception):
        pass

    def track(*_a):
        raise Stop

    est.frontend.track = track
    est.note_stereo_arrival(int(59e7))  # queued after the late frame
    blank = np.zeros((480, 640), np.float32)
    with pytest.raises(Stop):
        est.receive_stereo(StereoImage(t_frame, 0, blank, blank))
    assert est._last_stereo_t == (int(59e7) if lags else t_frame)
