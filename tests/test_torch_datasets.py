"""The port's dataset providers, LCM log and dataset player against the JAX
package on the CPU.

Both packages read the same files, written here from numpy seeds:

- EuRoC (``tests/test_datasets_fabric.py``'s mini layout, and the writer's
  round trip with a rotated groundtruth), an image-folder dataset, the merge
  order and the paced playback: the item streams equal (timestamps, values,
  frames);
- LCM logs (``tests/test_lcm_log.py``'s mission log): written by the port's
  ``LcmLogWriter`` and ``to_lcm``, read by both ``LcmLogDataset``s, equal
  streams; the estimator's own poses skipped; the player wiring;
- ``fabric/nodes/dataset_player.run("lcmlog", ..., device="cpu")`` against
  the JAX player on a small vision log (``tests/test_torch_vio_card.py``'s
  mission: 160x240, 14 frames, 100 Hz IMU): the same trajectory length and
  timestamps, poses within 1e-4 m and rad (the float32 frontend feeds the
  smoother; ``tests/test_torch_state_estimator.py``'s vision tolerance).
"""

import os
import time

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch import datasets as tds
from ocean_perception_tpu_torch.core import measurements as tm
from ocean_perception_tpu_torch.fabric import messages as ms
from ocean_perception_tpu_torch.fabric.lcm_log import LcmLogWriter, log_summary, play_log
from ocean_perception_tpu_torch.fabric.lcm_wire import to_lcm
from ocean_perception_tpu_torch.utils.image_io import save_image

H, W = 160, 240
FX, BASELINE, DEPTH = 200.0, 0.3, 5.0
GRAVITY = np.array([0.0, 0.0, -9.81])
POSE_TOL = 1e-4


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


def write_mini_euroc(root, n_frames=3, n_imu=20):
    """tests/test_datasets_fabric.py's tiny EuRoC layout."""
    rng = np.random.default_rng(0)
    mav0 = os.path.join(root, "mav0")
    for sub in ("cam0/data", "cam1/data", "imu0", "depth0", "aps0"):
        os.makedirs(os.path.join(mav0, sub), exist_ok=True)
    cam_rows = []
    for i in range(n_frames):
        ts = int((i + 1) * 1e8)
        img = rng.random((24, 32)).astype(np.float32)
        for cam in ("cam0", "cam1"):
            save_image(os.path.join(mav0, cam, "data", f"{ts}.png"), img)
        cam_rows.append(f"{ts},{ts}.png")
    for cam in ("cam0", "cam1"):
        with open(os.path.join(mav0, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(cam_rows) + "\n")
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp,...\n")
        for i in range(n_imu):
            f.write(f"{int((i + 1) * 2e7)},0.01,0.02,-0.01,0.1,-9.81,0.2\n")
    with open(os.path.join(mav0, "imu0_poses.txt"), "w") as f:
        f.write("100000000,1,0,0,0,0.5,0.2,-0.1\n")
    with open(os.path.join(mav0, "depth0", "data.csv"), "w") as f:
        f.write("#timestamp,depth\n100000000,2.5\n300000000,2.6\n")
    with open(os.path.join(mav0, "aps0", "data.csv"), "w") as f:
        f.write("#timestamp,range,bx,by,bz\n150000000,10.5,1,2,3\n")


def stream(ds):
    """Every item a provider dispatches, in order, as comparable tuples."""
    out = []
    ds.register_imu_callback(lambda m: out.append(
        ("imu", m.timestamp, *np.asarray(m.angular_velocity), *np.asarray(m.linear_acceleration))))
    ds.register_depth_callback(lambda m: out.append(("depth", m.timestamp, m.depth)))
    ds.register_range_callback(lambda m: out.append(
        ("range", m.timestamp, m.range, *np.asarray(m.point), m.beacon_id)))
    ds.register_groundtruth_callback(lambda m: out.append(
        ("pose", m.timestamp, *np.asarray(m.world_T_body).reshape(-1))))
    frames = []
    ds.register_stereo_callback(lambda im: (out.append(("stereo", im.timestamp, im.camera_id)),
                                            frames.append(im)))
    n = ds.play_all()
    return out, frames, n


def assert_same_stream(port_ds, jax_ds):
    a, fa, na = stream(port_ds)
    b, fb, nb = stream(jax_ds)
    assert na == nb == len(a) and a == b
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x.left, y.left)
        np.testing.assert_array_equal(x.right, y.right)
        assert x.left.dtype == y.left.dtype == np.float32
    return a


def test_euroc_matches_jax(tmp_path):
    from ocean_perception_tpu.datasets import EurocDataset as JaxEuroc

    write_mini_euroc(str(tmp_path))
    ds = tds.EurocDataset(str(tmp_path))
    assert (len(ds.stereo_data), len(ds.imu_data), len(ds.depth_data), len(ds.range_data),
            len(ds.pose_data)) == (3, 20, 2, 1, 1)
    np.testing.assert_allclose(ds.pose_data[0].world_T_body[:3, 3], [0.5, 0.2, -0.1])
    items = assert_same_stream(tds.EurocDataset(str(tmp_path)), JaxEuroc(str(tmp_path)))
    assert [k for k, *_ in items].count("stereo") == 3


def test_euroc_writer_roundtrip_matches_jax(tmp_path):
    """The port's writer (its groundtruth quaternion through the port's
    core/quaternion.py), read back by both packages."""
    from ocean_perception_tpu.datasets import EurocDataset as JaxEuroc

    w = tds.EurocDataWriter(str(tmp_path))
    rng = np.random.default_rng(1)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    for i in range(2):
        ts = int((i + 1) * 1e8)
        w.write_stereo(ts, rng.random((16, 16)).astype(np.float32),
                       rng.random((16, 16)).astype(np.float32))
        w.write_imu(tm.ImuMeasurement(ts, np.ones(3) * 0.1, np.array([0, -9.8, 0])))
        w.write_depth(tm.DepthMeasurement(ts, 1.5))
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, -0.2 * i, 0.05]
        T[:3, :3] = R
        w.write_groundtruth(tm.GroundtruthPose(ts, T))
    w.finish()
    ds = tds.EurocDataset(str(tmp_path))
    assert len(ds.pose_data) == 2
    np.testing.assert_allclose(ds.pose_data[1].world_T_body[:3, 3], [0.1, -0.2, 0.05], atol=1e-9)
    np.testing.assert_allclose(ds.pose_data[1].world_T_body[:3, :3], R, atol=1e-6)
    assert_same_stream(tds.EurocDataset(str(tmp_path)), JaxEuroc(str(tmp_path)))


def test_folder_dataset_matches_jax(tmp_path):
    from ocean_perception_tpu.datasets import get_dataset_by_name as jax_by_name

    for side in ("left", "right"):
        os.makedirs(tmp_path / side)
        for i in range(3):
            save_image(str(tmp_path / side / f"{i:03d}.png"),
                       np.random.default_rng(i).random((8, 8)).astype(np.float32))
    ds = tds.get_dataset_by_name("himb", str(tmp_path))
    assert len(ds.stereo_data) == 3
    assert [s.timestamp for s in ds.stereo_data] == [1e8, 2e8, 3e8]
    for name in ("himb", "caddy", "acfr"):
        assert_same_stream(tds.get_dataset_by_name(name, str(tmp_path)),
                           jax_by_name(name, str(tmp_path)))
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.get_dataset_by_name("nope", str(tmp_path))


def test_dataset_merge_order_and_playback():
    """Tie priority IMU > DEPTH > RANGE > STEREO (data_provider.cpp:53-62),
    and paced playback."""
    ds = tds.DataProvider()
    t = 100
    ds.imu_data = [tm.ImuMeasurement(t, np.zeros(3), np.zeros(3))]
    ds.depth_data = [tm.DepthMeasurement(t, 1.0)]
    ds.range_data = [tm.RangeMeasurement(t, 2.0, np.zeros(3))]
    order = []
    ds.register_imu_callback(lambda m: order.append("imu"))
    ds.register_depth_callback(lambda m: order.append("depth"))
    ds.register_range_callback(lambda m: order.append("range"))
    while ds.step():
        pass
    assert order == ["imu", "depth", "range"]

    ds = tds.DataProvider()
    ds.imu_data = [tm.ImuMeasurement(int(i * 5e7), np.zeros(3), np.zeros(3)) for i in range(1, 6)]
    seen = []
    ds.register_imu_callback(lambda m: seen.append(m.timestamp))
    t0 = time.perf_counter()
    ds.playback(speed=4.0, block=True)
    assert len(seen) == 5 and time.perf_counter() - t0 < 0.5


# -- LCM logs -----------------------------------------------------------------


def small_stereo(ts, w=12, h=8):
    rng = np.random.default_rng(ts)

    def img():
        u8 = rng.integers(0, 255, (h, w), np.uint8)
        return ms.ImageMessage(ts, w, h, 1, "u8", u8.tobytes())

    return ms.StereoImageMessage(ts, 0, img(), img())


def write_mission_log(path):
    """tests/test_lcm_log.py's tiny session, written by the port."""
    events = [("vio/init_pose", ms.PoseStampedMessage(
        0, pose=np.array([1.0, 0, 0, 0, 0.5, -0.25, 2.0])))]
    for i in range(30):
        events.append(("sensors/imu", ms.ImuMessage(
            i * 10_000_000, np.zeros(3), np.array([0.0, 0, 9.81]))))
    for i in range(6):
        events.append(("sensors/depth", ms.DepthMessage(i * 50_000_000, 2.0 + i)))
    for i in range(3):
        events.append(("sensors/stereo", small_stereo(i * 100_000_000 + 1)))
    with LcmLogWriter(path) as w:
        for ch, m in events:
            sd, v = to_lcm(m)
            w.write(ch, sd.encode(v), timestamp_us=m.timestamp // 1000)
    return events


def test_lcm_log_dataset_matches_jax(tmp_path):
    from ocean_perception_tpu.datasets.lcm_log import LcmLogDataset as JaxLog

    path = str(tmp_path / "mission.lcmlog")
    write_mission_log(path)
    ds = tds.LcmLogDataset(path)
    assert (len(ds.imu_data), len(ds.depth_data), len(ds.stereo_data), len(ds.pose_data)) == \
        (30, 6, 3, 1)
    np.testing.assert_allclose(ds.pose_data[0].world_T_body[:3, 3], [0.5, -0.25, 2.0])
    ref = JaxLog(path)
    items = assert_same_stream(ds, ref)
    assert len(items) == 30 + 6 + 3 + 1
    stamps = [t for _, t, *_ in items]
    assert stamps == sorted(stamps)
    summary = log_summary(path)
    assert summary["events"] == 40 and summary["channels"]["sensors/imu"]["count"] == 30
    ds.shutdown()
    ref.shutdown()


def test_lcm_log_dataset_skips_estimator_output_poses(tmp_path):
    path = str(tmp_path / "full.lcmlog")
    with LcmLogWriter(path) as w:
        for ch in ("vio/init_pose", "vio/pose", "vio/smoother_pose"):
            sd, v = to_lcm(ms.PoseStampedMessage(5, pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))
            w.write(ch, sd.encode(v), timestamp_us=0)
    ds = tds.LcmLogDataset(path)
    assert len(ds.pose_data) == 1 and sum(ds.skipped.values()) == 0
    ds.shutdown()


def test_player_wiring_from_log(tmp_path):
    """get_dataset_by_name('lcmlog', ...) plays a log paced; play_log
    re-publishes its events on an in-process bus."""
    from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus

    path = str(tmp_path / "m2.lcmlog")
    write_mission_log(path)
    ds = tds.get_dataset_by_name("lcmlog", path)
    seen = []
    ds.register_stereo_callback(lambda im: seen.append(im.timestamp))
    ds.playback(speed=50.0, block=True)
    assert len(seen) == 3
    ds.shutdown()
    bus = InProcessBus()
    got = []
    bus.subscribe("sensors/depth", lambda _c, m: got.append(m.depth))
    assert play_log(bus, path, speed=0.0) == 40
    assert got == [2.0 + i for i in range(6)]


# -- the dataset player -------------------------------------------------------


def vision_log(path, n_frames=14):
    """tests/test_torch_vio_card.py's mission as an LCM log: 1 m/s past a
    textured plane at 5 m, 10 Hz stereo (float32 frames, which the LCM
    image_t wire carries as 8 bits), 100 Hz IMU, 2 Hz depth, and the
    groundtruth init pose."""
    rng = np.random.default_rng(5)
    canvas = rng.random((H, W + 16 + 4 * n_frames + 40))
    for axis in (0, 1):
        for _ in range(2):
            canvas = (np.roll(canvas, 1, axis) + canvas + np.roll(canvas, -1, axis)) / 3.0
    canvas = (0.1 + 0.8 * (canvas - canvas.min()) / np.ptp(canvas)).astype(np.float32)
    disp = int(FX * BASELINE / DEPTH)
    events = [("vio/init_pose", ms.PoseStampedMessage(0, pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))]
    for k in range(1, 10 * n_frames + 1):
        t_ns = k * 10_000_000
        events.append(("sensors/imu", ms.ImuMessage(t_ns, np.zeros(3), -GRAVITY)))
        if k % 50 == 0:
            events.append(("sensors/depth", ms.DepthMessage(t_ns, 0.0)))
        if k % 10 == 0:
            x = 8 + 4 * (k // 10)
            left = np.ascontiguousarray(canvas[:, x:x + W])
            right = np.ascontiguousarray(canvas[:, x + disp:x + disp + W])
            events.append(("sensors/stereo", ms.StereoImageMessage(
                t_ns, 0, ms.ImageMessage.from_array(t_ns, left),
                ms.ImageMessage.from_array(t_ns, right))))
    with LcmLogWriter(path) as w:
        for ch, m in events:
            sd, v = to_lcm(m)
            w.write(ch, sd.encode(v), timestamp_us=m.timestamp // 1000)


def jax_vision_params():
    from ocean_perception_tpu.tracking import DetectorParams, LKParams, StripeMatcherParams
    from ocean_perception_tpu.tracking.stereo_tracker import StereoTrackerParams
    from ocean_perception_tpu.vio import state_estimator as jse
    from ocean_perception_tpu.vio.smoother import SmootherConfig
    from ocean_perception_tpu.vio.stereo_frontend import FrontendParams

    return jse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(),
        frontend=FrontendParams(
            tracker=StereoTrackerParams(
                capacity=96, trigger_keyframe_k=2,
                detector=DetectorParams(max_features=96, min_distance=10, border=10),
                lk=LKParams(max_level=2),
                matcher=StripeMatcherParams(max_disp=32, templ_cols=15, templ_rows=11,
                                            max_matching_cost=0.3)),
            pixel_sigma=1.0),
        smoother=SmootherConfig(window=6, iterations=4, max_landmarks=8),
        max_imu_per_keypose=64,
        min_sec_btw_keyposes=0.15,
        max_sec_btw_keyposes=10.0,
    )


def rot_err(Ra, Rb):
    return float(2.0 * np.arcsin(min(np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0)), 1.0)))


def test_dataset_player_matches_jax(tmp_path):
    from ocean_perception_tpu.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu.fabric.nodes import dataset_player as jplayer
    from ocean_perception_tpu.fabric.pubsub import InProcessBus as JaxBus

    from ocean_perception_tpu_torch import convert
    from ocean_perception_tpu_torch.fabric.nodes import dataset_player as tplayer
    from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus

    path = str(tmp_path / "vision.lcmlog")
    vision_log(path)
    cam = PinholeCamera.create(FX, FX, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, BASELINE)
    params = jax_vision_params()
    jbus, tbus = JaxBus(), InProcessBus()
    filters = {"jax": [], "port": []}
    jbus.subscribe("vio/pose/filter", lambda _c, m: filters["jax"].append(m))
    tbus.subscribe("vio/pose/filter", lambda _c, m: filters["port"].append(m))
    ref = jplayer.run("lcmlog", path, rig=rig, params=params, bus=jbus)
    got = tplayer.run("lcmlog", path, rig=convert.stereo_camera_from_jax(rig),
                      params=convert.state_estimator_params_from_jax(params), bus=tbus,
                      out_trajectory=str(tmp_path / "traj.csv"), device="cpu")
    assert len(got) == len(ref) >= 6
    assert [s.timestamp for s in got] == [s.timestamp for s in ref]
    dp = max(float(np.abs(a.world_T_body[:3, 3] - b.world_T_body[:3, 3]).max())
             for a, b in zip(got, ref))
    dr = max(rot_err(a.world_T_body[:3, :3], b.world_T_body[:3, :3]) for a, b in zip(got, ref))
    assert dp < POSE_TOL and dr < POSE_TOL, (dp, dr)
    # A filter pose after every frame, at the same times.
    assert [m.timestamp for m in filters["port"]] == [m.timestamp for m in filters["jax"]]
    assert len(filters["port"]) == 14
    rows = (tmp_path / "traj.csv").read_text().splitlines()
    assert rows[0].startswith("#timestamp [ns],qw") and len(rows) == len(got) + 1
