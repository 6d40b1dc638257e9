"""The port's StateEstimator on the card: it refuses to run without one, keeps
its state there, makes the host syncs its module states, and agrees with
the CPU on a short mission. The deployment around it too: the node, the
dataset player and the threaded estimator refuse to run without a card; on
the card a node's IMU step reads nothing back unless it publishes, the
threaded estimator's CUDA graphs (captured while the other thread runs)
replay equal to their calls, and the float64 builds of the LM kernels
(``vio/trilateration.py``'s) equal their twins.

The tests marked ``gpu`` skip without a CUDA device. This file imports no
JAX, so on a GPU machine without JAX they run with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vio_card.py -m gpu -q``.
"""

import traceback
import warnings

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.core.measurements import (DepthMeasurement, ImuMeasurement,
                                                          StereoImage)
from ocean_perception_tpu_torch.tracking.detector import DetectorParams
from ocean_perception_tpu_torch.tracking.lk import LKParams
from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerParams
from ocean_perception_tpu_torch.tracking.stripe_match import StripeMatcherParams
from ocean_perception_tpu_torch.vio import state_estimator as tse
from ocean_perception_tpu_torch.vio.smoother import SmootherConfig
from ocean_perception_tpu_torch.vio.stereo_frontend import FrontendParams

H, W = 160, 240
FX, BASELINE, DEPTH = 200.0, 0.3, 5.0
GRAVITY = np.array([0.0, 0.0, -9.81])


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


def rig():
    cam = PinholeCamera.create(FX, FX, W / 2, H / 2, H, W)
    return StereoCamera.create(cam, cam, BASELINE)


def params(window=6):
    return tse.StateEstimatorParams(
        n_gravity=GRAVITY.copy(),
        frontend=FrontendParams(
            tracker=StereoTrackerParams(
                capacity=96, trigger_keyframe_k=2,
                detector=DetectorParams(max_features=96, min_distance=10, border=10),
                lk=LKParams(max_level=2),
                matcher=StripeMatcherParams(max_disp=32, templ_cols=15, templ_rows=11,
                                            max_matching_cost=0.3)),
            pixel_sigma=1.0),
        smoother=SmootherConfig(window=window, iterations=4, max_landmarks=8),
        max_imu_per_keypose=64,
        min_sec_btw_keyposes=0.15,
        max_sec_btw_keyposes=10.0,
    )


def mission(n_frames):
    """1 m/s along x past a textured plane at 5 m (4 px a frame): 10 Hz
    stereo (whole-pixel shifts of a box-smoothed canvas), 100 Hz IMU, 2 Hz
    depth; events in time order. The IMU reads no acceleration and the
    engine starts at rest, so the smoother weighs VO against IMU: a test of
    the engine's mechanics, not of its accuracy."""
    rng = np.random.default_rng(5)
    canvas = rng.random((H, W + 16 + 4 * n_frames + 40))
    for axis in (0, 1):  # a 3-tap box blur, twice
        for _ in range(2):
            canvas = (np.roll(canvas, 1, axis) + canvas + np.roll(canvas, -1, axis)) / 3.0
    canvas = (0.1 + 0.8 * (canvas - canvas.min()) / np.ptp(canvas)).astype(np.float32)
    disp = int(FX * BASELINE / DEPTH)
    events = []
    for k in range(1, 10 * n_frames + 1):
        t_ns = k * 10_000_000
        events.append(ImuMeasurement(t_ns, np.zeros(3), -GRAVITY))
        if k % 50 == 0:
            events.append(DepthMeasurement(t_ns, 0.0))
        if k % 10 == 0:
            x = 8 + 4 * (k // 10)
            events.append(StereoImage(t_ns, 0, np.ascontiguousarray(canvas[:, x:x + W]),
                                      np.ascontiguousarray(canvas[:, x + disp:x + disp + W])))
    return events


def feed(est, m):
    if isinstance(m, ImuMeasurement):
        est.receive_imu(m)
    elif isinstance(m, DepthMeasurement):
        est.receive_depth(m)
    else:
        est.receive_stereo(m)


def start(device, window=6):
    est = tse.StateEstimator(params(window), rig(), device=device)
    est.initialize(0, np.eye(4))
    return est


def test_estimator_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tse.StateEstimator(params(), rig())


def test_mission_runs_on_the_cpu():
    """The card tests' mission on the CPU: vision holds, keyposes come, the
    window slides, and the trajectory moves +x."""
    est = start("cpu")
    solves = []
    est.smoother_callbacks.append(lambda r: solves.append(r.p.clone()))
    for m in mission(14):
        feed(est, m)
    assert est.mode is tse.SmootherMode.VISION_AVAILABLE
    assert est._n_keyposes == 6 and len(solves) > 6
    assert solves[-1][0] > solves[0][0]


# --- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels cannot run on the CPU")
    return torch.device("cuda", 0)


class Syncs:
    """Host syncs under torch.cuda.set_sync_debug_mode, with their sites."""

    def __init__(self):
        self.sites = []

    def record(self, message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1]
            self.sites.append(" <- ".join(f"{f.name}:{f.lineno}" for f in stack[::-1][:6]))

    def run(self, fn):
        self.sites = []
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self.record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return len(self.sites)


@pytest.mark.gpu
def test_estimator_defaults_to_the_card(cuda_device):
    est = tse.StateEstimator(params(), rig())
    assert est.device.type == "cuda"
    assert est.window.p.device.type == "cuda"


@pytest.mark.gpu
def test_estimator_keeps_its_state_on_the_card(cuda_device):
    est = start(cuda_device)
    for m in mission(14):
        feed(est, m)
    assert est._n_keyposes == 6
    for name, t in (*est.window._asdict().items(), *est.ekf_state._asdict().items()):
        assert t.device.type == "cuda", name
    assert est.frontend.state.table.pixels.device.type == "cuda"
    assert est.window.p.dtype == torch.float64 and est.ekf_state.S.dtype == torch.float64


@pytest.mark.gpu
def test_estimator_host_syncs(cuda_device):
    """An IMU step makes IMU_SYNCS host syncs; a frame FRAME_SYNCS, plus
    SMOOTHER_SYNCS when it makes a keypose and SLIDE_SYNCS when that slides
    the window. Counted after two smoother updates: the device constants'
    caches fill at their first use."""
    est = start(cuda_device, window=4)
    events = mission(14)
    syncs = Syncs()
    seen = set()
    for m in events:
        if est._n_keyposes < 3:
            feed(est, m)
            continue
        if isinstance(m, ImuMeasurement):
            n = syncs.run(lambda: feed(est, m))
            assert n == tse.IMU_SYNCS, syncs.sites
            continue
        if isinstance(m, DepthMeasurement):
            feed(est, m)
            continue
        kp, full = est._n_keyposes, est._n_keyposes >= est._smoother_cfg.window
        solves = len(est.smoother_callbacks)
        count = []
        est.smoother_callbacks.append(lambda r: count.append(1))
        n = syncs.run(lambda: feed(est, m))
        est.smoother_callbacks.pop()
        want = tse.FRAME_SYNCS
        if count:
            want += tse.SMOOTHER_SYNCS + (tse.SLIDE_SYNCS if full else 0)
            seen.add("slide" if full else "keypose")
        else:
            seen.add("frame")
        assert n == want, (kp, syncs.sites)
        assert len(est.smoother_callbacks) == solves
    assert seen == {"frame", "keypose", "slide"}


@pytest.mark.gpu
def test_estimator_card_matches_cpu(cuda_device):
    """The same mission on the card and on the CPU: the same keyposes, modes
    and statuses, smoother poses within 1e-4 m."""
    out = {}
    for dev in (cuda_device, "cpu"):
        est = start(dev)
        poses, statuses = [], []
        est.smoother_callbacks.append(lambda r: poses.append(r.p.double().cpu()))
        for m in mission(14):
            feed(est, m)
            if isinstance(m, StereoImage):
                statuses.append((est.last_status, est.mode))
        out[str(dev)] = (poses, statuses, list(est._keypose_times_ns))
    (pg, sg, kg), (pc, sc, kc) = out[str(cuda_device)], out["cpu"]
    assert sg == sc and kg == kc
    assert len(pg) == len(pc) > 0
    assert max(float((a - b).abs().max()) for a, b in zip(pg, pc)) < 1e-4


@pytest.mark.gpu
def test_graphed_steps_equal_their_calls(cuda_device):
    """The odometry, the smoother update and the filter step replay from CUDA
    graphs on the card (ops/graphs.py); every replay equals the same step by
    calls bit for bit."""
    import functools

    from ocean_perception_tpu_torch.ops.graphs import GraphedStep
    from ocean_perception_tpu_torch.vio import odometry as todo

    est = start(cuda_device)
    for m in mission(10):
        feed(est, m)
    assert est._n_keyposes >= 4

    rng = np.random.default_rng(9)
    P0 = torch.as_tensor(np.stack([rng.uniform(-2, 2, 96), rng.uniform(-1, 1, 96),
                                   rng.uniform(2, 8, 96)], -1), dtype=torch.float32,
                         device=cuda_device)
    p_obs = (FX * P0[:, :2] / P0[:, 2:] + torch.tensor([W / 2, H / 2], device=cuda_device)
             + torch.as_tensor(rng.normal(0, 0.5, (96, 2)), dtype=torch.float32, device=cuda_device))
    sig = torch.ones(96, device=cuda_device)
    mask = torch.ones(96, dtype=torch.bool, device=cuda_device)
    eye = torch.eye(4, device=cuda_device)
    want = todo._optimize(P0, p_obs, sig, mask, eye, rig(), todo.OdometryParams())
    for _ in range(2):  # the capture's call, then a replay
        got = todo.optimize_odometry(P0, p_obs, sig, mask, rig())
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    update = functools.partial(
        tse._smoother_update, calib=est.params.imu_calib, gravity=est._gravity_w,
        gravity_unit=est._gravity_unit_w, config=est._smoother_cfg, n_steps=32)
    graphed = GraphedStep(update)
    want = update(est.window)
    for _ in range(2):
        for a, b in zip(graphed(est.window), want):
            assert torch.equal(a, b)

    x = torch.tensor([0.01, 0.02, -0.01, 0.03, 0.1, -0.2, 9.7], dtype=torch.float64,
                     device=cuda_device)
    step = functools.partial(tse._filter_step, params=est.ekf_params, gravity=est._gravity,
                             q_body_imu=None)
    want = step(est.ekf_state, x)
    graphed = GraphedStep(step)
    for _ in range(2):
        for a, b in zip(graphed(est.ekf_state, x), want):
            assert torch.equal(a, b)


# --- the deployment ----------------------------------------------------------


def deployment(kind, device=None, log=None):
    """The node, the threaded estimator, or the dataset player of ``log``,
    on ``device`` (their default when None)."""
    kw = {} if device is None else {"device": device}
    if kind == "node":
        from ocean_perception_tpu_torch.fabric.nodes.state_estimator_node import (
            StateEstimatorNode)
        from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus

        return StateEstimatorNode(InProcessBus(), rig(), params=params(), **kw)
    if kind == "threaded":
        from ocean_perception_tpu_torch.vio.threaded_estimator import ThreadedStateEstimator

        return ThreadedStateEstimator(params(), rig(), **kw)
    from ocean_perception_tpu_torch.fabric.nodes import dataset_player

    return dataset_player.run("lcmlog", log, rig=rig(), params=params(), **kw)


@pytest.mark.parametrize("kind", ["node", "player", "threaded"])
def test_deployment_raises_without_a_card(kind, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ocean_perception_tpu_torch.fabric.lcm_log import LcmLogWriter
    from ocean_perception_tpu_torch.fabric.lcm_wire import to_lcm
    from ocean_perception_tpu_torch.fabric.messages import ImuMessage

    log = str(tmp_path / "imu.lcmlog")
    with LcmLogWriter(log) as w:
        sd, v = to_lcm(ImuMessage(10_000_000, np.zeros(3), -GRAVITY))
        w.write("sensors/imu", sd.encode(v), timestamp_us=10_000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deployment(kind, log=log)


def node_messages(events):
    from ocean_perception_tpu_torch.fabric.messages import (DepthMessage, ImageMessage,
                                                            ImuMessage, StereoImageMessage)

    for m in events:
        if isinstance(m, ImuMeasurement):
            yield "sensors/imu", ImuMessage(m.timestamp, m.angular_velocity,
                                            m.linear_acceleration)
        elif isinstance(m, DepthMeasurement):
            yield "sensors/depth", DepthMessage(m.timestamp, m.depth)
        else:
            yield "sensors/stereo", StereoImageMessage(
                m.timestamp, 0, ImageMessage.from_array(m.timestamp, m.left),
                ImageMessage.from_array(m.timestamp, m.right))


@pytest.mark.gpu
def test_node_imu_step_syncs_only_to_publish(cuda_device):
    """An IMU message makes no host sync unless its filter pose is
    published (1 in 5 at 20 Hz of 100 Hz here), and then one."""
    from ocean_perception_tpu_torch.fabric.messages import PoseStampedMessage

    node = deployment("node", cuda_device)
    bus = node.bus
    published = []
    bus.subscribe("vio/pose/filter", lambda _c, m: published.append(m.timestamp))
    bus.publish("vio/init_pose",
                PoseStampedMessage(timestamp=0, pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))
    syncs = Syncs()
    quiet = loud = 0
    for ch, msg in node_messages(mission(14)):
        if ch != "sensors/imu" or node.est._n_keyposes < 3:
            bus.publish(ch, msg)
            continue
        before = len(published)
        n = syncs.run(lambda: bus.publish(ch, msg))
        if len(published) > before:
            assert n == 1, syncs.sites
            loud += 1
        else:
            assert n == tse.IMU_SYNCS, syncs.sites
            quiet += 1
    assert loud > 0 and quiet >= 3 * loud


@pytest.mark.gpu
def test_threaded_estimator_graphs_equal_calls(cuda_device):
    """The threaded estimator on the card: its two threads on their own
    streams, its CUDA graphs captured while the other thread ran; no worker
    raised, the window slid, and every graph replays equal to its step by
    calls bit for bit."""
    from ocean_perception_tpu_torch.vio.threaded_estimator import ThreadedStateEstimator

    te = ThreadedStateEstimator(params(window=4), rig(), device=cuda_device)
    core = te.core
    errors = []

    def recording(fn):
        def call(*a, **k):
            try:
                return fn(*a, **k)
            except BaseException as e:  # noqa: BLE001 — recorded, then raised
                errors.append(repr(e))
                raise
        return call

    for name in ("receive_stereo", "receive_imu", "receive_depth", "_maybe_imu_keypose"):
        setattr(core, name, recording(getattr(core, name)))
    solves = []
    te.smoother_callbacks.append(lambda r: solves.append(r.p.clone()))
    te.initialize(0, np.eye(4))
    for m in mission(14):
        feed(te, m)
        if isinstance(m, StereoImage):
            assert te.wait_idle(timeout=120)
    assert te.wait_idle(timeout=120)
    te.shutdown()
    torch.cuda.synchronize()
    assert not errors, errors
    assert core._n_keyposes == 4 and len(solves) > 4
    assert core._smoother_steps and core._filter_step._graphs
    for step in core._smoother_steps.values():
        for a, b in zip(step(core.window), step.fn(core.window)):
            assert torch.equal(a, b)
    x = torch.tensor([0.01, 0.02, -0.01, 0.03, 0.1, -0.2, 9.7], dtype=torch.float64,
                     device=cuda_device)
    for a, b in zip(core._filter_step(core.ekf_state, x), core._filter_step.fn(core.ekf_state, x)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 3, 64])
@pytest.mark.parametrize("marquardt", [False, True])
def test_lm_float64_kernels_match_twins(cuda_device, M, marquardt):
    """The double builds of lm_solve_small and lm_row_sum equal their twins
    bit for bit (P=3 as trilateration's, and P=12), on the card and on the
    CPU, and count as launches of their names."""
    from ocean_perception_tpu_torch.ops import cuda, lm

    rng = np.random.default_rng(M)
    for P, N in ((3, 8), (12, 300)):
        J = torch.as_tensor(rng.normal(size=(M, N, P)) * 10.0 ** rng.uniform(-4, 0, (M, 1, P)))
        r = torch.as_tensor(rng.normal(size=(M, N)))
        lam = torch.as_tensor(10.0 ** rng.uniform(-6, 0, M))
        Jd, rd, lamd = (t.to(cuda_device) for t in (J, r, lam))
        before = dict(cuda.LAUNCHES)
        got = cuda.lm_solve_small(Jd, rd, lamd, marquardt)
        sums = cuda.lm_row_sum(rd)
        assert got.dtype == sums.dtype == torch.float64
        assert cuda.LAUNCHES["lm_solve_small"] == before["lm_solve_small"] + 1
        assert cuda.LAUNCHES["lm_row_sum"] == before["lm_row_sum"] + 1
        assert torch.equal(got, lm.lm_step_plain(Jd, rd, lamd, marquardt))
        assert torch.equal(got.cpu(), lm.lm_step_plain(J, r, lam, marquardt))
        assert torch.equal(sums.cpu(), lm.tree_sum_plain(r))
    with pytest.raises(ValueError, match="dtype"):
        cuda.lm_solve_small(Jd, rd.float(), lamd, marquardt)


@pytest.mark.gpu
def test_trilaterate_float64_on_the_card(cuda_device):
    """trilaterate on the card in float64: its LM runs the double builds,
    and its fix equals the CPU's within 1e-9 m."""
    from ocean_perception_tpu_torch.ops import cuda
    from ocean_perception_tpu_torch.vio.trilateration import trilaterate

    rng = np.random.default_rng(8)
    p_true = np.array([3.0, -4.0, -12.0])
    beacons = rng.uniform(-50, 50, (8, 3))
    ranges = np.linalg.norm(beacons - p_true, axis=1) + rng.normal(0, 0.05, 8)
    mask = np.ones(8, bool)
    mask[5] = False
    args = [torch.as_tensor(beacons), torch.as_tensor(ranges), torch.full((8,), 0.05,
            dtype=torch.float64), torch.as_tensor(mask)]
    cuda.reset_launches()
    got = trilaterate(*(a.to(cuda_device) for a in args))
    assert cuda.LAUNCHES["lm_solve_small"] == 20 and cuda.LAUNCHES["lm_row_sum"] == 22
    want = trilaterate(*args)
    assert got.position.dtype == torch.float64 and bool(got.success)
    assert float((got.position.cpu() - want.position).abs().max()) < 1e-9


@pytest.mark.gpu
def test_replay_chunks_equal_calls(cuda_device):
    """On the card the filter's IMU replay after a rewind runs in chunks of
    REPLAY_CHUNK samples, each a CUDA graph replay masked past the last
    sample: it equals the replay by calls bit for bit."""
    from ocean_perception_tpu_torch.vio.ekf import ekf_replay_imu

    est = start(cuda_device)
    for m in mission(4):
        feed(est, m)
    n = 2 * tse.REPLAY_CHUNK + 5
    rng = np.random.default_rng(3)
    rows = np.zeros((3 * tse.REPLAY_CHUNK, 8))
    rows[:n, 0] = 0.005
    rows[:n, 1:4] = rng.normal(0, 0.05, (n, 3))
    rows[:n, 4:7] = -GRAVITY + rng.normal(0, 0.2, (n, 3))
    rows[:n, 7] = 1.0
    d = torch.as_tensor(rows, device=cuda_device)
    state = est.ekf_state
    for k in range(0, d.shape[0], tse.REPLAY_CHUNK):
        c = d[k:k + tse.REPLAY_CHUNK]
        state = est._replay_chunk(state, c[:, 0], c[:, 1:4], c[:, 4:7], c[:, 7] > 0)
    want = ekf_replay_imu(est.ekf_state, d[:n, 0], d[:n, 1:4], d[:n, 4:7], None, est._gravity,
                          est.ekf_params)
    for a, b in zip(state, want):
        assert torch.equal(a, b)
