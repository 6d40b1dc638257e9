"""The port's StateEstimator on the card: it refuses to run without one, keeps
its state there, makes the host syncs its module states, and agrees with
the CPU on a short mission.

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
