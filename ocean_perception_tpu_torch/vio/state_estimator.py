"""StateEstimator: the top-level VIO engine, smoother + EKF hybrid (port of
``ocean_perception_tpu.vio.state_estimator``).

Reference parity: vio/state_estimator.{hpp,cpp} —
- keypose-aligned measurement gathering with per-sensor misalignment
  tolerances (cpp:237-282),
- smoother mode state machine VISION_AVAILABLE/UNAVAILABLE: keyposes come
  from VO when tracking works, else from IMU/range cadence (cpp:333-434),
- filter↔smoother sync: on each smoother result the EKF rewinds to the
  keypose time, applies a soft (pose measurement) or hard (re-initialize)
  correction depending on divergence, then replays IMU (cpp:496-549).

A synchronous, deterministic ``receive_*`` API driven by the caller
(dataset playback or a fabric node). The numeric state lives on one device
(``device``, the card by default): the keypose window in ``dtype``, the EKF
in float64 as in the JAX engine; this class routes measurements, keeps the
host-side history buffers and implements the sync policy. The JAX engine's
jitted closures are plain methods here.

Host syncs: the engine reads the device back at three places only, each
one copy — the frontend's result once a frame (``FRAME_SYNCS``), the
smoother's result once an update (``SMOOTHER_SYNCS``), and ``eigh``'s check
once a slide (``SLIDE_SYNCS``); a filter step makes ``IMU_SYNCS`` (none:
its samples go to the card through pinned memory without blocking). Times
stay exact on the host: int ns for every keypose match
(``_keypose_times_ns``), mission-relative seconds in the window.

Threads (``vio/threaded_estimator.py``): ``sync_lock``, when set, is held
around every change of the EKF state, and by the smoother's filter sync
from the rewind lookup through the commit, as in the JAX engine; the
solve's wait runs outside it. On the card the two threads run on two
streams: every commit of the EKF state records an event, and a thread
waits for it (and marks the state's tensors as used by its stream) before
it reads a state the other may have made (``_claim``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import enum
import functools
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.buffers import DataManager, ItemHistory
from ..core.cameras import StereoCamera
from ..core.measurements import (
    DepthMeasurement,
    ImuMeasurement,
    MagMeasurement,
    RangeMeasurement,
    StereoImage,
)
from ..core.quaternion import matrix_to_quat, quat_to_matrix
from ..core.se3 import gravity_axis
from ..ops.cuda import entry_device
from ..ops.graphs import GraphedStep
from ..utils.timing import StatsTracker
from .ekf import (
    EkfParams,
    EkfState,
    ekf_initialize,
    ekf_predict,
    ekf_replay_imu,
    ekf_update_depth,
    ekf_update_imu,
    ekf_update_pose,
    ekf_update_range,
)
from .imu_preintegration import ImuCalibration
from .smoother import (
    KeyposeWindow,
    SmootherConfig,
    SmootherResult,
    gauss_newton,
    make_window,
    preintegrate_window,
    slide_window,
    smoother_result,
)
from .stereo_frontend import (FrontendParams, FrontendStatus, StereoFrontend, VoResult, to_device,
                              to_host)

# Host syncs the engine makes on a CUDA device (see the module docstring).
IMU_SYNCS = 0
FRAME_SYNCS = 1
SMOOTHER_SYNCS = 1
SLIDE_SYNCS = 1

_F64 = torch.float64
# The preintegration loop's length on the card, rounded up to a multiple of
# this (its steps past the last valid sample are no-ops): one CUDA graph
# serves every update of a bucket.
IMU_STEP_BUCKET = 32
# The filter's IMU replay after a rewind, on the card: chunks of this many
# samples, each one replay of one CUDA graph (masked past the last sample),
# as the JAX engine dispatches its padded replay at once.
REPLAY_CHUNK = 16


class SmootherMode(enum.Enum):
    VISION_AVAILABLE = 0
    VISION_UNAVAILABLE = 1


@dataclasses.dataclass
class StateEstimatorParams:
    frontend: FrontendParams = dataclasses.field(default_factory=FrontendParams)
    smoother: SmootherConfig = dataclasses.field(default_factory=SmootherConfig)
    ekf: EkfParams = dataclasses.field(default_factory=EkfParams)
    imu_calib: ImuCalibration = dataclasses.field(default_factory=ImuCalibration)
    n_gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 9.81, 0.0])
    )
    max_imu_per_keypose: int = 256
    min_sec_btw_keyposes: float = 0.5
    max_sec_btw_keyposes: float = 1.0
    # Misalignment tolerances for attaching measurements to a keypose (sec).
    depth_tolerance: float = 0.1
    # External pose fixes attach to a keypose only within this window.
    fix_tolerance: float = 0.05
    range_tolerance: float = 0.2
    # Filter divergence thresholds vs smoother (soft = measurement update,
    # hard = re-initialize; state_estimator.cpp:507-543).
    soft_correction_pos: float = 0.05
    hard_correction_pos: float = 0.5
    ekf_history_sec: float = 10.0
    # VO-chain alignment gate (fixed_lag_smoother.cpp:277 uses 0.01 s).
    vo_align_tolerance: float = 0.01
    # Feed depth/range measurements to the EKF (they always reach the
    # smoother); StateEstimatorLcm.yaml filter_use_depth / filter_use_range.
    filter_use_depth: bool = True
    filter_use_range: bool = True
    # VO-timeout slack (WaitForResultOrTimeout, state_estimator.cpp:336-342).
    vo_timeout_slack: float = 0.1
    # Sensor extrinsics from the shared rig file (state_estimator.cpp:49,
    # state_ekf.cpp:54-56, fixed_lag_smoother.cpp:62-68).
    body_T_cam: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    body_T_imu: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    body_T_receiver: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    body_T_mag: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    mag_sensor_bias: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class StateStamped:
    timestamp: int
    world_T_body: np.ndarray
    velocity: np.ndarray
    covariance: Optional[np.ndarray] = None


class VoReadout(NamedTuple):
    """What the host needs of a frame's VoResult, read back in one copy."""

    status: int
    is_keyframe: bool
    T_prev_cur: np.ndarray     # (4, 4) float64
    lmk_ids: np.ndarray        # (K,) int
    lmk_valid: np.ndarray      # (K,) bool
    lmk_pixels: np.ndarray     # (K, 2)
    lmk_disparities: np.ndarray  # (K,)


class SmootherReadout(NamedTuple):
    """The newest keypose of a solve, and the filter's position at the
    rewind snapshot, read back in one copy."""

    R: np.ndarray
    p: np.ndarray
    v: np.ndarray
    cov_newest: np.ndarray
    p_filter: Optional[np.ndarray]


def _filter_step(state: EkfState, x: torch.Tensor, params: EkfParams, gravity: torch.Tensor,
                 q_body_imu: Optional[torch.Tensor]) -> EkfState:
    """Predict by x[0] seconds, then update with the gyro x[1:4] and the
    specific force x[4:7]."""
    return ekf_update_imu(ekf_predict(state, x[0], params), x[1:4], x[4:7], gravity, params,
                          q_body_imu=q_body_imu)


def _smoother_update(win: KeyposeWindow, calib: ImuCalibration, gravity: torch.Tensor,
                     gravity_unit: torch.Tensor, config: SmootherConfig, n_steps: int):
    """Preintegrate and solve: the states a solve changes, its residual and
    covariance."""
    pims = preintegrate_window(win, calib, n_steps)
    w, r, cov = gauss_newton(win, pims, gravity, gravity_unit, config)
    return w.R, w.p, w.v, w.bg, w.ba, r, cov


def _readout_vo(vo: VoResult) -> VoReadout:
    f = torch.float64
    flat = to_host(torch.cat([
        vo.status.to(f).reshape(1), vo.is_keyframe.to(f).reshape(1),
        vo.T_prev_cur.to(f).reshape(-1), vo.lmk_ids.to(f), vo.lmk_valid.to(f),
        vo.lmk_pixels.to(f).reshape(-1), vo.lmk_disparities.to(f),
    ]))
    K = vo.lmk_ids.shape[0]
    o = 18
    return VoReadout(
        status=int(flat[0]), is_keyframe=bool(flat[1]), T_prev_cur=flat[2:18].reshape(4, 4),
        lmk_ids=flat[o:o + K].astype(np.int64), lmk_valid=flat[o + K:o + 2 * K] > 0,
        lmk_pixels=flat[o + 2 * K:o + 4 * K].reshape(K, 2).astype(np.float32),
        lmk_disparities=flat[o + 4 * K:o + 5 * K].astype(np.float32),
    )


class StateEstimator:
    """Deterministic VIO engine on one device; feed measurements in
    timestamp order. Runs on the card unless ``device`` says otherwise, and
    raises without one."""

    def __init__(self, params: StateEstimatorParams, rig: StereoCamera, device="cuda",
                 dtype: torch.dtype = torch.float64):
        self.device = entry_device(device)
        self.dtype = dtype
        self.params = params
        self.rig = rig
        dev = self.device
        self._gravity_axis, g_unit = gravity_axis(params.n_gravity, _F64, dev)
        n_gravity = np.asarray(params.n_gravity, np.float64)
        self._gravity = to_device(n_gravity, dev, _F64)          # the EKF's (float64)
        self._gravity_unit = g_unit
        self._gravity_w = to_device(n_gravity, dev, dtype)       # the window's
        self._gravity_unit_w = g_unit.to(dtype)

        self.frontend = StereoFrontend(params.frontend, rig, device=dev)
        self.mode = SmootherMode.VISION_UNAVAILABLE

        # Measurement managers (host).
        self.imu_manager: DataManager[ImuMeasurement] = DataManager(max_size=10000)
        self.depth_manager: DataManager[DepthMeasurement] = DataManager(max_size=1000)
        self.range_manager: DataManager[RangeMeasurement] = DataManager(max_size=1000)
        self.mag_manager: DataManager[MagMeasurement] = DataManager(max_size=1000)
        # External fixes queue host-side until smoother attachment (a deque:
        # multi-source fixes legitimately arrive out of order).
        self._fix_queue: collections.deque = collections.deque(maxlen=200)
        self._fix_lock = threading.Lock()

        # Sensor extrinsics (identity on all shipped rigs but the camera's
        # translation). VO is conjugated into the body frame at intake; the
        # EKF rotates IMU samples and offsets range by the receiver lever
        # arm; the smoother gets the mounts in its static config.
        self._body_T_cam = np.asarray(params.body_T_cam, np.float64)
        self._cam_is_identity = np.allclose(self._body_T_cam, np.eye(4))
        R_bi = np.asarray(params.body_T_imu[:3, :3], np.float64)
        self._imu_is_identity = np.allclose(params.body_T_imu, np.eye(4))
        self._q_body_imu = (
            None if np.allclose(R_bi, np.eye(3))
            else matrix_to_quat(torch.as_tensor(R_bi)).to(dev)
        )
        t_recv = np.asarray(params.body_T_receiver[:3, 3], np.float64)
        self._body_t_receiver = None if np.allclose(t_recv, 0) else to_device(t_recv, dev, _F64)

        # Smoother window. Landmark projection factors need the left-camera
        # intrinsics in the (static) smoother config.
        smoother_cfg = params.smoother
        if smoother_cfg.max_landmarks > 0:
            smoother_cfg = smoother_cfg.replace(
                cam_fx=float(rig.left.fx), cam_fy=float(rig.left.fy),
                cam_cx=float(rig.left.cx), cam_cy=float(rig.left.cy),
                cam_baseline=float(rig.baseline),  # stereo disparity rows
            )
        smoother_cfg = smoother_cfg.replace(
            body_R_cam=tuple(self._body_T_cam[:3, :3].reshape(-1).tolist()),
            body_t_cam=tuple(self._body_T_cam[:3, 3].tolist()),
            body_t_receiver=tuple(t_recv.tolist()),
            mag_body_R_sensor=tuple(
                np.asarray(params.body_T_mag[:3, :3], np.float64).reshape(-1).tolist()
            ),
            mag_bias=tuple(np.asarray(params.mag_sensor_bias, np.float64).tolist()),
        )
        if not self._imu_is_identity:
            params.imu_calib = params.imu_calib.replace(
                body_R_imu=tuple(R_bi.reshape(-1).tolist()),
                body_t_imu=tuple(np.asarray(params.body_T_imu[:3, 3]).tolist()),
            )
        self._smoother_cfg = smoother_cfg
        self.window: KeyposeWindow = make_window(smoother_cfg, params.max_imu_per_keypose,
                                                 dtype=dtype, device=dev)
        # Valid IMU rows of each slot, on the host: the preintegration loop
        # stops after the longest.
        self._imu_rows = [0] * smoother_cfg.window
        self._imu_index = torch.arange(params.max_imu_per_keypose, device=dev)
        self._lmk_columns: dict = {}  # landmark id -> window landmark column
        self._n_keyposes = 0
        # Host-side int-ns keypose timestamps, one per filled slot: anything
        # that must MATCH a keypose by time reads these, never the window.
        self._keypose_times_ns: List[int] = []
        # The window stores MISSION-RELATIVE seconds (t - origin); the origin
        # is the initialization time.
        self._time_origin_ns: int = 0
        self._last_smoother_t_ns: Optional[int] = None
        self._last_keypose_t: Optional[int] = None
        self._last_smoother_result: Optional[SmootherResult] = None
        self._last_smoother_host: Optional[SmootherReadout] = None
        # The newest frame's VO status bitmask (host).
        self.last_status: Optional[int] = None

        # Running keyframe-to-keyframe VO composition (host, float64): when
        # the min_sec_btw_keyposes gate drops a keyframe, the keypose
        # between factor spans the COMPOSED motion across the skipped ones;
        # it is used only when the chain starts at the previous keypose
        # (fixed_lag_smoother.cpp:277).
        self._pending_vo: Optional[np.ndarray] = None
        self._pending_vo_start_t: Optional[int] = None
        self._last_kf_t: Optional[int] = None
        # Last stereo frame ARRIVAL: drives the VO-timeout check.
        self._last_stereo_t: Optional[int] = None

        # EKF + history for rewind/replay.
        self.ekf_params = params.ekf
        self.ekf_state: Optional[EkfState] = None
        self._ekf_time: Optional[int] = None
        self._ekf_history: ItemHistory = ItemHistory(lag_seconds=params.ekf_history_sec)
        self._imu_history: ItemHistory = ItemHistory(lag_seconds=params.ekf_history_sec)

        self.smoother_callbacks: List[Callable[[SmootherResult], None]] = []
        self.filter_callbacks: List[Callable[[StateStamped], None]] = []
        self._last_imu_t: Optional[int] = None
        # Set by ThreadedStateEstimator: held around every EKF-state mutation
        # so the vision thread's filter sync and the filter thread's IMU
        # updates serialize without serializing the (long) smoother solve.
        # With it set on the card, the EKF state's commits record _ekf_event
        # for the other thread's stream (see _claim).
        self.sync_lock = None
        self._ekf_event: Optional[tuple] = None  # (event, the stream it was recorded on)
        # Set by ThreadedStateEstimator, whose vision thread lags the filter:
        # a keypose starts from the EKF snapshot at its own time when the
        # filter has run past it (_state_at), and a frame counts as arrived
        # for the VO timeout when it is queued (note_stereo_arrival). Unset,
        # the JAX engine's rules: the current EKF state, and the time of the
        # frame being processed.
        self.vision_lags_filter = False

        # Per-stage latency stats (state_estimator.cpp:395-396, 427-428).
        self.stats = StatsTracker("state_estimator")
        self.print_stats = False

        # The filter step and the smoother update: by calls on the CPU,
        # replayed from CUDA graphs on the card (about 120 and 13,000
        # kernels; ops/graphs.py), the smoother's one for each bucket of the
        # preintegration loop's length.
        step = functools.partial(_filter_step, params=self.ekf_params, gravity=self._gravity,
                                 q_body_imu=self._q_body_imu)
        self._filter_step = GraphedStep(step) if dev.type == "cuda" else step
        self._replay_chunk = GraphedStep(functools.partial(
            ekf_replay_imu, n_gravity=self._gravity, params=self.ekf_params,
            q_body_imu=self._q_body_imu)) if dev.type == "cuda" else None
        self._smoother_steps: dict = {}

    def _locked(self):
        return self.sync_lock if self.sync_lock is not None else contextlib.nullcontext()

    def _w(self, x) -> torch.Tensor:
        """An array or tensor in the window's dtype on the device."""
        return to_device(x, self.device, self.dtype)

    # -- initialization -------------------------------------------------------

    def initialize(self, timestamp: int, world_T_body: np.ndarray) -> None:
        """External pose initialization (state_estimator_lcm InitializeLcm)."""
        T = to_device(np.asarray(world_T_body, np.float64), self.device, _F64)
        R0, p0 = T[:3, :3], T[:3, 3]
        self._commit_ekf(ekf_initialize(t0=p0, q0=matrix_to_quat(R0), dtype=_F64,
                                        device=self.device), timestamp)
        self._time_origin_ns = timestamp
        self._push_keypose(
            timestamp, R0, p0, torch.zeros(3, dtype=_F64, device=self.device),
            vo_T=None, imu_rows=None, depth=None, ranges=(),
            prior_anchor=True,
        )

    # -- measurement intake ---------------------------------------------------

    def receive_imu(self, m: ImuMeasurement, check_keypose: bool = True) -> None:
        """check_keypose=False runs the FILTER path only (EKF + history)."""
        self.imu_manager.push(m)
        self._imu_history.add(m.timestamp, m)
        self._last_imu_t = m.timestamp
        if self.ekf_state is not None:
            self._filter_predict_update(m)
        if check_keypose:
            self._maybe_imu_keypose(m.timestamp)

    def poll_imu_keypose(self) -> None:
        """IMU-fallback keypose check at the newest IMU time."""
        if self._last_imu_t is not None:
            self._maybe_imu_keypose(self._last_imu_t)

    def receive_depth(self, m: DepthMeasurement) -> None:
        self.depth_manager.push(m)
        if self.ekf_state is not None and self.params.filter_use_depth:
            self._commit_ekf(ekf_update_depth(self._claim(self.ekf_state), float(m.depth),
                                              self._gravity_unit, self.ekf_params))

    def receive_range(self, m: RangeMeasurement) -> None:
        self.range_manager.push(m)
        if self.ekf_state is not None and self.params.filter_use_range:
            self._commit_ekf(ekf_update_range(
                self._claim(self.ekf_state), float(m.range),
                to_device(np.asarray(m.point), self.device, _F64),
                self.ekf_params, body_t_receiver=self._body_t_receiver,
            ))

    def receive_mag(self, m: MagMeasurement) -> None:
        self.mag_manager.push(m)

    def receive_pose(self, m) -> None:
        """External absolute pose aiding (core.measurements.PoseMeasurement):
        (1) a manifold pose update at the EKF snapshot closest before the
        fix, then IMU replay; (2) queued for the smoother, where the keypose
        nearest the fix gets a 6-DoF absolute factor."""
        if self.ekf_state is None:
            return
        with self._fix_lock:
            self._fix_queue.append(m)
        cov = (
            np.eye(6) * 1e-4 if m.covariance is None
            else np.asarray(m.covariance, np.float64)
        )
        T = to_device(np.asarray(m.world_T_body, np.float64), self.device, _F64)
        q_meas = matrix_to_quat(T[:3, :3])
        t_meas = T[:3, 3]
        cov_t = to_device(cov, self.device, _F64)
        rewind = self._ekf_history.closest_before(m.timestamp)
        if rewind is None:
            # No snapshot at/before the fix: update the current state in
            # place without replay (a replay would double-apply IMU).
            self._commit_ekf(ekf_update_pose(self._claim(self.ekf_state), t_meas, q_meas, cov_t))
            return
        state = ekf_update_pose(self._claim(rewind[1]), t_meas, q_meas, cov_t)
        # Replay from the SNAPSHOT's time, not the fix's.
        self._commit_rewound_state(state, rewind[0])

    def note_stereo_arrival(self, timestamp: int) -> None:
        """A stereo frame has arrived (the VO-timeout check measures the
        camera's silence from it): the threaded wrapper calls it when it
        queues a frame, so a backlog on the vision thread is not taken for
        a silent camera."""
        if self._last_stereo_t is None or timestamp > self._last_stereo_t:
            self._last_stereo_t = timestamp

    def receive_stereo(self, m: StereoImage) -> None:
        if self.vision_lags_filter:
            self.note_stereo_arrival(m.timestamp)
        else:
            self._last_stereo_t = m.timestamp
        host = _readout_vo(self.frontend.track(m.left, m.right))
        self.last_status = host.status
        vision_ok = not (host.status & FrontendStatus.ODOM_ESTIMATION_FAILED) and not (
            host.status & FrontendStatus.NO_FEATURES_FROM_LAST_KF
        )
        self.mode = (
            SmootherMode.VISION_AVAILABLE if vision_ok else SmootherMode.VISION_UNAVAILABLE
        )
        if host.is_keyframe:
            if vision_ok:
                # Compose this keyframe's VO into the running chain.
                if self._pending_vo is None:
                    self._pending_vo = np.eye(4)
                    self._pending_vo_start_t = self._last_kf_t
                # VO measures camera motion; convert to BODY odometry by
                # conjugation (reference smoother.cpp:282).
                T_cam = host.T_prev_cur
                if not self._cam_is_identity:
                    T_cam = self._body_T_cam @ T_cam @ np.linalg.inv(self._body_T_cam)
                self._pending_vo = self._pending_vo @ T_cam
                self._last_kf_t = m.timestamp
                self._vision_keypose(m.timestamp, host)
            else:
                # Tracking broke: the chain no longer spans a clean interval.
                self._pending_vo = None
                self._pending_vo_start_t = None
                self._last_kf_t = m.timestamp

    # -- keypose creation -----------------------------------------------------

    def _maybe_imu_keypose(self, timestamp: int) -> None:
        """VISION_UNAVAILABLE fallback: keyposes at min cadence from IMU; and
        the VO-timeout check (a silent camera flips the mode here,
        state_estimator.cpp:336-397)."""
        if self._last_keypose_t is None or self.ekf_state is None:
            return
        if self.mode is SmootherMode.VISION_AVAILABLE:
            last_seen = self._last_stereo_t
            if last_seen is None:
                last_seen = self._last_keypose_t
            silence = (timestamp - last_seen) * 1e-9
            if silence <= self.params.max_sec_btw_keyposes + self.params.vo_timeout_slack:
                return
            self.mode = SmootherMode.VISION_UNAVAILABLE
            self._pending_vo = None
            self._pending_vo_start_t = None
        dt = (timestamp - self._last_keypose_t) * 1e-9
        if dt < self.params.min_sec_btw_keyposes:
            return
        imu_rows = self._gather_imu(self._last_keypose_t, timestamp)
        st = self._state_at(timestamp)
        self._push_keypose(
            timestamp, quat_to_matrix(st.q), st.t, st.v,
            vo_T=None, imu_rows=imu_rows,
            depth=self._gather_depth(timestamp),
            ranges=self._gather_ranges(timestamp),
            mag=self._gather_mag(timestamp),
        )
        self._run_smoother(timestamp)

    def _vision_keypose(self, timestamp: int, vo: VoReadout) -> None:
        if self._last_keypose_t is not None:
            dt = (timestamp - self._last_keypose_t) * 1e-9
            if dt < self.params.min_sec_btw_keyposes:
                return  # keyframe skipped; _pending_vo keeps accumulating
        imu_rows = (
            self._gather_imu(self._last_keypose_t, timestamp)
            if self._last_keypose_t is not None
            else None
        )
        tol_ns = int(self.params.vo_align_tolerance * 1e9)
        chain_aligned = (
            self._pending_vo is not None
            and self._pending_vo_start_t is not None
            and self._last_keypose_t is not None
            and abs(self._pending_vo_start_t - self._last_keypose_t) <= tol_ns
        )
        T_rel = self._pending_vo if chain_aligned else None
        # Chain is consumed either way: the next chain starts at this keyframe.
        self._pending_vo = None
        self._pending_vo_start_t = None

        prev_slot = self._newest_slot()
        win = self.window
        if T_rel is not None:
            # Predicted new state: previous keypose composed with VO, on the device.
            T_d = self._w(T_rel)
            R_prev, p_prev = win.R[prev_slot], win.p[prev_slot]
            R = R_prev @ T_d[:3, :3]
            p = p_prev + R_prev @ T_d[:3, 3]
            v = win.v[prev_slot]
        elif self.ekf_state is not None:
            st = self._state_at(timestamp)
            R, p, v = quat_to_matrix(st.q), st.t, st.v
        else:
            R, p, v = win.R[prev_slot], win.p[prev_slot], win.v[prev_slot]
        self._push_keypose(
            timestamp, R, p, v,
            vo_T=T_rel, imu_rows=imu_rows,
            depth=self._gather_depth(timestamp),
            ranges=self._gather_ranges(timestamp),
            mag=self._gather_mag(timestamp),
        )
        self._attach_landmarks(vo)
        self._run_smoother(timestamp)

    def _gather_imu(self, t0: int, t1: int) -> Optional[np.ndarray]:
        items = [m for m in self.imu_manager.pop_until(t1) if m.timestamp > t0]
        if not items:
            return None
        # Boundary-dt padding (imu_manager.cpp:57-135): the interval spans
        # exactly [t0, t1].
        pad_ns = t1 - items[-1].timestamp
        n = len(items) + (1 if pad_ns > 0 else 0)
        rows = np.zeros((n, 7))
        t_prev = t0
        for i, m in enumerate(items):
            rows[i, 0] = (m.timestamp - t_prev) * 1e-9
            rows[i, 1:4] = m.angular_velocity
            rows[i, 4:7] = m.linear_acceleration
            t_prev = m.timestamp
        if pad_ns > 0:
            rows[-1, 0] = pad_ns * 1e-9
            rows[-1, 1:4] = items[-1].angular_velocity
            rows[-1, 4:7] = items[-1].linear_acceleration
        return rows

    def _gather_depth(self, t: int) -> Optional[float]:
        tol = int(self.params.depth_tolerance * 1e9)
        self.depth_manager.discard_before(t - tol)
        items = self.depth_manager.pop_until(t + tol)
        return items[-1].depth if items else None

    def _gather_ranges(self, t: int):
        tol = int(self.params.range_tolerance * 1e9)
        self.range_manager.discard_before(t - tol)
        items = self.range_manager.pop_until(t + tol)
        return [(m.range, np.asarray(m.point, np.float64))
                for m in items[-self._smoother_cfg.max_ranges:]]

    def _gather_mag(self, t: int) -> Optional[np.ndarray]:
        tol = int(self.params.depth_tolerance * 1e9)
        self.mag_manager.discard_before(t - tol)
        items = self.mag_manager.pop_until(t + tol)
        return np.asarray(items[-1].field, np.float64) if items else None

    def _fix_tuple(self, m, dt_signed_sec: float, v_kp: np.ndarray):
        """PoseMeasurement -> (R, p, sigma6) for the window's fix factor: the
        position transported to the keypose time with the keypose's
        velocity, its sigma inflated for the transport's own error."""
        T = np.asarray(m.world_T_body, np.float64)
        cov = (
            np.eye(6) * 1e-4 if m.covariance is None
            else np.asarray(m.covariance, np.float64)
        )
        sig = np.sqrt(np.clip(np.diag(cov), 1e-12, None))
        sigma6 = np.concatenate([sig[3:6], sig[0:3]])
        p = T[:3, 3].copy()
        if dt_signed_sec != 0.0:
            v = np.asarray(v_kp, np.float64)
            p = p + dt_signed_sec * v
            speed = float(np.linalg.norm(v))
            slop = abs(dt_signed_sec) * (0.1 * speed + 0.1)
            sigma6[3:6] = np.sqrt(sigma6[3:6] ** 2 + slop**2)
        return T[:3, :3], p, sigma6

    def _attach_pending_fixes(self) -> None:
        """Attach queued external pose fixes to their closest keypose slot
        (within ±fix_tolerance), matching on the host's int-ns keypose
        times. Reads the window back only when a fix is due."""
        if self._n_keyposes == 0 or self._last_keypose_t is None:
            return
        tol_ns = int(self.params.fix_tolerance * 1e9)
        times = self._keypose_times_ns
        bound = self._last_keypose_t + tol_ns
        with self._fix_lock:
            take = [m for m in self._fix_queue if m.timestamp <= bound]
            if not take:
                return
            keep = [m for m in self._fix_queue if m.timestamp > bound]
            self._fix_queue.clear()
            self._fix_queue.extend(keep)
        win = self.window
        fix_valid = win.fix_valid.cpu().numpy().copy()
        vel = win.v.cpu().numpy()
        changed = False
        for m in take:
            cand = [
                k for k in range(len(times))
                if not fix_valid[k] and abs(times[k] - m.timestamp) <= tol_ns
            ]
            if not cand:
                continue  # no matching keypose: the filter already used it
            k = min(cand, key=lambda i: abs(times[i] - m.timestamp))
            R, p, sigma6 = self._fix_tuple(m, (times[k] - m.timestamp) * 1e-9, vel[k])
            win = win._replace(
                fix_R=_put(win.fix_R, k, self._w(R)),
                fix_p=_put(win.fix_p, k, self._w(p)),
                fix_sigma=_put(win.fix_sigma, k, self._w(sigma6)),
                fix_valid=_put(win.fix_valid, k, True),
            )
            fix_valid[k] = True
            changed = True
        if changed:
            self.window = win

    def _attach_landmarks(self, vo: VoReadout) -> None:
        """Write this keypose's landmark pixel observations into the window
        (structureless projection factors). Landmark identity across
        keyposes = window COLUMN; the host keeps the id->column assignment
        and recycles columns of landmarks that dropped out of the tracker."""
        L = self._smoother_cfg.max_landmarks
        if L <= 0:
            return
        slot = self._newest_slot()
        ids, valid = vo.lmk_ids, vo.lmk_valid
        live = {int(i) for i in ids[valid]}
        self._lmk_columns = {i: c for i, c in self._lmk_columns.items() if i in live}
        used = set(self._lmk_columns.values())
        free = [c for c in range(L) if c not in used]

        uv = np.zeros((L, 2))
        dsp = np.zeros(L)
        v_mask = np.zeros(L, bool)
        lmk_valid = self.window.lmk_valid
        for k in np.where(valid)[0]:
            lmk = int(ids[k])
            col = self._lmk_columns.get(lmk)
            if col is None:
                if not free:
                    continue
                col = free.pop()
                self._lmk_columns[lmk] = col
                # A recycled column's stale history belongs to another
                # landmark: clear it across the window.
                lmk_valid = _put(lmk_valid, (slice(None), col), False)
            uv[col] = vo.lmk_pixels[k]
            dsp[col] = max(float(vo.lmk_disparities[k]), 0.0)
            v_mask[col] = True
        packed = self._w(np.concatenate([uv.reshape(-1), dsp, v_mask]))
        self.window = self.window._replace(
            lmk_uv=_put(self.window.lmk_uv, slot, packed[:2 * L].reshape(L, 2)),
            lmk_disp=_put(self.window.lmk_disp, slot, packed[2 * L:3 * L]),
            lmk_valid=_put(lmk_valid, slot, packed[3 * L:] > 0),
        )

    def _newest_slot(self) -> int:
        return min(self._n_keyposes, self._smoother_cfg.window) - 1

    def _push_keypose(
        self, timestamp, R, p, v, vo_T, imu_rows, depth, ranges,
        mag=None, prior_anchor=False,
    ) -> None:
        cfg = self._smoother_cfg
        win = self.window
        if self._n_keyposes >= cfg.window:
            # Slide: the marginal of slot 1 — the next slot 0 — anchors the
            # slid window.
            cov = (
                self._last_smoother_result.cov_slot1
                if self._last_smoother_result is not None
                else torch.eye(15, dtype=self.dtype, device=self.device) * 1e-2
            )
            win = slide_window(win, cov)
            self._n_keyposes = cfg.window - 1
            del self._imu_rows[0]
            self._imu_rows.append(0)
            if self._keypose_times_ns:
                del self._keypose_times_ns[0]
        slot = self._n_keyposes

        # Every host value of the slot in one copy to the device.
        n_imu = self.params.max_imu_per_keypose
        samples = np.zeros((n_imu, 7))
        k = 0
        if imu_rows is not None:
            k = min(len(imu_rows), n_imu)
            samples[:k] = imu_rows[:k]
        B = cfg.max_ranges
        rng_vals = np.zeros(B)
        rng_beacons = np.zeros((B, 3))
        rng_valid = np.zeros(B)
        for i, (rv, bp) in enumerate(ranges[:B]):
            rng_vals[i], rng_beacons[i], rng_valid[i] = rv, bp, 1.0
        host = np.concatenate([
            (vo_T if vo_T is not None else np.eye(4)).reshape(-1), samples.reshape(-1),
            rng_vals, rng_beacons.reshape(-1), rng_valid,
            mag if mag is not None else np.zeros(3),
        ])
        d = self._w(host)
        o = 16 + 7 * n_imu
        slot_vo = d[:16].reshape(4, 4)
        slot_samples = d[16:o].reshape(n_imu, 7)
        slot_ranges = d[o:o + B]
        slot_beacons = d[o + B:o + 4 * B].reshape(B, 3)
        slot_rvalid = d[o + 4 * B:o + 5 * B] > 0
        slot_mag = d[o + 5 * B:o + 5 * B + 3]

        R, p, v = self._w(R), self._w(p), self._w(v)
        win = win._replace(
            timestamps=_put(win.timestamps, slot, (timestamp - self._time_origin_ns) * 1e-9),
            R=_put(win.R, slot, R),
            p=_put(win.p, slot, p),
            v=_put(win.v, slot, v),
            valid=_put(win.valid, slot, True),
            vo_T=_put(win.vo_T, slot, slot_vo),
            vo_valid=_put(win.vo_valid, slot, vo_T is not None),
            imu_samples=_put(win.imu_samples, slot, slot_samples),
            imu_mask=_put(win.imu_mask, slot, self._imu_index < k),
            imu_valid=_put(win.imu_valid, slot, imu_rows is not None),
            depth=_put(win.depth, slot, float(depth) if depth is not None else 0.0),
            depth_valid=_put(win.depth_valid, slot, depth is not None),
            ranges=_put(win.ranges, slot, slot_ranges),
            range_beacons=_put(win.range_beacons, slot, slot_beacons),
            range_valid=_put(win.range_valid, slot, slot_rvalid),
            mag=_put(win.mag, slot, slot_mag),
            mag_valid=_put(win.mag_valid, slot, mag is not None),
            # External pose fixes attach RETROACTIVELY (before each solve).
            fix_valid=_put(win.fix_valid, slot, False),
        )
        self._imu_rows[slot] = k
        if prior_anchor:
            win = win._replace(
                prior_R=R,
                prior_p=p,
                prior_v=v,
                prior_sqrt_info=torch.eye(15, dtype=self.dtype, device=self.device) * 100.0,
            )
        self.window = win
        self._n_keyposes += 1
        self._keypose_times_ns.append(timestamp)
        self._last_keypose_t = timestamp

    # -- smoother + filter sync ----------------------------------------------

    def _run_smoother(self, timestamp: int) -> None:
        if self._n_keyposes < 2:
            return
        t0 = time.perf_counter()
        self._attach_pending_fixes()
        n_steps = max(self._imu_rows)
        if self.device.type == "cuda":
            n_steps = min(-(-max(n_steps, 1) // IMU_STEP_BUCKET) * IMU_STEP_BUCKET,
                          self.params.max_imu_per_keypose)
        R, p, v, bg, ba, r, cov = self._smoother_step(n_steps)(self.window)
        self.window = self.window._replace(R=R, p=p, v=v, bg=bg, ba=ba)
        result = smoother_result(self.window, r, cov, self._newest_slot())
        # The filter's position at the rewind snapshot rides in the solve's
        # readout (one copy). The readout waits for the solve, so it runs
        # outside sync_lock; _sync_filter repeats the lookup under the lock
        # and reads again only if the snapshot changed meanwhile.
        with self._locked():
            rewind, state_at = self._rewind(timestamp)
        host = self._readout_smoother(result, state_at)
        # The readout waited for the solve, so the stat includes its device work.
        self.stats.add("smoother_update_ms", (time.perf_counter() - t0) * 1e3, self.print_stats)
        self._last_smoother_result = result
        self._last_smoother_host = host
        # Exact host time of the solved keypose.
        self._last_smoother_t_ns = timestamp
        for cb in self.smoother_callbacks:
            cb(result)
        self._sync_filter(timestamp, result, host, (rewind, state_at))

    def _smoother_step(self, n_steps: int):
        """The smoother update with a preintegration loop of ``n_steps``: by
        calls on the CPU, on the card a CUDA graph for each bucket."""
        step = self._smoother_steps.get(n_steps)
        if step is None:
            step = functools.partial(
                _smoother_update, calib=self.params.imu_calib, gravity=self._gravity_w,
                gravity_unit=self._gravity_unit_w, config=self._smoother_cfg, n_steps=n_steps)
            if self.device.type == "cuda":
                step = self._smoother_steps[n_steps] = GraphedStep(step)
        return step

    def capture_graphs(self) -> None:
        """On the card, capture now every CUDA graph the engine replays: the
        filter step, the replay chunk, the smoother update of each bucket
        and the frontend's odometry, each run once on the present state
        (outputs discarded). The threaded wrapper calls it before its
        threads start: a capture runs its step three times by calls, which
        takes seconds while another thread contends for the interpreter."""
        if self.device.type != "cuda" or self.ekf_state is None:
            return
        dev = self.device
        x = torch.zeros(7, dtype=_F64, device=dev)
        self._filter_step(self.ekf_state, x)
        z = torch.zeros(REPLAY_CHUNK, 3, dtype=_F64, device=dev)
        self._replay_chunk(self.ekf_state, z[:, 0], z, z, z[:, 0] > 0)
        for n_steps in range(IMU_STEP_BUCKET, self.params.max_imu_per_keypose + IMU_STEP_BUCKET,
                             IMU_STEP_BUCKET):
            self._smoother_step(min(n_steps, self.params.max_imu_per_keypose))(self.window)
        self.frontend.capture_graphs()

    def _readout_smoother(self, result: SmootherResult,
                          state_at: Optional[EkfState]) -> SmootherReadout:
        parts = [result.R.reshape(-1), result.p, result.v, result.cov_newest.reshape(-1)]
        if state_at is not None:
            parts.append(state_at.t.to(result.p.dtype))
        flat = to_host(torch.cat([x.to(_F64) for x in parts]))
        return SmootherReadout(
            R=flat[:9].reshape(3, 3), p=flat[9:12], v=flat[12:15],
            cov_newest=flat[15:240].reshape(15, 15),
            p_filter=flat[240:243] if state_at is not None else None,
        )

    def _state_at(self, timestamp: int) -> EkfState:
        """The EKF state a keypose at ``timestamp`` starts from: the current
        one, unless ``vision_lags_filter`` is set and the filter has run past
        the keypose, then the snapshot closest before it."""
        with self._locked():
            state = self.ekf_state
            if (self.vision_lags_filter and self._ekf_time is not None
                    and self._ekf_time > timestamp):
                rewind = self._ekf_history.closest_before(timestamp)
                if rewind is not None:
                    state = rewind[1]
            return self._claim(state)

    def _rewind(self, timestamp: int):
        """The EKF snapshot closest before ``timestamp`` (None if there is
        none) and the state the sync compares with: the snapshot's, else
        the current one."""
        rewind = self._ekf_history.closest_before(timestamp)
        state_at = rewind[1] if rewind is not None else self.ekf_state
        return rewind, self._claim(state_at)

    def _sync_filter(self, timestamp: int, result: SmootherResult,
                     host: SmootherReadout, looked_up) -> None:
        """Rewind -> soft/hard correction -> IMU replay (cpp:496-549), under
        ``sync_lock`` from the rewind lookup through the commit."""
        with self._locked():
            self._sync_filter_locked(timestamp, result, host, looked_up)

    def _sync_filter_locked(self, timestamp: int, result: SmootherResult,
                            host: SmootherReadout, looked_up) -> None:
        if self.ekf_state is None:
            return
        rewind, state_at = self._rewind(timestamp)
        p_filter = host.p_filter
        if state_at is not looked_up[1]:
            # The filter moved the snapshot since the readout: read again.
            p_filter = to_host(state_at.t)
        divergence = float(np.linalg.norm(host.p - p_filter))

        p_s = result.p.to(_F64)
        q_s = matrix_to_quat(result.R.to(_F64))
        base_t = timestamp
        if divergence > self.params.hard_correction_pos:
            # Hard: re-initialize the filter at the smoother state, defined
            # at the keypose time, so replay starts there.
            state = ekf_initialize(t0=p_s, q0=q_s, dtype=_F64, device=self.device)
            state = state._replace(v=result.v.to(_F64))
        elif rewind is None:
            # No snapshot before the keypose: a soft correction followed by
            # replay would double-apply IMU. Skip.
            return
        elif divergence > self.params.soft_correction_pos:
            # Soft: the smoother pose as a measurement, at the snapshot.
            # [rot, trans] -> [trans, rot]: rolled by 3 on both axes.
            cov6 = torch.roll(result.cov_newest[:6, :6].to(_F64), (3, 3), dims=(0, 1))
            cov6 = cov6 + torch.eye(6, dtype=_F64, device=self.device) * 1e-6
            state = ekf_update_pose(state_at, p_s, q_s, cov6)
            base_t = rewind[0]
        else:
            return  # filter agrees; nothing to do

        self._commit_rewound_state(state, base_t)

    def _commit_rewound_state(self, state, timestamp: int) -> None:
        """Replay the IMU samples newer than the rewind point onto `state` and
        commit: one copy of the samples to the device, then a predict and an
        update a sample, by calls on the CPU and on the card a CUDA graph of
        REPLAY_CHUNK samples a replay (a masked step keeps its state, so
        the bits are the calls')."""
        self._ekf_history.discard_after(timestamp)
        times, items = self._imu_items_after(timestamp)
        t_cur = timestamp
        if times:
            n = len(times)
            chunked = self._replay_chunk is not None
            rows = np.zeros((-(-n // REPLAY_CHUNK) * REPLAY_CHUNK if chunked else n, 8))
            for i, (t_m, m) in enumerate(zip(times, items)):
                rows[i, 0] = max((t_m - t_cur) * 1e-9, 0.0)
                rows[i, 1:4] = np.asarray(m.angular_velocity)
                rows[i, 4:7] = np.asarray(m.linear_acceleration)
                rows[i, 7] = 1.0
                t_cur = t_m
            d = to_device(rows, self.device, _F64)
            if chunked:
                for k in range(0, d.shape[0], REPLAY_CHUNK):
                    c = d[k:k + REPLAY_CHUNK]
                    state = self._replay_chunk(state, c[:, 0], c[:, 1:4], c[:, 4:7], c[:, 7] > 0)
            else:
                state = ekf_replay_imu(
                    state, d[:, 0], d[:, 1:4], d[:, 4:7], None, self._gravity, self.ekf_params,
                    q_body_imu=self._q_body_imu,
                )
        self._commit_ekf(state, t_cur)

    def _commit_ekf(self, state: EkfState, timestamp: Optional[int] = None) -> None:
        """Make ``state`` the EKF state (at ``timestamp``, if given); under
        ``sync_lock`` on the card, record the event a reader on another
        stream waits for."""
        if self.sync_lock is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            event = torch.cuda.Event()
            event.record(stream)
            self._ekf_event = (event, stream)
        self.ekf_state = state
        if timestamp is not None:
            self._ekf_time = timestamp

    def _claim(self, state: Optional[EkfState]) -> Optional[EkfState]:
        """``state``, any EKF state of this engine, made safe to read on this
        thread's stream: the stream waits for the newest commit's event
        (every commit waited for the one before, so that covers every state
        in the history), and the state's tensors are marked as used by it,
        so the caching allocator does not hand their memory to the stream
        that made them while this one may still read them. Without
        ``sync_lock`` on the card, ``state`` as it is; on the stream that made the
        newest commit, without a wait, and the newest state as it is (this
        stream made it)."""
        recorded = self._ekf_event
        if recorded is None or state is None:
            return state
        event, source = recorded
        stream = torch.cuda.current_stream(self.device)
        if stream == source:
            if state is self.ekf_state:
                return state
        else:
            stream.wait_event(event)
        for t in state:
            t.record_stream(stream)
        return state

    def _imu_items_after(self, t: int):
        times, items = [], []
        hist = self._imu_history
        with hist._lock:  # snapshot
            for tt, m in zip(hist._times, hist._items):
                if tt > t:
                    times.append(tt)
                    items.append(m)
        return times, items

    def _filter_predict_update(self, m: ImuMeasurement) -> None:
        dt = 0.0 if self._ekf_time is None else (m.timestamp - self._ekf_time) * 1e-9
        x = to_device(np.concatenate([[max(dt, 0.0)], m.angular_velocity,
                                      m.linear_acceleration]), self.device, _F64)
        state = self._filter_step(self._claim(self.ekf_state), x)
        self._commit_ekf(state, m.timestamp)
        self._ekf_history.add(m.timestamp, state)
        if self.filter_callbacks:
            out = self.filter_state()
            for cb in self.filter_callbacks:
                cb(out)

    # -- outputs --------------------------------------------------------------

    def filter_state(self) -> StateStamped:
        assert self.ekf_state is not None and self._ekf_time is not None
        st = self._claim(self.ekf_state)
        flat = to_host(torch.cat([quat_to_matrix(st.q).reshape(-1), st.t, st.v,
                                  st.S.reshape(-1)]))
        T = np.eye(4)
        T[:3, :3] = flat[:9].reshape(3, 3)
        T[:3, 3] = flat[9:12]
        return StateStamped(
            timestamp=self._ekf_time,
            world_T_body=T,
            velocity=flat[12:15],
            covariance=flat[15:].reshape(15, 15),
        )

    def smoother_state(self) -> Optional[StateStamped]:
        h = self._last_smoother_host
        if h is None:
            return None
        T = np.eye(4)
        T[:3, :3] = h.R
        T[:3, 3] = h.p
        return StateStamped(
            timestamp=self._last_smoother_t_ns,
            world_T_body=T,
            velocity=h.v.copy(),
            covariance=h.cov_newest.copy(),
        )


def _put(t: torch.Tensor, index, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[index] = value`` (the window's fields are
    never written in place: a caller may hold the previous window). A
    Python value is filled on the device: assigned as it is, it would be
    copied from the host, a sync."""
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=t.dtype, device=t.device)
    out = t.clone()
    out[index] = value
    return out
