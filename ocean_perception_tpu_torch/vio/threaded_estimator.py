"""Threaded StateEstimator wrapper — the reference's concurrency shape (port
of ``ocean_perception_tpu.vio.threaded_estimator``).

Reference parity: vio/state_estimator.cpp spawns three workers (frontend /
smoother / filter, :133-138) fed by ThreadsafeQueues with drop-oldest
backpressure; the whole point of the split is that the filter keeps 50+ Hz
output DURING the ~1 Hz smoother solve (vio/README.md:8-15). The numerics
live in the deterministic synchronous ``StateEstimator``; this wrapper
restores the asynchronous process shape:

- a **vision thread** (frontend + keyposing + smoother solve, ~frame rate)
  drains the stereo queue and owns all window/keypose state — including the
  IMU-fallback keypose check, which the reference also runs on its smoother
  thread (state_estimator.cpp:336-397);
- a **filter thread** (IMU-rate) drains the fast queue and runs ONLY the
  EKF predict/update path. When an IMU timestamp makes a fallback keypose
  *due* (min_sec cadence in MEASUREMENT time), it enqueues a timestamped
  keypose REQUEST that the vision thread executes.

The two paths share just the EKF state; ``sync_lock`` is held around EKF
mutations (filter updates, and the vision thread's brief
rewind/correct/replay after each solve) — the long solve itself runs
WITHOUT it, so filter output cadence is bounded by the sync, not the solve.

On the card each thread launches on a CUDA stream of its own, the
filter's of a higher priority, so a filter step does not queue behind the
smoother's ~100 ms of kernels; the engine hands the EKF state between the two streams by events
(``StateEstimator._claim``). The engine's CUDA graphs are captured in
``initialize``, before the threads start (``capture_graphs``): a capture
runs its step three times by calls, and while the other thread contends
for the interpreter that took seconds, long enough for the vision thread
to drop frames; a capture that does happen later runs in thread-local
mode (``ops/graphs.py``). The wrapper runs on ``device``, the card by
default, and raises without one.

Two rules of the JAX wrapper change with a vision thread that lags the
filter (it does on the card, where both threads' launches contend for the
interpreter); the wrapper sets ``StateEstimator.vision_lags_filter`` for
them, and the synchronous engine keeps JAX's rules: a keypose takes the EKF
snapshot at its own time, not the filter's newest state
(``StateEstimator._state_at``), and a frame counts as arrived for the
VO-timeout check when it is queued, not when it is processed
(``note_stereo_arrival``), so a backlog is not taken for a silent camera.

A full collection of the interpreter's cyclic garbage collector holds the
interpreter, and with it both threads, for as long as it walks the heap:
with PyTorch loaded, hundreds of thousands of objects and up to seconds
(PERF.md §6), long enough for the stereo queue to drop frames and the
estimator to lose its track. While its threads run, the wrapper keeps the
objects that existed when they started in the collector's permanent
generation (``gc.freeze``), so a full collection walks only what was made
since; ``shutdown`` gives them back to the collector once no wrapper runs.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import traceback

import torch

from ..core.buffers import ThreadsafeQueue
from ..core.cameras import StereoCamera
from ..core.measurements import (
    DepthMeasurement,
    ImuMeasurement,
    MagMeasurement,
    PoseMeasurement,
    RangeMeasurement,
    StereoImage,
)
from .state_estimator import StateEstimator, StateEstimatorParams


# Wrappers whose threads run, and the lock around the count: the heap stays
# frozen while any does (gc.freeze and gc.unfreeze act on the process).
_running = [0]
_running_lock = threading.Lock()


class ThreadedStateEstimator:
    def __init__(self, params: StateEstimatorParams, rig: StereoCamera,
                 stereo_queue_size: int = 4, imu_queue_size: int = 1000,
                 device="cuda", dtype: torch.dtype = torch.float64):
        self.core = StateEstimator(params, rig, device=device, dtype=dtype)
        self._stereo_q: ThreadsafeQueue[StereoImage] = ThreadsafeQueue(stereo_queue_size)
        self._fast_q: ThreadsafeQueue[object] = ThreadsafeQueue(imu_queue_size)
        # Timestamped IMU-fallback keypose requests, filter -> vision thread.
        self._kp_q: ThreadsafeQueue[int] = ThreadsafeQueue(256)
        self._last_kp_request_t: float = -1.0
        self._vision_busy = False
        self._filter_busy = False
        # Filter lock: EKF state + measurement managers (fast path). Vision
        # lock: window/keypose/frontend state. The smoother solve holds only
        # the vision lock; core._sync_filter takes the filter lock itself
        # (via core.sync_lock) for the brief rewind/correct/replay.
        self._filter_lock = threading.Lock()
        self._vision_lock = threading.Lock()
        self.core.sync_lock = self._filter_lock
        self.core.vision_lags_filter = True
        dev = self.core.device
        self._streams = {}
        if dev.type == "cuda":
            # The filter's stream has the higher priority: the card runs its
            # few kernels a step ahead of the smoother's pending ones.
            self._streams = {"vision": torch.cuda.Stream(dev),
                             "filter": torch.cuda.Stream(dev, priority=-1)}
        self._shutdown = threading.Event()
        self._threads = []

    # -- lifecycle -------------------------------------------------------------

    def initialize(self, timestamp: int, world_T_body) -> None:
        with self._filter_lock, self._vision_lock:
            self.core.initialize(timestamp, world_T_body)
        if self._streams:
            # Every graph is captured before the threads start, and their
            # streams start after the initial state exists.
            self.core.capture_graphs()
            torch.cuda.synchronize(self.core.device)
        with _running_lock:
            _running[0] += 1
            gc.freeze()
        for target, name in ((self._vision_loop, "vision"), (self._filter_loop, "filter")):
            t = threading.Thread(target=self._on_stream, args=(name, target),
                                 name=f"estimator-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def _on_stream(self, name: str, loop) -> None:
        stream = self._streams.get(name)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            loop()

    def shutdown(self) -> None:
        self._shutdown.set()
        for t in self._threads:
            t.join(timeout=5)
        if self._threads:
            self._threads = []
            with _running_lock:
                _running[0] -= 1
                if not _running[0]:
                    gc.unfreeze()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the queues drain AND in-flight work finishes (for
        deterministic tests). Requires the idle condition to hold across
        several consecutive checks to close the pop-to-busy-flag race."""
        t0 = time.monotonic()
        stable = 0
        while time.monotonic() - t0 < timeout:
            idle = (
                self._stereo_q.empty()
                and self._fast_q.empty()
                and self._kp_q.empty()
                and not self._vision_busy
                and not self._filter_busy
            )
            stable = stable + 1 if idle else 0
            if stable >= 3:
                return True
            time.sleep(0.02)
        return False

    # -- ingest (non-blocking; drop-oldest on overflow) -------------------------

    def receive_stereo(self, m: StereoImage) -> None:
        # A queued frame is not camera silence, however far the vision
        # thread lags behind (the VO-timeout check).
        self.core.note_stereo_arrival(m.timestamp)
        self._stereo_q.push(m)

    def receive_imu(self, m: ImuMeasurement) -> None:
        self._fast_q.push(m)

    def receive_depth(self, m: DepthMeasurement) -> None:
        self._fast_q.push(m)

    def receive_range(self, m: RangeMeasurement) -> None:
        self._fast_q.push(m)

    def receive_mag(self, m: MagMeasurement) -> None:
        self._fast_q.push(m)

    def receive_pose(self, m: PoseMeasurement) -> None:
        self._fast_q.push(m)

    # -- workers ----------------------------------------------------------------

    def _vision_loop(self) -> None:
        while not self._shutdown.is_set():
            m = self._stereo_q.pop(timeout=0.02)
            try:
                self._vision_busy = True
                if m is not None:
                    with self._vision_lock:
                        self.core.receive_stereo(m)
                # Fallback keypose requests are serviced EVERY iteration,
                # stereo frame or not — a sustained stereo backlog must not
                # starve the VO-timeout / IMU-fallback path.
                t_req = self._kp_q.pop(timeout=0.0)
                with self._vision_lock:
                    if t_req is not None:
                        # A filter-requested fallback keypose check at its
                        # MEASUREMENT timestamp.
                        self.core._maybe_imu_keypose(t_req)
                    elif m is None:
                        # Idle tick: the VO-timeout / IMU-fallback check
                        # (state_estimator.cpp:336-397).
                        self.core.poll_imu_keypose()
            except Exception:  # noqa: BLE001 — worker must survive bad input
                traceback.print_exc()
            finally:
                self._vision_busy = False

    def _filter_loop(self) -> None:
        min_gap = self.core.params.min_sec_btw_keyposes
        while not self._shutdown.is_set():
            m = self._fast_q.pop(timeout=0.1)
            if m is None:
                continue
            try:
                self._filter_busy = True
                with self._filter_lock:
                    if isinstance(m, ImuMeasurement):
                        # Filter path only — keyposing runs on the vision thread.
                        self.core.receive_imu(m, check_keypose=False)
                        t_sec = m.timestamp * 1e-9
                        if t_sec - self._last_kp_request_t >= min_gap:
                            self._last_kp_request_t = t_sec
                            self._kp_q.push(m.timestamp)
                    elif isinstance(m, DepthMeasurement):
                        self.core.receive_depth(m)
                    elif isinstance(m, RangeMeasurement):
                        self.core.receive_range(m)
                    elif isinstance(m, MagMeasurement):
                        self.core.receive_mag(m)
                    elif isinstance(m, PoseMeasurement):
                        # External pose fix: brief rewind/update/replay on the
                        # EKF — filter-lock scope, like the smoother sync commit.
                        self.core.receive_pose(m)
            except Exception:  # noqa: BLE001 — one bad measurement must not
                # silently kill the filter thread for the process lifetime
                traceback.print_exc()
            finally:
                self._filter_busy = False

    # -- outputs ---------------------------------------------------------------

    @property
    def smoother_callbacks(self):
        return self.core.smoother_callbacks

    @property
    def filter_callbacks(self):
        return self.core.filter_callbacks

    def filter_state(self):
        with self._filter_lock:
            return self.core.filter_state()

    def smoother_state(self):
        with self._vision_lock:
            return self.core.smoother_state()
