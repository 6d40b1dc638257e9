#!/usr/bin/env python
"""The threaded estimator's filter gaps taken apart, on one NVIDIA GPU.

Feeds ``chip_smoke.py`` phase 17 (d)'s mission (the shipped
``StateEstimatorNode`` config on ``Farmsim.yaml``, 30 s, in real time) to
``ThreadedStateEstimator`` several times in one process. A filter output is
a CUDA event recorded after each filter step, as phase 17 (d) records it;
the calls of the filter and vision threads that a gap can hide in are
stamped on the host's clock (the input upload and its pinned block's
fill, the state's claim, the
graph's input copies, replay and output clones, the commit, the
smoother's update and its sync, the frontend's frame). For each run it
prints the longest gaps between two filter outputs on the card, the
longest from frame ``VIO_WARMUP`` on (the quantity phase 17 (d) bounds),
the filter step's host time, and for the longest gaps every stamped call
of either thread inside them.

Run 0 warms the process: its first-time costs land there. The runs after
it take the variants in turns, so that variants are compared within one
call: each pair of the interpreter's switch interval while the threads run
(``--intervals``, seconds) and ``RESERVE_IMU_HZ``, the IMU rate whose
history of filter states the wrapper reserves in the filter stream's
memory pool before its threads start (``--reserves``, 0: none). After each
filter step it reads the memory the caching allocator holds, and marks the
gaps in which it grew (a cudaMalloc by either thread).

Run: ``python vio_gaps.py [--runs 9] [--intervals 0.005]
[--reserves 400,0]`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import argparse
import gc
import itertools
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map

import chip_smoke as cs
from ocean_perception_tpu_torch.config.bindings import load_state_estimator_params
from ocean_perception_tpu_torch.ops import graphs
from ocean_perception_tpu_torch.vio import state_estimator as vse
from ocean_perception_tpu_torch.vio import stereo_frontend as sf
from ocean_perception_tpu_torch.vio import threaded_estimator as tse

STAMPS = []  # (thread name, call, host start s, host end s)
SHOWN = 4    # the longest gaps of a run whose calls are listed
LISTED_MS = 2.0  # another thread's call is listed in a gap when it took longer


def thread_name() -> str:
    return threading.current_thread().name.removeprefix("estimator-")


def stamped(name: str, fn):
    def call(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            STAMPS.append((thread_name(), name, t0, time.perf_counter()))
    return call


def stamped_replay(self, *args):
    """``GraphedStep.__call__`` with its input copies, replay and output
    clones stamped apart."""
    if torch.cuda.is_current_stream_capturing():
        return self.fn(*args)
    flat, spec = tree_flatten(args)
    key = (str(spec), tuple((t.shape, t.dtype, t.device) for t in flat))
    t0 = time.perf_counter()
    entry = self._graphs.get(key)
    if entry is None:
        entry = self._graphs[key] = self._capture(flat, spec)
        STAMPS.append((thread_name(), "graph capture", t0, time.perf_counter()))
    graph, static_in, static_out = entry
    t1 = time.perf_counter()
    for buf, t in zip(static_in, flat):
        buf.copy_(t)
    t2 = time.perf_counter()
    graph.replay()
    t3 = time.perf_counter()
    out = tree_map(torch.clone, static_out)
    t4 = time.perf_counter()
    name = thread_name()
    STAMPS.extend([(name, "graph copies in", t1, t2), (name, "graph replay", t2, t3),
                   (name, "graph clones out", t3, t4)])
    return out


def stamped_to_device(x, device, dtype):
    """``vio/stereo_frontend.py::to_device`` with its steps stamped apart
    (the host tensor, the pinned block and its fill, the upload)."""
    name, t0 = thread_name(), time.perf_counter()
    if isinstance(x, torch.Tensor) or torch.device(device).type != "cuda":
        out = plain_to_device(x, device, dtype)
        STAMPS.append((name, "to_device", t0, time.perf_counter()))
        return out
    t = torch.as_tensor(np.ascontiguousarray(x)).to(dtype)
    t1 = time.perf_counter()
    pinned = t.pin_memory()
    t2 = time.perf_counter()
    out = pinned.to(device, non_blocking=True)
    t3 = time.perf_counter()
    STAMPS.extend([(name, "to_device", t0, t3), (name, "  host tensor", t0, t1),
                   (name, "  pinned fill", t1, t2), (name, "  upload", t2, t3)])
    return out


plain_to_device = sf.to_device


def instrument() -> None:
    graphs.GraphedStep.__call__ = stamped_replay
    for mod in (vse, sf):
        mod.to_device = stamped_to_device
        mod.to_host = stamped("to_host", mod.to_host)
    for name in ("_claim", "_commit_ekf", "_sync_filter", "_run_smoother", "receive_stereo",
                 "receive_depth"):
        setattr(vse.StateEstimator, name, stamped(name, getattr(vse.StateEstimator, name)))
    sf.StereoFrontend.track = stamped("track", sf.StereoFrontend.track)


def run_once(mission: dict, k: int, interval: float, reserve: float) -> float:
    """One real-time feed of the mission; returns the longest gap between
    two filter outputs from frame VIO_WARMUP on, ms on the card's clock."""
    STAMPS.clear()
    tse.RESERVE_IMU_HZ = reserve
    events, gt = mission["events"], mission["gt"]
    te = tse.ThreadedStateEstimator(mission["params"], mission["rig"], device="cuda:0")
    core = te.core
    outputs, host_done, reserved = [], [], []
    filter_step = stamped("filter step", core._filter_predict_update)

    def step(*a):
        filter_step(*a)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        outputs.append(ev)
        host_done.append(time.perf_counter())
        reserved.append(torch.cuda.memory_reserved())

    core._filter_predict_update = step
    collections = []

    def on_gc(phase, info):
        if phase == "stop":
            collections.append(info["generation"])

    interpreter_interval = sys.getswitchinterval()
    sys.setswitchinterval(interval)
    try:
        te.initialize(gt[0].timestamp, gt[0].world_T_body)
        base = torch.cuda.Event(enable_timing=True)
        base.record()
        t_wall0, t_ns0 = time.perf_counter(), events[0][1].timestamp
        feed = {"imu": te.receive_imu, "depth": te.receive_depth, "stereo": te.receive_stereo}
        gc.callbacks.append(on_gc)
        try:
            for kind, m in events:
                delay = (m.timestamp - t_ns0) * 1e-9 - (time.perf_counter() - t_wall0)
                if delay > 0:
                    time.sleep(delay)
                feed[kind](m)
            idle = te.wait_idle(timeout=300)
        finally:
            gc.callbacks.remove(on_gc)
            te.shutdown()
    finally:
        sys.setswitchinterval(interpreter_interval)
    torch.cuda.synchronize()
    done = np.array([base.elapsed_time(ev) for ev in outputs])
    gaps = np.diff(done)
    host = np.array(host_done)
    steps = [1e3 * (b - a) for n, c, a, b in STAMPS if c == "filter step"]
    frame_at = [i for i, (kind, _) in enumerate(events) if kind == "stereo"]
    warm = sum(kind == "imu" for kind, _ in events[:frame_at[cs.VIO_WARMUP]])
    longest = float(gaps[warm:].max())
    order = np.argsort(gaps)[::-1]
    # The filter steps after which the caching allocator held more memory
    # than after the step before (a cudaMalloc by either thread).
    grew = [i for i in range(1, len(reserved)) if reserved[i] > reserved[i - 1]]
    fills = {n: [1e3 * (b - a) for nn, c, a, b in STAMPS if nn == n and c == "  pinned fill"]
             for n in ("vision", "filter")}
    captures = sum(c == "graph capture" and n in ("vision", "filter") for n, c, _, _ in STAMPS)
    print(f"[run {k}] switch interval {1e3 * interval:g} ms, filter memory reserved for "
          f"{reserve:g} Hz; the allocator grew after filter "
          f"outputs {grew[:12]} ({len(grew)}, {(reserved[-1] - reserved[0]) / 2**20:.0f} MiB); "
          f"pinned fill ms p50, p99, max: vision {pct(fills['vision'])}, filter "
          f"{pct(fills['filter'])}; idle {idle}; {len(outputs)} filter "
          f"outputs; gaps ms p50 {np.percentile(gaps, 50):.3f}, p99 "
          f"{np.percentile(gaps, 99):.3f}, {int((gaps > 20).sum())} over 20; longest "
          f"{[round(float(gaps[i]), 3) for i in order[:5]]} after outputs "
          f"{[int(i) for i in order[:5]]}; from frame {cs.VIO_WARMUP} on {longest:.3f} "
          f"(phase 17 (d)'s bound {cs.VIO_MAX_FILTER_GAP_MS:g}); filter step ms (host) p50 "
          f"{np.percentile(steps, 50):.3f}, p99 {np.percentile(steps, 99):.3f}, max "
          f"{max(steps):.3f}; {captures} captures while the threads ran; "
          f"{len(collections)} collections")
    for i in order[:SHOWN]:
        t0, t1 = host[i] - 1e-3, host[i + 1]
        print(f"  gap {gaps[i]:.3f} ms after output {i} ({i * cs.VIO_IMU_NS * 1e-9:.2f} s into "
              f"the mission), host window {1e3 * (t1 - t0):.3f} ms, the allocator "
              f"{'grew' if i + 1 in grew else 'did not grow'} in it; times from its start:")
        for name, call, a, b in sorted(STAMPS, key=lambda s: s[2]):
            if b >= t0 and a <= t1 and (name == "filter" or 1e3 * (b - a) > LISTED_MS):
                print(f"    {name:7s} {call:18s} {1e3 * (a - t0):9.3f} .. {1e3 * (b - t0):9.3f}"
                      f" ({1e3 * (b - a):.3f} ms)")
    return longest


def pct(xs) -> str:
    if not xs:
        return "none"
    return (f"{np.percentile(xs, 50):.3f}, {np.percentile(xs, 99):.3f}, "
            f"{max(xs):.3f} over {len(xs)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=9)
    ap.add_argument("--intervals", default=f"{sys.getswitchinterval():g}")
    ap.add_argument("--reserves", default=f"{tse.RESERVE_IMU_HZ:g},0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vio_gaps.py needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    cs.cuda.library()
    instrument()
    parser = cs.YamlParser(node_path=cs.VIO_YAML, shared_path=cs.FARMSIM_YAML)
    params = load_state_estimator_params(parser)
    rig = cs.load_rig(parser)
    events, gt, n_frames, _ = cs.vio_mission(rig, params.n_gravity)
    mission = dict(params=params, rig=rig, events=events, gt=gt, n_frames=n_frames)
    variants = list(itertools.product([float(v) for v in args.intervals.split(",")],
                                      [float(v) for v in args.reserves.split(",")]))
    longest, wrapper_reserve = [], tse.RESERVE_IMU_HZ
    try:
        for k in range(args.runs):
            v = variants[0] if k == 0 else variants[(k - 1) % len(variants)]
            longest.append((*v, run_once(mission, k, *v)))
    finally:
        tse.RESERVE_IMU_HZ = wrapper_reserve
    print(f"longest gap from frame {cs.VIO_WARMUP} on, ms, each run (switch interval s, "
          f"reserve Hz, ms): {longest}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
