"""Estimator state checkpoint/resume (port of ``ocean_perception_tpu.vio.checkpoint``).

The reference has NO checkpointing (SURVEY.md §5.4: state lives in memory;
re-initialization comes from an external pose). This module adds it: the
smoother window, EKF state, and engine counters serialize to a single
``.npz``, so a node can restart mid-mission and resume smoothing where it
left off.

The layout is the JAX package's, key for key: a field of the window is
``window.<name>`` and of the EKF state ``ekf.<name>`` (what
``jax.tree_util.keystr`` gives for the JAX named tuples), each in its
tensor's dtype, beside the same scalars and ``FORMAT_VERSION``. A
checkpoint saved by either package loads into the other. Saving reads the
state back from the device in one copy; loading puts every field on the
estimator's device in its template's dtype.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from .stereo_frontend import to_device, to_host

FORMAT_VERSION = 1


def _fields(tree: NamedTuple, prefix: str):
    return [(f"{prefix}.{name}", t) for name, t in tree._asdict().items()]


def save_estimator(est, path: str) -> None:
    """Serialize a StateEstimator's resumable state to `path` (.npz)."""
    # (state, time) must be captured ATOMICALLY: under the threaded wrapper
    # the filter thread rebinds both between any two reads here, and a
    # checkpoint pairing state k+1 with time k would re-integrate one
    # already-applied IMU period on resume. sync_lock is the filter lock.
    with est._locked():
        ekf_state = est._claim(est.ekf_state)
        ekf_time = est._ekf_time
    fields = _fields(est.window, "window")
    if ekf_state is not None:
        fields += _fields(ekf_state, "ekf")
    # Every field in one read-back: float64 holds each float32, float64 and
    # bool value exactly.
    flat = to_host(torch.cat([t.reshape(-1).to(torch.float64) for _, t in fields]))
    data: Dict[str, np.ndarray] = {
        "__version__": np.asarray(FORMAT_VERSION),
        "n_keyposes": np.asarray(est._n_keyposes),
        "last_keypose_t": np.asarray(est._last_keypose_t if est._last_keypose_t is not None else -1),
        "ekf_time": np.asarray(ekf_time if ekf_time is not None else -1),
        "mode": np.asarray(est.mode.value),
        # Host int-ns keypose times (exact; the window's f32 timestamps
        # cannot reconstruct these at epoch scale). Fix attachment needs them.
        "keypose_times_ns": np.asarray(est._keypose_times_ns, np.int64),
        # Window timestamps are mission-relative seconds; the origin anchors
        # them back to epoch ns.
        "time_origin_ns": np.asarray(est._time_origin_ns),
    }
    o = 0
    for key, t in fields:
        n = t.numel()
        data[key] = flat[o:o + n].reshape(tuple(t.shape)).astype(
            torch.empty((), dtype=t.dtype).numpy().dtype)
        o += n
    # Atomic update: a crash mid-write must never leave a truncated .npz at
    # `path` (the node rewrites the checkpoint on every smoother update).
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **data)
    # np.savez appends .npz if missing — mirror that for the rename source.
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def load_estimator(est, path: str) -> None:
    """Restore state saved by save_estimator (of either package) into a
    freshly constructed StateEstimator (same params/window geometry)."""
    from .ekf import ekf_initialize
    from .state_estimator import SmootherMode

    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    if int(data["__version__"]) != FORMAT_VERSION:
        # NOT an assert: -O must not silently load an incompatible format.
        raise ValueError(
            f"checkpoint format {int(data['__version__'])} != {FORMAT_VERSION}"
        )

    def _unflatten(template: NamedTuple, prefix: str):
        out = {}
        for key, leaf in _fields(template, prefix):
            name = key[len(prefix) + 1:]
            if key not in data and ".fix_" in key:
                # The fix_* pose-fix fields postdate some checkpoints: keep
                # the fresh template's defaults ("no fixes recorded"). Any
                # OTHER missing key still raises — a torn/corrupted file
                # must fail loudly, not silently reset state.
                out[name] = leaf
                continue
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                if ".lmk_" in key:
                    # max_landmarks changed between save and load: landmark
                    # history is additive evidence, not core state — resume
                    # with empty columns.
                    out[name] = leaf
                    continue
                # Anything else mis-shaped means the window geometry changed
                # (window/max_ranges/n_imu config): fail loudly.
                raise ValueError(
                    f"checkpoint field {key} shape {tuple(arr.shape)} != "
                    f"configured {tuple(leaf.shape)} — estimator was "
                    "built with different window geometry than the saved "
                    "mission"
                )
            out[name] = to_device(arr, est.device, leaf.dtype)
        return type(template)(**out)

    est.window = _unflatten(est.window, "window")
    # "ekf." = the flattened EKF tree prefix. NOT bare "ekf": the scalar
    # "ekf_time" key is always present.
    if any(k.startswith("ekf.") or k.startswith("ekf[") for k in data):
        template = est.ekf_state
        if template is None:
            template = ekf_initialize(dtype=torch.float64, device=est.device)
        est._commit_ekf(_unflatten(template, "ekf"))
    est._n_keyposes = int(data["n_keyposes"])
    est._time_origin_ns = int(data.get("time_origin_ns", 0))
    if "keypose_times_ns" in data:
        est._keypose_times_ns = [int(t) for t in data["keypose_times_ns"]]
    else:
        # Pre-fix_* checkpoint: approximate from the window's MISSION-
        # RELATIVE timestamps, re-anchored by the restored origin.
        ts = np.asarray(data["window.timestamps"], np.float64)
        est._keypose_times_ns = [
            int(round(ts[k] * 1e9)) + est._time_origin_ns
            for k in range(est._n_keyposes)
        ]
    # The preintegration loop's length per slot (host, port only): the
    # valid IMU rows of each slot's mask.
    est._imu_rows = [int(n) for n in np.asarray(data["window.imu_mask"]).sum(axis=1)]
    lk = int(data["last_keypose_t"])
    est._last_keypose_t = lk if lk >= 0 else None
    et = int(data["ekf_time"])
    est._ekf_time = et if et >= 0 else None
    est.mode = SmootherMode(int(data["mode"]))
