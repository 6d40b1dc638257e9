"""Trajectory evaluation: absolute trajectory error (ATE) and relative pose
error (RPE), TUM-RGBD methodology (Sturm et al., IROS 2012).

The reference carries groundtruth through its dataset layer but only ever
*renders* it for visual comparison (tools/vio_dataset_player/main.cpp:80,
135-137 — `Visualizer3D::AddGroundtruthPose`); it has no numeric trajectory
metric. This module adds the standard offline evaluation the reference
lacks, operating on the same `GroundtruthPose` records the dataset layer
already parses (datasets/euroc.py `_parse_groundtruth`) and on the
estimator's published pose stream.

Host-side numpy by design: evaluation is an offline tool that runs once
per mission, not a device kernel. A copy of
``ocean_perception_tpu.vio.evaluation``.

Conventions
-----------
- A trajectory is (timestamps[int ns], poses (N, 4, 4) world_T_body).
- Groundtruth is linearly interpolated (positions) / slerped (rotations)
  at the estimate's timestamps; estimate samples outside the groundtruth
  time span are dropped.
- ATE aligns the estimate to groundtruth with a closed-form Umeyama fit
  (SE3 by default, Sim3 optionally for monocular-style scale ambiguity,
  or no alignment for odometry-frame checks) and reports translation
  error statistics.
- RPE compares relative motions over a fixed time delta, which isolates
  drift rate from accumulated error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "AteResult",
    "RpeResult",
    "align_umeyama",
    "interpolate_poses",
    "absolute_trajectory_error",
    "relative_pose_error",
    "evaluate_trajectory",
    "poses_from_groundtruth",
]


# ---------------------------------------------------------------------------
# small host-side quaternion helpers (f64; core.quaternion is the tensor path)
# ---------------------------------------------------------------------------


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z] (Shepperd's method)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Spherical interpolation between unit quaternions (shortest arc)."""
    d = float(np.dot(q0, q1))
    if d < 0:  # take the short way around
        q1, d = -q1, -d
    if d > 1.0 - 1e-9:  # nearly parallel: lerp is exact enough and stable
        q = q0 + u * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1 - u) * theta) * q0 + np.sin(u * theta) * q1) / s


def _rot_angle_deg(R: np.ndarray) -> float:
    """Geodesic rotation angle of R, degrees."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


# ---------------------------------------------------------------------------
# association / interpolation
# ---------------------------------------------------------------------------


def interpolate_poses(
    gt_ts: np.ndarray, gt_poses: np.ndarray, query_ts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Interpolate groundtruth poses at `query_ts`.

    Positions interpolate linearly, rotations slerp between the bracketing
    samples. Returns (poses (M, 4, 4), mask (len(query_ts),) of queries that
    fell inside the groundtruth time span).
    """
    gt_ts = np.asarray(gt_ts, np.int64)
    query_ts = np.asarray(query_ts, np.int64)
    order = np.argsort(gt_ts)
    gt_ts, gt_poses = gt_ts[order], np.asarray(gt_poses, np.float64)[order]
    mask = (query_ts >= gt_ts[0]) & (query_ts <= gt_ts[-1])
    quats = np.stack([_mat_to_quat(T[:3, :3]) for T in gt_poses])

    out = []
    for t in query_ts[mask]:
        j = int(np.searchsorted(gt_ts, t, side="right"))
        j = min(max(j, 1), len(gt_ts) - 1)
        i = j - 1
        span = float(gt_ts[j] - gt_ts[i])
        u = 0.0 if span == 0 else float(t - gt_ts[i]) / span
        T = np.eye(4)
        T[:3, 3] = (1 - u) * gt_poses[i, :3, 3] + u * gt_poses[j, :3, 3]
        T[:3, :3] = _quat_to_mat(_slerp(quats[i], quats[j], u))
        out.append(T)
    poses = np.stack(out) if out else np.zeros((0, 4, 4))
    return poses, mask


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------


def align_umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Closed-form (s, R, t) minimizing ||dst - (s * R @ src + t)||^2.

    Umeyama (TPAMI 1991). `src`/`dst` are (N, 3). With `with_scale=False`
    this is the Horn SE3 fit the TUM ATE uses for stereo/VIO estimates.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(f"expected matching (N, 3) point sets, got {src.shape} vs {dst.shape}")
    if src.shape[0] < 3:
        raise ValueError("need >= 3 point pairs to align")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        sgn[2, 2] = -1.0
    R = U @ sgn @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(S) @ sgn) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    max: float
    n: int
    scale: float  # Umeyama scale (1.0 unless align="sim3")

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"ATE rmse {self.rmse:.4f} m  mean {self.mean:.4f}  "
            f"median {self.median:.4f}  max {self.max:.4f}  (n={self.n})"
        )


@dataclass
class RpeResult:
    trans_rmse: float   # meters per delta
    trans_mean: float
    rot_rmse_deg: float  # degrees per delta
    rot_mean_deg: float
    delta_s: float
    n: int

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"RPE@{self.delta_s:g}s trans rmse {self.trans_rmse:.4f} m  "
            f"rot rmse {self.rot_rmse_deg:.4f} deg  (n={self.n})"
        )


def absolute_trajectory_error(
    est_ts: np.ndarray,
    est_poses: np.ndarray,
    gt_ts: np.ndarray,
    gt_poses: np.ndarray,
    align: str = "se3",
) -> AteResult:
    """ATE over the overlapping time span. `align`: "se3", "sim3", "none"."""
    gt_at_est, mask = interpolate_poses(gt_ts, gt_poses, est_ts)
    est = np.asarray(est_poses, np.float64)[mask]
    if est.shape[0] < 2:
        raise ValueError("trajectories do not overlap in time")
    p_est, p_gt = est[:, :3, 3], gt_at_est[:, :3, 3]
    if align == "none":
        s = 1.0
        p_al = p_est
    elif align in ("se3", "sim3"):
        if est.shape[0] < 3:
            raise ValueError("need >= 3 overlapping samples to align")
        s, R, t = align_umeyama(p_est, p_gt, with_scale=(align == "sim3"))
        p_al = (s * (R @ p_est.T)).T + t
    else:
        raise ValueError(f"unknown align mode {align!r}")
    err = np.linalg.norm(p_al - p_gt, axis=1)
    return AteResult(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        n=int(err.size),
        scale=float(s),
    )


def relative_pose_error(
    est_ts: np.ndarray,
    est_poses: np.ndarray,
    gt_ts: np.ndarray,
    gt_poses: np.ndarray,
    delta_s: float = 1.0,
    tol_frac: float = 0.25,
) -> RpeResult:
    """Drift over fixed time deltas: for every estimate sample i, pair it
    with the sample *closest* to delta_s later (within `tol_frac * delta_s`
    — closest-match pairing, like the TUM rpe tool) and compare est motion
    i->j against gt motion."""
    est_ts = np.asarray(est_ts, np.int64)
    gt_at_est, mask = interpolate_poses(gt_ts, gt_poses, est_ts)
    ts = est_ts[mask]
    est = np.asarray(est_poses, np.float64)[mask]
    if est.shape[0] < 2:
        raise ValueError("trajectories do not overlap in time")
    delta_ns = int(delta_s * 1e9)
    tol_ns = int(tol_frac * delta_ns)
    terrs, rerrs = [], []
    for i in range(len(ts)):
        target = ts[i] + delta_ns
        j = int(np.searchsorted(ts, target, side="left"))
        if j >= len(ts):
            # The closest candidate is the LAST sample (earlier than the
            # target) — still a valid pair if within tolerance; `break`
            # would drop every trailing pair on short/sparse trajectories.
            j = len(ts) - 1
        elif j > i + 1 and abs(int(ts[j - 1]) - target) < abs(int(ts[j]) - target):
            j -= 1  # the earlier bracket is closer to the requested delta
        if j <= i:
            continue
        if abs(int(ts[j]) - target) > tol_ns:
            continue
        de = np.linalg.solve(est[i], est[j])       # est motion i->j
        dg = np.linalg.solve(gt_at_est[i], gt_at_est[j])
        e = np.linalg.solve(dg, de)                # residual motion
        terrs.append(np.linalg.norm(e[:3, 3]))
        rerrs.append(_rot_angle_deg(e[:3, :3]))
    if not terrs:
        raise ValueError(f"no sample pairs {delta_s} s apart")
    terrs_a, rerrs_a = np.asarray(terrs), np.asarray(rerrs)
    return RpeResult(
        trans_rmse=float(np.sqrt((terrs_a**2).mean())),
        trans_mean=float(terrs_a.mean()),
        rot_rmse_deg=float(np.sqrt((rerrs_a**2).mean())),
        rot_mean_deg=float(rerrs_a.mean()),
        delta_s=float(delta_s),
        n=int(terrs_a.size),
    )


# ---------------------------------------------------------------------------
# conveniences over the dataset layer's types
# ---------------------------------------------------------------------------


def poses_from_groundtruth(items: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """(timestamps, (N,4,4) poses) from a list of GroundtruthPose records
    (core.measurements.GroundtruthPose: .timestamp ns, .world_T_body)."""
    ts = np.asarray([g.timestamp for g in items], np.int64)
    poses = np.stack([np.asarray(g.world_T_body, np.float64) for g in items])
    return ts, poses


def _result_dict(
    est_ts: np.ndarray,
    est_poses: np.ndarray,
    gt_ts: np.ndarray,
    gt_poses: np.ndarray,
    align: str,
    rpe_deltas_s: List[float],
) -> dict:
    """The shared JSON-friendly result schema (library API + CLI)."""
    ate = absolute_trajectory_error(est_ts, est_poses, gt_ts, gt_poses, align=align)
    out = {
        "ate_rmse_m": ate.rmse,
        "ate_mean_m": ate.mean,
        "ate_median_m": ate.median,
        "ate_max_m": ate.max,
        "ate_n": ate.n,
        "align": align,
        "scale": ate.scale,
        "rpe": {},
    }
    for d in rpe_deltas_s:
        try:
            r = relative_pose_error(est_ts, est_poses, gt_ts, gt_poses, delta_s=d)
        except ValueError:
            continue
        out["rpe"][f"{d:g}s"] = {
            "trans_rmse_m": r.trans_rmse,
            "rot_rmse_deg": r.rot_rmse_deg,
            "n": r.n,
        }
    return out


def evaluate_trajectory(
    est_ts: np.ndarray,
    est_poses: np.ndarray,
    gt: Sequence,
    align: str = "se3",
    rpe_deltas_s: Optional[List[float]] = None,
) -> dict:
    """One-call evaluation against a GroundtruthPose list. Returns a plain
    dict (JSON-friendly) with the ATE and one RPE entry per delta."""
    gt_ts, gt_poses = poses_from_groundtruth(gt)
    return _result_dict(
        est_ts, est_poses, gt_ts, gt_poses, align, rpe_deltas_s or [1.0]
    )


def _load_tum_or_euroc_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a trajectory file. Three layouts are recognized:

    - TUM: ``sec tx ty tz qx qy qz qw`` (qx-first, qw-LAST);
    - real EuRoC groundtruth (``state_groundtruth_estimate0/data.csv``):
      ``ns, px py pz, qw qx qy qz, v, bw, ba`` — position-first, qw-FIRST,
      >8 columns (detected by width or the ``p_RS``/``q_RS`` header);
    - this repo's imu0_poses state CSV (datasets/euroc.py):
      ``ns, qw qx qy qz, tx ty tz``.

    A fractional timestamp means TUM float seconds. Integer TUM stamps are
    still SECONDS per the format spec and are scaled, unless their magnitude
    (>= 1e12) already implies nanoseconds. For integer 8-column files the
    quaternion-norm column test picks TUM vs imu0_poses (timestamp magnitude
    is NOT a safe signal — synthetic missions start near t=0)."""
    rows, widths, frac_ts, header_gt = [], [], False, False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if "p_RS" in line or "q_RS" in line:
                    header_gt = True  # the EuRoC groundtruth header names
                continue
            parts = [p for p in line.replace(",", " ").split() if p]
            if len(parts) < 8:
                continue
            frac_ts = frac_ts or ("." in parts[0])
            widths.append(len(parts))
            rows.append([float(v) for v in parts[:8]])
    if not rows:
        raise ValueError(f"no poses parsed from {path}")
    mat = np.asarray(rows, np.float64)
    if header_gt or (not frac_ts and min(widths) > 8):
        layout = "euroc_gt"
    elif frac_ts:
        layout = "tum"
    else:  # integer 8-column: quat-norm column decides
        err_pose = np.abs(np.linalg.norm(mat[:, 1:5], axis=1) - 1.0).mean()
        err_48 = np.abs(np.linalg.norm(mat[:, 4:8], axis=1) - 1.0).mean()
        layout = "tum" if err_48 < err_pose else "imu0_poses"
    ts, poses = [], []
    for vals in mat:
        if layout == "tum":
            if frac_ts or vals[0] < 1e12:  # TUM stamps are seconds
                t = int(round(vals[0] * 1e9))
            else:  # already nanoseconds (nonstandard but unambiguous)
                t = int(vals[0])
            tx, ty, tz = vals[1:4]
            qx, qy, qz, qw = vals[4:8]
        elif layout == "euroc_gt":
            t = int(vals[0])
            tx, ty, tz = vals[1:4]
            qw, qx, qy, qz = vals[4:8]
        else:  # imu0_poses
            t = int(vals[0])
            qw, qx, qy, qz = vals[1:5]
            tx, ty, tz = vals[5:8]
        T = np.eye(4)
        T[:3, :3] = _quat_to_mat(np.array([qw, qx, qy, qz]))
        T[:3, 3] = [tx, ty, tz]
        ts.append(t)
        poses.append(T)
    return np.asarray(ts, np.int64), np.stack(poses)


def main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover - CLI
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--est", required=True, help="estimated trajectory CSV (EuRoC or TUM format)")
    ap.add_argument("--gt", required=True, help="groundtruth trajectory CSV")
    ap.add_argument("--align", default="se3", choices=["se3", "sim3", "none"])
    ap.add_argument("--rpe-deltas", default="1.0", help="comma-separated seconds")
    args = ap.parse_args(argv)

    est_ts, est_poses = _load_tum_or_euroc_csv(args.est)
    gt_ts, gt_poses = _load_tum_or_euroc_csv(args.gt)
    deltas = [float(x) for x in args.rpe_deltas.split(",") if x]
    print(json.dumps(
        _result_dict(est_ts, est_poses, gt_ts, gt_poses, args.align, deltas)
    ))


if __name__ == "__main__":  # pragma: no cover
    main()
