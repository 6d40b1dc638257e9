"""The port's VIO modules against the JAX package on the CPU: SE(3) and
quaternion math, IMU preintegration, the EKF, LM odometry, the smoother's
solve and slide, and the converters that carry the state across.

Inputs come from numpy seeds and go through the JAX function and its port.
Tolerances: float64 paths to 1e-9 (measured to ~1e-13 and below), the
float32 odometry to 1e-4 (its pose to ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.core import quaternion as jq
from ocean_perception_tpu.core import se3 as jse3
from ocean_perception_tpu.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu.vio import ekf as jekf
from ocean_perception_tpu.vio import imu_preintegration as jimu
from ocean_perception_tpu.vio import odometry as jodo
from ocean_perception_tpu.vio import smoother as jsm
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.core import quaternion as tq
from ocean_perception_tpu_torch.core import se3 as tse3
from ocean_perception_tpu_torch.vio import ekf as tekf
from ocean_perception_tpu_torch.vio import imu_preintegration as timu
from ocean_perception_tpu_torch.vio import odometry as todo
from ocean_perception_tpu_torch.vio import smoother as tsm
from test_smoother import G_UNIT, GRAVITY, N_IMU, build_window, simulate


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

F64 = 1e-9


def t64(x):
    return torch.as_tensor(np.array(x, np.float64))


def close(a, b, atol=F64, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


def rotvecs(seed=0):
    """Rotation vectors across the branches: generic, θ -> 0 and θ -> π."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    thetas = [0.0, 1e-9, 1e-5, 0.7, 2.5, np.pi - 1e-7, np.pi]
    return np.concatenate([np.outer(thetas, axes[0]), rng.normal(0, 1.0, (5, 3)),
                           axes[1:4] * (np.pi - 1e-4)])


# -- core math ---------------------------------------------------------------


def test_so3_round_trips_match_jax():
    w = rotvecs()
    R_j = np.asarray(jax.vmap(jse3.so3_exp)(jnp.asarray(w)))
    R_t = tse3.so3_exp(t64(w))
    close(R_t, R_j, 1e-12)
    log_j = np.asarray(jax.vmap(jse3.so3_log)(jnp.asarray(R_j)))
    log_t = tse3.so3_log(t64(R_j))
    close(log_t, log_j, 1e-9)
    # Round trip up to the antipodal ambiguity at θ = π.
    close(tse3.so3_exp(log_t), R_j, 1e-6)


def test_se3_round_trips_match_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 1, (12, 3)), rotvecs()[:12]], axis=1)
    T_j = np.asarray(jax.vmap(jse3.se3_exp)(jnp.asarray(x)))
    T_t = tse3.se3_exp(t64(x))
    close(T_t, T_j, 1e-12)
    close(tse3.se3_inverse(T_t), jax.vmap(jse3.se3_inverse)(jnp.asarray(T_j)), 1e-12)
    gen = slice(0, 10)  # se3_log away from θ = π (its V is singular there)
    close(tse3.se3_log(T_t[gen]), jax.vmap(jse3.se3_log)(jnp.asarray(T_j[gen])), 1e-8)
    close(tse3.se3_transform(T_t, t64(x[:, :3])),
          jax.vmap(jse3.se3_transform)(jnp.asarray(T_j), jnp.asarray(x[:, :3])), 1e-12)
    axis, unit = tse3.gravity_axis([0.0, 9.81, 0.0])
    axis_j, unit_j = jse3.gravity_axis([0.0, 9.81, 0.0])
    assert axis == axis_j
    close(unit, unit_j, 0.0)


def test_quaternion_round_trips_match_jax():
    w = rotvecs(2)
    q_j = np.asarray(jax.vmap(jq.quat_exp)(jnp.asarray(w)))
    q_t = tq.quat_exp(t64(w))
    close(q_t, q_j, 1e-12)
    close(tq.quat_log(q_t), jax.vmap(jq.quat_log)(jnp.asarray(q_j)), 1e-9)
    R_j = np.asarray(jax.vmap(jq.quat_to_matrix)(jnp.asarray(q_j)))
    close(tq.quat_to_matrix(q_t), R_j, 1e-12)
    close(tq.matrix_to_quat(t64(R_j)), jax.vmap(jq.matrix_to_quat)(jnp.asarray(R_j)), 1e-9)
    rng = np.random.default_rng(3)
    v = rng.normal(size=(len(w), 3))
    close(tq.quat_rotate(q_t, t64(v)), jax.vmap(jq.quat_rotate)(jnp.asarray(q_j), jnp.asarray(v)),
          1e-12)
    close(tq.quat_mul(q_t, q_t.flip(0)),
          jax.vmap(jq.quat_mul)(jnp.asarray(q_j), jnp.asarray(q_j[::-1])), 1e-12)
    close(tq.quat_conj(q_t), jax.vmap(jq.quat_conj)(jnp.asarray(q_j)), 1e-15)


def test_residual_jacobian_finite_at_theta_pi():
    """jacfwd of a window whose masked pair sits at θ = π: a down-looking rig
    (R = diag(1, -1, -1)) against the empty slots' identity. The masked-row
    substitutions keep every entry finite, and the Jacobian equals JAX's."""
    cfg = jsm.SmootherConfig(window=8, iterations=2)
    states, imu_windows = simulate(yaw_rate=0.0, vel=np.array([0.1, 0.0, 0.0]))
    flip = np.diag([1.0, -1.0, -1.0])
    states = [(Rk @ flip, pk, vk) for Rk, pk, vk in states]
    win_j = build_window(states, imu_windows, cfg, with_imu=False)
    pims_j = jsm.preintegrate_window(win_j)
    M = cfg.window

    def res_j(d):
        return jsm._residuals(d.reshape(M, 15), win_j, pims_j, jnp.asarray(GRAVITY),
                              jnp.asarray(G_UNIT), cfg)

    J_j = np.asarray(jax.jit(jax.jacfwd(res_j))(jnp.zeros(M * 15)))
    win_t = convert.keypose_window_from_jax(win_j)
    pims_t = convert.preintegrated_imu_from_jax(pims_j)
    J_t, r_t = tsm._linearize(win_t, pims_t, t64(GRAVITY), t64(G_UNIT),
                              convert.smoother_config_from_jax(cfg))
    assert torch.isfinite(J_t).all() and np.isfinite(J_j).all()
    close(J_t, J_j, 1e-8)
    close(r_t, res_j(jnp.zeros(M * 15)), 1e-9)


def test_factors_match_jax():
    from ocean_perception_tpu.vio import factors as jf
    from ocean_perception_tpu_torch.vio import factors as tf

    rng = np.random.default_rng(13)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.5, 3))))
    meas, field, bias, p = (rng.normal(size=3) for _ in range(4))
    close(tf.mag_residual(t64(R), t64(meas), t64(field), 50.0, t64(bias)),
          jf.mag_residual(jnp.asarray(R), jnp.asarray(meas), jnp.asarray(field), 50.0,
                          jnp.asarray(bias)), 1e-12)
    close(tf.single_axis_residual(t64(p), t64([0.0, 1.0, 0.0]), t64(0.3)),
          jf.single_axis_residual(jnp.asarray(p), jnp.asarray([0.0, 1.0, 0.0]), 0.3), 1e-15)
    g = np.array([0.0, 9.81, 0.0])
    for accel in (R.T @ -g + rng.normal(0, 0.1, 3), -g):  # tilted, and level (axis = 0)
        close(tf.estimate_attitude(t64(accel), t64(g)),
              jf.estimate_attitude(jnp.asarray(accel), jnp.asarray(g)), 1e-12)


# -- IMU preintegration ------------------------------------------------------


def imu_samples(seed, n=48, n_valid=40):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 7))
    rows[:, 0] = 0.005 + rng.uniform(0, 0.002, n)
    rows[:, 1:4] = rng.normal(0, 0.3, (n, 3))
    rows[:, 4:7] = rng.normal(0, 1.0, (n, 3)) + np.array([0, 0, 9.81])
    return rows, np.arange(n) < n_valid


@pytest.mark.parametrize("calib", [
    jimu.ImuCalibration(),
    jimu.ImuCalibration(body_R_imu=tuple(np.asarray(jse3.so3_exp(
        jnp.asarray([0.1, -0.2, 0.3]))).reshape(-1).tolist()), body_t_imu=(0.05, -0.02, 0.1)),
], ids=["identity", "extrinsic"])
def test_preintegrate_masked_tail(calib):
    rows, mask = imu_samples(4)
    bg, ba = np.array([0.01, -0.02, 0.005]), np.array([0.03, 0.01, -0.02])
    pim_j = jax.jit(lambda s, m, g, a: jimu.preintegrate(s, m, g, a, calib))(
        jnp.asarray(rows), jnp.asarray(mask), jnp.asarray(bg), jnp.asarray(ba))
    c = convert.imu_calibration_from_jax(calib)
    pim_t = timu.preintegrate(t64(rows), torch.as_tensor(mask), t64(bg), t64(ba), c)
    for name in jimu.PreintegratedImu._fields:
        close(getattr(pim_t, name), getattr(pim_j, name), 1e-12)
    # The loop may stop after the last valid sample: the rest are no-ops.
    pim_s = timu.preintegrate(t64(rows), torch.as_tensor(mask), t64(bg), t64(ba), c, n_steps=40)
    for a, b in zip(pim_s, pim_t):
        assert torch.equal(a, b)
    # A batch of windows (the smoother's slots) equals each window alone.
    rows2, mask2 = imu_samples(5, n_valid=17)
    batch = timu.preintegrate(t64(np.stack([rows, rows2])), torch.as_tensor(np.stack([mask, mask2])),
                              t64(np.stack([bg, ba])), t64(np.stack([ba, bg])), c)
    one = timu.preintegrate(t64(rows2), torch.as_tensor(mask2), t64(ba), t64(bg), c)
    for a, b in zip(batch, one):
        close(a[1], b, 1e-14)

    # The factor residual and the prediction at a perturbed state.
    rng = np.random.default_rng(6)
    Ri, Rj = (np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3)))) for _ in range(2))
    pi, vi, pj, vj = (rng.normal(size=3) for _ in range(4))
    g = np.array([0, 0, -9.81])
    r_j = jimu.imu_factor_residual(*(jnp.asarray(x) for x in (Ri, pi, vi, Rj, pj, vj, bg * 2, ba)),
                                   pim_j, jnp.asarray(g))
    r_t = timu.imu_factor_residual(*(t64(x) for x in (Ri, pi, vi, Rj, pj, vj, bg * 2, ba)),
                                   pim_t, t64(g))
    close(r_t, r_j, 1e-10)
    for a, b in zip(timu.predict_state(t64(Ri), t64(pi), t64(vi), pim_t, t64(g)),
                    jimu.predict_state(jnp.asarray(Ri), jnp.asarray(pi), jnp.asarray(vi), pim_j,
                                       jnp.asarray(g))):
        close(a, b, 1e-12)


# -- EKF ---------------------------------------------------------------------


def ekf_pair(seed=7):
    rng = np.random.default_rng(seed)
    q = np.asarray(jq.quat_exp(jnp.asarray(rng.normal(0, 0.5, 3))))
    A = rng.normal(0, 0.05, (15, 15))
    st_j = jekf.EkfState(t=jnp.asarray(rng.normal(size=3)), v=jnp.asarray(rng.normal(size=3)),
                         a=jnp.asarray(rng.normal(0, 0.1, 3)), q=jnp.asarray(q),
                         w=jnp.asarray(rng.normal(0, 0.1, 3)),
                         S=jnp.asarray(A @ A.T + 0.01 * np.eye(15)))
    return st_j, convert.ekf_state_from_jax(st_j)


def close_state(a, b, atol=1e-10):
    for name in jekf.EkfState._fields:
        close(getattr(a, name), getattr(b, name), atol)


def test_ekf_steps_match_jax():
    params = jekf.EkfParams(range_gate_sigmas=5.0)
    tp = convert.ekf_params_from_jax(params)
    st_j, st_t = ekf_pair()
    g = np.array([0.0, 9.81, 0.0])
    rng = np.random.default_rng(8)
    w_m, a_m = rng.normal(0, 0.1, 3), rng.normal(0, 0.2, 3) - g
    q_bi = np.asarray(jq.quat_exp(jnp.asarray([0.02, -0.01, 0.03])))

    close_state(tekf.ekf_predict(st_t, 0.005, tp), jekf.ekf_predict(st_j, 0.005, params))
    for q in (None, q_bi):
        close_state(
            tekf.ekf_update_imu(st_t, t64(w_m), t64(a_m), t64(g), tp,
                                None if q is None else t64(q)),
            jekf.ekf_update_imu(st_j, jnp.asarray(w_m), jnp.asarray(a_m), jnp.asarray(g), params,
                                None if q is None else jnp.asarray(q)))
    gu = np.array([0.0, 1.0, 0.0])
    close_state(tekf.ekf_update_depth(st_t, 1.7, t64(gu), tp),
                jekf.ekf_update_depth(st_j, 1.7, jnp.asarray(gu), params))
    beacon = np.array([5.0, -2.0, 3.0])
    arm = np.array([0.1, 0.0, -0.2])
    dist = float(np.linalg.norm(beacon - np.asarray(st_j.t)))
    for rng_meas in (dist + 0.3, dist + 40.0):  # accepted, and gated out
        for lever in (None, arm):
            close_state(
                tekf.ekf_update_range(st_t, rng_meas, t64(beacon), tp,
                                      None if lever is None else t64(lever)),
                jekf.ekf_update_range(st_j, rng_meas, jnp.asarray(beacon), params,
                                      None if lever is None else jnp.asarray(lever)))
    q_meas = np.asarray(jq.quat_exp(jnp.asarray([0.05, 0.3, -0.1])))
    t_meas = np.array([0.5, -0.2, 0.1])
    cov = np.eye(6) * 1e-3
    close_state(tekf.ekf_update_pose(st_t, t64(t_meas), t64(q_meas), t64(cov)),
                jekf.ekf_update_pose(st_j, jnp.asarray(t_meas), jnp.asarray(q_meas),
                                     jnp.asarray(cov), ))
    s0_j = jekf.ekf_initialize(t0=np.array([1.0, 2, 3]), q0=q_meas, dtype=jnp.float64)
    s0_t = tekf.ekf_initialize(t0=np.array([1.0, 2, 3]), q0=q_meas, dtype=torch.float64)
    close_state(s0_t, s0_j, 0.0)


def test_ekf_replay_matches_jax():
    """The replay loop over the real samples equals JAX's padded scan, and
    a masked replay keeps the masked samples as no-ops."""
    params = jekf.EkfParams()
    tp = convert.ekf_params_from_jax(params)
    st_j, st_t = ekf_pair(9)
    rng = np.random.default_rng(10)
    n, cap = 11, 16
    g = np.array([0.0, 0.0, -9.81])
    dts = np.full(cap, 0.005)
    dts[3] = -0.001  # clamped to 0
    gyr = rng.normal(0, 0.1, (cap, 3))
    acc = rng.normal(0, 0.2, (cap, 3)) - g
    mask = np.arange(cap) < n
    out_j = jax.jit(lambda s, d, gy, ac, m: jekf.ekf_replay_imu(
        s, d, gy, ac, m, jnp.asarray(g), params))(
        st_j, jnp.asarray(dts), jnp.asarray(gyr), jnp.asarray(acc), jnp.asarray(mask))
    out_t = tekf.ekf_replay_imu(st_t, t64(dts[:n]), t64(gyr[:n]), t64(acc[:n]), None, t64(g), tp)
    close_state(out_t, out_j, 1e-10)
    masked = tekf.ekf_replay_imu(st_t, t64(dts), t64(gyr), t64(acc), torch.as_tensor(mask),
                                 t64(g), tp)
    for a, b in zip(masked, out_t):
        assert torch.equal(a, b)


# -- odometry ----------------------------------------------------------------


def odometry_case(seed, n=60, noise=0.3, outliers=0):
    cam = PinholeCamera.create(300.0, 300.0, 320.0, 240.0, 480, 640)
    rig = StereoCamera.create(cam, cam, baseline=0.2)
    rng = np.random.default_rng(seed)
    T_true = np.asarray(jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01])))
    P0 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 8, n)], -1)
    P1 = P0 @ T_true[:3, :3].T + T_true[:3, 3]
    p_obs = 300.0 * P1[:, :2] / P1[:, 2:3] + np.array([320.0, 240.0]) + rng.normal(0, noise, (n, 2))
    p_obs[:outliers] += rng.uniform(30, 80, (outliers, 2))
    mask = np.ones(n, bool)
    mask[-5:] = False
    return rig, P0.astype(np.float32), p_obs.astype(np.float32), mask


@pytest.mark.parametrize("outliers", [0, 12])
def test_optimize_odometry_f32_matches_jax(outliers):
    rig, P0, p_obs, mask = odometry_case(11 + outliers, outliers=outliers)
    sig = np.ones(len(P0), np.float32)
    params = jodo.OdometryParams()
    with jax.enable_x64(False):
        res_j = jax.jit(lambda a, b, c, d: jodo.optimize_odometry(a, b, c, d, rig, params=params))(
            jnp.asarray(P0), jnp.asarray(p_obs), jnp.asarray(sig), jnp.asarray(mask))
        res_j = jax.tree.map(np.asarray, res_j)
    trig = convert.stereo_camera_from_jax(rig)
    res_t = todo.optimize_odometry(torch.as_tensor(P0), torch.as_tensor(p_obs),
                                   torch.as_tensor(sig), torch.as_tensor(mask), trig,
                                   params=convert.odometry_params_from_jax(params))
    assert res_t.T_10.dtype == torch.float32
    close(res_t.T_10, res_j.T_10, 1e-4)
    close(res_t.error, res_j.error, 1e-4)
    np.testing.assert_allclose(res_t.covariance.numpy(), res_j.covariance, rtol=1e-3,
                               atol=1e-4 * np.abs(res_j.covariance).max())
    assert int(res_t.n_inliers) == int(res_j.n_inliers)
    assert bool(res_t.success) == bool(res_j.success)


# -- smoother ----------------------------------------------------------------

LMK_CFG = dict(max_landmarks=6, cam_fx=200.0, cam_fy=200.0, cam_cx=80.0, cam_cy=60.0)


def smoother_case(landmarks: bool):
    cfg = jsm.SmootherConfig(window=6, iterations=4, **(LMK_CFG if landmarks else {}))
    states, imu_windows = simulate(M_used=5)
    win = build_window(states, imu_windows, cfg, state_noise=0.03, vo_noise=0.01, seed=3)
    if landmarks:
        rng = np.random.default_rng(12)
        pts = rng.uniform([-1, -1, 2.0], [1, 1, 5.0], size=(5, 3))
        M, L = cfg.window, cfg.max_landmarks
        uv, disp, vmask = np.zeros((M, L, 2)), np.zeros((M, L)), np.zeros((M, L), bool)
        for k, (Rk, pk, _) in enumerate(states):
            cam = (pts - pk) @ np.asarray(Rk)
            uv[k, :5] = 200.0 * cam[:, :2] / cam[:, 2:3] + np.array([80.0, 60.0])
            disp[k, :5] = np.where(np.arange(5) < 3, 200.0 * cfg.cam_baseline / cam[:, 2], 0.0)
            vmask[k, :5] = cam[:, 2] > 0.5
        uv += rng.normal(0, 0.5, uv.shape)
        win = win._replace(lmk_uv=jnp.asarray(uv), lmk_disp=jnp.asarray(disp),
                           lmk_valid=jnp.asarray(vmask))
    return cfg, win


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "landmarks"])
def solved(request):
    """One JAX solve of the window (M=6, 4 iterations) and the port's."""
    cfg, win_j = smoother_case(request.param)
    pims_j = jsm.preintegrate_window(win_j)
    w_j, res_j = jax.jit(lambda w, pm: jsm.solve_window(
        w, pm, jnp.asarray(GRAVITY), jnp.asarray(G_UNIT), cfg, jnp.asarray(4, jnp.int32)))(
        win_j, pims_j)
    win_t = convert.keypose_window_from_jax(win_j)
    pims_t = tsm.preintegrate_window(win_t, None)
    w_t, res_t = tsm.solve_window(win_t, pims_t, t64(GRAVITY), t64(G_UNIT),
                                  convert.smoother_config_from_jax(cfg), 4)
    return dict(cfg=cfg, win_j=win_j, pims_j=pims_j, w_j=w_j, res_j=res_j, win_t=win_t,
                pims_t=pims_t, w_t=w_t, res_t=res_t)


def test_preintegrate_window_matches_jax(solved):
    for name in jimu.PreintegratedImu._fields:
        close(getattr(solved["pims_t"], name), getattr(solved["pims_j"], name), 1e-12)


def test_solve_window_matches_jax(solved):
    w_t, w_j, res_t, res_j = solved["w_t"], solved["w_j"], solved["res_t"], solved["res_j"]
    for name in ("R", "p", "v", "bg", "ba"):
        close(getattr(w_t, name), getattr(w_j, name), 1e-8)
    for name in jsm.SmootherResult._fields:
        scale = max(1.0, float(np.abs(np.asarray(getattr(res_j, name))).max()))
        close(getattr(res_t, name), getattr(res_j, name), 1e-8 * scale)
    # Untouched fields pass through.
    assert torch.equal(w_t.imu_samples, solved["win_t"].imu_samples)


def test_slide_window_matches_jax(solved):
    cov_j = solved["res_j"].cov_slot1
    slid_j = jsm.slide_window(solved["w_j"], cov_j)
    slid_t = tsm.slide_window(solved["w_t"], solved["res_t"].cov_slot1)
    for name in jsm.KeyposeWindow._fields:
        a, b = getattr(slid_t, name), getattr(slid_j, name)
        if a.dtype == torch.bool:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
        else:
            scale = max(1.0, float(np.abs(np.asarray(b)).max()))
            close(a, b, 1e-8 * scale)


def test_smoother_float32_port():
    """The QR-based damped GN recovers the trajectory in float32 on the port
    too (the JAX package's tests/test_smoother.py::test_smoother_float32)."""
    cfg = jsm.SmootherConfig(window=8, iterations=8)
    states, imu_windows = simulate()
    win = convert.keypose_window_from_jax(
        build_window(states, imu_windows, cfg, state_noise=0.05), dtype=torch.float32)
    pims = tsm.preintegrate_window(win)
    w, result = tsm.solve_window(win, pims, torch.tensor(GRAVITY, dtype=torch.float32),
                                 torch.tensor(G_UNIT, dtype=torch.float32),
                                 convert.smoother_config_from_jax(cfg), 5)
    assert w.p.dtype == torch.float32
    for k, (Rk, pk, vk) in enumerate(states):
        close(w.p[k], pk, 5e-2)
        close(w.v[k], vk, 8e-2)
        close(w.R[k], Rk, 3e-2)
    cov = result.cov_newest.double().numpy()
    assert np.isfinite(cov).all()
    assert np.linalg.eigvalsh(0.5 * (cov + cov.T)).min() > 0


def test_window_converter_keeps_fields():
    cfg = jsm.SmootherConfig(window=4, max_landmarks=3)
    win_j = jsm.make_window(cfg, N_IMU)
    win_t = convert.keypose_window_from_jax(win_j)
    empty = tsm.make_window(convert.smoother_config_from_jax(cfg), N_IMU)
    for name in jsm.KeyposeWindow._fields:
        a, b = getattr(win_t, name), getattr(empty, name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), name
