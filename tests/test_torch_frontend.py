"""The PyTorch port's full_frontend_step against the JAX reference on the CPU:
camera -> disparity -> tracked features -> landmark-graph clusters, over a
short sequence with known motion.

The scene is a box-smoothed random canvas (the chip smoke test's recipe) at
64x96: frame i shows canvas(y, x + 16 + 2i) on the left and the same moved
8 px more on the right, so features move -2 px a frame and every stereo
disparity is 8 px. Both sides start from one created state (with the
pyramid ring) and one landmark graph, and run PatchMatch at full resolution
without enhancement, K=32 landmark slots and two pyramid levels. JAX runs
its XLA LK correlation path (the fused kernels' math) with x64 off, as in
production.

Tolerances, and why:
- disparity: within 1e-3 px on >= 99% of pixels (test_torch_perception.py's
  bound: pyr_down and the gradients differ in the last bits).
- tracker: ids, keyframe flags and the alive set equal; pixels within
  1e-3 px where both track (the LK bound of tests/test_torch_lk.py);
  disparities equal (the stripe matcher lands on whole pixels).
- mesher: labels, sizes and graph weights equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.core import cameras as jcam
from ocean_perception_tpu.mesher import landmark_graph as jlg
from ocean_perception_tpu.mesher import object_mesher as jom
from ocean_perception_tpu.models import perception as jmodel
from ocean_perception_tpu.tracking import DetectorParams, LKParams, StripeMatcherParams
from ocean_perception_tpu.tracking.stereo_tracker import StereoTrackerParams, StereoTrackerState
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.mesher import landmark_graph as tlg
from ocean_perception_tpu_torch.mesher.object_mesher import build_meshes
from ocean_perception_tpu_torch.models import perception as tmodel
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import to_grayscale

H, W, K, N = 64, 96, 32, 4


def _frames():
    rng = np.random.default_rng(0)
    canvas = rng.random((H, W + 64)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)
    tint = np.array([0.35, 0.75, 0.9], np.float32)

    def rgb(x0):
        return np.clip(canvas[:, x0:x0 + W, None] * tint + 0.05, 0, 1).astype(np.float32)

    return [(rgb(16 + 2 * i), rgb(24 + 2 * i)) for i in range(N)]


@pytest.fixture(scope="module")
def runs():
    cam = jcam.PinholeCamera.create(80.0, 80.0, W / 2, H / 2, H, W)
    rig = jcam.StereoCamera.create(cam, cam, baseline=0.12)
    cfg = jmodel.PerceptionConfig(engine="patchmatch", max_disp=32, internal_scale=1,
                                  run_enhance=False, chunks=4)
    mp = jom.ObjectMesherDeviceParams(
        tracker=StereoTrackerParams(
            capacity=K, trigger_keyframe_k=3,
            detector=DetectorParams(max_features=K, min_distance=10, border=8),
            lk=LKParams(max_level=1, corr_iters=True, pallas_iters=False, fused_lk=False),
            matcher=StripeMatcherParams(max_disp=24, templ_cols=15, templ_rows=11)),
        neighbor_radius_px=40.0, min_obs_connect_edge=2.0, min_obs_disconnect_edge=2.0)
    frames = _frames()

    ref = []
    with jax.enable_x64(False):
        state = StereoTrackerState.create(mp.tracker, image_shape=(H, W))
        graph = jlg.LandmarkGraph.create(K)
        step = jax.jit(lambda s, g, p, l, r: jmodel.full_frontend_step(s, g, p, l, r, rig, cfg, mp))
        prev = jmodel.to_grayscale(jnp.asarray(frames[0][0]))
        for left, right in frames:
            out, prev = step(state, graph, prev, jnp.asarray(left), jnp.asarray(right))
            state, graph = out.tracker_state, out.graph
            ref.append(jax.tree_util.tree_map(np.asarray, out))

    trig, tcfg = convert.stereo_camera_from_jax(rig), convert.perception_config_from_jax(cfg)
    tmp = convert.object_mesher_device_params_from_jax(mp)
    with jax.enable_x64(False):
        state0 = StereoTrackerState.create(mp.tracker, image_shape=(H, W))
    state = convert.stereo_tracker_state_from_jax(state0)
    graph = tlg.LandmarkGraph.create(K)
    prev = to_grayscale(torch.from_numpy(frames[0][0]))
    ours = []
    cuda.reset_launches()
    for left, right in frames:
        out, prev = tmodel.full_frontend_step(state, graph, prev, torch.from_numpy(left),
                                              torch.from_numpy(right), trig, tcfg, tmp,
                                              device="cpu")
        state, graph = out.tracker_state, out.graph
        ours.append(out)
    return dict(ref=ref, ours=ours, rig=trig, launches=dict(cuda.LAUNCHES))


@pytest.mark.parametrize("i", range(N))
def test_frame_matches_jax(runs, i):
    ref, ours = runs["ref"][i], runs["ours"][i]
    diff = np.abs(ours.perception.disparity.numpy() - ref.perception.disparity)
    assert (diff <= 1e-3).mean() >= 0.99
    np.testing.assert_allclose(ours.perception.depth.numpy(), ref.perception.depth, rtol=1e-5,
                               atol=1e-5)

    jt, tt = ref.tracker_state.table, ours.tracker_state.table
    np.testing.assert_array_equal(tt.ids.numpy(), jt.ids)
    np.testing.assert_array_equal(tt.missed.numpy(), jt.missed)
    np.testing.assert_allclose(tt.pixels.numpy(), jt.pixels, atol=1e-3)
    np.testing.assert_array_equal(tt.disparities.numpy(), jt.disparities)
    assert int(ours.tracker_state.next_lmk_id) == int(ref.tracker_state.next_lmk_id)

    jm, tm = ref.mesher, ours.mesher
    assert bool(tm.is_keyframe) == bool(jm.is_keyframe)
    for name in ("alive", "labels", "sizes", "foreground"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(ours.graph.weights.numpy(), ref.graph.weights)


def test_sequence_tracks_the_known_motion(runs):
    """Landmarks seen in consecutive frames moved -2 px in x, 0 in y, and
    their stereo disparity is 8 px; the last frame holds a cluster that
    meshes."""
    ours = runs["ours"]
    errs = []
    for a, b in zip(ours[:-1], ours[1:]):
        ta, tb = a.tracker_state.table, b.tracker_state.table
        same = (ta.ids >= 0) & (ta.ids == tb.ids) & (tb.missed == 0)
        moved = tb.pixels[same] - ta.pixels[same]
        moved[:, 0] += 2.0 * (ta.missed[same].float() + 1)
        errs.append(moved.abs().max(dim=1).values)
    errs = torch.cat(errs)
    assert len(errs) >= 3 * 20 and float(errs.median()) < 0.01
    last = ours[-1].mesher
    assert float((last.disparities[last.alive] - 8.0).abs().median()) < 0.5
    assert int(last.sizes.max()) >= 3
    assert build_meshes(last, runs["rig"]).num_triangles > 0
    assert set(runs["launches"].values()) == {0}   # the CPU runs the plain twins


def test_mesher_scale_runs_the_mesher_half_downscaled():
    """mesher_scale=2: the tracker runs on pyr_down'ed grays, so its pixels
    and disparities are at half scale (4 px for the 8 px scene); other
    scales are refused."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.mesher.object_mesher import ObjectMesherDeviceParams
    from ocean_perception_tpu_torch.tracking.detector import DetectorParams as TDet
    from ocean_perception_tpu_torch.tracking.lk import LKParams as TLK
    from ocean_perception_tpu_torch.tracking.stereo_tracker import (StereoTrackerParams as TSP,
                                                                    StereoTrackerState as TSS)
    from ocean_perception_tpu_torch.tracking.stripe_match import StripeMatcherParams as TSM

    cam = PinholeCamera.create(80.0, 80.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, 0.12)
    cfg = tmodel.PerceptionConfig(max_disp=32, internal_scale=1, run_enhance=False, chunks=4)
    tracker = TSP(capacity=16, detector=TDet(max_features=16, min_distance=6, border=4),
                  lk=TLK(max_level=1), matcher=TSM(max_disp=12, templ_cols=9, templ_rows=7))
    mp = ObjectMesherDeviceParams(tracker=tracker)
    state, graph = TSS.create(tracker, image_shape=(H // 2, W // 2)), tlg.LandmarkGraph.create(16)
    left, right = (torch.from_numpy(a) for a in _frames()[0])
    prev = None
    for _ in range(2):
        prev = to_grayscale(left)[::2, ::2] if prev is None else prev
        out, prev = tmodel.full_frontend_step(state, graph, prev, left, right, rig, cfg, mp,
                                              mesher_scale=2, device="cpu")
        state, graph = out.tracker_state, out.graph
    assert prev.shape == (H // 2, W // 2) and out.perception.disparity.shape == (H, W)
    assert out.mesher.foreground.shape == (H // 2, W // 2)
    d = out.mesher.disparities[out.mesher.alive]
    assert len(d) >= 6 and float((d - 4.0).abs().median()) < 0.5
    with pytest.raises(ValueError, match="power of two"):
        tmodel.full_frontend_step(state, graph, prev, left, right, rig, cfg, mp, mesher_scale=3,
                                  device="cpu")
