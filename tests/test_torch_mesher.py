"""The PyTorch port's mesher (ocean_perception_tpu_torch.mesher) against the
JAX reference on the CPU.

Inputs are made with numpy from a seed and fed as float32 to both sides;
the JAX side runs with x64 off, as in production (tests/conftest.py turns it
on for the suite, and under x64 ``jnp.linspace`` gives the edge gate float64
sample positions).

Tolerances, and why:
- foreground mask, landmark graph (weights, labels, sizes) and the whole
  mesher_device_step from one tracker state (weights, labels, sizes, alive,
  foreground): equal. The gate's sample positions are bit-exact
  (segment_fractions), and every value it averages is a multiple of 1/256.
- the tracker half of that step: pixels within 1e-3 px (the LK bound of
  tests/test_torch_lk.py).
- build_meshes from the same device output: the same triangles, vertices
  within 1e-6 relative.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.core import cameras as jcam
from ocean_perception_tpu.mesher import foreground as jfg
from ocean_perception_tpu.mesher import landmark_graph as jlg
from ocean_perception_tpu.mesher import object_mesher as jom
from ocean_perception_tpu.ops import image as jimg
from ocean_perception_tpu.tracking import DetectorParams, LKParams, StripeMatcherParams
from ocean_perception_tpu.tracking.stereo_tracker import StereoTrackerParams, StereoTrackerState
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.mesher import foreground as tfg
from ocean_perception_tpu_torch.mesher import landmark_graph as tlg
from ocean_perception_tpu_torch.mesher import object_mesher as tom
from ocean_perception_tpu_torch.ops import image as timg

H, W = 120, 160


def _t(a):
    return torch.from_numpy(np.array(a))


def _textured_box(seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 0.5, np.float32) + rng.normal(0, 0.003, (H, W)).astype(np.float32)
    img[30:80, 50:110] = rng.random((50, 60)).astype(np.float32)
    return img


@pytest.mark.parametrize("ksize", [3, 9])
def test_erode_and_morph_gradient_are_exact(ksize):
    x = np.random.default_rng(1).random((40, 64)).astype(np.float32)
    np.testing.assert_array_equal(timg.erode(_t(x), ksize).numpy(),
                                  np.asarray(jimg.erode(jnp.asarray(x), ksize)))
    np.testing.assert_array_equal(timg.morph_gradient(_t(x), ksize).numpy(),
                                  np.asarray(jimg.morph_gradient(jnp.asarray(x), ksize)))


def test_image_pyramid_matches_jax():
    x = np.random.default_rng(2).random((45, 67)).astype(np.float32)
    ref = jimg.image_pyramid(jnp.asarray(x), 4)
    ours = timg.image_pyramid(_t(x), 4)
    assert [tuple(o.shape) for o in ours] == [r.shape for r in ref]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("image", ["box", "noise"])
def test_foreground_mask_matches_jax(image):
    img = _textured_box() if image == "box" else np.random.default_rng(3).random((H, W)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jfg.estimate_foreground_mask(jnp.asarray(img), ksize=15, min_gradient=20.0))
    ours = tfg.estimate_foreground_mask(_t(img), ksize=15, min_gradient=20.0).numpy()
    np.testing.assert_array_equal(ours, ref)
    if image == "box":
        assert ours[40:70, 60:100].mean() > 0.8 and ours[:20, :30].mean() < 0.1


def _graph_pair(K, seed):
    rng = np.random.default_rng(seed)
    w = np.where(rng.random((K, K)) < 0.15, rng.integers(0, 12, (K, K)), 0).astype(np.float32)
    w = np.triu(w, 1) + np.triu(w, 1).T
    ids = rng.integers(-1, 3 * K, K).astype(np.int32)
    return w, ids, rng


@pytest.mark.parametrize("K", [8, 48])
def test_landmark_graph_matches_jax(K):
    w, ids, rng = _graph_pair(K, K)
    new_ids = np.where(rng.random(K) < 0.2, rng.integers(0, 3 * K, K), ids).astype(np.int32)
    observed = rng.random((K, K)) < 0.6
    observed = observed & observed.T
    pair_valid = rng.random((K, K)) < 0.5
    alive = new_ids >= 0
    jg = jlg.update_graph(jlg.LandmarkGraph(weights=jnp.asarray(w), ids=jnp.asarray(ids)),
                          jnp.asarray(new_ids), jnp.asarray(observed), jnp.asarray(pair_valid), 11.0)
    tg = tlg.update_graph(tlg.LandmarkGraph(weights=_t(w), ids=_t(ids)), _t(new_ids), _t(observed),
                          _t(pair_valid), 11.0)
    np.testing.assert_array_equal(tg.weights.numpy(), np.asarray(jg.weights))
    jl = jlg.get_cluster_labels(jg, jnp.asarray(alive), 7.0)
    tl = tlg.get_cluster_labels(tg, _t(alive), 7.0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tlg.cluster_sizes(tl).numpy(), np.asarray(jlg.cluster_sizes(jl)))


def test_chain_collapses_to_one_label():
    K = 32
    w = np.zeros((K, K), np.float32)
    for i in range(K - 1):
        w[i, i + 1] = w[i + 1, i] = 10.0
    g = tlg.LandmarkGraph(weights=_t(w), ids=torch.arange(K, dtype=torch.int32))
    assert (tlg.get_cluster_labels(g, torch.ones(K, dtype=torch.bool), 7.0) == 0).all()


def _tracker(K):
    return StereoTrackerParams(
        capacity=K,
        detector=DetectorParams(max_features=K, min_distance=6, border=4),
        lk=LKParams(max_level=1, corr_iters=True, pallas_iters=False, fused_lk=False),
        matcher=StripeMatcherParams(max_disp=16, templ_cols=9, templ_rows=7),
    )


@pytest.mark.parametrize("fg_downsample", [4, 1])
def test_mesher_device_step_matches_jax(fg_downsample):
    """One mesher step from an identical tracker state and graph with live
    landmarks spread over the image (borders and corners too), on a scene of
    one textured box: the tracker, the foreground gate, the graph update and
    the clustering (test_edge_gate_onehot_matches_gather's setup)."""
    rng = np.random.default_rng(11)
    left = _textured_box(4)
    left[20:100, 30:140] = cv2.GaussianBlur(rng.random((80, 110)).astype(np.float32), (3, 3), 0.8)
    right = np.ascontiguousarray(np.roll(left, -8, axis=1))   # disparity 8
    prev = np.ascontiguousarray(np.roll(left, 1, axis=1))
    K = 48
    params = jom.ObjectMesherDeviceParams(tracker=_tracker(K), neighbor_radius_px=40.0,
                                          min_obs_connect_edge=2.0, fg_downsample=fg_downsample,
                                          edge_gate_impl="gather")
    pts = np.stack([rng.uniform(0, W - 1, K), rng.uniform(0, H - 1, K)], axis=1).astype(np.float32)
    pts[0], pts[1] = [0.0, 0.0], [W - 1.0, H - 1.0]
    ids = np.arange(K, dtype=np.int32)
    ids[5] = -1
    w, _, _ = _graph_pair(K, 7)
    with jax.enable_x64(False):
        state = StereoTrackerState.create(params.tracker)
        state = state.replace(table=state.table.replace(ids=jnp.asarray(ids), pixels=jnp.asarray(pts)),
                              last_kf_frame=jnp.asarray(0, jnp.int32))
        graph = jlg.LandmarkGraph(weights=jnp.asarray(w), ids=jnp.asarray(ids))
        step = jax.jit(lambda s, g: jom.mesher_device_step(
            s, g, jnp.asarray(prev), jnp.asarray(left), jnp.asarray(right), jnp.float32(100.0),
            params))
        for _ in range(2):   # two frames: the evidence builds up
            state, graph, ref = step(state, graph)
    ts = convert.stereo_tracker_state_from_jax(StereoTrackerState.create(params.tracker).replace(
        table=StereoTrackerState.create(params.tracker).table.replace(
            ids=jnp.asarray(ids), pixels=jnp.asarray(pts)),
        last_kf_frame=jnp.asarray(0, jnp.int32)))
    tg = tlg.LandmarkGraph(weights=_t(w), ids=_t(ids))
    tp = convert.object_mesher_device_params_from_jax(params)
    fxb = torch.tensor(100.0)
    for _ in range(2):
        ts, tg, ours = tom.mesher_device_step(ts, tg, _t(prev), _t(left), _t(right), fxb, tp)

    np.testing.assert_allclose(ours.pixels.numpy(), np.asarray(ref.pixels), atol=1e-3)
    np.testing.assert_array_equal(ours.disparities.numpy(), np.asarray(ref.disparities))
    for name in ("alive", "foreground", "labels", "sizes"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tg.weights.numpy(), np.asarray(graph.weights))
    assert bool(ours.is_keyframe) == bool(ref.is_keyframe)
    assert ours.alive.sum() >= 20 and (ours.sizes >= 2).sum() >= 1

    jrig = jcam.StereoCamera.create(jcam.PinholeCamera.create(200.0, 200.0, W / 2, H / 2, H, W),
                                    jcam.PinholeCamera.create(200.0, 200.0, W / 2, H / 2, H, W), 0.3)
    # Step 5, on the host, from the same device output: the same meshes.
    ref_mesh = jom.build_meshes(ref, jrig, vertex_min_obs=2)
    same = tom.MesherDeviceOutput(*(_t(np.asarray(v)) for v in ref))
    mesh = tom.build_meshes(same, convert.stereo_camera_from_jax(jrig), vertex_min_obs=2)
    assert mesh.num_triangles > 0
    np.testing.assert_array_equal(mesh.triangles, ref_mesh.triangles)
    np.testing.assert_array_equal(mesh.cluster_ids, ref_mesh.cluster_ids)
    np.testing.assert_allclose(mesh.vertices, ref_mesh.vertices, rtol=1e-6)


def test_object_mesher_meshes_a_box():
    """The host ObjectMesher on the CPU (the JAX package's slow end-to-end
    scene): a textured box 12 px in disparity over a flat background gives a
    mesh at the box's depth, fx*b/d = 200*0.3/12 = 5 m."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.tracking.detector import DetectorParams as TDet
    from ocean_perception_tpu_torch.tracking.lk import LKParams as TLK
    from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerParams as TST
    from ocean_perception_tpu_torch.tracking.stripe_match import StripeMatcherParams as TSM

    rng = np.random.default_rng(3)
    bg = np.full((H, W + 20), 0.45, np.float32) + rng.normal(0, 0.004, (H, W + 20)).astype(np.float32)
    tex = cv2.GaussianBlur((rng.random((60, 70)) * 0.8 + 0.1).astype(np.float32), (3, 3), 0.7)
    left, right = bg[:, :W].copy(), bg[:, :W].copy()
    left[30:90, 60:130] = tex
    right[30:90, 48:118] = tex
    cam = PinholeCamera.create(200.0, 200.0, W / 2, H / 2, H, W)
    params = tom.ObjectMesherParams(device=tom.ObjectMesherDeviceParams(
        tracker=TST(capacity=64, detector=TDet(max_features=64, min_distance=8, border=6),
                    lk=TLK(max_level=2), trigger_keyframe_k=2,
                    matcher=TSM(max_disp=24, templ_cols=11, templ_rows=11, max_matching_cost=0.4)),
        min_obs_connect_edge=3.0, min_obs_disconnect_edge=2.0, neighbor_radius_px=60.0))
    mesher = tom.ObjectMesher(params, StereoCamera.create(cam, cam, 0.3), device="cpu")
    for _ in range(6):
        mesh = mesher.process_stereo(left, right)
    assert mesh.num_triangles > 0
    assert abs(np.median(mesh.vertices[:, 2]) - 5.0) < 0.6


def test_object_mesher_needs_a_card_by_default(monkeypatch):
    """ObjectMesher runs on the card unless the caller asks for the CPU:
    without a card it raises, as the other entry points do."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = PinholeCamera.create(200.0, 200.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, 0.3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tom.ObjectMesher(tom.ObjectMesherParams(), rig)
    assert tom.ObjectMesher(tom.ObjectMesherParams(), rig, device="cpu").device.type == "cpu"
