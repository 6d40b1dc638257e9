"""The PyTorch port's sparse front end (ocean_perception_tpu_torch.tracking)
against the JAX reference on the CPU, and the state converters.

Inputs are the 120x160 `textured` recipe of tests/test_tracking.py, made
with numpy from a seed and fed as float32 to both sides.

Tolerances, and why:
- detector: identical points, scores and valid flags (the corner score is
  bit-exact: sqrt_f32 rounds as XLA does).
- stripe matcher: equal disparities, costs within 1e-5 (XLA sums the
  correlation in another order). With subpixel refinement the parabola
  turns those cost differences into disparity differences, held to 2e-3 px.
- the stereo tracker over 3 frames with its pyramid ring: see
  test_tracker_steps_match_jax. The LK tracker's own comparisons are in
  tests/test_torch_lk.py.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.ops import interp as jinterp
from ocean_perception_tpu.tracking import detector as jdet
from ocean_perception_tpu.tracking import lk as jlk
from ocean_perception_tpu.tracking import stereo_tracker as jst
from ocean_perception_tpu.tracking import stripe_match as jsm
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.ops import interp as tinterp
from ocean_perception_tpu_torch.ops import windows as twin
from ocean_perception_tpu_torch.tracking import detector as tdet
from ocean_perception_tpu_torch.tracking import lk as tlk
from ocean_perception_tpu_torch.tracking import stereo_tracker as tst
from ocean_perception_tpu_torch.tracking import stripe_match as tsm


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

H, W = 120, 160


@pytest.fixture(scope="module")
def textured():
    rng = np.random.default_rng(11)
    im = rng.random((H, W + 40)).astype(np.float32)
    return cv2.GaussianBlur(im, (5, 5), 1.2) * 0.7 + 0.15


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kw", [
    dict(max_features=48, min_distance=10, border=8),
    dict(max_features=64, min_distance=6, border=4, subpixel=True),
    dict(max_features=300, min_distance=4),   # more slots than cells: padded tail
    dict(max_features=40, min_distance=8, use_harris=True),
])
def test_detector_matches_jax(textured, kw):
    img = np.ascontiguousarray(textured[:, :W])
    rng = np.random.default_rng(3)
    excl = rng.uniform(0, W - 10, (20, 2)).astype(np.float32)
    ev = rng.random(20) > 0.3
    ref = jdet.detect_features(jnp.asarray(img), jdet.DetectorParams(**kw), jnp.asarray(excl),
                               jnp.asarray(ev))
    ours = tdet.detect_features(_t(img), tdet.DetectorParams(**kw), _t(excl), _t(ev))
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(ours.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert ours.valid.sum() >= 30


def test_mask_around_points_matches_jax():
    pts = np.array([[0, 0], [159, 119], [40.5, 60.5], [80, 20]], np.float32)
    valid = np.array([True, True, False, True])
    ref = jdet.mask_around_points((H, W), jnp.asarray(pts), jnp.asarray(valid), 6.0)
    np.testing.assert_array_equal(tdet.mask_around_points((H, W), _t(pts), _t(valid), 6.0).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("subpixel", [False, True])
def test_stripe_matcher_matches_jax(textured, subpixel):
    left = np.ascontiguousarray(textured[:, 16:16 + W - 32])
    right = np.ascontiguousarray(textured[:, 4:4 + W - 32])
    rng = np.random.default_rng(7)
    K = 60
    pts = np.stack([rng.uniform(0, left.shape[1] - 1, K), rng.uniform(0, H - 1, K)], 1)
    pts = pts.astype(np.float32)
    pts[0], pts[1] = [0, 0], [left.shape[1] - 1, H - 1]
    valid = rng.random(K) > 0.1
    ref = jsm.match_rectified(jnp.asarray(left), jnp.asarray(right), jnp.asarray(pts),
                              jnp.asarray(valid),
                              jsm.StripeMatcherParams(max_disp=32, impl="sliced", subpixel=subpixel))
    ours = tsm.match_rectified(_t(left), _t(right), _t(pts), _t(valid),
                               tsm.StripeMatcherParams(max_disp=32, subpixel=subpixel))
    np.testing.assert_allclose(ours.cost.numpy(), np.asarray(ref.cost), atol=1e-5)
    d_ref, d = np.asarray(ref.disparity), ours.disparity.numpy()
    np.testing.assert_array_equal(d >= 0, d_ref >= 0)
    if subpixel:
        np.testing.assert_allclose(d, d_ref, atol=2e-3)
    else:
        np.testing.assert_array_equal(d, d_ref)
    assert (d >= 0).sum() >= 20


def test_interp_matches_jax():
    """bilinear_sample (the mesher's full-resolution edge gate) and
    sample_patches_bilinear (the ZNCC gate's recentring) on points inside,
    on and beyond the borders."""
    rng = np.random.default_rng(9)
    img = rng.random((20, 30)).astype(np.float32)
    y = rng.uniform(-2, 22, (5, 7)).astype(np.float32)
    x = rng.uniform(-2, 32, (5, 7)).astype(np.float32)
    np.testing.assert_allclose(tinterp.bilinear_sample(_t(img), _t(y), _t(x)).numpy(),
                               np.asarray(jinterp.bilinear_sample(jnp.asarray(img), jnp.asarray(y),
                                                                  jnp.asarray(x))), atol=1e-6)
    rgb = rng.random((20, 30, 3)).astype(np.float32)
    np.testing.assert_allclose(tinterp.bilinear_sample(_t(rgb), _t(y), _t(x)).numpy(),
                               np.asarray(jinterp.bilinear_sample(jnp.asarray(rgb), jnp.asarray(y),
                                                                  jnp.asarray(x))), atol=1e-6)
    windows = rng.random((4, 24, 24)).astype(np.float32)
    cy = np.array([11.5, 0.25, 23.0, 12.75], np.float32)
    cx = np.array([11.5, 23.0, 0.0, 3.125], np.float32)
    ours = tinterp.sample_patches_bilinear(_t(windows), _t(cy), _t(cx), 23, 23).numpy()
    for k in range(4):
        ref = jinterp.sample_patches_bilinear(jnp.asarray(windows[k]), jnp.float32(cy[k]),
                                              jnp.float32(cx[k]), 23, 23)
        np.testing.assert_allclose(ours[k], np.asarray(ref), atol=1e-6)


def test_extract_windows_ring_and_pad():
    img = np.random.default_rng(0).random((3, 20, 30)).astype(np.float32)
    y0, x0, src = np.array([0, 5, 12]), np.array([0, 9, 22]), np.array([2, 0, 1])
    ours = twin.extract_windows(_t(img), _t(y0), _t(x0), 8, src=_t(src)).numpy()
    for k in range(3):
        np.testing.assert_array_equal(ours[k], img[src[k], y0[k]:y0[k] + 8, x0[k]:x0[k] + 8])
    # Origins in the edge-padded image's coordinates, windows over its edges.
    padded = np.pad(img, ((0, 0), (4, 4), (4, 4)), mode="edge")
    y0, x0 = np.array([0, 5, 16]), np.array([0, 13, 26])
    ours = twin.extract_windows(_t(img), _t(y0), _t(x0), 12, src=_t(src), pad=4).numpy()
    for k in range(3):
        np.testing.assert_array_equal(ours[k], padded[src[k], y0[k]:y0[k] + 12, x0[k]:x0[k] + 12])


def test_tracker_state_round_trips(textured):
    """A JAX StereoTrackerState with its ring, filled with seeded values,
    converts to the port's and back without a changed bit."""
    jp = jst.StereoTrackerParams(capacity=16, lk=jlk.LKParams(max_level=2))
    state = jst.StereoTrackerState.create(jp, image_shape=(30, 41))
    rng = np.random.default_rng(5)
    t = state.table
    table = t.replace(
        ids=jnp.asarray(rng.integers(-1, 50, 16), jnp.int32),
        pixels=jnp.asarray(rng.random((16, 2)), jnp.float32) * 40,
        disparities=jnp.asarray(rng.random(16), jnp.float32),
        kf_pixels=jnp.asarray(rng.random((16, 2)), jnp.float32),
        kf_disparities=jnp.asarray(rng.random(16), jnp.float32),
        ages=jnp.asarray(rng.integers(0, 9, 16), jnp.int32),
        missed=jnp.asarray(rng.integers(0, 3, 16), jnp.int32))
    ring = tuple(jnp.asarray(rng.random(l.shape), jnp.float32) for l in state.ring)
    state = state.replace(table=table, ring=ring, frame_idx=jnp.asarray(7, jnp.int32),
                          next_lmk_id=jnp.asarray(51, jnp.int32))
    ours = convert.stereo_tracker_state_from_jax(state)
    assert [tuple(l.shape) for l in ours.ring] == [(4, 30, 41), (4, 15, 21), (4, 8, 11)]
    back = jst.StereoTrackerState(
        table=jst.TrackTable(**{k: jnp.asarray(getattr(ours.table, k).numpy())
                                for k in ("ids", "pixels", "disparities", "kf_pixels",
                                          "kf_disparities", "ages", "missed")}),
        frame_idx=jnp.asarray(ours.frame_idx.numpy()),
        last_kf_frame=jnp.asarray(ours.last_kf_frame.numpy()),
        next_lmk_id=jnp.asarray(ours.next_lmk_id.numpy()),
        ring=tuple(jnp.asarray(l.numpy()) for l in ours.ring))
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    tp = convert.stereo_tracker_params_from_jax(jp)
    assert tp.capacity == 16 and tp.lk.max_level == 2 and tp.lk.window == 21
    assert tp.matcher == tsm.StripeMatcherParams() and tp.detector == tdet.DetectorParams()


def test_tracker_steps_match_jax(textured):
    """Three frames of track_and_triangulate with the k-ago ring, from the
    same created state, on a camera translating 1.5 px a frame with an 8 px
    stereo disparity. JAX runs its XLA correlation walk (the fused kernels'
    math) with x64 off, as in production.

    Tolerance: keyframe flags, ids, next ids and the alive set equal; pixels
    within 1e-3 px (the LK bound of tests/test_torch_lk.py); disparities
    equal, since the stripe matcher lands on whole pixels."""
    kw = dict(capacity=48, trigger_keyframe_k=3)
    det = dict(max_features=48, min_distance=10, border=8)
    match = dict(max_disp=24, templ_cols=15, templ_rows=11, max_matching_cost=0.3)
    jp = jst.StereoTrackerParams(
        **kw, detector=jdet.DetectorParams(**det), matcher=jsm.StripeMatcherParams(**match),
        lk=jlk.LKParams(max_level=1, corr_iters=True, pallas_iters=False, fused_lk=False))
    tp = tst.StereoTrackerParams(
        **kw, detector=tdet.DetectorParams(**det), matcher=tsm.StripeMatcherParams(**match),
        lk=tlk.LKParams(max_level=1))

    def frame(shift):
        M = np.float32([[1, 0, -shift], [0, 1, 0]])
        l = cv2.warpAffine(textured, M, (textured.shape[1], textured.shape[0]))[:, :W]
        return np.ascontiguousarray(l), np.ascontiguousarray(np.roll(l, -8, axis=1))

    with jax.enable_x64(False):
        js = jst.StereoTrackerState.create(jp, image_shape=(H, W))
        step = jax.jit(lambda s, l, r: jst.track_and_triangulate(s, l, l, r, jnp.float32(100.0), jp))
        ts = convert.stereo_tracker_state_from_jax(js)
        for i, shift in enumerate([0.0, 1.5, 3.0]):
            l, r = frame(shift)
            js, jout = step(js, jnp.asarray(l), jnp.asarray(r))
            ts, tout = tst.track_and_triangulate(ts, _t(l), _t(l), _t(r), 100.0, tp)
            jt, tt = js.table, ts.table
            assert bool(jout.is_keyframe) == bool(tout.is_keyframe) == (i == 0)
            assert int(jout.n_tracked) == int(tout.n_tracked)
            assert int(js.next_lmk_id) == int(ts.next_lmk_id)
            np.testing.assert_array_equal(tt.ids.numpy(), np.asarray(jt.ids))
            np.testing.assert_array_equal(tt.missed.numpy(), np.asarray(jt.missed))
            np.testing.assert_allclose(tt.pixels.numpy(), np.asarray(jt.pixels), atol=1e-3)
            np.testing.assert_array_equal(tt.disparities.numpy(), np.asarray(jt.disparities))
            for a, b in zip(ts.ring, js.ring):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
            alive = tt.ids.numpy() >= 0
            assert alive.sum() >= 30
            if i > 0:
                assert int(tout.n_tracked) >= 25
                d = tt.disparities.numpy()[alive]
                assert np.median(d[d > 0]) == 8.0
