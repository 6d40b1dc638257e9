"""The PyTorch port's LK tracker (ocean_perception_tpu_torch.tracking.lk)
against the JAX reference on the CPU: the plain twins of the two CUDA
kernels against the Pallas kernels they replace, and the whole tracker
against JAX's fused-kernel path and its XLA correlation path.

Inputs are the 120x160 `textured` recipe of tests/test_tracking.py moved
by (2.7, -1.3) px, with K=32 corners, made with numpy from a seed.

Tolerances, and why:
- lk_prep / lk_walk twins against lk_prep_pallas / lk_iterate_lane_major in
  interpret mode: surfaces within 1e-5 absolute, the other prep outputs
  within 1e-5 relative, positions within 1e-5 px; gates, origins and hit
  flags equal. Not bit-exact: interpret mode runs the kernel body through
  XLA, which contracts a*b + c into fused multiply-adds, where the twin
  (and the CUDA kernel) rounds every operation.
- track_points / track_points_ring against JAX's fused kernels (interpret)
  and its XLA correlation path: status agreement >= 0.97 and |dpos| < 1e-3 px
  where both accept. JAX holds its own fused path to its XLA path at
  >= 0.97 and < 0.01 px (tests/test_tracking.py::test_lk_fused_matches_xla).

Interpret mode compiles the Pallas kernels anew for every level shape and
window (about 10 s each on the CPU), so the fused comparisons run one level.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.ops.pallas.lk_iterate import lk_iterate_lane_major
from ocean_perception_tpu.ops.pallas.lk_prep import lk_prep_pallas
from ocean_perception_tpu.tracking import lk as jlk
from ocean_perception_tpu_torch.tracking import lk as tlk

H, W = 120, 160
PAD = 21 // 2 + 2


@pytest.fixture(scope="module")
def flow_pair():
    """prev, next (moved by (2.7, -1.3) px) and K=32 corners of prev."""
    rng = np.random.default_rng(11)
    textured = cv2.GaussianBlur(rng.random((H, W + 40)).astype(np.float32), (5, 5), 1.2) * 0.7 + 0.15
    prev = np.ascontiguousarray(textured[:, :W])
    M = np.float32([[1, 0, 2.7], [0, 1, -1.3]])
    nxt = np.ascontiguousarray(
        cv2.warpAffine(textured, M, (textured.shape[1], textured.shape[0]))[:, :W])
    pts = cv2.goodFeaturesToTrack(prev, maxCorners=32, qualityLevel=0.01, minDistance=7)
    return prev, nxt, pts.reshape(-1, 2).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_lk_twins_match_pallas_kernels(flow_pair):
    """One level of the port's prep and walk twins against lk_prep_pallas and
    lk_iterate_lane_major (interpret mode) on the same padded level."""
    prev, nxt, pts = flow_pair
    K = len(pts)
    guess = pts + np.float32([2.5, -1.0])
    guess[0] = np.nan                      # sanitised to origin 0, as the kernel does
    zk = np.zeros(K, np.int32)
    edge = lambda a: np.pad(a[None], ((0, 0), (PAD, PAD), (PAD, PAD)), mode="edge")
    corr, scal, okg, sy0, sx0 = lk_prep_pallas(
        jnp.asarray(edge(prev)), jnp.asarray(edge(nxt)), jnp.asarray(pts), jnp.asarray(guess),
        jnp.asarray(zk), jnp.asarray(zk), win=21, slack=4, pad=PAD, min_eig_threshold=1.5e-9,
        interpret=True)
    c, s, ok = tlk.lk_prep(_t(prev[None]), _t(nxt[None]), _t(pts), _t(guess), _t(zk), _t(zk),
                           win=21, slack=4, pad=PAD, min_eig_threshold=1.5e-9)
    jc = np.transpose(np.asarray(corr)[..., :K], (3, 0, 1, 2))
    js = np.asarray(scal)[:, :K].T
    assert c.shape == jc.shape == (K, 2, 11, 11)
    np.testing.assert_allclose(c.numpy(), jc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.numpy()[:, :6], js[:, :6], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(s.numpy()[:, 6:], js[:, 6:])
    np.testing.assert_array_equal(s.numpy()[:, 6], np.asarray(sy0))
    np.testing.assert_array_equal(s.numpy()[:, 7], np.asarray(sx0))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okg))
    assert ok.all()

    # The walk, fed the same (JAX) surfaces.
    Kp = corr.shape[-1]
    pos0 = np.where(np.isfinite(guess), guess, 0).astype(np.float32)
    pos_t, hit_f = lk_iterate_lane_major(
        corr, scal, jnp.pad(jnp.asarray(pos0.T), ((0, 0), (0, Kp - K))), r=10, ws=31, pad=PAD,
        max_iters=30, eps=0.01, interpret=True)
    pos, hit = tlk.lk_walk(_t(jc), _t(js), _t(pos0), r=10, ws=31, pad=PAD, max_iters=30,
                           eps=0.01)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_t)[:, :K].T, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_f)[0, :K] > 0.5)


def _assert_flow_close(ours, ref, min_accept):
    so, sr = ours.status.numpy(), np.asarray(ref.status)
    assert (so == sr).mean() >= 0.97
    both = so & sr
    assert both.sum() >= min_accept
    assert np.abs(ours.points.numpy() - np.asarray(ref.points))[both].max() < 1e-3


JAX_FUSED = dict(fused_lk=True)
JAX_XLA = dict(corr_iters=True, pallas_iters=False, fused_lk=False)


# The fused comparison runs one level; the XLA one runs coarse to fine.
@pytest.mark.parametrize("jax_path,max_level", [(JAX_FUSED, 0), (JAX_XLA, 1)],
                         ids=["fused", "xla"])
def test_track_points_matches_jax(flow_pair, jax_path, max_level):
    prev, nxt, pts = flow_pair
    K = len(pts)
    valid = np.ones(K, bool)
    valid[3] = False
    ref = jlk.track_points(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
                           jnp.asarray(valid), jlk.LKParams(max_level=max_level, **jax_path))
    ours = tlk.track_points(_t(prev), _t(nxt), _t(pts), _t(valid),
                            tlk.LKParams(max_level=max_level))
    _assert_flow_close(ours, ref, 0.8 * K)
    assert not ours.status[3]


@pytest.mark.parametrize("jax_path", [JAX_FUSED, JAX_XLA], ids=["fused", "xla"])
def test_track_points_ring_matches_jax(flow_pair, jax_path):
    """k-ago ring: each point's template from its own frame (2 frames here),
    the backward check into the same frame. A window of 9 keeps the
    interpret-mode compile short."""
    prev, nxt, pts = flow_pair
    K = len(pts)
    older = np.ascontiguousarray(np.roll(prev, 1, axis=1))
    ring = np.stack([prev, older])                    # (R, H, W), level 0 only
    src = (np.arange(K) % 2).astype(np.int32)
    pts_src = np.where(src[:, None] == 1, pts + np.float32([1, 0]), pts).astype(np.float32)
    kw = dict(max_level=0, window=9)
    ref = jlk.track_points_ring((jnp.asarray(ring),), (jnp.asarray(nxt),),
                                jnp.asarray(pts_src), jnp.ones(K, bool), jnp.asarray(src),
                                jlk.LKParams(**kw, **jax_path))
    ours = tlk.track_points_ring((_t(ring),), (_t(nxt),), _t(pts_src),
                                 torch.ones(K, dtype=torch.bool), _t(src), tlk.LKParams(**kw))
    _assert_flow_close(ours, ref, 0.6 * K)


def test_lk_options_raise_or_gate(flow_pair):
    prev, nxt, pts = flow_pair
    args = (_t(prev), _t(nxt), _t(pts), torch.ones(len(pts), dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        tlk.track_points(*args, tlk.LKParams(coarse_init=True))
    with pytest.raises(NotImplementedError):
        tlk.track_points(*args, tlk.LKParams(search_slack=0))
    with pytest.raises(ValueError, match="fwd_bwd_tol"):
        tlk.track_points(*args, tlk.LKParams(max_level=1, bwd_levels=1, search_slack=2))
    # The truncated backward pass with its ZNCC gate keeps the true tracks.
    gated = tlk.track_points(*args, tlk.LKParams(max_level=1, bwd_levels=1))
    assert gated.status.float().mean() > 0.7


def test_appearance_gate_matches_jax(flow_pair):
    prev, nxt, pts = flow_pair
    moved = pts + np.float32([2.7, -1.3])
    wrong = np.ascontiguousarray(moved[::-1])
    p = dict(bwd_zncc_min=0.5)
    for target in (moved, wrong):
        ref = jlk._appearance_gate(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
                                   jnp.asarray(target), jlk.LKParams(**p))
        ours = tlk._appearance_gate(_t(prev), _t(nxt), _t(pts), _t(target), tlk.LKParams(**p))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
