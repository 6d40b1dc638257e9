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

- the two-tap spelling of the lk_track kernel's recentring and surface
  lookups (tents with two non-zero taps, the other products dropped)
  against the twins' full sums: equal (torch.equal), on random and integer
  positions, positions at the clamps and the slack-window edges, and
  negative and zero values.
- lk_track_plain over 6 levels (windows 21, 21, 21, 15, 7 and a skipped
  level) against JAX's XLA path: as track_points above.

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
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import image_pyramid
from ocean_perception_tpu_torch.tracking import lk as tlk


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


# --- the lk_track kernel's two-tap arithmetic --------------------------------


def _tent(pos, i):
    return (1.0 - (pos - i.float()).abs()).clamp_min(0.0)


def _two_tap_recentre(twin, fy, fx):
    """csrc/lk.cu's recentring: each entry of the y and x contractions is
    w0*v(floor(c)) + w1*v(floor(c) + 1); where floor(c) + 1 is past the
    window, w1 is 0 and the second value is read at floor(c)."""
    K, ST = twin.shape[0], twin.shape[-1]
    P = ST - 1
    i = torch.arange(P, dtype=torch.float32)
    k = torch.arange(K)[:, None]
    cy = ((fy[:, None] + i) - (P // 2)).clamp(0, ST - 1)             # (K, P)
    cx = ((fx[:, None] + i) - (P // 2)).clamp(0, ST - 1)
    a0 = cy.long()
    a1 = (a0 + 1).clamp(max=ST - 1)
    t1 = (_tent(cy, a0)[..., None] * twin[k, a0, :]
          + _tent(cy, a0 + 1)[..., None] * twin[k, a1, :])            # (K, P, ST)
    b0 = cx.long()
    b1 = (b0 + 1).clamp(max=ST - 1)
    kk, pp = torch.arange(K)[:, None, None], torch.arange(P)[None, :, None]
    return (t1[kk, pp, b0[:, None, :]] * _tent(cx, b0)[:, None, :]
            + t1[kk, pp, b1[:, None, :]] * _tent(cx, b0 + 1)[:, None, :])


def _two_tap_lookup(corr, ry, rx):
    """csrc/lk.cu's walk step lookup: the taps floor(r) and floor(r) + 1 on
    each axis, x offsets first. A point still walking has ry, rx in
    [1, A-2]; the clamp only keeps a stopped point's indices valid."""
    A = corr.shape[-1]
    a0 = torch.nan_to_num(ry).floor().clamp(0, A - 2).long()
    b0 = torch.nan_to_num(rx).floor().clamp(0, A - 2).long()
    k = torch.arange(corr.shape[0])
    wx0, wx1 = _tent(rx, b0)[:, None], _tent(rx, b0 + 1)[:, None]
    t0 = corr[k, :, a0, b0] * wx0 + corr[k, :, a0, b0 + 1] * wx1    # (K, 2)
    t1 = corr[k, :, a0 + 1, b0] * wx0 + corr[k, :, a0 + 1, b0 + 1] * wx1
    return t0 * _tent(ry, a0)[:, None] + t1 * _tent(ry, a0 + 1)[:, None]


def test_two_tap_recentring_equals_the_full_sums(monkeypatch):
    """lk_prep_plain with csrc/lk.cu's two-tap recentring gives the twin's
    outputs: images with negative and zero regions; random, integer,
    clamped and NaN points."""
    rng = np.random.default_rng(12)
    img = rng.normal(0.0, 1.0, (2, 40, 56)).astype(np.float32)
    img[0, 10:20, 10:30] = 0.0
    img[1, :, 40:] = -np.abs(img[1, :, 40:])
    K = 40
    pts = np.stack([rng.uniform(0, 55, K), rng.uniform(0, 39, K)], 1).astype(np.float32)
    pts[:8] = np.round(pts[:8])                       # one non-zero tap
    pts[8:12] = [[0, 0], [55, 39], [-7.5, 3.25], [70.2, 45.9]]  # at and past the clamps
    pts[12] = np.nan
    pts[13:16] = [[15.0, 12.5], [20.25, 14.0], [12.0, 11.0]]  # on the zero block
    src = (np.arange(K) % 2).astype(np.int32)
    args = (_t(img), _t(img[::-1].copy()), _t(pts), _t(pts + np.float32(0.5)), _t(src), _t(src))
    for win in (21, 7):
        kw = dict(win=win, slack=4, pad=PAD, min_eig_threshold=1.5e-9)
        want = tlk.lk_prep_plain(*args, **kw)
        with monkeypatch.context() as m:
            m.setattr(tlk, "_recentre", _two_tap_recentre)
            got = tlk.lk_prep_plain(*args, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_two_tap_lookup_equals_the_full_sums(monkeypatch):
    """lk_walk_plain with csrc/lk.cu's two-tap lookups gives the twin's
    positions and flags: surfaces with negative entries and zero rows;
    random starts, starts on whole offsets (one non-zero tap a step) and on
    the slack window's edges, and NaN."""
    rng = np.random.default_rng(13)
    K, A, r, ws, pad = 48, 11, 10, 31, PAD
    corr = rng.normal(0.0, 1.0, (K, 2, A, A)).astype(np.float32)
    corr[::3, :, 4] = 0.0
    corr[1::3] = -np.abs(corr[1::3])
    scal = np.zeros((K, 8), np.float32)
    scal[:, :2] = rng.normal(0.0, 1.0, (K, 2))
    scal[:, 2] = scal[:, 5] = rng.uniform(0.2, 0.5, K)
    scal[:, 3] = scal[:, 4] = rng.uniform(-0.1, 0.1, K)
    scal[:, 6:] = rng.integers(0, 20, (K, 2))
    # c = pos + pad - origin, walked inside [r + 1, ws - r - 2] = [11, 19].
    c = rng.uniform(11, 19, (K, 2)).astype(np.float32)
    c[:8] = np.round(c[:8])                            # whole offsets
    c[8:16] = rng.choice([11.0, 19.0], (8, 2))         # on the edges
    c[16:20] = [[10.999999, 15], [15, 19.000002], [11, 19], [19, 11]]
    pos0 = (c - pad + scal[:, [7, 6]]).astype(np.float32)
    pos0[20] = np.nan
    args = (_t(corr), _t(scal), _t(pos0))
    for max_iters in (1, 3, 30):
        kw = dict(r=r, ws=ws, pad=pad, max_iters=max_iters, eps=0.01)
        want = tlk.lk_walk_plain(*args, **kw)
        with monkeypatch.context() as m:
            m.setattr(tlk, "_surface_lookup", _two_tap_lookup)
            got = tlk.lk_walk_plain(*args, **kw)
        assert torch.equal(got[0].nan_to_num(-1e30), want[0].nan_to_num(-1e30))
        assert torch.equal(got[1], want[1])
    assert 0 < int(want[1].sum()) < K                  # some points hit, some walk on


def test_lk_track_levels_match_jax(flow_pair):
    """Six levels coarse to fine: 120x160 down to 4x5, so the windows are 21,
    21, 21, 15 and 7 and the coarsest level is skipped (level_window)."""
    prev, nxt, pts = flow_pair
    K = len(pts)
    valid = np.ones(K, bool)
    ref = jlk.track_points(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
                           jnp.asarray(valid), jlk.LKParams(max_level=5, **JAX_XLA))
    cuda.reset_launches()
    ours = tlk.track_points(_t(prev), _t(nxt), _t(pts), _t(valid), tlk.LKParams(max_level=5))
    assert set(cuda.LAUNCHES.values()) == {0}
    _assert_flow_close(ours, ref, 0.8 * K)
    pyr = image_pyramid(_t(prev), 6)
    steps = []
    tlk.lk_track_plain([l[None] for l in pyr], [l[None] for l in image_pyramid(_t(nxt), 6)],
                       _t(pts), _t(pts), torch.zeros(K, dtype=torch.int32),
                       torch.zeros(K, dtype=torch.int32), wins=[21, 21, 21, 15, 7, None],
                       slack=4, pad=PAD, min_eig_threshold=1.5e-9, max_iters=30, eps=0.01,
                       steps=steps)
    assert [l.shape for l in pyr][-2:] == [(8, 10), (4, 5)]
    assert [lvl for lvl, _ in steps] == [4, 3, 2, 1, 0]
