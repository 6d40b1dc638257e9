"""The LK tracker's two options in the PyTorch port against the JAX
reference on the CPU: the unbounded walk (``search_slack <= 0``) and the
coarse block-match start (``coarse_init``). The reference runs both in XLA
(no Pallas kernel reaches them), so each test compares with JAX's own path.

Inputs are made with numpy from a seed: the 120x160 `textured` recipe of
tests/test_tracking.py moved by (2.7, -1.3) px with K=32 corners, and, for
the coarse start, the same recipe moved 20 px, beyond the default walk's
reach.

Tolerances, and why:
- trackers against JAX: status agreement >= 0.97 and |dpos| < 1e-3 px where
  both accept, as tests/test_torch_lk.py holds the default path. Not
  bit-exact: XLA contracts a*b + c into fused multiply-adds and resamples
  with matrix products; the twins (and the CUDA kernels) round every
  operation in the kernels' order.
- the coarse block match against JAX's: the offsets equal at every finite
  point. Each SSD is a sum of patch^2 squares in another order than XLA's,
  which could only matter at a near tie; these inputs have none.
- a batch of cameras against each camera alone: equal (torch.equal). The
  kernels' two-tap resampling is held to the twin's full sums in
  tests/test_torch_lk.py, beside the slack mode's.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.ops.image import image_pyramid as jax_pyramid
from ocean_perception_tpu.tracking import lk as jlk
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import image_pyramid
from ocean_perception_tpu_torch.tracking import lk as tlk


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's thread pool in each would oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 120, 160
PAD = 21 // 2 + 2
UNBOUNDED = dict(search_slack=0)


def _textured(seed, extra=40):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.random((H, W + extra)).astype(np.float32), (5, 5), 1.2) * 0.7 + 0.15


def _moved(textured, dx, dy):
    M = np.float32([[1, 0, dx], [0, 1, dy]])
    return np.ascontiguousarray(
        cv2.warpAffine(textured, M, (textured.shape[1], textured.shape[0]))[:, :W])


@pytest.fixture(scope="module")
def flow_pair():
    """prev, next (moved by (2.7, -1.3) px) and K=32 corners of prev."""
    textured = _textured(11)
    prev = np.ascontiguousarray(textured[:, :W])
    pts = cv2.goodFeaturesToTrack(prev, maxCorners=32, qualityLevel=0.01, minDistance=7)
    return prev, _moved(textured, 2.7, -1.3), pts.reshape(-1, 2).astype(np.float32)


@pytest.fixture(scope="module")
def far_pair():
    """prev, next moved 20 px right, and a grid of 30 points away from the
    borders: 5 px at level 2, beyond a slack of 4 at every level."""
    textured = _textured(12, extra=80)
    prev = np.ascontiguousarray(textured[:, :W])
    pts = np.stack(np.meshgrid(np.arange(30, W - 30, 20), np.arange(20, H - 20, 16)), -1)
    return prev, _moved(textured, 20.0, 0.0), pts.reshape(-1, 2).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax(fn, *args):
    """The JAX side on float32, as the port computes."""
    with jax.enable_x64(False):
        out = fn(*(jnp.asarray(a) for a in args))
        return jax.tree_util.tree_map(np.asarray, out)


def _assert_flow_close(ours, ref, min_accept):
    so, sr = ours.status.numpy(), np.asarray(ref.status)
    assert (so == sr).mean() >= 0.97
    both = so & sr
    assert both.sum() >= min_accept
    assert np.abs(ours.points.numpy() - np.asarray(ref.points))[both].max() < 1e-3


# --- the unbounded walk -------------------------------------------------------


def test_unbounded_lk_track_plain_matches_jax(flow_pair):
    """One direction, 4 levels (windows 21, 21, 21, 15), from a start 3 px
    off: lk_track_plain against JAX's pyramidal_lk with search_slack=0."""
    prev, nxt, pts = flow_pair
    K = len(pts)
    init = pts + np.float32([5.5, -4.0])
    p = jlk.LKParams(max_level=3, **UNBOUNDED)
    ref = _jax(lambda a, b, c, d: jlk.pyramidal_lk(jax_pyramid(a, 4), jax_pyramid(b, 4), c, p,
                                                    initial_flow=d),
               prev, nxt, pts, init)
    zero = torch.zeros(K, dtype=torch.int32)
    cuda.reset_launches()
    steps = []
    got = tlk.lk_track_plain([l[None] for l in image_pyramid(_t(prev), 4)],
                             [l[None] for l in image_pyramid(_t(nxt), 4)], _t(pts), _t(init),
                             zero, zero, wins=[21, 21, 21, 15], slack=0, pad=PAD,
                             min_eig_threshold=1.5e-9, max_iters=30, eps=0.01, steps=steps)
    assert set(cuda.LAUNCHES.values()) == {0}
    _assert_flow_close(tlk.FlowResult(*got), ref, 0.8 * K)
    assert [lvl for lvl, _ in steps] == [3, 2, 1, 0]
    assert all(int(moved.max()) <= 30 for _, moved in steps)


def test_unbounded_read_box_covers_every_window(flow_pair):
    """The walk's read box (what the unbounded mode's bound counts) is the
    box of the windows it read before it converged: rebuilt here from the
    positions after 0, 1, ... steps, each a walk of that many steps."""
    prev, nxt, pts = flow_pair
    win, iters = 21, 30
    ws = win + 2
    src = torch.zeros(len(pts), dtype=torch.int32)
    ts = tlk.template_side_plain(_t(prev)[None], _t(pts), src, win=win, pad=PAD,
                                 min_eig_threshold=1.5e-9)
    pos0 = _t(pts + np.float32([2.0, -1.0]))
    walk = dict(pad=PAD, eps=0.01)
    _, steps, box = tlk.lk_walk_unbounded_plain(_t(nxt)[None], src, ts, pos0, max_iters=iters,
                                                count_steps=True, **walk)
    assert int(steps.max()) > 1
    origins = []
    for n in range(iters):
        pos = tlk.lk_walk_unbounded_plain(_t(nxt)[None], src, ts, pos0, max_iters=n, **walk)
        pos = torch.nan_to_num(pos, nan=0.0, posinf=0.0, neginf=0.0)
        origins.append(torch.stack([(torch.floor(pos[:, 1]) + PAD - win // 2 - 1)
                                    .clamp(0, H + 2 * PAD - ws),
                                    (torch.floor(pos[:, 0]) + PAD - win // 2 - 1)
                                    .clamp(0, W + 2 * PAD - ws)], 1).int())
    origins = torch.stack(origins)  # (iters, K, 2)
    read = torch.arange(iters)[:, None] < steps[None, :]  # the windows read
    big, small = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min
    lo = torch.where(read[..., None], origins, big).amin(0)
    hi = torch.where(read[..., None], origins, small).amax(0)
    want = torch.where(steps[:, None] > 0, hi - lo + ws, 0)
    assert torch.equal(box, want.int())
    assert bool((box[steps > 0] >= ws).all())


def test_unbounded_track_points_matches_jax(flow_pair):
    prev, nxt, pts = flow_pair
    K = len(pts)
    valid = np.ones(K, bool)
    valid[3] = False
    ref = _jax(lambda a, b, c, v: jlk.track_points(a, b, c, v, jlk.LKParams(max_level=1,
                                                                          **UNBOUNDED)),
               prev, nxt, pts, valid)
    ours = tlk.track_points(_t(prev), _t(nxt), _t(pts), _t(valid),
                            tlk.LKParams(max_level=1, **UNBOUNDED))
    _assert_flow_close(ours, ref, 0.8 * K)
    assert not ours.status[3]


def test_unbounded_track_points_ring_matches_jax(flow_pair):
    """k-ago ring of 2 frames, each point's template from its own frame, the
    backward check into the same frame; window 9, one level."""
    prev, nxt, pts = flow_pair
    K = len(pts)
    ring = np.stack([prev, np.roll(prev, 1, axis=1)])
    src = (np.arange(K) % 2).astype(np.int32)
    pts_src = np.where(src[:, None] == 1, pts + np.float32([1, 0]), pts).astype(np.float32)
    kw = dict(max_level=0, window=9, **UNBOUNDED)
    ref = _jax(lambda r, n, c, s: jlk.track_points_ring((r,), (n,), c, jnp.ones(K, bool), s,
                                                        jlk.LKParams(**kw)),
               ring, nxt, pts_src, src)
    ours = tlk.track_points_ring((_t(ring),), (_t(nxt),), _t(pts_src),
                                 torch.ones(K, dtype=torch.bool), _t(src), tlk.LKParams(**kw))
    _assert_flow_close(ours, ref, 0.6 * K)


@pytest.mark.parametrize("tol,slack,want", [(2.0, 4, 2.0), (4.0, 4, 3.0), (5.0, 0, 5.0),
                                            (5.0, -1, 5.0), (5.0, 4, None)],
                         ids=["default", "clamped", "unbounded", "negative-slack", "refused"])
def test_bwd_init_matches_jax(tol, slack, want):
    """The truncated backward pass's start, on the cases of
    tests/test_config_bindings.py::test_bwd_init_tol_slack_guard: clamped to
    search_slack - 1 only with a slack window."""
    pts = np.zeros((3, 2), np.float32)
    tp, jp = tlk.LKParams(fwd_bwd_tol=tol, search_slack=slack), \
        jlk.LKParams(fwd_bwd_tol=tol, search_slack=slack)
    if want is None:
        with pytest.raises(ValueError, match="search_slack"):
            tlk._bwd_init(_t(pts), tp)
        with pytest.raises(ValueError, match="search_slack"):
            jlk._bwd_init(jnp.asarray(pts), jp)
        return
    ours = tlk._bwd_init(_t(pts), tp).numpy()
    np.testing.assert_array_equal(ours, np.full((3, 2), want, np.float32))
    np.testing.assert_array_equal(ours, _jax(lambda a: jlk._bwd_init(a, jp), pts))


def test_unbounded_truncated_backward_matches_jax(flow_pair):
    """bwd_levels=1 with fwd_bwd_tol=5 and the unbounded walk: the backward
    pass starts 5 px off the round-trip target, and the tracker agrees with
    JAX's. A one-level walk from 5 px off comes back for few of the points,
    in both."""
    prev, nxt, pts = flow_pair
    K = len(pts)
    kw = dict(max_level=1, bwd_levels=1, fwd_bwd_tol=5.0, **UNBOUNDED)
    ref = _jax(lambda a, b, c: jlk.track_points(a, b, c, jnp.ones(K, bool), jlk.LKParams(**kw)),
               prev, nxt, pts)
    ours = tlk.track_points(_t(prev), _t(nxt), _t(pts), torch.ones(K, dtype=torch.bool),
                            tlk.LKParams(**kw))
    _assert_flow_close(ours, ref, 5)


# --- the coarse start -----------------------------------------------------------


def _coarse_inputs(seed=3, h=30, w=40, K=48):
    """A 2-frame ring at a coarse level's size, its first frame moved
    (2, -3) px as the search frame, and points inside, on and near the
    borders (within search + patch//2 + 1, where the reference's window
    starts clamp, and past them, where a negative start counts from the
    end), far outside and NaN."""
    rng = np.random.default_rng(seed)
    ring = np.stack([cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (3, 3), 0.8)
                     for _ in range(2)])
    nxt = np.ascontiguousarray(np.roll(ring[0], (2, -3), (0, 1)))
    pts = np.stack([rng.uniform(-4, w + 3, K), rng.uniform(-4, h + 3, K)], 1).astype(np.float32)
    pts[:10] = [[0, 0], [w - 1, h - 1], [2.5, 3.5], [1.5, h - 0.5], [-2.6, 5.0], [7.0, -3.4],
                [w + 1.6, 9.0], [-40.0, 12.0], [3.0, 2.0 * h + 30.0], [np.nan, 4.0]]
    src = (np.arange(K) % 2).astype(np.int32)
    return ring, nxt, pts, src


@pytest.mark.parametrize("search,patch", [(4, 5), (2, 3)])
def test_coarse_block_match_matches_jax(search, patch):
    ring, nxt, pts, src = _coarse_inputs()
    fin = np.isfinite(pts).all(1)
    one = _jax(jax.jit(lambda a, b, c: jlk._coarse_block_match(a, b, c, search, patch)),
               ring[0], nxt, pts)
    ours = tlk.coarse_block_match_plain(_t(ring[0]), _t(nxt), _t(pts), None, search=search,
                                        patch=patch).numpy()
    np.testing.assert_array_equal(ours[fin], one[fin])
    assert not np.isfinite(ours[~fin]).all(1).any()
    ringed = _jax(jax.jit(lambda a, b, c, d: jlk._coarse_block_match_ring(a, b, c, d, search,
                                                                          patch)),
                  ring, nxt, pts, src)
    cuda.reset_launches()
    ours = tlk.coarse_block_match(_t(ring), _t(nxt), _t(pts), _t(src), search=search,
                                  patch=patch).numpy()
    assert set(cuda.LAUNCHES.values()) == {0}
    np.testing.assert_array_equal(ours[fin], ringed[fin])
    if search >= 3:  # most inside points find the motion (-3, 2)
        inside = fin & (pts[:, 0] > 6) & (pts[:, 0] < 33) & (pts[:, 1] > 6) \
            & (pts[:, 1] < 23) & (src == 0)
        assert (np.abs(ours - pts - [-3, 2])[inside].max(1) < 1e-5).mean() > 0.8


def test_coarse_block_match_ties_and_nan():
    """Flat images tie every offset: the first (dy, dx) = (-s, -s) wins, as
    jnp.argmin takes it; a NaN in the window makes its offsets least."""
    s, p = 2, 3
    flat = np.full((1, 12, 14), 0.5, np.float32)
    pts = np.float32([[6, 6], [3.5, 2.5]])
    got = tlk.coarse_block_match_plain(_t(flat), _t(flat[0]), _t(pts), None, search=s, patch=p)
    np.testing.assert_array_equal(got.numpy(), pts - s)
    nan_next = flat[0].copy()
    nan_next[7, 8] = np.nan  # in the windows of offsets dy, dx in {0, 1, 2}, 0..3 rows below
    ref = _jax(lambda a, b, c: jlk._coarse_block_match(a, b, c, s, p), flat[0], nan_next, pts)
    got = tlk.coarse_block_match_plain(_t(flat), _t(nan_next), _t(pts), None, search=s, patch=p)
    np.testing.assert_array_equal(got.numpy(), ref)


def _true_tracks(res, pts, dx):
    flow = res.points.numpy() - pts
    return res.status.numpy() & (np.abs(flow[:, 0] - dx) < 0.1) & (np.abs(flow[:, 1]) < 0.1)


def test_coarse_init_track_points_matches_jax(far_pair):
    """A 20 px motion: the default walk loses it, the coarse start at level 2
    (search 6, patch 5) finds it, as in JAX. The backward check runs the 2
    finest levels from the round-trip target (bwd_levels): the coarse start
    seeds only the forward walk, and a backward walk over every level from
    zero motion would lose the motion again."""
    prev, nxt, pts = far_pair
    K = len(pts)
    kw = dict(max_level=2, coarse_search=6, coarse_patch=5, bwd_levels=2)
    args = (_t(prev), _t(nxt), _t(pts), torch.ones(K, dtype=torch.bool))
    assert _true_tracks(tlk.track_points(*args, tlk.LKParams(**kw)), pts, 20.0).sum() == 0
    ref = _jax(lambda a, b, c: jlk.track_points(a, b, c, jnp.ones(K, bool),
                                                jlk.LKParams(coarse_init=True, **kw)),
               prev, nxt, pts)
    ours = tlk.track_points(*args, tlk.LKParams(coarse_init=True, **kw))
    _assert_flow_close(ours, ref, 0.8 * K)
    assert _true_tracks(ours, pts, 20.0).sum() >= 0.8 * K


# --- a batch of cameras ---------------------------------------------------------


@pytest.mark.parametrize("option", [dict(coarse_init=True, coarse_search=6, coarse_patch=5,
                                         bwd_levels=2), UNBOUNDED], ids=["coarse", "unbounded"])
def test_batch_equals_each_camera(flow_pair, far_pair, option):
    """track_points on 2 cameras of unlike scenes in one call equals each
    camera's own call bit for bit; so do the twins on the folded rings."""
    cams = [flow_pair, far_pair]
    K = min(len(c[2]) for c in cams)
    prev = _t(np.stack([c[0] for c in cams]))
    nxt = _t(np.stack([c[1] for c in cams]))
    pts = _t(np.stack([c[2][:K] for c in cams]))
    p = tlk.LKParams(max_level=2, **option)
    both = tlk.track_points(prev, nxt, pts, torch.ones(2, K, dtype=torch.bool), p)
    assert both.points.shape == (2, K, 2)
    for b in range(2):
        one = tlk.track_points(prev[b], nxt[b], pts[b], torch.ones(K, dtype=torch.bool), p)
        assert torch.equal(both.points[b].nan_to_num(-1e30), one.points.nan_to_num(-1e30))
        assert torch.equal(both.status[b], one.status)
    ring = torch.stack([prev, prev.roll(1, -1)], 1)                       # (2, 2, H, W)
    src = torch.tensor([[0, 1] * (K // 2) + [0] * (K % 2)] * 2, dtype=torch.int32)
    coarse = tlk.coarse_block_match_plain(ring, nxt, pts / 4, src, search=4, patch=5)
    for b in range(2):
        assert torch.equal(coarse[b], tlk.coarse_block_match_plain(
            ring[b], nxt[b], pts[b] / 4, src[b], search=4, patch=5))


def test_coarse_wrapper_refuses_cpu_tensors():
    ring, pts, src = torch.zeros(2, 8, 16), torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.lk_coarse_match(ring, ring[0], pts, src, 4, 5)
