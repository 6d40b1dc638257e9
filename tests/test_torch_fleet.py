"""The port's fleet frontend on the CPU: ``full_frontend_step`` on B cameras
in one call, and the one-card ``parallel/sharded_pipeline.py`` forms.

Scenes: two box-smoothed random canvases from numpy seeds 0 and 7 at
64x96, moving -2 and -1 px a frame, each with an 8 px stereo disparity, over
4 frames; the tracker of test_torch_frontend.py (K=32 slots, 2 pyramid
levels, the stripe matcher at max_disp=24), PatchMatch at full resolution
without enhancement. JAX runs with x64 off, as in production.

- (a) the batched port call against a jitted ``jax.vmap`` of the JAX
  ``full_frontend_step``, at test_torch_frontend.py's tolerances: the
  disparity map within 1e-3 px on >= 99% of each camera's pixels; ids,
  keyframe flags and the alive set equal; pixels within 1e-3 px; stripe
  disparities, labels, sizes and graph weights equal;
- (b) each camera of the batched call equal to its one-camera port call,
  bit for bit on every output, state and graph;
- (c) a camera that sees blank (untextured) frames leaves the other
  camera's outputs bit-identical: a reduction across cameras would not;
- (d) ``multi_camera_frontend_step`` on uint8 mono frames equal, bit for
  bit, to the float RGB call on x / 255 broadcast to 3 channels;
- (e) ``multi_camera_step``'s FleetStats against JAX's ``multi_camera_step``
  on a one-device CPU mesh, within 1e-6 relative (two float32 sums over a
  camera's pixels in different orders);
- (f) ``lk_track_plain`` with the camera folded into the ring, equal bit for
  bit to per-camera calls, the steps a level included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ocean_perception_tpu.core import cameras as jcam
from ocean_perception_tpu.mesher import object_mesher as jom
from ocean_perception_tpu.models import perception as jmodel
from ocean_perception_tpu.parallel import sharded_pipeline as jsp
from ocean_perception_tpu.tracking import DetectorParams, LKParams, StripeMatcherParams
from ocean_perception_tpu.tracking.stereo_tracker import StereoTrackerParams
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.mesher.landmark_graph import LandmarkGraph
from ocean_perception_tpu_torch.models import perception as tmodel
from ocean_perception_tpu_torch.ops.image import to_grayscale
from ocean_perception_tpu_torch.parallel import sharded_pipeline as tsp
from ocean_perception_tpu_torch.tracking import lk as tlk
from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerState


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

H, W, K, N, B = 64, 96, 32, 4, 2
SCENES = ((0, 2), (7, 1))  # (canvas seed, px a frame)


def _canvas(seed):
    rng = np.random.default_rng(seed)
    canvas = rng.random((H, W + 64)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    return np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)


def _sequence(seed, shift):
    """N (left, right) RGB frames of one camera."""
    canvas = _canvas(seed)
    tint = np.array([0.35, 0.75, 0.9], np.float32)

    def rgb(x0):
        return np.clip(canvas[:, x0:x0 + W, None] * tint + 0.05, 0, 1).astype(np.float32)

    return [(rgb(16 + shift * i), rgb(24 + shift * i)) for i in range(N)]


def _batch(seqs):
    """Frame by frame, the (B, H, W, 3) left and right stacks."""
    return [(np.stack([s[i][0] for s in seqs]), np.stack([s[i][1] for s in seqs]))
            for i in range(len(seqs[0]))]


def _configs():
    cam = jcam.PinholeCamera.create(80.0, 80.0, W / 2, H / 2, H, W)
    rig = jcam.StereoCamera.create(cam, cam, baseline=0.12)
    cfg = jmodel.PerceptionConfig(engine="patchmatch", max_disp=32, internal_scale=1,
                                  run_enhance=False, chunks=4, scan_unroll=1)
    mp = jom.ObjectMesherDeviceParams(
        tracker=StereoTrackerParams(
            capacity=K, trigger_keyframe_k=3,
            detector=DetectorParams(max_features=K, min_distance=10, border=8),
            lk=LKParams(max_level=1, corr_iters=True, pallas_iters=False, fused_lk=False),
            matcher=StripeMatcherParams(max_disp=24, templ_cols=15, templ_rows=11)),
        neighbor_radius_px=40.0, min_obs_connect_edge=2.0, min_obs_disconnect_edge=2.0)
    return rig, cfg, mp


def _run_port(frames, state, graph, rig, cfg, mp):
    """The port's frontend over frames ((..., H, W, 3) pairs) from one
    state; returns each frame's output."""
    prev = to_grayscale(torch.from_numpy(frames[0][0]))
    outs = []
    for left, right in frames:
        out, prev = tmodel.full_frontend_step(state, graph, prev, torch.from_numpy(left),
                                              torch.from_numpy(right), rig, cfg, mp,
                                              device="cpu")
        state, graph = out.tracker_state, out.graph
        outs.append(out)
    return outs


def _leaves(obj, name="out"):
    """(name, tensor) for every tensor of a nested output."""
    if isinstance(obj, torch.Tensor):
        return [(name, obj)]
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name), f"{name}.{f.name}")]
    if hasattr(obj, "_fields"):
        return [x for f in obj._fields for x in _leaves(getattr(obj, f), f"{name}.{f}")]
    return [x for i, o in enumerate(obj) for x in _leaves(o, f"{name}[{i}]")]


def _require_camera_equal(batched, b, single):
    """Camera b of a batched output equal to a one-camera output, bit for
    bit on every tensor."""
    got, want = _leaves(batched), _leaves(single)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, x), (_, y) in zip(got, want):
        assert x[b].shape == y.shape and x[b].dtype == y.dtype, name
        assert torch.equal(x[b].nan_to_num(-7.0), y.nan_to_num(-7.0)), name


@pytest.fixture(scope="module")
def fleet():
    jrig, jcfg, jmp = _configs()
    seqs = [_sequence(*s) for s in SCENES]
    frames = _batch(seqs)

    ref = []
    with jax.enable_x64(False):
        states, graphs = jsp.create_fleet_frontend_state(B, jmp, image_shape=(H, W))
        step = jax.jit(jax.vmap(lambda s, g, p, l, r: jmodel.full_frontend_step(
            s, g, p, l, r, jrig, jcfg, jmp)))
        prev = jax.vmap(jmodel.to_grayscale)(jnp.asarray(frames[0][0]))
        st, gr = states, graphs
        for left, right in frames:
            out, prev = step(st, gr, prev, jnp.asarray(left), jnp.asarray(right))
            st, gr = out.tracker_state, out.graph
            ref.append(jax.tree_util.tree_map(np.asarray, out))
        one_state = jax.tree_util.tree_map(lambda x: x[0], states)
        one_graph = jax.tree_util.tree_map(lambda x: x[0], graphs)

    rig, cfg = convert.stereo_camera_from_jax(jrig), convert.perception_config_from_jax(jcfg)
    mp = convert.object_mesher_device_params_from_jax(jmp)
    state = convert.stereo_tracker_state_from_jax(states)
    graph = convert.landmark_graph_from_jax(graphs)
    ours = _run_port(frames, state, graph, rig, cfg, mp)
    singles = [_run_port(seq, convert.stereo_tracker_state_from_jax(one_state),
                         convert.landmark_graph_from_jax(one_graph), rig, cfg, mp)
               for seq in seqs]
    return dict(ref=ref, ours=ours, singles=singles, seqs=seqs, rig=rig, cfg=cfg, mp=mp,
                jrig=jrig, jcfg=jcfg, jmp=jmp)


def test_fleet_state_converts_with_its_camera_axis(fleet):
    """The JAX fleet state converts to the port's batched state, equal to
    the port's own create_fleet_frontend_state."""
    with jax.enable_x64(False):
        states, graphs = jsp.create_fleet_frontend_state(B, fleet["jmp"], image_shape=(H, W))
    got = (convert.stereo_tracker_state_from_jax(states), convert.landmark_graph_from_jax(graphs))
    want = tsp.create_fleet_frontend_state(B, fleet["mp"], image_shape=(H, W), device="cpu")
    for (name, x), (_, y) in zip(_leaves(got), _leaves(want)):
        assert x.shape[0] == B and x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("i", range(N))
def test_batched_frontend_matches_jax_vmap(fleet, i):
    ref, ours = fleet["ref"][i], fleet["ours"][i]
    dj, dt = ref.perception.disparity, ours.perception.disparity.numpy()
    assert dt.shape == dj.shape == (B, H, W)
    jt, tt = ref.tracker_state.table, ours.tracker_state.table
    jm, tm = ref.mesher, ours.mesher
    for b in range(B):
        assert (np.abs(dt[b] - dj[b]) <= 1e-3).mean() >= 0.99, b
    np.testing.assert_array_equal(tt.ids.numpy(), jt.ids)
    np.testing.assert_array_equal(tt.missed.numpy(), jt.missed)
    np.testing.assert_allclose(tt.pixels.numpy(), jt.pixels, atol=1e-3)
    np.testing.assert_array_equal(tt.disparities.numpy(), jt.disparities)
    np.testing.assert_array_equal(ours.tracker_state.next_lmk_id.numpy(),
                                  ref.tracker_state.next_lmk_id)
    np.testing.assert_array_equal(tm.is_keyframe.numpy(), jm.is_keyframe)
    for name in ("alive", "labels", "sizes", "foreground"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(ours.graph.weights.numpy(), ref.graph.weights)
    # The cameras are unlike: their tracks and clusters differ.
    assert not torch.equal(tt.pixels[0], tt.pixels[1])


@pytest.mark.parametrize("i", range(N))
def test_batched_cameras_equal_one_camera_calls(fleet, i):
    for b in range(B):
        _require_camera_equal(fleet["ours"][i], b, fleet["singles"][b][i])


def test_batched_sequence_tracks_each_cameras_motion(fleet):
    """Each camera's landmarks move its own -shift px a frame; both
    cameras hold a cluster that meshes."""
    from ocean_perception_tpu_torch.mesher.object_mesher import MesherDeviceOutput, build_meshes

    ours = fleet["ours"]
    for b, (_, shift) in enumerate(SCENES):
        errs = []
        for a_out, b_out in zip(ours[:-1], ours[1:]):
            ta, tb = a_out.tracker_state.table, b_out.tracker_state.table
            same = (ta.ids[b] >= 0) & (ta.ids[b] == tb.ids[b]) & (tb.missed[b] == 0)
            moved = tb.pixels[b][same] - ta.pixels[b][same]
            moved[:, 0] += shift * (ta.missed[b][same].float() + 1)
            errs.append(moved.abs().max(dim=1).values)
        errs = torch.cat(errs)
        assert len(errs) >= 3 * 15 and float(errs.median()) < 0.01, b
        last = MesherDeviceOutput(*(t[b] for t in ours[-1].mesher))
        assert int(last.sizes.max()) >= 3, b
        assert build_meshes(last, fleet["rig"]).num_triangles > 0, b


@pytest.mark.parametrize("option", ["bwd_levels", "zncc_gate", "subpixel", "full_res_gate",
                                    "no_ring"])
def test_batched_options_equal_one_camera_calls(fleet, option):
    """The tracker's and mesher's other paths on the batch: the truncated
    backward walk and the ZNCC gate (the appearance gate folds the cameras
    into its ring), subpixel corners and stripe matches, the bilinear edge
    gate on the full-resolution mask, and tracking without a ring; each
    camera equal to its one-camera call bit for bit over 3 frames."""
    mp = fleet["mp"]
    tracker = mp.tracker
    if option in ("bwd_levels", "zncc_gate"):
        lk = dataclasses.replace(tracker.lk, **{option: 1 if option == "bwd_levels" else True})
        mp = dataclasses.replace(mp, tracker=dataclasses.replace(tracker, lk=lk))
    elif option == "subpixel":
        mp = dataclasses.replace(mp, tracker=dataclasses.replace(
            tracker, detector=dataclasses.replace(tracker.detector, subpixel=True),
            matcher=dataclasses.replace(tracker.matcher, subpixel=True)))
    elif option == "full_res_gate":
        mp = dataclasses.replace(mp, fg_downsample=1)
    shape = None if option == "no_ring" else (H, W)
    seqs = [s[:3] for s in fleet["seqs"]]
    state, graph = tsp.create_fleet_frontend_state(B, mp, image_shape=shape, device="cpu")
    outs = _run_port(_batch(seqs), state, graph, fleet["rig"], fleet["cfg"], mp)
    for b, seq in enumerate(seqs):
        singles = _run_port(seq, StereoTrackerState.create(mp.tracker, image_shape=shape),
                            LandmarkGraph.create(K), fleet["rig"], fleet["cfg"], mp)
        for out, single in zip(outs, singles):
            _require_camera_equal(out, b, single)
    assert int(outs[-1].mesher.alive.sum(-1).min()) > 0


def test_blank_camera_leaves_the_other_bit_identical(fleet):
    """Camera 1 sees its scene for two frames, then blank frames (no corner,
    no texture, no match): camera 0 stays equal to its one-camera run."""
    seq0, seq1 = fleet["seqs"]
    blank = np.full((H, W, 3), 0.5, np.float32)
    seq1 = seq1[:2] + [(blank, blank)] * (N - 2)
    state, graph = tsp.create_fleet_frontend_state(B, fleet["mp"], image_shape=(H, W),
                                                   device="cpu")
    outs = _run_port(_batch([seq0, seq1]), state, graph, fleet["rig"], fleet["cfg"],
                     fleet["mp"])
    for i, out in enumerate(outs):
        _require_camera_equal(out, 0, fleet["singles"][0][i])
    table = outs[-1].tracker_state.table
    # On blank frames camera 1 tracks nothing: every landmark it keeps missed.
    assert bool((table.missed[1][table.ids[1] >= 0] > 0).all())
    assert int(outs[-1].mesher.alive[0].sum()) > 0


def test_u8_mono_frames_equal_the_float_rgb_call(fleet):
    """multi_camera_frontend_step casts uint8 to float32 / 255 and
    broadcasts mono to three channels on the device: bit for bit the float
    RGB call on x / 255 (numpy's float32 division) broadcast to 3."""
    canvases = [_canvas(s) for s, _ in SCENES]
    u8 = [(np.stack([(c[:, 16 + i:16 + i + W] * 255).astype(np.uint8) for c in canvases]),
           np.stack([(c[:, 24 + i:24 + i + W] * 255).astype(np.uint8) for c in canvases]))
          for i in range(2)]

    def f32(x):
        return np.repeat((x.astype(np.float32) / np.float32(255.0))[..., None], 3, -1)

    rig, cfg, mp = fleet["rig"], fleet["cfg"], fleet["mp"]
    runs = []
    for frames in (u8, [(f32(l), f32(r)) for l, r in u8]):
        state, graph = tsp.create_fleet_frontend_state(B, mp, image_shape=(H, W), device="cpu")
        prev = to_grayscale(tsp.prepare_frames(frames[0][0], "cpu"))
        outs = []
        for left, right in frames:
            out, prev = tsp.multi_camera_frontend_step(state, graph, prev, left, right, rig, cfg,
                                                       mp, device="cpu")
            state, graph = out.tracker_state, out.graph
            outs.append((out, prev))
        runs.append(outs)
    for got, want in zip(*runs):
        for (name, x), (_, y) in zip(_leaves(got), _leaves(want)):
            assert x.dtype == y.dtype and torch.equal(x.nan_to_num(-7.0),
                                                      y.nan_to_num(-7.0)), name
    assert int(runs[0][-1][0].mesher.alive.sum()) > 0


def test_fleet_stats_match_jax_multi_camera_step(fleet):
    """multi_camera_step on the CPU against JAX's on a one-device mesh: the
    disparity as in (a), the FleetStats within 1e-6 relative."""
    frames = _batch(fleet["seqs"])[0]
    mesh = Mesh(np.array(jax.devices()[:1]), ("cam",))
    with jax.enable_x64(False):
        jcfg = dataclasses.replace(fleet["jcfg"], scan_unroll=1)
        jout, jstats = jsp.multi_camera_step(jnp.asarray(frames[0]), jnp.asarray(frames[1]),
                                             fleet["jrig"], jcfg, mesh)
        jout, jstats = jax.tree_util.tree_map(np.asarray, (jout, jstats))
    out, stats = tsp.multi_camera_step(frames[0], frames[1], fleet["rig"], fleet["cfg"],
                                       device="cpu")
    for b in range(B):
        assert (np.abs(out.disparity[b].numpy() - jout.disparity[b]) <= 1e-3).mean() >= 0.99
    assert stats.mean_depth.shape == stats.valid_fraction.shape == (B,)
    for name in ("mean_depth", "valid_fraction", "global_mean_depth"):
        np.testing.assert_allclose(getattr(stats, name).numpy(), getattr(jstats, name),
                                   rtol=1e-6, err_msg=name)
    assert (stats.valid_fraction > 0.5).all()


def test_fleet_stats_weight_by_valid_counts():
    """A blind camera (no valid pixel) does not drag the fleet mean to 0."""
    depth = torch.zeros(3, 4, 5)
    depth[0, :2] = 2.0   # 10 valid pixels at 2 m
    depth[2, :, :1] = 5.0  # 4 valid at 5 m; camera 1 blind
    stats = tsp.fleet_stats(depth)
    assert stats.mean_depth.tolist() == [2.0, 0.0, 5.0]
    assert stats.valid_fraction.tolist() == pytest.approx([0.5, 0.0, 0.2], rel=1e-6)
    assert float(stats.global_mean_depth) == pytest.approx((20.0 + 20.0) / 14.0, rel=1e-6)


@pytest.mark.parametrize("wins", [[15, 9], [21, None, 7]], ids=["15-9", "21-skip-7"])
def test_lk_track_plain_folds_cameras_into_the_ring(wins):
    """lk_track_plain on B=3 cameras (rings of 3 frames against one search
    frame, unlike content, each camera its own points and frames, frame
    indices past the ring clamped) equals its per-camera calls, the
    Gauss-Newton steps included, in both directions."""
    rng = np.random.default_rng(12)
    levels = len(wins)
    ring = rng.random((3, 3, 48, 64)).astype(np.float32)
    cur = np.roll(ring[:, :1], (1, -2), (2, 3)) * 0.5 + 0.25
    rings, curs = [torch.from_numpy(ring)], [torch.from_numpy(cur[:, 0])]
    for _ in range(levels - 1):
        rings.append(rings[-1][..., ::2, ::2].contiguous())
        curs.append(curs[-1][..., ::2, ::2].contiguous())
    Kp = 9
    pts = torch.from_numpy(np.stack([rng.uniform(-3, 67, (3, Kp)), rng.uniform(-3, 51, (3, Kp))],
                                    -1).astype(np.float32))
    pts[1, 0] = float("nan")
    src = torch.from_numpy(rng.integers(-1, 5, (3, Kp)).astype(np.int32))
    kw = dict(wins=wins, slack=4, pad=12, min_eig_threshold=1.5e-9, max_iters=30, eps=0.01)
    zero = torch.zeros_like(src)
    one = [r[:, None] for r in curs]  # the search frame as a ring of one
    for tmpl, srch, st, ss, init in ((rings, one, src, zero, pts + 1.25),
                                     (one, rings, zero, src, pts)):
        steps = []
        got = tlk.lk_track_plain(tmpl, srch, pts, init, st, ss, steps=steps, **kw)
        assert got[0].shape == (3, Kp, 2) and got[1].shape == (3, Kp)
        for b in range(3):
            steps_b = []
            want = tlk.lk_track_plain([t[b] for t in tmpl], [s[b] for s in srch], pts[b],
                                      init[b], st[b], ss[b], steps=steps_b, **kw)
            assert torch.equal(got[0][b].nan_to_num(-7.0), want[0].nan_to_num(-7.0)), b
            assert torch.equal(got[1][b], want[1]), b
            assert [lvl for lvl, _ in steps] == [lvl for lvl, _ in steps_b]
            for (_, s_all), (_, s_b) in zip(steps, steps_b):
                assert torch.equal(s_all[b], s_b), b
        assert 0 < int(got[1].sum()) < got[1].numel()


def test_batched_frontend_refuses_a_mismatched_state(fleet):
    left, right = _batch(fleet["seqs"])[0]
    state, graph = tsp.create_fleet_frontend_state(3, fleet["mp"], image_shape=(H, W),
                                                   device="cpu")
    with pytest.raises(ValueError, match="batch"):
        tmodel.full_frontend_step(state, graph, to_grayscale(torch.from_numpy(left)),
                                  torch.from_numpy(left), torch.from_numpy(right), fleet["rig"],
                                  fleet["cfg"], fleet["mp"], device="cpu")
