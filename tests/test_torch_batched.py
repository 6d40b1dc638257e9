"""The port's batched perception_step (B cameras in one call) on the CPU,
three ways:

- against ``jax.vmap`` of the JAX step at B=3, three scenes of different
  content and true disparity, for the configurations of
  test_torch_perception.py, at its tolerances (disparity within 1e-3 px on
  >= 99% of each camera's pixels, valid masks agreeing on >= 99%, depth
  within rtol 1e-6 where the disparities are equal);
- each camera of the batch against the port's one-camera step on that
  camera: disparity and depth bit-identical, the enhanced image within the
  enhance tolerance of test_torch_imaging.py (the median and the 99.9th
  percentile of |batched - single| within twice the one-camera
  enhancement's own change under a one-ulp change of its input);
- each batched plain twin against the stack of its one-camera results,
  bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ocean_perception_tpu.models import perception as jmodel
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.imaging.enhance import enhance_underwater
from ocean_perception_tpu_torch.models import perception as tmodel
from ocean_perception_tpu_torch.ops import histogram as thist
from ocean_perception_tpu_torch.ops.image import gradient_magnitude
from ocean_perception_tpu_torch.stereo import cost as tcost
from ocean_perception_tpu_torch.stereo import patchmatch as tpm

B = 3


def _scene(H, W, d, seed):
    """Box-smoothed random canvas, right(y, x - d) == left(y, x), tinted."""
    rng = np.random.default_rng(seed)
    canvas = rng.random((H, W + 64)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas).astype(np.float32)
    tint = np.array([0.35, 0.75, 0.9], np.float32) * np.float32(0.8 + 0.1 * seed)
    left = np.clip(canvas[:, 32 : 32 + W, None] * tint + 0.05, 0, 1)
    right = np.clip(canvas[:, 32 + d : 32 + d + W, None] * tint + 0.05, 0, 1)
    return left.astype(np.float32), right.astype(np.float32)


# name: (H, W, the cameras' true disparities, JAX config); scan_unroll=1
# keeps the JAX compiles short.
CASES = {
    "entry": (64, 96, (4, 6, 3), jmodel.PerceptionConfig(
        engine="patchmatch", max_disp=32, internal_scale=1, scan_unroll=1)),
    "half_res": (128, 192, (8, 5, 11), jmodel.PerceptionConfig(
        engine="patchmatch", max_disp=32, internal_scale=2, scan_unroll=1)),
    "strip_volumes": (48, 64, (5, 3, 7), jmodel.PerceptionConfig(
        engine="patchmatch", max_disp=16, internal_scale=1, chunks=4, scan_unroll=1,
        use_pallas_build=True, run_enhance=False)),
    "sgm": (128, 192, (8, 5, 11), jmodel.PerceptionConfig(
        engine="sgm", max_disp=32, internal_scale=2, scan_unroll=1, run_enhance=False)),
    "wta": (128, 192, (8, 5, 11), jmodel.PerceptionConfig(
        engine="wta", max_disp=32, internal_scale=2, run_enhance=False)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    H, W, disparities, cfg = CASES[request.param]
    pairs = [_scene(H, W, d, seed) for seed, d in enumerate(disparities)]
    left, right = np.stack([l for l, _ in pairs]), np.stack([r for _, r in pairs])
    rig = graft._rig(H, W)
    ref = jax.jit(jax.vmap(lambda a, b: jmodel.perception_step(a, b, rig, cfg)))(left, right)
    trig, tcfg = convert.stereo_camera_from_jax(rig), convert.perception_config_from_jax(cfg)
    ours = tmodel.perception_step(torch.from_numpy(left), torch.from_numpy(right), trig, tcfg,
                                  device="cpu")
    singles = [tmodel.perception_step(torch.from_numpy(left[b]), torch.from_numpy(right[b]), trig,
                                      tcfg, device="cpu") for b in range(B)]
    nudged = [enhance_underwater(torch.from_numpy(left[b] * np.float32(1 + 2.0**-23)),
                                 singles[b].depth, tcfg.enhance)[0] if tcfg.run_enhance else None
              for b in range(B)]
    return dict(ref=[np.asarray(x) for x in ref], ours=ours, singles=singles, nudged=nudged,
                H=H, W=W)


def test_batched_disparity_matches_jax_vmap(case):
    dj, dt = case["ref"][0], case["ours"].disparity.numpy()
    assert dt.shape == dj.shape == (B, case["H"], case["W"])
    for b in range(B):
        assert (np.abs(dt[b] - dj[b]) <= 1e-3).mean() >= 0.99, b
        assert ((dt[b] > 0) == (dj[b] > 0)).mean() >= 0.99, b
        assert (dj[b] > 0).mean() > 0.2, b


def test_batched_depth_matches_jax_vmap(case):
    (dj, zj, _), ours = case["ref"], case["ours"]
    dt, zt, et = (x.numpy() for x in ours)
    same = dt == dj
    np.testing.assert_allclose(zt[same], zj[same], rtol=1e-6)
    for b in range(B):
        assert ((zt[b] > 0) == (zj[b] > 0)).mean() >= 0.99, b
    assert et.shape == (B, case["H"], case["W"], 3) and np.isfinite(et).all()


def test_batched_cameras_equal_single_camera_steps(case):
    ours = case["ours"]
    for b, (one, nudged) in enumerate(zip(case["singles"], case["nudged"])):
        assert torch.equal(ours.disparity[b], one.disparity), b
        assert torch.equal(ours.depth[b], one.depth), b
        if nudged is None:
            assert torch.equal(ours.enhanced_left[b], one.enhanced_left), b
            continue
        diff = (ours.enhanced_left[b] - one.enhanced_left).abs().numpy()
        spread = (nudged - one.enhanced_left).abs().numpy()
        assert np.median(diff) <= 2.0 * np.median(spread), b
        assert np.quantile(diff, 0.999) <= 2.0 * np.quantile(spread, 0.999), b


# --- batched plain twins -----------------------------------------------------


@pytest.fixture(scope="module")
def pairs():
    """3 half-resolution gray pairs of different scenes, (3, 40, 64), and
    their gradients."""
    ls, rs = [], []
    for seed, d in enumerate((3, 5, 2)):
        l, r = _scene(40, 64, d, seed + 10)
        ls.append(l.mean(-1))
        rs.append(r.mean(-1))
    l, r = torch.from_numpy(np.stack(ls)), torch.from_numpy(np.stack(rs))
    return l, r, gradient_magnitude(l), gradient_magnitude(r)


def _stacked(fn, *batched):
    """fn on each camera of the batched arguments, stacked (a tuple of
    outputs stacked output by output)."""
    outs = [fn(*(a[b] for a in batched)) for b in range(batched[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cost_volume_plain_batch(pairs, dtype):
    def fn(l, r, gl, gr):
        return tcost.cost_volume_plain(l, r, 16, 0.9, gl, gr, dtype)
    assert _equal(fn(*pairs), _stacked(fn, *pairs))


@pytest.mark.parametrize("chunks_y", [None, 3])
def test_build_strip_volumes_plain_batch(pairs, chunks_y):
    def fn(l, r, gl, gr):
        return tcost.build_strip_volumes_plain(l, r, gl, gr, 16, 0.9, 4, chunks_y, torch.bfloat16)
    got = fn(*pairs)
    assert got[0].shape[0] == got[1].shape[0] == B
    assert _equal(got, _stacked(fn, *pairs))
    C = tcost.cost_volume_plain(*pairs[:2], 16, 0.9, *pairs[2:], torch.bfloat16)
    assert torch.equal(tcost.volume_from_row_strips(got[0]), C)
    assert torch.equal(tcost.volume_from_col_strips(got[1]), C)


@pytest.mark.parametrize("seeding", ["path", "adversarial"])
def test_match_plain_batch(pairs, seeding):
    """_match_plain on the batch (one noise image for all cameras) against
    each camera's match, on the path's seeds and on seeds whose lookups tie
    and clamp and whose mask fires."""
    p = tpm.PatchMatchParams(max_disp=16, chunks=4, chunks_y=3, iters=2)
    C = tcost.cost_volume_plain(*pairs[:2], 16, 0.9, *pairs[2:], torch.bfloat16)
    noise = tpm.unit_noise(C.shape[1:3], p.noise_seed)
    if seeding == "path":
        seed = tpm.sparse_wta_seed(C, p)
    else:
        rng = np.random.default_rng(5)
        d = np.floor(rng.uniform(0, 20, C.shape[:3]) * 2).astype(np.float32) / 2
        d[rng.random(C.shape[:3]) < 0.25] = 0
        seed = torch.from_numpy(d)
    got = tpm._match_plain(C, C, seed, noise, p)
    assert _equal(got, _stacked(lambda c, s: tpm._match_plain(c, c, s, noise, p), C, seed))
    assert 0 < (got > 0).float().mean() < 1


def test_masked_percentile_threshold_batch(pairs):
    """One threshold a camera: the batch's cameras have unlike brightness
    and masks, so a threshold over the whole batch would differ."""
    values = pairs[0] * torch.tensor([1.0, 0.5, 2.0])[:, None, None]
    mask = pairs[1] > torch.tensor([0.3, 0.5, 0.6])[:, None, None]
    got = thist.masked_percentile_threshold(values, mask, 0.05)
    assert got.shape == (B,)
    assert _equal(got, _stacked(lambda v, m: thist.masked_percentile_threshold(v, m, 0.05),
                                values, mask))
    assert len(set(got.tolist())) == B


@pytest.mark.parametrize("extra", [dict(right_wta=False), dict(right_wta=True, cost="zncc"),
                                   dict(right_wta=True, use_strip_volumes=True)],
                         ids=["two-sided", "zncc", "strips"])
def test_patchmatch_disparity_batch(pairs, extra):
    """The PatchMatch configurations perception_step does not reach (two
    sides matched, the ZNCC cost) and the strip layouts, on the batch:
    each camera's left, right and raw maps equal its own call's."""
    p = tpm.PatchMatchParams(max_disp=16, chunks=4, **extra)
    got = tpm.patchmatch_disparity(pairs[0], pairs[1], p)
    assert _equal(tuple(got), _stacked(lambda l, r: tuple(tpm.patchmatch_disparity(l, r, p)),
                                       pairs[0], pairs[1]))
    assert (got.left > 0).float().mean() > 0.05
