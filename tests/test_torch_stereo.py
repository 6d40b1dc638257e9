"""Parity of the PyTorch port's stereo stack (ocean_perception_tpu_torch.stereo)
with the JAX reference on the CPU, where the port runs its kernels' plain
twins.

Tolerances:
- unit_noise, the cost volume (given JAX's gradient images), every
  PatchMatch stage (propagation passes, the whole left-side match, seed,
  right WTA, background and occlusion masks) and patchmatch_disparity:
  bit-exact. These stages are lookups, compares and selects, the noise scales
  are powers of two, and the cost volume's fused e-term is reproduced with
  one rounding (ops.image.fma_f32). This is the XLA path that
  test_pallas_propagate_bit_identical holds equal to the TPU's propagation
  kernel and test_pallas_fused_bit_identical to its fused match kernel.
- subpixel_refine: <= 1e-6 (float32 parabola arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.stereo import cost as jcost
from ocean_perception_tpu.stereo import patchmatch as jpm
from ocean_perception_tpu.ops import image as jimg
from ocean_perception_tpu_torch.stereo import api as tapi
from ocean_perception_tpu_torch.stereo import cost as tcost
from ocean_perception_tpu_torch.stereo import patchmatch as tpm


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

H, W, D = 48, 64, 16
BASE = dict(max_disp=D, chunks=4, chunks_y=3, iters=2, halo=5, right_wta=True)


def _t(a, dtype=None):
    """numpy/JAX array -> torch tensor (bf16 goes through float32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=dtype or a.dtype))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(21)
    canvas = rng.random((H, W + 16)).astype(np.float32)
    return canvas[:, 8 : 8 + W], canvas[:, 3 : 3 + W]  # true disparity 5


@pytest.fixture(scope="module", params=["bf16", "f32"])
def volume(request, pair):
    """JAX's gradients and volume, and the shared state for the match stages."""
    l, r = pair
    bf16 = request.param == "bf16"
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    gl = np.asarray(jax.jit(jimg.gradient_magnitude)(l))
    gr = np.asarray(jax.jit(jimg.gradient_magnitude)(r))
    C = jax.jit(lambda a, b, c, d: jcost.cost_volume(a, b, D, 0.9, c, d, dtype=jdt))(l, r, gl, gr)
    jp = jpm.PatchMatchParams(volume_bf16=bf16, **BASE)
    tp = tpm.PatchMatchParams(volume_bf16=bf16, **BASE)
    seed = jax.jit(lambda c: jpm.sparse_wta_seed(c, jp))(C)
    noise = jpm.unit_noise((H, W), jp.noise_seed)
    disp = jpm.add_foreground_noise(seed, noise, 8.0)
    cost = jax.jit(lambda c, d: jpm._full_cost_map(c, d, 1))(C, disp)
    return dict(l=l, r=r, gl=gl, gr=gr, C=C, jp=jp, tp=tp, seed=seed, noise=noise,
                disp=disp, cost=cost, dtype=torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("shape", [(48, 64), (360, 640)])
def test_unit_noise_bit_exact(shape):
    np.testing.assert_array_equal(tpm.unit_noise(shape, 123).numpy(),
                                  np.asarray(jpm.unit_noise(shape, 123)))


def test_cost_volume_bit_exact(volume):
    v = volume
    ours = tcost.cost_volume(_t(v["l"]), _t(v["r"]), D, 0.9, _t(v["gl"]), _t(v["gr"]), dtype=v["dtype"])
    assert ours.dtype == v["dtype"] and ours.shape == (H, W, D)
    np.testing.assert_array_equal(_np(ours), np.asarray(v["C"], np.float32))


def test_cost_volume_from_images(pair):
    """Without precomputed gradients the port computes its own Sobel, which
    can differ from XLA's in the last bit on a few pixels."""
    l, r = pair
    ref = np.asarray(jcost.cost_volume(jnp.asarray(l), jnp.asarray(r), D, 0.9))
    ours = tcost.cost_volume(_t(l), _t(r), D, 0.9).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _adversarial_fronts(C, seed=5):
    """Fronts on which a pass's compare flips often: disparities uniform in
    [0, D), half of them on the half-integer grid (rounding ties), and costs
    drawn from the volume's own entries at random, in its dtype."""
    rng = np.random.default_rng(seed)
    C = np.asarray(C)
    h, w, d_max = C.shape
    disp = rng.uniform(0, d_max, (h, w)).astype(np.float32)
    half = rng.random((h, w)) < 0.5
    disp[half] = np.floor(disp[half] * 2) / 2
    return disp, C.reshape(-1)[rng.integers(0, C.size, h * w)].reshape(h, w)


@pytest.mark.parametrize("fronts", ["seeded", "adversarial"])
@pytest.mark.parametrize("direction,axis", [(1, 1), (1, 0), (-1, 1), (-1, 0)])
def test_propagate_pass_bit_exact(volume, direction, axis, fronts):
    v = volume
    disp, cost = (v["disp"], v["cost"]) if fronts == "seeded" else _adversarial_fronts(v["C"])
    layout = (jpm._layout_rows if axis == 1 else jpm._layout_cols)(v["C"], v["jp"])
    ref_d, ref_c = jax.jit(
        lambda d, c: jpm._propagate(layout, d, c, direction, axis, v["jp"]))(disp, cost)
    ours_d, ours_c = tpm._propagate_plain(_t(v["C"]), _t(disp), _t(cost), direction, axis, v["tp"])
    np.testing.assert_array_equal(ours_d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(_np(ours_c), np.asarray(ref_c, np.float32))
    assert (np.asarray(ref_d) != np.asarray(disp)).any()  # the pass did something


def test_refresh_matches_noise_then_cost_map(volume):
    v = volume
    ours_d, ours_c = tpm._refresh_plain(_t(v["C"]), _t(v["seed"]), _t(v["noise"]), 8.0, 1)
    np.testing.assert_array_equal(ours_d.numpy(), np.asarray(v["disp"]))
    np.testing.assert_array_equal(_np(ours_c), np.asarray(v["cost"], np.float32))


def test_match_one_side_bit_exact(volume):
    v = volume
    ref = jax.jit(lambda c, s, n: jpm._match_one_side(c, s, n, v["jp"]))(v["C"], v["seed"], v["noise"])
    ours = tpm._match_one_side(_t(v["C"]), _t(v["seed"]), _t(v["noise"]), v["tp"])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (np.asarray(ref) > 0).mean() > 0.2


def _adversarial_seed(C, seed=6):
    """A seed and a noise image on which the match's lookups tie and clamp:
    disparities on the half-integer grid over [0, D + 4), a quarter of them 0
    (background), so past x - pr at the left edge and past D - 1; noise on
    the 1/64 grid, so that noise * 32, 16 and 8 keep the refreshed
    disparities on the half-integer grid."""
    rng = np.random.default_rng(seed)
    h, w, d_max = np.asarray(C).shape
    disp = np.floor(rng.uniform(0, d_max + 4, (h, w)) * 2).astype(np.float32) / 2
    disp[rng.random((h, w)) < 0.25] = 0
    noise = (rng.integers(-64, 64, (h, w)) / 64).astype(np.float32)
    return disp, noise


def _tie_volume(bf16: bool, seed=7):
    """A volume whose costs tie often: 4 values, so most compares meet equal
    costs, and the mask's threshold 0.8 * cost(0) falls on both sides."""
    rng = np.random.default_rng(seed)
    C = (rng.integers(1, 5, (H, W, D)) / 4).astype(np.float32)
    return jnp.asarray(C, jnp.bfloat16 if bf16 else jnp.float32)


def _carried_costs(C, seed, noise, p):
    """The plain match's (disp, cost) after each refresh and each pass."""
    out, disp = [], seed
    for it in range(p.iters):
        disp, cost = tpm._refresh_plain(C, disp, noise, p.noise_scale0 / 2.0**it, p.patch_radius)
        out.append((disp, cost))
        for direction, axis in tpm.PASSES:
            disp, cost = tpm._propagate_plain(C, disp, cost, direction, axis, p)
            out.append((disp, cost))
    return out


@pytest.mark.parametrize("inputs", ["fixture", "adversarial seed", "tie volume"])
def test_carried_cost_is_the_cost_of_the_disparity(volume, inputs):
    """The invariant the match kernel's folded mask rests on: after the
    refresh and after every pass, cost == _full_cost_map(C, disp, pr) on
    every pixel; and MaskBackground from the carried cost equals
    mask_background_plain."""
    v = volume
    C = v["C"] if inputs != "tie volume" else _tie_volume(v["dtype"] == torch.bfloat16)
    seed, noise = (v["seed"], v["noise"]) if inputs == "fixture" else _adversarial_seed(C)
    C, seed, noise = _t(C), _t(seed), _t(noise)
    states = _carried_costs(C, seed, noise, v["tp"])
    assert len(states) == 5 * v["tp"].iters
    for i, (disp, cost) in enumerate(states):
        assert torch.equal(cost, tpm._full_cost_map(C, disp, 1)), i
    disp, cost = states[-1]
    masked = tpm._mask_with_cost(C, disp, cost, v["tp"])
    assert torch.equal(masked, tpm.mask_background_plain(C, disp, v["tp"]))
    assert 0 < (masked > 0).sum() < (disp > 0).sum()  # the mask fired, and kept some


@pytest.mark.parametrize("inputs", ["adversarial seed", "tie volume"])
def test_match_plain_bit_exact_on_adversarial_inputs(volume, inputs):
    """The plain match, in the kernel's order (the refresh folded into the
    passes' fronts, the mask on the carried cost), against JAX's
    _match_one_side under jit where lookups tie and clamp."""
    v = volume
    C = v["C"] if inputs == "adversarial seed" else _tie_volume(v["dtype"] == torch.bfloat16)
    seed, noise = _adversarial_seed(C)
    ref = jax.jit(lambda c, s, n: jpm._match_one_side(c, s, n, v["jp"]))(C, seed, noise)
    ours = tpm._match_plain(_t(C), _t(C), _t(seed), _t(noise), v["tp"])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert 0 < (np.asarray(ref) > 0).mean() < 1


def test_seed_right_wta_and_masks_bit_exact(volume):
    v = volume
    jp, tp, C = v["jp"], v["tp"], _t(v["C"])
    np.testing.assert_array_equal(tpm.sparse_wta_seed(C, tp).numpy(), np.asarray(v["seed"]))
    ref_r = jax.jit(lambda c: jpm.right_wta_from_left(c, jp))(v["C"])
    ours_r = tpm.right_wta_from_left(C, tp)
    np.testing.assert_array_equal(ours_r.numpy(), np.asarray(ref_r))
    ref_m = jax.jit(lambda c, d: jpm.mask_background(c, d, jp))(v["C"], v["disp"])
    np.testing.assert_array_equal(tpm.mask_background_plain(C, _t(v["disp"]), tp).numpy(),
                                  np.asarray(ref_m))
    ref_o = jax.jit(lambda a, b: jpm.mask_occlusions(a, b, jp))(v["disp"], ref_r)
    ours_o = tpm.mask_occlusions(_t(v["disp"]), ours_r, tp)
    np.testing.assert_array_equal(ours_o.numpy(), np.asarray(ref_o))
    assert 0 < (np.asarray(ref_o) > 0).sum() < (np.asarray(v["disp"]) > 0).sum()


def test_lookups_and_subpixel_refine(volume):
    v = volume
    rng = np.random.default_rng(22)
    d_int = rng.integers(0, D, (H, W)).astype(np.int32)
    C = _t(v["C"])
    np.testing.assert_array_equal(
        _np(tcost.cost_of_disparity(C, _t(d_int))),
        np.asarray(jcost.cost_of_disparity(v["C"], jnp.asarray(d_int)), np.float32))
    vals = rng.random((H, W)).astype(np.float32)
    np.testing.assert_array_equal(
        tcost.sample_at_disparity(_t(vals), _t(d_int), D).numpy(),
        np.asarray(jcost.sample_at_disparity(jnp.asarray(vals), jnp.asarray(d_int), D)))
    ref = np.asarray(jax.jit(jcost.subpixel_refine)(v["C"], d_int))
    np.testing.assert_allclose(tcost.subpixel_refine(C, _t(d_int)).numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra", [
    dict(subpixel=False),
    dict(subpixel=True, volume_bf16=True),
    dict(subpixel=True, volume_bf16=True, chunks=5, chunks_y=None, iters=3),
])
def test_patchmatch_disparity_bit_exact(pair, extra):
    l, r = pair
    base = {**BASE, **extra}
    jp, tp = jpm.PatchMatchParams(**base), tpm.PatchMatchParams(**base)
    ref = jax.jit(lambda a, b: jpm.patchmatch_disparity(a, b, jp))(l, r)
    ours = tpm.patchmatch_disparity(_t(l), _t(r), tp)
    for field in ("left", "right", "left_raw"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert (np.asarray(ref.left) > 0).mean() > 0.1


def test_effective_chunks_and_layout():
    assert tpm._effective_chunks(640, 16) == 16
    assert tpm._effective_chunks(360, 16) == 15
    pos, valid, chunk, w = tpm._chunk_columns(360, 16, 5, 1)
    jpos, jvalid, jchunk, jw = jpm._chunk_columns(360, 16, 5, 1)
    assert (chunk, w) == (jchunk, jw) == (24, 34)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_unported_paths_raise():
    """What the port still refuses: an unknown engine or cost, and the
    strip-volume match outside right_wta + l1g + iters >= 1 (where JAX
    silently ignores its build flag)."""
    l = torch.zeros(16, 24)
    with pytest.raises(ValueError):
        tapi.estimate_disparity(l, l, engine="census")
    with pytest.raises(ValueError, match="use_strip_volumes"):
        tpm.patchmatch_disparity(l, l, tpm.PatchMatchParams(max_disp=8, right_wta=False,
                                                             use_strip_volumes=True))
    for engine in ("sgm", "wta"):
        out = tapi.estimate_disparity(l + 0.5, l + 0.5, engine=engine, max_disp=8)
        assert out.left.shape == (16, 24)
    out = tapi.estimate_disparity(l + 0.5, l + 0.5, engine="patchmatch", patchmatch_params=tpm.PatchMatchParams(
        max_disp=8, chunks=2, right_wta=True))
    assert out.left.shape == (16, 24)
