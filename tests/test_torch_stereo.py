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


@pytest.mark.parametrize("direction,axis", [(1, 1), (1, 0), (-1, 1), (-1, 0)])
def test_propagate_pass_bit_exact(volume, direction, axis):
    v = volume
    layout = (jpm._layout_rows if axis == 1 else jpm._layout_cols)(v["C"], v["jp"])
    ref_d, ref_c = jax.jit(
        lambda d, c: jpm._propagate(layout, d, c, direction, axis, v["jp"]))(v["disp"], v["cost"])
    ours_d, ours_c = tpm._propagate(_t(v["C"]), _t(v["disp"]), _t(v["cost"]), direction, axis, v["tp"])
    np.testing.assert_array_equal(ours_d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(_np(ours_c), np.asarray(ref_c, np.float32))
    assert (np.asarray(ref_d) != np.asarray(v["disp"])).any()  # the pass did something


def test_refresh_matches_noise_then_cost_map(volume):
    v = volume
    ours_d, ours_c = tpm._refresh(_t(v["C"]), _t(v["seed"]), _t(v["noise"]), 8.0, 1)
    np.testing.assert_array_equal(ours_d.numpy(), np.asarray(v["disp"]))
    np.testing.assert_array_equal(_np(ours_c), np.asarray(v["cost"], np.float32))


def test_match_one_side_bit_exact(volume):
    v = volume
    ref = jax.jit(lambda c, s, n: jpm._match_one_side(c, s, n, v["jp"]))(v["C"], v["seed"], v["noise"])
    ours = tpm._match_one_side(_t(v["C"]), _t(v["seed"]), _t(v["noise"]), v["tp"])
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (np.asarray(ref) > 0).mean() > 0.2


def test_seed_right_wta_and_masks_bit_exact(volume):
    v = volume
    jp, tp, C = v["jp"], v["tp"], _t(v["C"])
    np.testing.assert_array_equal(tpm.sparse_wta_seed(C, tp).numpy(), np.asarray(v["seed"]))
    ref_r = jax.jit(lambda c: jpm.right_wta_from_left(c, jp))(v["C"])
    ours_r = tpm.right_wta_from_left(C, tp)
    np.testing.assert_array_equal(ours_r.numpy(), np.asarray(ref_r))
    ref_m = jax.jit(lambda c, d: jpm.mask_background(c, d, jp))(v["C"], v["disp"])
    np.testing.assert_array_equal(tpm.mask_background(C, _t(v["disp"]), tp).numpy(), np.asarray(ref_m))
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
    l = torch.zeros(16, 24)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tpm.patchmatch_disparity(l, l, tpm.PatchMatchParams(max_disp=8, right_wta=False))
    for engine in ("sgm", "wta"):
        with pytest.raises(NotImplementedError, match="slice 3"):
            tapi.estimate_disparity(l, l, engine=engine)
    out = tapi.estimate_disparity(l + 0.5, l + 0.5, engine="patchmatch", patchmatch_params=tpm.PatchMatchParams(
        max_disp=8, chunks=2, right_wta=True))
    assert out.left.shape == (16, 24)
