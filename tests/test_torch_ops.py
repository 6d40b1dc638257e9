"""Parity of the PyTorch port's ops (ocean_perception_tpu_torch.ops) with the
JAX reference (ocean_perception_tpu.ops) on the CPU.

Inputs are made with numpy from a seed and fed as float32 to both sides
(tests/conftest.py turns on JAX x64, so the JAX side gets explicit f32).

Tolerances:
- gradient magnitude: bit-exact (fma_f32 and sqrt_f32 round as XLA does).
- float32 filter stages (Sobel, pyr_down, box filter, linear resize, guided
  filter): max abs <= 1e-5. XLA's CPU backend contracts a*b + c into one
  fused multiply-add and sums matmul taps in its own order; the port rounds
  each op, so last-bit differences remain on O(1) values.
- to_grayscale, dilate, nearest resize, the percentile threshold: exact or
  <= 1e-6 (no contraction left, or sums of 0/1 values that are exact in any
  order).
- lm_solve on a well-conditioned fit: parameters within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.ops import guided_filter as jgf
from ocean_perception_tpu.ops import histogram as jhist
from ocean_perception_tpu.ops import image as jimg
from ocean_perception_tpu.ops import lm as jlm
from ocean_perception_tpu_torch.imaging import formation as tform
from ocean_perception_tpu_torch.ops import guided_filter as tgf
from ocean_perception_tpu_torch.ops import histogram as thist
from ocean_perception_tpu_torch.ops import image as timg
from ocean_perception_tpu_torch.ops import lm as tlm

F32_TOL = 1e-5


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _jax(fn, *args):
    return np.asarray(jax.jit(fn)(*args))


@pytest.mark.parametrize("name", ["sobel_x", "sobel_y", "gradient_magnitude", "pyr_down"])
@pytest.mark.parametrize("shape", [(48, 80), (37, 53)])
def test_filters_match_jax(name, shape):
    x = _img(1, shape)
    ref = _jax(getattr(jimg, name), x)
    ours = getattr(timg, name)(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    if name == "gradient_magnitude":
        # fma_f32 is XLA's contraction and sqrt_f32 rounds correctly, as XLA does.
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=F32_TOL)


def test_sqrt_f32_is_correctly_rounded():
    # torch.sqrt on a CPU float32 tensor is not (it differs from IEEE sqrt on
    # about 0.7% of such values); the float64 root rounded once is.
    rng = np.random.default_rng(14)
    v = np.concatenate([rng.random(500_000), rng.random(500_000) * 1e6]).astype(np.float32)
    np.testing.assert_array_equal(timg.sqrt_f32(torch.from_numpy(v)).numpy(), np.sqrt(v))


def test_pyr_down_tiny_images_reflect_again():
    # Images narrower than the 5-tap kernel fold the reflection more than once.
    for shape in [(1, 1), (3, 2), (4, 7)]:
        x = _img(2, shape)
        np.testing.assert_allclose(
            timg.pyr_down(torch.from_numpy(x)).numpy(), _jax(jimg.pyr_down, x), atol=F32_TOL)


def test_grayscale_is_bit_exact():
    # XLA's dot computes fma(b, .114, fma(g, .587, r * .299)); fma_f32 repeats it.
    x = _img(3, (64, 96, 3))
    np.testing.assert_array_equal(timg.to_grayscale(torch.from_numpy(x)).numpy(),
                                  _jax(jimg.to_grayscale, x))
    assert timg.compute_intensity(torch.from_numpy(x)).shape == (64, 96)


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(4)
    a, b, c = (rng.standard_normal(10_000).astype(np.float32) for _ in range(3))
    exact = (a.astype(np.float64) * b + c).astype(np.float32)  # close, may double-round
    ours = timg.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    assert (ours == exact).mean() > 0.999
    # A case where rounding to float64 first, then to float32, is wrong:
    # a*b + c = 1 + 2^-23 + 2^-24 - 2^-54 lies just below a float32 midpoint,
    # but float64 rounds it onto the midpoint, which then ties to even.
    a = np.float32(2.0**-24 * (1 + 2.0**-15))
    b = np.float32(1 - 2.0**-15)
    c = np.float32(1 + 2.0**-23)
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    got = timg.fma_f32(torch.tensor([a]), torch.tensor([b]), torch.tensor([c])).item()
    assert got == c and naive != c


@pytest.mark.parametrize("radius", [2, 8, 9, 20, 40])
def test_box_filter_matches_jax(radius):
    # Radius <= 8 is the shifted-add path, above it the cumsum path; 40 pads
    # wider than the 32-row image, where reflect-101 folds again.
    x = _img(5, (32, 96))
    ref = _jax(lambda v: jimg.box_filter(v, radius), x)
    ours = timg.box_filter(torch.from_numpy(x), radius).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_TOL)


def test_box_filter_three_channels():
    x = _img(6, (24, 40, 3))
    for radius in (3, 12):
        got = timg.box_filter(torch.from_numpy(x).movedim(-1, 0), radius).movedim(0, -1)
        np.testing.assert_allclose(got.numpy(),
                                   _jax(lambda v: jimg.box_filter(v, radius), x), atol=F32_TOL)


@pytest.mark.parametrize("ksize", [3, 7, 35])
def test_dilate_is_exact(ksize):
    x = _img(7, (40, 64))
    np.testing.assert_array_equal(timg.dilate(torch.from_numpy(x), ksize).numpy(),
                                  np.asarray(jimg.dilate(jnp.asarray(x), ksize)))


@pytest.mark.parametrize("method,src,dst", [
    ("nearest", (45, 80), (90, 160)),
    ("nearest", (720, 1280), (90, 160)),
    ("nearest", (37, 53), (8, 12)),
    ("linear", (8, 12), (64, 96)),
    ("linear", (11, 20), (90, 160)),
    ("linear", (64, 96), (8, 12)),
])
def test_resize_matches_jax(method, src, dst):
    x = _img(8, src)
    ref = np.asarray(jimg.resize(jnp.asarray(x), dst, method=method))
    ours = timg.resize(torch.from_numpy(x), dst, method=method).numpy()
    if method == "nearest":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, atol=F32_TOL)


def test_resize_unported_method_raises():
    with pytest.raises(NotImplementedError):
        timg.resize(torch.zeros(4, 4), (8, 8), method="cubic")


@pytest.mark.parametrize("percentile", [0.01, 0.2])
def test_masked_percentile_threshold(percentile):
    values = _img(9, (64, 96))
    mask = _img(10, (64, 96)) > 0.3
    ref = float(jax.jit(lambda v, m: jhist.masked_percentile_threshold(v, m, percentile))(values, mask))
    ours = float(thist.masked_percentile_threshold(torch.from_numpy(values), torch.from_numpy(mask), percentile))
    assert abs(ours - ref) <= 1e-6


@pytest.mark.parametrize("shape,radius", [((64, 96), 32), ((90, 160), 426), ((128, 192), 64)])
def test_fast_guided_filter_matches_jax(shape, radius):
    # The enhance stage's radii: W//3 rounded up to even at 64x96, 1280x720
    # (run here at its 1/8 fit resolution's shape) and 128x192.
    guide = 1.0 + 3.0 * _img(11, shape)
    target = _img(12, shape + (3,))
    ref = _jax(lambda g, t: jgf.fast_guided_filter(g, t, radius, 0.01, 8), guide, target)
    ours = tgf.fast_guided_filter(torch.from_numpy(guide), torch.from_numpy(target), radius, 0.01, 8)
    np.testing.assert_allclose(ours.numpy(), ref, atol=F32_TOL)


def _decay_problem():
    x = np.linspace(0, 4, 64).astype(np.float32)
    y = (2.0 * np.exp(-1.3 * x) + 0.5
         + np.random.default_rng(13).normal(0, 0.01, 64)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("marquardt", [False, True])
def test_lm_solve_matches_jax_on_well_conditioned_fit(marquardt):
    """y = a*exp(-b x) + c: a fit whose normal equations are well conditioned,
    so the two LM runs must land on the same parameters."""
    x, y = _decay_problem()
    p0 = np.array([1.0, 0.5, 0.0], np.float32)

    def rj_jax(p):
        e = jnp.exp(-p[1] * x)
        return p[0] * e + p[2] - y, jnp.stack([e, -p[0] * x * e, jnp.ones_like(e)], -1)

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def rj_torch(p):
        e = torch.exp(-p[..., 1:2] * xt)
        return p[..., 0:1] * e + p[..., 2:3] - yt, torch.stack(
            [e, -p[..., 0:1] * xt * e, torch.ones_like(e)], -1)

    ref = jax.jit(lambda p: jlm.lm_solve(rj_jax, p, jlm.LMConfig(max_iters=20, marquardt_diag=marquardt)))(p0)
    ours = tlm.lm_solve(rj_torch, torch.from_numpy(p0), tlm.LMConfig(max_iters=20, marquardt_diag=marquardt))
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x), rtol=1e-4)
    np.testing.assert_allclose(float(ours.error), float(ref.error), rtol=1e-4)

    # A batch of starts is the same as each start on its own.
    starts = torch.tensor([[1.0, 0.5, 0.0], [3.0, 2.0, 1.0]])
    batch = tlm.lm_solve(rj_torch, starts, tlm.LMConfig(max_iters=20, marquardt_diag=marquardt))
    for i in range(2):
        one = tlm.lm_solve(rj_torch, starts[i], tlm.LMConfig(max_iters=20, marquardt_diag=marquardt))
        np.testing.assert_allclose(batch.x[i].numpy(), one.x.numpy(), rtol=1e-6, atol=1e-7)


def test_lm_solve_singular_step_is_rejected():
    """A zero Jacobian gives a singular system and a non-finite step; the
    guard drops the step (solve_ex does not raise), as the reference does."""
    x0 = np.array([1.0, 2.0], np.float32)

    def rj_jax(p):
        return jnp.full((4,), 0.5, jnp.float32), jnp.zeros((4, 2), jnp.float32)

    def rj_torch(p):
        return torch.full((4,), 0.5), torch.zeros(4, 2)

    ref = jlm.lm_solve(rj_jax, jnp.asarray(x0), jlm.LMConfig(max_iters=3))
    ours = tlm.lm_solve(rj_torch, torch.from_numpy(x0), tlm.LMConfig(max_iters=3))
    np.testing.assert_array_equal(ours.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(ours.x.numpy(), x0)


# --- constants cached on the device -----------------------------------------


def _nearest_from_jax(m, n):
    """Source index of each nearest-resized sample: jax.image.resize of
    arange(m) to n samples."""
    src = jax.image.resize(jnp.arange(m, dtype=jnp.float32), (n,), "nearest")
    return np.asarray(src).astype(np.int64)


DEVICE_CONSTANTS = {
    # name: (the cached constant on a device, the value it must hold)
    "reflect101": (lambda dev: timg._reflect101_index(37, 4, 4, dev),
                   lambda: np.pad(np.arange(37), 4, mode="reflect")),
    "reflect101, pads wider than the image": (lambda dev: timg._reflect101_index(5, 9, 9, dev),
                                              lambda: np.pad(np.arange(5), 9, mode="reflect")),
    "nearest resize index": (lambda dev: timg._nearest_index(90, 720, dev),
                             lambda: _nearest_from_jax(90, 720)),
    "nearest resize index, downsampling": (lambda dev: timg._nearest_index(720, 90, dev),
                                           lambda: _nearest_from_jax(720, 90)),
    "linear resize index": (lambda dev: timg._linear_taps_on(360, 45, dev)[0],
                            lambda: timg._linear_taps(360, 45)[0].T),
    "linear resize weight": (lambda dev: timg._linear_taps_on(45, 360, dev)[1],
                             lambda: timg._linear_taps(45, 360)[1].T),
    "backscatter start": (tform.backscatter_start,
                          lambda: np.concatenate([tform.B_DEFAULT, tform.BETA_B_DEFAULT,
                                                  tform.JP_DEFAULT, tform.BETA_DP_DEFAULT])),
    "attenuation guesses": (tform.beta_guesses,
                            lambda: np.stack([tform.BETA_GUESS_1, tform.BETA_GUESS_2])),
}


@pytest.mark.parametrize("name", list(DEVICE_CONSTANTS))
def test_device_constants_are_cached_per_device(name):
    """Each constant is built once per device and cached there: a caller
    gets it on its own device (another device's copy first does not leak to
    it), with the uncached value, and the same tensor on every call."""
    get, want = DEVICE_CONSTANTS[name]
    cpu, meta = torch.device("cpu"), torch.device("meta")
    other = get(meta)
    assert other.device == meta
    t = get(cpu)
    assert t.device == cpu
    np.testing.assert_array_equal(t.numpy(), want())
    assert t.dtype == torch.from_numpy(np.asarray(want())).dtype
    assert get(cpu) is t and get(meta) is other


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_improve_threshold_equals_the_tensor_product(dtype):
    """improve_factor * cost(0) with the factor as a Python float equals the
    product with the factor as a 0-d tensor of the volume's dtype, bit for
    bit (the factor so rounded is exact in float32)."""
    from ocean_perception_tpu_torch.stereo import patchmatch as tpm

    C = torch.from_numpy(_img(11, (24, 40, 8)) * 3.0).to(dtype)
    p = tpm.PatchMatchParams(max_disp=8)
    want = torch.tensor(p.improve_factor, dtype=dtype) * C[..., 0]
    got = tpm._improve_threshold(C, p)
    assert got.dtype == dtype and torch.equal(got, want)


def test_sgm_step_pads_with_1e9():
    """The SGM recurrence's neighbours past either end of D are 1e9, as a
    concatenated constant gives them."""
    from ocean_perception_tpu_torch.stereo import sgm as tsgm

    prev = torch.from_numpy(_img(12, (2, 5, 7, 9)))
    c_row = torch.from_numpy(_img(13, (2, 5, 7, 9)))
    big = torch.full(prev[..., :1].shape, 1e9)
    prev_min = prev.amin(dim=-1, keepdim=True)
    up = torch.cat([big, prev[..., :-1]], dim=-1)
    down = torch.cat([prev[..., 1:], big], dim=-1)
    best = torch.minimum(torch.minimum(prev, torch.minimum(up, down) + 0.06), prev_min + 0.5)
    assert torch.equal(tsgm._sgm_step(prev, c_row, 0.06, 0.5), c_row + best - prev_min)
