"""The port's image normalization (ocean_perception_tpu_torch.imaging.normalization),
Gaussian blur and EnhanceSequence against the JAX reference on the CPU.

Tolerances:
- gaussian_kernel1d: equal (the same numpy arithmetic).
- the normalization functions and gaussian_blur: 1e-6 absolute on [0, 1]
  images (XLA fuses the blur's and the stretches' multiply-adds, the port
  rounds each product; the gamma maps' pow differs in the last ulp).
- a batch of images equals the stack of its images' results exactly: no
  statistic may mix two images of a batch.
- EnhanceSequence over 3 frames: the enhance tolerance of
  test_torch_imaging.py (the median and the 99.9th percentile of |port -
  JAX| within twice the reference's own change under a one-ulp change of
  its input; its LM fits are ill-conditioned).
- its guess rule: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.imaging import enhance as jenh
from ocean_perception_tpu.imaging import formation as jform
from ocean_perception_tpu.imaging import normalization as jnorm
from ocean_perception_tpu.ops import image as jimg
from ocean_perception_tpu_torch.imaging import enhance as tenh
from ocean_perception_tpu_torch.imaging import normalization as tnorm
from ocean_perception_tpu_torch.ops import image as timg

TOL = 1e-6
H, W = 48, 64


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax(fn, *args):
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


# name: (JAX function, port function, input shape); every one a map of one image.
FUNCTIONS = {
    "normalize_unit gray": (jnorm.normalize_unit, tnorm.normalize_unit, (H, W)),
    "normalize_unit colour": (jnorm.normalize_unit,
                              lambda x: tnorm.normalize_unit(x, channels=True), (H, W, 3)),
    "enhance_contrast": (jnorm.enhance_contrast,
                         lambda x: tnorm.enhance_contrast(x, channels=True), (H, W, 3)),
    "enhance_contrast_factor": (lambda x: jnorm.enhance_contrast_factor(x, 1.7),
                                lambda x: tnorm.enhance_contrast_factor(x, 1.7), (H, W, 3)),
    "enhance_contrast_clip": (lambda x: jnorm.enhance_contrast_clip(x, 0.2, 0.7),
                              lambda x: tnorm.enhance_contrast_clip(x, 0.2, 0.7), (H, W, 3)),
    "white_balance_simple": (jnorm.white_balance_simple, tnorm.white_balance_simple, (H, W, 3)),
    "correct_color_ratio": (jnorm.correct_color_ratio, tnorm.correct_color_ratio, (H, W, 3)),
    "linear_to_gamma": (jnorm.linear_to_gamma, tnorm.linear_to_gamma, (H, W, 3)),
    "gamma_to_linear": (jnorm.gamma_to_linear, tnorm.gamma_to_linear, (H, W, 3)),
    "normalize_color_illuminant": (lambda x: jnorm.normalize_color_illuminant(x, 5.0),
                                   lambda x: tnorm.normalize_color_illuminant(x, 5.0), (H, W, 3)),
    "sharpen": (lambda x: jnorm.sharpen(x, 0.8, 1.5), lambda x: tnorm.sharpen(x, 0.8, 1.5),
                (H, W)),
}


def _scaled(x, seed):
    """Images of unlike ranges and colour casts, so that a statistic taken
    over the wrong axes shows."""
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.3, 1.0, x.shape[-1:] if x.ndim == 3 else ()).astype(np.float32)
    return (x * gain + np.float32(rng.uniform(0, 0.2))).astype(np.float32)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_normalization_matches_jax(name):
    jfn, tfn, shape = FUNCTIONS[name]
    x = _scaled(_img(1, shape), 2)
    np.testing.assert_allclose(tfn(_t(x)).numpy(), _jax(jfn, x), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_normalization_batch_is_per_image(name):
    """Three images of unlike statistics as one batch: each equals its own
    result exactly."""
    _, tfn, shape = FUNCTIONS[name]
    xs = [_scaled(_img(10 + i, shape), 20 + i) for i in range(3)]
    got = tfn(_t(np.stack(xs)))
    for i, x in enumerate(xs):
        assert torch.equal(got[i], tfn(_t(x))), i


def test_gaussian_kernel1d_is_the_reference():
    for sigma, radius in ((1.0, 3), (15.0, 45), (0.6, 1)):
        np.testing.assert_array_equal(timg.gaussian_kernel1d(sigma, radius),
                                      jimg.gaussian_kernel1d(sigma, radius))


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (2.5, 4), (15.0, None)])
def test_gaussian_blur_matches_jax(sigma, radius):
    """Gray and colour (the reference blurs an (H, W, C) image over its two
    leading axes; the port blurs (C, H, W)), and a radius wider than the
    48-row image, where reflect-101 folds again."""
    gray, rgb = _img(3, (H, W)), _img(4, (H, W, 3))
    np.testing.assert_allclose(timg.gaussian_blur(_t(gray), sigma, radius).numpy(),
                               _jax(lambda v: jimg.gaussian_blur(v, sigma, radius), gray),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(timg.gaussian_blur(_t(rgb).movedim(-1, 0), sigma, radius)
                               .movedim(0, -1).numpy(),
                               _jax(lambda v: jimg.gaussian_blur(v, sigma, radius), rgb),
                               atol=TOL, rtol=0)
    batch = _t(np.stack([gray, gray[::-1].copy()]))
    got = timg.gaussian_blur(batch, sigma, radius)
    assert torch.equal(got[1], timg.gaussian_blur(batch[1], sigma, radius))


# --- EnhanceSequence ---------------------------------------------------------

IH, IW = 96, 128
B_TRUE = np.array([0.05, 0.10, 0.13], np.float32)
BETA_B_TRUE = np.array([1.0, 0.7, 0.4], np.float32)
BETA_D_TRUE = np.array([0.9, 1.1, 1.2, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module")
def frames():
    """tests/test_imaging.py's synthetic scene (frame 0) and two more frames
    of it whose range map drifts (the camera moves in range): 3 (degraded
    image, range map) frames."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:IH, 0:IW].astype(np.float32)
    clean = np.stack([0.3 + 0.4 * (xx / IW), 0.35 + 0.25 * (yy / IH),
                      0.4 + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 7.0)], axis=-1).astype(np.float32)
    clean += rng.normal(0, 0.02, clean.shape).astype(np.float32)
    for _ in range(30):
        y0, x0 = rng.integers(0, IH - 8), rng.integers(0, IW - 8)
        clean[y0 : y0 + 6, x0 : x0 + 6] *= 0.05
    clean = np.clip(clean, 0.0, 1.0)
    out = []
    for i in range(3):
        z = (1.0 + 3.0 * (0.5 + 0.5 * np.sin((xx + 6 * i) / 40.0) * np.cos(yy / 30.0))
             ).astype(np.float32)
        degraded = jform.synthesize_underwater(clean, z, B_TRUE, BETA_B_TRUE, BETA_D_TRUE)
        out.append((np.array(degraded, np.float32), z))
    return out


def test_enhance_sequence_matches_jax(frames):
    with jax.enable_x64(False):
        ref_seq, nudged_seq = jenh.EnhanceSequence(), jenh.EnhanceSequence()
        refs = [ref_seq(img, z) for img, z in frames]
        nudged = [nudged_seq((img * np.float32(1 + 2.0**-23)).astype(np.float32), z)[0]
                  for img, z in frames]
    seq = tenh.EnhanceSequence(device="cpu")
    for k, ((img, z), (ref, ref_info), ref_n) in enumerate(zip(frames, refs, nudged)):
        ours, info = seq(img, z)
        assert ours.shape == (IH, IW, 3) and torch.isfinite(ours).all()
        assert bool(info.success_backscatter) == bool(ref_info.success_backscatter), k
        spread = np.abs(np.asarray(ref) - np.asarray(ref_n))
        diff = np.abs(ours.numpy() - np.asarray(ref))
        assert np.median(diff) <= 2.0 * np.median(spread), k
        assert np.quantile(diff, 0.999) <= 2.0 * np.quantile(spread, 0.999), k
        assert seq.guess.shape == (12,)


@pytest.mark.parametrize("success", [True, False])
def test_enhance_sequence_guess_rule(frames, monkeypatch, success):
    """The guess becomes the frame's beta_D where its fit succeeded and
    stays where it failed, camera by camera in a batch."""
    real = tenh.enhance_underwater
    starts = []

    def forced(image, range_img, params, guess):
        starts.append(guess.clone())
        out, info = real(image, range_img, params, guess)
        flags = torch.tensor([success, not success])[: info.beta_D.shape[0]] \
            if info.beta_D.ndim == 2 else torch.tensor(success)
        return out, info._replace(success_attenuation=flags)

    monkeypatch.setattr(tenh, "enhance_underwater", forced)
    img, z = frames[0]
    seq = tenh.EnhanceSequence(device="cpu")
    first = seq.guess.clone()
    np.testing.assert_array_equal(first.numpy(), jform.BETA_GUESS_1)
    _, info = seq(img, z)
    assert torch.equal(starts[0], first)
    assert torch.equal(seq.guess, info.beta_D if success else first)

    given = torch.from_numpy(jform.BETA_GUESS_2.copy())
    seq = tenh.EnhanceSequence(beta_D_guess=given, device="cpu")
    _, info = seq(np.stack([img, frames[1][0]]), np.stack([z, frames[1][1]]))
    assert seq.guess.shape == (2, 12)
    assert torch.equal(seq.guess[0], info.beta_D[0] if success else given)
    assert torch.equal(seq.guess[1], given if success else info.beta_D[1])


def test_enhance_sequence_needs_a_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tenh.EnhanceSequence()
