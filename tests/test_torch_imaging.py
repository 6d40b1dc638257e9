"""Parity of the PyTorch port's Sea-thru stages (ocean_perception_tpu_torch.imaging)
with the JAX reference on the CPU.

Tolerances:
- dark mask, hash ranking and pixel sampling: exact (integer work and a
  threshold that is exact given equal inputs).
- beta_D(z), backscatter removal, the illuminant, the attenuation
  correction and each fit's error at its start: float32 round-off
  (rtol 1e-5, or atol 1e-5 on O(1) images; the illuminant goes through the
  guided filter's box sums).
- The LM fits themselves are NOT held to the reference's parameters. The
  12-parameter backscatter and attenuation models are ill-conditioned: the
  reference's own fit moves by up to ~3e5 relative in a parameter, and its
  enhanced image by a median 0.04, when one input pixel value changes by one
  ulp (ROADMAP.md Queue 3). The fits are held instead to what the repo's JAX
  tests ask of the reference (recovery of a synthetic truth), to the same
  success flags where the reference's error is far from the 0.1 threshold,
  and end to end to the reference's own one-ulp spread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.imaging import attenuation as jatt
from ocean_perception_tpu.imaging import backscatter as jbs
from ocean_perception_tpu.imaging import enhance as jenh
from ocean_perception_tpu.imaging import formation as jform
from ocean_perception_tpu.imaging import illuminant as jill
from ocean_perception_tpu.ops.image import compute_intensity
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.imaging import attenuation as tatt
from ocean_perception_tpu_torch.imaging import backscatter as tbs
from ocean_perception_tpu_torch.imaging import enhance as tenh
from ocean_perception_tpu_torch.imaging import formation as tform
from ocean_perception_tpu_torch.imaging import illuminant as till


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

H, W = 96, 128
B_TRUE = np.array([0.05, 0.10, 0.13], np.float32)
BETA_B_TRUE = np.array([1.0, 0.7, 0.4], np.float32)
BETA_D_TRUE = np.array([0.9, 1.1, 1.2, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)
GUESSES = np.stack([jform.BETA_GUESS_1, jform.BETA_GUESS_2])


@pytest.fixture(scope="module")
def scene():
    """tests/test_imaging.py's synthetic scene: clean image with dark patches,
    smooth 1-4 m range map, degraded with known formation parameters."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    clean = np.stack([0.3 + 0.4 * (xx / W), 0.35 + 0.25 * (yy / H),
                      0.4 + 0.2 * np.sin(xx / 9.0) * np.cos(yy / 7.0)], axis=-1).astype(np.float32)
    clean += rng.normal(0, 0.02, clean.shape).astype(np.float32)
    for _ in range(30):
        y0, x0 = rng.integers(0, H - 8), rng.integers(0, W - 8)
        clean[y0 : y0 + 6, x0 : x0 + 6] *= 0.05
    clean = np.clip(clean, 0.0, 1.0)
    z = (1.0 + 3.0 * (0.5 + 0.5 * np.sin(xx / 40.0) * np.cos(yy / 30.0))).astype(np.float32)
    degraded = np.asarray(jform.synthesize_underwater(clean, z, B_TRUE, BETA_B_TRUE, BETA_D_TRUE),
                          np.float32)
    intensity = np.asarray(compute_intensity(jnp.asarray(degraded)))
    dark = np.asarray(jax.jit(jbs.find_dark_mask)(intensity, z))
    return dict(clean=clean, z=z, degraded=degraded, intensity=intensity, dark=dark)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_beta_d_of_z():
    z = np.linspace(0.2, 6.0, 50).astype(np.float32)
    for X in GUESSES:
        np.testing.assert_allclose(tform.beta_d_of_z(_t(X), _t(z)).numpy(),
                                   np.asarray(jform.beta_d_of_z(X, z)), rtol=1e-6)


def test_dark_mask_and_sampling_exact(scene):
    s = scene
    ours = tbs.find_dark_mask(_t(s["intensity"]), _t(s["z"])).numpy()
    np.testing.assert_array_equal(ours, s["dark"])
    assert 0.002 < ours.mean() < 0.03
    n = 720 * 1280
    np.testing.assert_array_equal(tbs._hash_rank(n).numpy(),
                                  np.asarray(jbs._hash_rank(n)).astype(np.int64))
    tiny = np.zeros((H, W), bool)
    tiny[4:8, 4:8] = True
    for mask, num_px in ((s["dark"], 256), (tiny, 64)):
        ref = jbs.sample_masked_pixels(jnp.asarray(s["degraded"]), jnp.asarray(s["z"]), jnp.asarray(mask), num_px)
        ours = tbs.sample_masked_pixels(_t(s["degraded"]), _t(s["z"]), _t(mask), num_px)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ours[2].sum()) == 16


def test_remove_backscatter_and_correct_attenuation(scene):
    s = scene
    ref = np.asarray(jbs.remove_backscatter(s["degraded"], s["z"], B_TRUE, BETA_B_TRUE))
    ours = tbs.remove_backscatter(_t(s["degraded"]), _t(s["z"]), _t(B_TRUE), _t(BETA_B_TRUE)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    z0 = s["z"].copy()
    z0[:10] = 0.0  # zero ranges take the image's largest range
    for X in GUESSES:
        ref_c = np.asarray(jatt.correct_attenuation(ours, z0, X))
        ours_c = tatt.correct_attenuation(_t(ours), _t(z0), _t(X)).numpy()
        np.testing.assert_allclose(ours_c, ref_c, rtol=1e-5)


def test_illuminant_matches_jax(scene):
    s = scene
    D = s["degraded"]
    radius = jenh._next_even_int(W // 3)
    ref = np.asarray(jax.jit(lambda d, z: jill.estimate_illuminant_range_guided(d, z, radius, 0.01, 8))(D, s["z"]))
    ours = till.estimate_illuminant_range_guided(_t(D), _t(s["z"]), radius, 0.01, 8).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_fit_errors_at_the_start_match(scene):
    """With no LM iteration the fits return their start and its error: this
    holds the residual models and error functions to the reference."""
    s = scene
    ref = jax.jit(lambda a, b, c: jbs.estimate_backscatter(a, b, c, iters=0))(s["degraded"], s["z"], s["dark"])
    ours = tbs.estimate_backscatter(_t(s["degraded"]), _t(s["z"]), _t(s["dark"]), iters=0)
    for f in ref._fields:
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-5)
    E = np.asarray(jform.synthesize_underwater(np.ones_like(s["degraded"]), s["z"], np.zeros(3, np.float32),
                                               np.zeros(3, np.float32), BETA_D_TRUE))
    for X in GUESSES:
        ref = jax.jit(lambda z, e, x: jatt.estimate_beta(z, e, iters=0, X0=x))(s["z"], E, X)
        ours = tatt.estimate_beta(_t(s["z"]), _t(E), iters=0, X0=_t(X))
        np.testing.assert_allclose(ours.X.numpy(), np.asarray(ref.X), rtol=1e-6)
        np.testing.assert_allclose(float(ours.error), float(ref.error), rtol=1e-5)


def test_backscatter_fit_recovers_truth(scene):
    s = scene
    ref = jax.jit(lambda a, b, c: jbs.estimate_backscatter(a, b, c, iters=20))(s["degraded"], s["z"], s["dark"])
    ours = tbs.estimate_backscatter(_t(s["degraded"]), _t(s["z"]), _t(s["dark"]), iters=20)
    assert float(ref.error) < 0.01 and float(ours.error) < 0.01
    np.testing.assert_allclose(ours.B.numpy(), B_TRUE, atol=0.04)


def test_attenuation_fits_recover_truth(scene):
    """Perfect illuminant E = exp(-beta_D z): beta_D(z) must be recovered;
    a batch of starts is one LM run and equals each start run alone."""
    z = scene["z"]
    E = np.exp(-np.asarray(jform.beta_d_of_z(BETA_D_TRUE, z)) * z[..., None]).astype(np.float32)
    ref = jax.jit(lambda a, b, c: jatt.estimate_beta(a, b, iters=40, X0=c))(z, E, jform.BETA_GUESS_1)
    ours = tatt.estimate_beta(_t(z), _t(E), iters=40, X0=_t(jform.BETA_GUESS_1))
    assert float(ref.error) < 0.05 and float(ours.error) < 0.05
    for zt in (1.5, 2.5, 3.5):
        truth = np.asarray(jform.beta_d_of_z(BETA_D_TRUE, np.float32(zt)))
        np.testing.assert_allclose(tform.beta_d_of_z(ours.X, torch.tensor(zt)).numpy(), truth, rtol=0.15)

    batch = tatt.estimate_beta(_t(z), _t(E), iters=20, X0=_t(GUESSES))
    for i in range(len(GUESSES)):
        one = tatt.estimate_beta(_t(z), _t(E), iters=20, X0=_t(GUESSES[i]))
        np.testing.assert_allclose(batch.X[i].numpy(), one.X.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(batch.error[i]), float(one.error), rtol=1e-5)
    best = tatt.estimate_beta_multi_start(_t(z), _t(E), _t(GUESSES), iters=20)
    i = int(torch.argmin(batch.error))
    np.testing.assert_array_equal(best.X.numpy(), batch.X[i].numpy())


def test_enhance_underwater_end_to_end(scene):
    s = scene
    step = jax.jit(jenh.enhance_underwater)
    ref, ref_info = step(s["degraded"], s["z"])
    nudged = (s["degraded"] * np.float32(1 + 2.0**-23)).astype(np.float32)
    ref_nudged, _ = step(nudged, s["z"])
    ours, info = tenh.enhance_underwater(_t(s["degraded"]), _t(s["z"]))
    ours = ours.numpy()

    # What the reference test asks of the reference, asked of the port.
    assert np.isfinite(ours).all() and ours.shape == (H, W, 3)
    assert bool(info.success_backscatter) == bool(ref_info.success_backscatter) is True
    assert float(info.error_attenuation) < 0.5
    err_in = np.abs(s["degraded"] - s["clean"]).mean()
    assert np.abs(ours - s["clean"]).mean() < 0.6 * err_in

    # No further from the reference than the reference moves under a
    # one-ulp change of its input (ROADMAP.md Queue 3).
    spread = np.abs(np.asarray(ref) - np.asarray(ref_nudged))
    diff = np.abs(ours - np.asarray(ref))
    assert np.median(diff) <= 2.0 * np.median(spread)
    assert np.quantile(diff, 0.999) <= 2.0 * np.quantile(spread, 0.999)


def test_enhance_with_a_carried_guess(scene):
    s = scene
    guess = convert.beta_guess_from_numpy(jform.BETA_GUESS_2)
    out, info = tenh.enhance_underwater(_t(s["degraded"]), _t(s["z"]), beta_D_guess=guess)
    assert torch.isfinite(out).all()
    assert info.beta_D.shape == (12,)
    with pytest.raises(ValueError):
        convert.beta_guess_from_numpy(np.zeros(3))
