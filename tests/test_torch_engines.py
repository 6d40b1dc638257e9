"""The PyTorch port's other stereo configurations against the JAX reference
on the CPU: two-sided PatchMatch (right_wta=False), the ZNCC cost, SGM and
WTA, and the parameter converters. Inputs come from one seeded numpy canvas
at 48x64 with D=16 (a true disparity of 5).

Tolerances, and why:
- right_cost_volume_from_left, two-sided PatchMatch before subpixel
  refinement, sgm_aggregate and the WTA argmins: bit-exact (indexing,
  compares, selects, and adds and mins in JAX's order).
- after subpixel refinement: <= 1e-6 px (float32 parabola arithmetic,
  test_torch_stereo.py's bound).
- cost_volume_zncc: <= 5e-4 (2.1e-4 measured), with the per-pixel argmin
  equal on >= 99% of pixels (100% measured). The variances are differences
  of nearly equal terms, E[x^2] - mu^2, on a smooth image, so a last-bit
  difference in a box sum grows by the ratio mu^2 / var. Those differences
  are XLA's CPU code generation, the same in every plane (the 16 plane
  fusions run two identical kernels): each box filter's taps fused into
  FMAs, E[x^2] - mu^2 and the cross term fused, and cross / sqrt(v)
  computed as cross * rsqrt(v) from the x86 rsqrt estimate and two Newton
  steps. test_cost_volume_zncc_gap_is_xla_codegen shows that the FMAs
  emulated and XLA's own rsqrt close the gap exactly, and that the FMAs
  alone leave ~2e-7. The estimate is the CPU's, so the port cannot
  reproduce those bits, and it keeps its plain box filters and correctly
  rounded division.
- the ZNCC match: within 1e-3 px on >= 99% of pixels (a near tie can flip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.stereo import api as japi
from ocean_perception_tpu.stereo import cost as jcost
from ocean_perception_tpu.stereo import patchmatch as jpm
from ocean_perception_tpu.stereo import sgm as jsgm
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.stereo import api as tapi
from ocean_perception_tpu_torch.stereo import cost as tcost
from ocean_perception_tpu_torch.stereo import patchmatch as tpm
from ocean_perception_tpu_torch.stereo import sgm as tsgm


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
BASE = dict(max_disp=D, chunks=4, chunks_y=3, iters=2, halo=2)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(61)
    canvas = rng.random((H, W + 16)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas).astype(np.float32)
    return canvas[:, 3:3 + W].copy(), canvas[:, 8:8 + W].copy()  # right(x - 5) == left(x)


@pytest.fixture(scope="module")
def volume(pair):
    """JAX's f32 volume, jitted (XLA's fused build)."""
    return np.asarray(jax.jit(lambda a, b: jcost.cost_volume(a, b, D, 0.9))(*pair))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_right_cost_volume_from_left_bit_exact(volume):
    ref = np.asarray(jcost.right_cost_volume_from_left(jnp.asarray(volume)))
    ours = tcost.right_cost_volume_from_left(_t(volume)).numpy()
    np.testing.assert_array_equal(ours, ref)
    # Columns past the right edge repeat the last column, not column 0.
    assert ours[5, W - 1, 3] == volume[5, W - 1, 3] and ours[5, W - 2, 3] == volume[5, W - 1, 3]


@pytest.mark.parametrize("subpixel", [False, True])
def test_two_sided_patchmatch(pair, subpixel):
    jp = jpm.PatchMatchParams(**BASE, right_wta=False, subpixel=subpixel)
    ref = jax.jit(lambda a, b: jpm.patchmatch_disparity(a, b, jp))(*pair)
    ours = tpm.patchmatch_disparity(*map(_t, pair), tpm.PatchMatchParams(**BASE, right_wta=False,
                                                                       subpixel=subpixel))
    tol = 1e-6 if subpixel else 0.0
    for field in ("left_raw", "right"):
        np.testing.assert_allclose(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=0, atol=tol, err_msg=field)
    agree = (np.abs(ours.left.numpy() - np.asarray(ref.left)) <= tol).mean()
    assert agree >= (1.0 if not subpixel else 0.99), agree
    assert (np.asarray(ref.left) > 0).mean() > 0.3 and (np.asarray(ref.right) > 0).mean() > 0.3


def test_two_sided_match_is_two_one_sided_matches(pair, volume):
    """The right side is the one-side match over the derived right volume,
    from its own WTA seed (JAX vmaps the two sides)."""
    p = tpm.PatchMatchParams(**BASE, right_wta=False, subpixel=False)
    C_r = tcost.right_cost_volume_from_left(_t(volume))
    noise = tpm.unit_noise((H, W), p.noise_seed)
    right = tpm._match_one_side(C_r, tpm.sparse_wta_seed(C_r, p), noise, p)
    jp = jpm.PatchMatchParams(**BASE, right_wta=False, subpixel=False)
    ref = jax.jit(lambda a, b: jpm.patchmatch_disparity(a, b, jp))(*pair)
    np.testing.assert_array_equal(right.numpy(), np.asarray(ref.right))


def test_cost_volume_zncc(pair):
    ref = np.asarray(jax.jit(lambda a, b: jcost.cost_volume_zncc(a, b, D, 5))(*pair))
    ours = tcost.cost_volume_zncc(*map(_t, pair), D, 5).numpy()
    assert ours.shape == (H, W, D) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)
    assert (np.argmin(ours, -1) == np.argmin(ref, -1)).mean() >= 0.99
    assert (np.argmin(ours, -1)[8:-8, 16:-8] == 5).mean() > 0.9


def test_cost_volume_zncc_gap_is_xla_codegen(pair):
    """The port's ZNCC formula with XLA's CPU code generation spelled out
    gives JAX's volume bit for bit: every box filter's taps as FMAs (the
    first sum fuses tap 0's product), E[x^2] - mu^2 and the cross term as
    FMAs, and the division by sqrt as a product with XLA's rsqrt. With a
    correctly rounded division instead, only last bits differ."""
    from ocean_perception_tpu_torch.ops.image import _pad_reflect101, fma_f32, sqrt_f32

    xla_rsqrt = jax.jit(jax.lax.rsqrt)
    w = float(np.float32(1 / 5))

    def box(img):
        p = _pad_reflect101(img, 2, 2)

        def taps(terms):
            acc = fma_f32(terms[0], w, terms[1] * w)
            for t in terms[2:]:
                acc = fma_f32(t, w, acc)
            return acc

        rows = taps([p[i:i + H] for i in range(5)])
        return taps([rows[:, j:j + W] for j in range(5)])

    def volume(xla_division):
        iml, imr = map(_t, pair)
        mu_l = box(iml)
        var_l = torch.clamp_min(fma_f32(-mu_l, mu_l, box(iml * iml)), 1e-8)
        planes = []
        for d in range(D):
            rd = tcost._shift_right_image(imr, d)
            mu_r = box(rd)
            var_r = torch.clamp_min(fma_f32(-mu_r, mu_r, box(rd * rd)), 1e-8)
            cross = fma_f32(-mu_l, mu_r, box(iml * rd))
            v = var_l * var_r
            z = (cross * _t(xla_rsqrt(v.numpy())) if xla_division else cross / sqrt_f32(v))
            planes.append(1.0 - torch.clamp(z, -1.0, 1.0))
        return torch.stack(planes, -1).numpy()

    ref = np.asarray(jax.jit(lambda a, b: jcost.cost_volume_zncc(a, b, D, 5))(*pair))
    np.testing.assert_array_equal(volume(True), ref)
    np.testing.assert_allclose(volume(False), ref, rtol=0, atol=1e-6)


def test_zncc_patchmatch(pair):
    """The ZNCC engine end to end: disparities within 1e-3 px on >= 99% of
    pixels (the volume's last-bit differences can flip a near tie)."""
    base = dict(BASE, cost="zncc", right_wta=True)
    ref = jax.jit(lambda a, b: jpm.patchmatch_disparity(a, b, jpm.PatchMatchParams(**base)))(*pair)
    ours = tpm.patchmatch_disparity(*map(_t, pair), tpm.PatchMatchParams(**base))
    for field in ("left", "right"):
        a, b = getattr(ours, field).numpy(), np.asarray(getattr(ref, field))
        assert (np.abs(a - b) <= 1e-3).mean() >= 0.99, field
    valid = ours.left.numpy() > 0
    assert valid.mean() > 0.3 and np.median(np.abs(ours.left.numpy()[valid] - 5)) < 0.5


SGM_CASES = {
    "strips": dict(max_disp=D, chunks=3, halo=4),
    "full_paths": dict(max_disp=D, chunks=1, halo=0),
    "background": dict(max_disp=D, chunks=4, halo=2, background_improve=0.9, subpixel=False),
}


@pytest.mark.parametrize("case", sorted(SGM_CASES))
def test_sgm_aggregate_bit_exact(volume, case):
    kw = SGM_CASES[case]
    jp, tp = jsgm.SgmParams(**kw), tsgm.SgmParams(**kw)
    C_r = np.asarray(jcost.right_cost_volume_from_left(jnp.asarray(volume)))
    stack = np.stack([volume, C_r])
    ref = np.asarray(jax.jit(jax.vmap(lambda c: jsgm.sgm_aggregate(c, jp)))(stack))
    ours = tsgm.sgm_aggregate(_t(stack), tp).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", sorted(SGM_CASES))
def test_sgm_disparity(pair, case):
    kw = SGM_CASES[case]
    ref = jax.jit(lambda a, b: jsgm.sgm_disparity(a, b, jsgm.SgmParams(**kw)))(*pair)
    ours = tsgm.sgm_disparity(*map(_t, pair), tsgm.SgmParams(**kw))
    for field in ("left", "right", "left_raw"):
        np.testing.assert_allclose(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=0, atol=1e-6, err_msg=field)
    valid = ours.left.numpy() > 0
    assert valid.mean() > 0.5 and np.median(np.abs(ours.left.numpy()[valid] - 5)) < 0.5


@pytest.mark.parametrize("subpixel", [False, True])
def test_wta_disparity(pair, subpixel):
    ref = jax.jit(lambda a, b: japi.wta_disparity(a, b, D, subpixel=subpixel))(*pair)
    ours = tapi.wta_disparity(*map(_t, pair), D, subpixel=subpixel)
    for field in ("left", "right", "left_raw"):
        np.testing.assert_allclose(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                   rtol=0, atol=1e-6 if subpixel else 0.0, err_msg=field)


@pytest.mark.parametrize("engine", ["sgm", "wta", "patchmatch"])
def test_estimate_disparity_dispatch(pair, engine):
    ref = jax.jit(lambda a, b: japi.estimate_disparity(
        a, b, engine=engine, max_disp=D,
        patchmatch_params=jpm.PatchMatchParams(**BASE, right_wta=True),
        sgm_params=jsgm.SgmParams(max_disp=D, chunks=4, halo=2)))(*pair)
    ours = tapi.estimate_disparity(*map(_t, pair), engine=engine, max_disp=D,
                                   patchmatch_params=tpm.PatchMatchParams(**BASE, right_wta=True),
                                   sgm_params=tsgm.SgmParams(max_disp=D, chunks=4, halo=2))
    np.testing.assert_allclose(ours.left.numpy(), np.asarray(ref.left), rtol=0, atol=1e-6)


def test_unknown_engine_and_cost_raise(pair):
    l = torch.zeros(16, 24)
    with pytest.raises(ValueError):
        tapi.estimate_disparity(l, l, engine="census")
    with pytest.raises(ValueError, match="cost"):
        tpm.patchmatch_disparity(l, l, tpm.PatchMatchParams(max_disp=8, cost="sad"))


def test_converters_round_trip():
    jp = jpm.PatchMatchParams(max_disp=48, iters=2, chunks=8, chunks_y=5, halo=3, right_wta=True,
                              cost="zncc", zncc_patch=7, volume_bf16=True, use_pallas_build=True,
                              scan_unroll=0)
    tp = convert.patchmatch_params_from_jax(jp)
    assert tp == tpm.PatchMatchParams(max_disp=48, iters=2, chunks=8, chunks_y=5, halo=3,
                                      right_wta=True, cost="zncc", zncc_patch=7,
                                      volume_bf16=True, use_strip_volumes=True)
    assert not convert.patchmatch_params_from_jax(jpm.PatchMatchParams()).use_strip_volumes
    assert convert.patchmatch_params_from_jax(jpm.PatchMatchParams()) == tpm.PatchMatchParams()
    js = jsgm.SgmParams(max_disp=32, p1=0.1, p2=0.7, chunks=4, halo=3, background_improve=0.9,
                        scan_unroll=0)
    assert convert.sgm_params_from_jax(js) == tsgm.SgmParams(
        max_disp=32, p1=0.1, p2=0.7, chunks=4, halo=3, background_improve=0.9)
    assert convert.sgm_params_from_jax(jsgm.SgmParams()) == tsgm.SgmParams()
