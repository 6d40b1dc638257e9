"""The port's Levenberg-Marquardt step: its twin on the CPU, its kernels on
the card (``csrc/lm_solve.cu``), and the batch invariance it exists for.

A camera's Sea-thru fits must not depend on how many cameras share the call:
the damped normal equations (a pairwise tree over the samples), their solve
(Gaussian elimination with partial pivoting) and the error sums are fixed
arithmetic in a fixed order for each system.

- the twin (``lm_step_plain``) is batch-invariant: system i of a batch of 4
  and of 64 equals system i solved alone, bit for bit;
- ``solve_plain`` agrees with ``torch.linalg.solve`` within 1e-5 relative on
  well-conditioned systems, and gives a non-finite step where a pivot is 0,
  which ``lm_solve`` zeroes;
- ``tree_sum_plain`` against a float64 sum, padded lengths included;
- ``enhance_underwater`` on 3 cameras in one call equals each camera's own
  call bit for bit on the CPU;
- ``chip_smoke.lm_adversarial``'s batch does what it is for: its first
  system's first pivot is a tie whose other choice gives other bits, its
  zero pivot and its NaN give steps that are not finite;
- on the card (``gpu``): ``lm_solve_small`` equals its twin bit for bit
  (``chip_smoke.same_bits``: integer bits, NaNs in their places) at the
  perception step's systems (1, 2, 3 at B=1; 4, 8, 12 at B=4; N=256, P=12),
  at 64, at P = 1 and 16, at N = 20, 33, 300 and 4096 (J from device memory),
  and in float64 at trilateration's (1, 8, 3) and at (4, 256, 12); on the
  adversarial batch too; each system alone equals itself in its batch.
  ``lm_row_sum`` equals its twin, and camera 1 of the fleet of
  ``chip_smoke.py`` phase 13 (uint8 mono 720p at the farm point) has the
  same enhanced image at B=4 as alone, in each of its 8 timed calls.

This file imports no JAX: on a GPU machine without JAX, run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lm.py -m gpu -q``.
"""

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.imaging.enhance import EnhanceParams, enhance_underwater
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops import lm

P, N = 12, 256


def _systems(M, seed=0, scale_spread=4.0, n=N, p=P, dtype=np.float32):
    """M weighted least-squares problems (J (M, n, p), r (M, n), lam (M,)),
    columns scaled over 10^scale_spread as the Sea-thru Jacobians are."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(M, n, p)) * 10.0 ** rng.uniform(-scale_spread, 0, size=(M, 1, p))
    J[:, n // 2:] *= rng.random((M, 1, 1)) < 0.5  # some systems with half their rows masked
    r = rng.normal(size=(M, n))
    lam = 10.0 ** rng.uniform(-6, 0, size=M)
    return tuple(torch.from_numpy(a.astype(dtype)) for a in (J, r, lam))


@pytest.mark.parametrize("marquardt", [False, True])
def test_twin_is_batch_invariant(marquardt):
    J, r, lam = _systems(64, seed=1)
    many = lm.lm_step_plain(J, r, lam, marquardt)
    four = lm.lm_step_plain(J[:4], r[:4], lam[:4], marquardt)
    for i in range(4):
        alone = lm.lm_step_plain(J[i], r[i], lam[i], marquardt)
        assert torch.equal(alone, many[i]) and torch.equal(alone, four[i])
    assert torch.equal(lm.lm_step_plain(J[63:], r[63:], lam[63:], marquardt), many[63:])


def test_solve_plain_matches_linalg_solve():
    rng = np.random.default_rng(2)
    Q = rng.normal(size=(16, P, P))
    A = Q @ Q.transpose(0, 2, 1) + P * np.eye(P)  # well conditioned (cond < 50)
    b = rng.normal(size=(16, P))
    ours = lm.solve_plain(torch.from_numpy(A.astype(np.float32)),
                          torch.from_numpy(b.astype(np.float32))).double().numpy()
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    torch_ref = torch.linalg.solve(torch.from_numpy(A.astype(np.float32)),
                                   torch.from_numpy(b.astype(np.float32)))
    np.testing.assert_allclose(ours, torch_ref.double().numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_solve_plain_pivots():
    """A zero leading entry needs the row swap; a general permutation too."""
    A = torch.tensor([[0.0, 2.0, 1.0], [1.0, 1.0, 0.0], [3.0, 0.0, 1.0]])
    b = torch.tensor([3.0, 2.0, 4.0])
    x = lm.solve_plain(A, b)
    np.testing.assert_allclose((A @ x).numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_zero_pivot_gives_non_finite_step_and_the_guard_zeroes_it():
    J = torch.zeros(8, 3)
    J[:, 0] = 1.0  # columns 1 and 2 are zero: a zero pivot without damping
    r = torch.ones(8)
    A, b = lm.damped_system(J, r, torch.tensor(0.0), marquardt=False)
    assert not torch.isfinite(lm.solve_plain(A, b)).all()

    def residual_jac(x):
        return torch.ones(8), torch.zeros(8, 3)

    x0 = torch.tensor([1.0, 2.0, 3.0])
    out = lm.lm_solve(residual_jac, x0, lm.LMConfig(max_iters=3))
    assert torch.equal(out.x, x0)


@pytest.mark.parametrize("n", [1, 5, 32, 255, 256, 300])
def test_tree_sum_plain(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(size=(3, n)).astype(np.float32))
    got = lm.tree_sum_plain(x)
    ref = x.double().sum(-1)
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(lm.tree_sum_plain(x[1:2]), got[1:2])
    assert torch.equal(lm.tree_sum_plain(x.T.contiguous(), dim=0), got)


@pytest.mark.parametrize("n, p, dtype", [(N, P, torch.float32), (8, 3, torch.float64)])
def test_adversarial_batch_on_cpu(n, p, dtype):
    import chip_smoke as cs

    J, r, lam = cs.lm_adversarial(n, p, dtype, "cpu")
    t = p - 2
    for marquardt in (False, True):
        A, b = lm.damped_system(J, r, lam, marquardt)
        col = A[0, :, 0].abs()
        assert col[t] == col[t + 1] == col.max() > col[0] and A[0, t, 0] == -A[0, t + 1, 0]
        step = lm.lm_step_plain(J, r, lam, marquardt)
        assert torch.isfinite(step[0]).all() and torch.isfinite(step[3]).all()
        assert not torch.isfinite(step[1]).all() and torch.isnan(step[2]).all()
        for i in range(4):
            assert cs.same_bits(lm.lm_step_plain(J[i], r[i], lam[i], marquardt), step[i])
    # Rows t and t + 1 swapped are the same equations with the tie's other
    # row first: the solve's bits change, so a kernel that took the other
    # row would differ from the twin.
    A, b = lm.damped_system(J, r, lam, False)
    order = list(range(p))
    order[t], order[t + 1] = t + 1, t
    assert not cs.same_bits(lm.solve_plain(A[0, order], b[0, order]), lm.solve_plain(A[0], b[0]))


def test_cpu_lm_launches_no_kernel():
    cuda.reset_launches()
    J, r, lam = _systems(2)
    lm.lm_step(J, r, lam, True)
    lm.row_sum(r)
    assert set(cuda.LAUNCHES.values()) == {0}


def test_enhance_batch_equals_each_camera_on_cpu():
    """Three cameras of unlike scenes in one enhance call against each alone,
    bit for bit (fits, images and errors)."""
    rng = np.random.default_rng(5)
    H, W = 48, 64
    imgs = rng.random((3, H, W, 3)).astype(np.float32) * np.array([0.3, 0.6, 0.9], np.float32)
    ranges = (1.0 + 6.0 * rng.random((3, H, W))).astype(np.float32)
    ranges[1, :8] = 0.0  # some pixels without range
    img_t, rng_t = torch.from_numpy(imgs), torch.from_numpy(ranges)
    out, info = enhance_underwater(img_t, rng_t, EnhanceParams())
    for b in range(3):
        one, one_info = enhance_underwater(img_t[b], rng_t[b], EnhanceParams())
        assert torch.equal(out[b], one)
        for name, v in one_info._asdict().items():
            assert torch.equal(getattr(info, name)[b], v), name


# --- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels cannot run on the CPU")
    return torch.device("cuda", 0)


# (M, N, P, dtype): the perception step's systems at B=1 and B=4 (N=256,
# P=12), a larger batch, the smallest and largest P, N under a warp, past a
# power of two, and long enough to read J from device memory; trilateration's
# float64 systems and the float64 build at the step's shape.
SHAPES = [(1, 256, 12, torch.float32), (2, 256, 12, torch.float32), (3, 256, 12, torch.float32),
          (4, 256, 12, torch.float32), (8, 256, 12, torch.float32), (12, 256, 12, torch.float32),
          (64, 256, 12, torch.float32), (4, 256, 1, torch.float32), (4, 256, 16, torch.float32),
          (4, 20, 12, torch.float32), (4, 33, 12, torch.float32), (4, 300, 12, torch.float32),
          (2, 4096, 12, torch.float32), (2, 4096, 1, torch.float32), (1, 8, 3, torch.float64),
          (4, 256, 12, torch.float64)]


@pytest.mark.gpu
@pytest.mark.parametrize("M, n, p, dtype", SHAPES, ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("marquardt", [False, True])
def test_lm_solve_small_matches_twin(cuda_device, M, n, p, dtype, marquardt):
    from chip_smoke import same_bits

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    J, r, lam = (t.to(cuda_device) for t in _systems(M, seed=M + n + p, n=n, p=p, dtype=np_dtype))
    before = cuda.LAUNCHES["lm_solve_small"]
    got = cuda.lm_solve_small(J, r, lam, marquardt)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["lm_solve_small"] == before + 1
    assert same_bits(got, lm.lm_step_plain(J, r, lam, marquardt))
    assert same_bits(got.cpu(), lm.lm_step_plain(J.cpu(), r.cpu(), lam.cpu(), marquardt))
    for i in {0, M - 1}:
        alone = cuda.lm_solve_small(J[i].contiguous(), r[i].contiguous(), lam[i].contiguous(),
                                    marquardt)
        assert same_bits(alone, got[i])


@pytest.mark.gpu
@pytest.mark.parametrize("n, p, dtype", [(N, P, torch.float32), (8, 3, torch.float64),
                                         (33, 16, torch.float32)])
@pytest.mark.parametrize("marquardt", [False, True])
def test_lm_solve_small_adversarial(cuda_device, n, p, dtype, marquardt):
    """A pivot tie, a zero column (the step not finite), a NaN in J and
    columns over 10^8 (chip_smoke.lm_adversarial): the kernel's bits are the
    twin's on the card and on the CPU, NaNs in the same places, and each
    system alone is itself in the batch."""
    import chip_smoke as cs

    J, r, lam = cs.lm_adversarial(n, p, dtype, cuda_device)
    got = cuda.lm_solve_small(J, r, lam, marquardt)
    assert cs.same_bits(got, lm.lm_step_plain(J, r, lam, marquardt))
    assert cs.same_bits(got.cpu(), lm.lm_step_plain(J.cpu(), r.cpu(), lam.cpu(), marquardt))
    assert not torch.isfinite(got[1]).all() and torch.isnan(got[2]).all()
    for i in range(J.shape[0]):
        assert cs.same_bits(cuda.lm_solve_small(J[i], r[i], lam[i], marquardt), got[i])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 256), (12, 256), (5, 300), (64, 12, 1)])
def test_lm_row_sum_matches_twin(cuda_device, shape):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(np.float32))
    got = cuda.lm_row_sum(x.to(cuda_device))
    assert torch.equal(got.cpu(), lm.tree_sum_plain(x))


@pytest.mark.gpu
def test_fleet_enhance_is_batch_invariant_on_the_card(cuda_device):
    """Camera 1 of chip_smoke.py phase 13's fleet (the camera whose batched
    Sea-thru fit used to diverge): its enhanced image at B=4 equals its
    one-camera call's in each of the 8 timed calls."""
    import chip_smoke as cs
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
    from ocean_perception_tpu_torch.parallel.sharded_pipeline import prepare_frames

    canvas = cs.make_canvas()
    cam = PinholeCamera.create(700.0, 700.0, cs.W / 2, cs.H / 2, cs.H, cs.W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=cs.MAX_DISP,
                              internal_scale=cs.FARM_SCALE)
    for i in range(5, 13):
        pairs = [cs.make_mono_u8(canvas, i + cs.FLEET_PHASE * b) for b in range(cs.N_CAMERAS)]
        left, right = (prepare_frames(torch.as_tensor(np.stack(side), device=cuda_device),
                                      cuda_device) for side in zip(*pairs))
        batched = perception_step(left, right, rig, config, cuda_device)
        alone = perception_step(left[1], right[1], rig, config, cuda_device)
        assert torch.equal(batched.enhanced_left[1], alone.enhanced_left), f"call {i}"
        assert torch.isfinite(batched.enhanced_left).all()
