"""The PyTorch port's strip-volume path against the JAX reference on the CPU:
``build_strip_volumes`` (the plain twin of kernel ``build_volumes``) against
the TPU build kernel in interpret mode, and the strip-volume PatchMatch
against JAX's prebuilt-volume fused kernel, at 48x64, D=16, 4 row strips,
3 column strips, halo 2.

Tolerances:
- bf16 volumes: bit-exact; f32 volumes: <= 1e-6. The plain twin is the
  (H, W, D) volume relaid out, which equals XLA's build bit for bit; the
  TPU kernel sums the same terms with another association in a few places
  (tests/test_pallas.py::test_volume_build_bit_identical holds it to XLA's
  build with the same bounds).
- the strip-volume match: bit-exact, left and right.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.ops import image as jimg
from ocean_perception_tpu.ops.pallas.fused_patchmatch import fused_geometry
from ocean_perception_tpu.ops.pallas.volume_build import pallas_build_volumes
from ocean_perception_tpu.stereo import cost as jcost
from ocean_perception_tpu.stereo import patchmatch as jpm
from ocean_perception_tpu_torch.ops import cuda
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
CHUNKS, CHUNKS_Y, HALO = 4, 3, 2


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(51)
    canvas = rng.random((H, W + 8)).astype(np.float32)
    iml, imr = canvas[:, 4:4 + W], canvas[:, :W]
    gl = np.asarray(jax.jit(jimg.gradient_magnitude)(iml))
    gr = np.asarray(jax.jit(jimg.gradient_magnitude)(imr))
    return iml, imr, gl, gr


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_strip_geometry_matches_fused_geometry():
    for h, w, d, chunks, chunks_y in ((H, W, D, CHUNKS, CHUNKS_Y), (360, 640, 64, 16, None),
                                      (64, 96, 32, 5, None)):
        ours = tcost.strip_geometry(h, w, d, chunks, chunks_y)
        ref = fused_geometry(h, w, d, chunks, chunks_y, HALO, 1)
        assert tuple(ours) == tuple(ref)[:7]
    g = tcost.strip_geometry(360, 640, 64, 16, None)
    assert (g.chunks_x, g.chunk_x, g.chunks_y, g.chunk_y) == (16, 40, 15, 24)


@pytest.mark.parametrize("bf16,tol", [(True, 0.0), (False, 1e-6)])
def test_build_strip_volumes_matches_pallas_kernel(images, bf16, tol):
    iml, imr, gl, gr = images
    vr_ref, vc_ref = pallas_build_volumes(
        iml, imr, gl, gr, D=D, alpha=0.9, chunks=CHUNKS, chunks_y=CHUNKS_Y, halo=HALO, pr=1,
        bf16=bf16, interpret=True)
    dtype = torch.bfloat16 if bf16 else torch.float32
    vr, vc = tcost.build_strip_volumes(*(_t(a) for a in images), D, 0.9, CHUNKS, CHUNKS_Y, dtype)
    for ours, ref in ((vr, vr_ref), (vc, vc_ref)):
        assert ours.dtype == dtype and tuple(ours.shape) == tuple(ref.shape)
        err = np.abs(ours.float().numpy() - np.asarray(ref, np.float32)).max()
        assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strip_layouts_hold_the_volume(images, dtype):
    """V_row[i, c, d, h] = C[h, c*chunk_x + i, d], V_col[i, c, d, w] =
    C[c*chunk_y + i, w, d], and the two inverse relayouts give C back."""
    C = tcost.cost_volume(*(_t(a) for a in images[:2]), D, 0.9, *(_t(a) for a in images[2:]),
                          dtype=dtype)
    vr, vc = tcost.build_strip_volumes(*(_t(a) for a in images), D, 0.9, CHUNKS, CHUNKS_Y, dtype)
    g = tcost.strip_geometry(H, W, D, CHUNKS, CHUNKS_Y)
    assert vr.shape == (g.chunk_x, g.chunks_x, D, H) and vc.shape == (g.chunk_y, g.chunks_y, D, W)
    i, c, d, y = 3, 2, 7, 11
    assert vr[i, c, d, y] == C[y, c * g.chunk_x + i, d]
    assert vc[i, c, d, y] == C[c * g.chunk_y + i, y, d]
    assert torch.equal(tcost.volume_from_row_strips(vr), C)
    assert torch.equal(tcost.volume_from_col_strips(vc), C)


@pytest.fixture(scope="module", params=["bf16", "f32"])
def strips(request, images):
    dtype = torch.bfloat16 if request.param == "bf16" else torch.float32
    p = tpm.PatchMatchParams(max_disp=D, chunks=CHUNKS, chunks_y=CHUNKS_Y, halo=HALO, iters=2,
                             right_wta=True, volume_bf16=dtype == torch.bfloat16)
    vr, vc = tcost.build_strip_volumes(*(_t(a) for a in images), D, 0.9, CHUNKS, CHUNKS_Y, dtype)
    C = tcost.volume_from_col_strips(vc)
    seed = tpm.sparse_wta_seed(C, p)
    noise = tpm.unit_noise((H, W), p.noise_seed)
    return dict(p=p, vr=vr, vc=vc, C=C, seed=seed, noise=noise)


def test_strip_twins_equal_volume_twins(strips):
    """Each strip-layout twin gives what its (H, W, D) namesake gives."""
    s = strips
    p, C, vr, vc = s["p"], s["C"], s["vr"], s["vc"]
    disp, cost = tpm._refresh_strip_plain(vc, s["seed"], s["noise"], 8.0, 1)
    ref_d, ref_c = tpm._refresh_plain(C, s["seed"], s["noise"], 8.0, 1)
    assert torch.equal(disp, ref_d) and torch.equal(cost, ref_c)
    for direction, axis in tpm.PASSES:
        V = vr if axis == 1 else vc
        got = tpm._propagate_strip_plain(V, disp, cost, direction, axis, p)
        want = tpm._propagate_plain(C, disp, cost, direction, axis, p)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (direction, axis)
    assert torch.equal(tpm.mask_background_strip_plain(vc, disp, p),
                       tpm.mask_background_plain(C, disp, p))
    full = tpm._match_one_side_strips(vr, vc, s["seed"], s["noise"], p)
    assert torch.equal(full, tpm._match_one_side(C, s["seed"], s["noise"], p))
    assert (full > 0).float().mean() > 0.2


def test_strip_match_matches_jax_prebuilt_kernel(images):
    """patchmatch_disparity with use_strip_volumes against JAX's with the
    in-kernel build feeding the prebuilt fused kernel (both interpret mode)."""
    iml, imr = images[:2]
    base = dict(max_disp=D, chunks=CHUNKS, chunks_y=CHUNKS_Y, halo=HALO, iters=2, right_wta=True,
                volume_bf16=True)
    jp = jpm.PatchMatchParams(**base, use_pallas_fused=True, use_pallas_build=True)
    ref = jpm.patchmatch_disparity(jnp.asarray(iml), jnp.asarray(imr), jp)
    cuda.reset_launches()
    ours = tpm.patchmatch_disparity(_t(iml), _t(imr), tpm.PatchMatchParams(**base, use_strip_volumes=True))
    assert set(cuda.LAUNCHES.values()) == {0}  # the CPU runs the plain twins
    for field in ("left", "right", "left_raw"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert (np.asarray(ref.left) > 0).mean() > 0.1
    plain = tpm.patchmatch_disparity(_t(iml), _t(imr), tpm.PatchMatchParams(**base))
    assert torch.equal(plain.left, ours.left)


@pytest.mark.parametrize("bad", [dict(right_wta=False), dict(cost="zncc"), dict(iters=0)])
def test_strip_volumes_outside_their_mode_raise(bad):
    """JAX ignores use_pallas_build outside right_wta + l1g + iters >= 1; the
    port refuses it instead of falling back."""
    l = torch.zeros(16, 24)
    params = tpm.PatchMatchParams(**{"max_disp": 8, "chunks": 2, "right_wta": True,
                                     "use_strip_volumes": True, **bad})
    with pytest.raises(ValueError, match="use_strip_volumes"):
        tpm.patchmatch_disparity(l, l, params)


def test_cost_volume_relayout_matches_xla(images):
    """The twin's source volume equals XLA's jitted build bit for bit (f32),
    so the twin's relayouts are JAX's relayouts of the same values."""
    iml, imr, gl, gr = images
    C = np.asarray(jax.jit(lambda *a: jcost.cost_volume(a[0], a[1], D, 0.9, a[2], a[3]))(*images))
    g = fused_geometry(H, W, D, CHUNKS, CHUNKS_Y, HALO, 1)
    vc_ref = np.transpose(np.transpose(C, (0, 2, 1)).reshape(g.chunks_y, g.chunk_y, D, W), (1, 0, 2, 3))
    vr_ref = np.transpose(np.transpose(C, (1, 2, 0)).reshape(g.chunks_x, g.chunk_x, D, H), (1, 0, 2, 3))
    vr, vc = tcost.build_strip_volumes_plain(*(_t(a) for a in images), D, 0.9, CHUNKS, CHUNKS_Y)
    np.testing.assert_array_equal(vr.numpy(), vr_ref)
    np.testing.assert_array_equal(vc.numpy(), vc_ref)
