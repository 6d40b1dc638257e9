"""The PyTorch port's perception_step against the JAX reference on the CPU,
end to end, and the config/rig bridge (ocean_perception_tpu_torch.convert).

Both sides are built from one JAX config and rig through convert.py and fed
the same float32 images. Tolerance: disparity within 1e-3 px on >= 99% of
pixels and valid masks agreeing on >= 99%. Grayscale, the cost volume and
the whole PatchMatch stage are bit-exact given equal inputs
(test_torch_stereo.py); pyr_down's horizontal pass is a matmul in XLA and
shifted adds here, which can flip a bf16 cost rounding and, through it, a
near-tie in the match. The enhanced image is not compared here: its LM fits
are ill-conditioned (test_torch_imaging.py, ROADMAP.md Queue 3).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ocean_perception_tpu.core import cameras as jcam
from ocean_perception_tpu.models import perception as jmodel
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.models import perception as tmodel


def _scene(H, W, d, seed=0):
    """Box-smoothed random canvas, right(y, x - d) == left(y, x), tinted."""
    rng = np.random.default_rng(seed)
    canvas = rng.random((H, W + 64)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
    canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas).astype(np.float32)
    tint = np.array([0.35, 0.75, 0.9], np.float32)
    left = np.clip(canvas[:, 32 : 32 + W, None] * tint + 0.05, 0, 1)
    right = np.clip(canvas[:, 32 + d : 32 + d + W, None] * tint + 0.05, 0, 1)
    return left.astype(np.float32), right.astype(np.float32)


CASES = {
    # __graft_entry__.entry()'s configuration: 64x96, full resolution, max_disp 32.
    "entry": lambda: (*[np.array(a) for a in graft._tiny_inputs()], graft._rig(),
                      jmodel.PerceptionConfig(engine="patchmatch", max_disp=32, internal_scale=1)),
    # The production operating point's shape of work, small: /2 internally.
    "half_res": lambda: (*_scene(128, 192, 8), graft._rig(128, 192),
                         jmodel.PerceptionConfig(engine="patchmatch", max_disp=32, internal_scale=2)),
    # The strip-volume build and match (JAX: the in-kernel Pallas build).
    "strip_volumes": lambda: (*_scene(48, 64, 5), graft._rig(48, 64),
                              jmodel.PerceptionConfig(engine="patchmatch", max_disp=16,
                                                      internal_scale=1, chunks=4, scan_unroll=1,
                                                      use_pallas_build=True, run_enhance=False)),
    "sgm": lambda: (*_scene(128, 192, 8), graft._rig(128, 192),
                    jmodel.PerceptionConfig(engine="sgm", max_disp=32, internal_scale=2,
                                            scan_unroll=1, run_enhance=False)),
    "wta": lambda: (*_scene(128, 192, 8), graft._rig(128, 192),
                    jmodel.PerceptionConfig(engine="wta", max_disp=32, internal_scale=2,
                                            run_enhance=False)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    left, right, rig, cfg = CASES[request.param]()
    ref = jax.jit(lambda a, b: jmodel.perception_step(a, b, rig, cfg))(left, right)
    ours = tmodel.perception_step(torch.from_numpy(left), torch.from_numpy(right),
                                  convert.stereo_camera_from_jax(rig),
                                  convert.perception_config_from_jax(cfg), device="cpu")
    return dict(ref=[np.asarray(x) for x in ref], ours=[x.numpy() for x in ours], H=left.shape[0],
                W=left.shape[1])


def test_disparity_matches_jax(case):
    dj, dt = case["ref"][0], case["ours"][0]
    assert dt.shape == dj.shape == (case["H"], case["W"])
    assert (np.abs(dt - dj) <= 1e-3).mean() >= 0.99
    assert ((dt > 0) == (dj > 0)).mean() >= 0.99
    assert (dj > 0).mean() > 0.2


def test_depth_and_enhanced_outputs(case):
    (dj, zj, _), (dt, zt, et) = case["ref"], case["ours"]
    same = dt == dj
    np.testing.assert_allclose(zt[same], zj[same], rtol=1e-6)
    assert ((zt > 0) == (zj > 0)).mean() >= 0.99
    assert et.shape == (case["H"], case["W"], 3) and np.isfinite(et).all()


def test_convert_and_rig():
    cam = jcam.PinholeCamera.create(700.0, 701.5, 640.0, 360.0, 720, 1280)
    rig = jcam.StereoCamera.create(cam, cam, baseline=0.12)
    trig = convert.stereo_camera_from_jax(rig)
    assert trig.fx == float(np.float32(700.0)) and trig.left.height == 720
    d = np.random.default_rng(31).uniform(-1, 60, (16, 32)).astype(np.float32)
    np.testing.assert_array_equal(trig.disp_to_depth(torch.from_numpy(d)).numpy(),
                                  np.asarray(rig.disp_to_depth(d)))
    half = trig.rescale(0.5)
    jhalf = rig.rescale(0.5)
    assert (half.left.width, half.left.cx) == (jhalf.left.width, float(jhalf.left.cx))

    cfg = convert.perception_config_from_jax(jmodel.PerceptionConfig(max_disp=64, chunks=8))
    assert (cfg.max_disp, cfg.internal_scale, cfg.chunks, cfg.run_enhance) == (64, 2, 8, True)
    assert cfg.enhance == tmodel.EnhanceParams() and not cfg.use_strip_volumes
    for build in (True, False):
        cfg = convert.perception_config_from_jax(jmodel.PerceptionConfig(engine="sgm",
                                                                         use_pallas_build=build))
        assert (cfg.engine, cfg.use_strip_volumes) == ("sgm", build)


def test_unported_config_raises():
    """What perception_step refuses: an unknown engine, a scale that is not
    a power of two, the strip volumes outside their mode, and (without a
    GPU) a run on the card that the caller did not move to the CPU."""
    left, right = graft._tiny_inputs()
    rig = convert.stereo_camera_from_jax(graft._rig())
    l, r = torch.from_numpy(np.array(left)), torch.from_numpy(np.array(right))
    with pytest.raises(ValueError, match="engine"):
        tmodel.perception_step(l, r, rig, tmodel.PerceptionConfig(engine="census"), device="cpu")
    with pytest.raises(ValueError):
        tmodel.perception_step(l, r, rig, tmodel.PerceptionConfig(internal_scale=3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodel.perception_step(l, r, rig, tmodel.PerceptionConfig(max_disp=32, internal_scale=1))
    out = tmodel.perception_step(np.array(left), np.array(right), rig,
                                 tmodel.PerceptionConfig(max_disp=32, internal_scale=1,
                                                         run_enhance=False), device="cpu")
    assert torch.equal(out.enhanced_left, l)
    for engine in ("sgm", "wta"):
        out = tmodel.perception_step(l, r, rig, tmodel.PerceptionConfig(
            engine=engine, max_disp=32, internal_scale=1, run_enhance=False), device="cpu")
        assert out.disparity.shape == l.shape[:2] and torch.isfinite(out.depth).all()
