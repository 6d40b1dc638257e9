"""The Sea-thru fits as one launch each (``csrc/sea_thru_fit.cu``): their
plain version on the CPU, the wrapper's checks, and the kernel on the card.

On a CUDA tensor ``fit_backscatter`` and ``fit_beta`` launch
``sea_thru_fit`` once; on the CPU they run its plain version,
``backscatter_lm_plain`` and ``beta_lm_plain`` (``ops/lm.py::lm_solve`` over
the models' residuals and Jacobians), whose bits are the fits' before the
kernel. Here, on the CPU:

- the plain version with and without ``kernels`` and the fits' public
  functions give the same bits, at B = 1 and 3 cameras and G = 1, 2 and 3
  starts, and in the single-start form;
- a batch is each camera's fit and each start's fit alone, bit for bit;
- the wrapper raises before any launch on a fit it cannot run (too many
  samples, another dtype, another parameter count, a start of another
  batch, a CPU tensor).

On the card (``gpu``): ``sea_thru_fit`` equals its plain version run on the
card without the port's kernels, and the plain version with
``lm_solve_small`` and ``lm_row_sum``, in x, error, lambda and the accepted
steps, bit for bit, on cameras of unlike water at the perception step's
shapes (N = 256; B = 1 and 4; G = 2 and 3) and at N = 20, 33, 300 and 2048;
each camera alone as in its batch; and on ``chip_smoke.fit_adversarial``'s
fits (no valid sample, a sample at z = inf, zero ranges, a start far off, a
start whose model overflows). A fit makes exactly one launch.

This file imports no JAX: on a GPU machine without JAX, run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sea_thru_fit.py -m gpu -q``.
"""

import pytest
import torch

from ocean_perception_tpu_torch.imaging import attenuation as att
from ocean_perception_tpu_torch.imaging import backscatter as bs
from ocean_perception_tpu_torch.ops import cuda

N = 96  # samples a camera on the CPU: a few of the trees' levels, cheap


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers
    would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b) -> bool:
    import chip_smoke as cs

    return all(cs.same_bits(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("B", [1, 3])
def test_backscatter_plain_routes_agree_on_cpu(B):
    import chip_smoke as cs

    rgb, z, valid = cs.fit_samples("backscatter", B, N, "cpu", seed=B)
    if B == 1:
        rgb, z, valid = rgb[0], z[0], valid[0]
    x0, config = cs.fit_start("backscatter", "cpu"), bs.backscatter_config(10)
    plain = bs.backscatter_lm_plain(rgb, z, valid, x0, config)
    assert _equal(plain, bs.backscatter_lm_plain(rgb, z, valid, x0, config, kernels=True))
    fit = bs.fit_backscatter(rgb, z, valid, 10)
    assert torch.equal(torch.cat(fit[:4], dim=-1), plain.x) and torch.equal(fit.error, plain.error)
    assert plain.x.shape == z.shape[:-1] + (12,) and int(plain.n_accepted.min()) > 0


@pytest.mark.parametrize("B, G", [(1, 1), (1, 2), (3, 2), (3, 3)])
def test_attenuation_plain_routes_agree_on_cpu(B, G):
    import chip_smoke as cs

    E, z, valid = cs.fit_samples("attenuation", B, N, "cpu", seed=10 + B)
    x0, config = cs.fit_start("attenuation", "cpu", G), att.beta_config(20)
    if B > 1 and G == 3:  # starts of each camera's own
        x0 = x0 + 0.01 * torch.arange(B, dtype=torch.float32)[:, None, None]
    plain = att.beta_lm_plain(E, z, valid, x0, config)
    assert _equal(plain, att.beta_lm_plain(E, z, valid, x0, config, kernels=True))
    fit = att.fit_beta(z, E, valid, 20, x0)
    assert torch.equal(fit.X, plain.x) and torch.equal(fit.error, plain.error)
    assert plain.x.shape == (B, G, 12) and int(plain.n_accepted.min()) > 0
    if G == 1:  # the single-start form
        one = att.fit_beta(z, E, valid, 20, x0[0])
        assert torch.equal(one.X, plain.x[:, 0]) and torch.equal(one.error, plain.error[:, 0])


def test_each_camera_and_start_is_its_own_fit_on_cpu():
    """Three cameras of unlike water, three starts each: every (camera,
    start) fit equals that camera's fit from that start alone, and every
    camera's backscatter fit its fit alone, bit for bit."""
    import chip_smoke as cs

    E, z, valid = cs.fit_samples("attenuation", 3, N, "cpu", seed=21)
    x0 = cs.fit_start("attenuation", "cpu", 3)
    many = att.beta_lm_plain(E, z, valid, x0, att.beta_config(20))
    rgb, zb, vb = cs.fit_samples("backscatter", 3, N, "cpu", seed=22)
    backs = bs.backscatter_lm_plain(rgb, zb, vb, cs.fit_start("backscatter", "cpu"),
                                    bs.backscatter_config(10))
    for b in range(3):
        for g in range(3):
            one = att.beta_lm_plain(E[b], z[b], valid[b], x0[g:g + 1], att.beta_config(20))
            assert _equal([t[0] for t in one], [t[b, g] for t in many]), (b, g)
        one = bs.backscatter_lm_plain(rgb[b], zb[b], vb[b], cs.fit_start("backscatter", "cpu"),
                                      bs.backscatter_config(10))
        assert _equal(one, [t[b] for t in backs]), b


def _fit_args(model, B=2, n=N, G=2):
    import chip_smoke as cs

    colour, z, valid = cs.fit_samples(model, B, n, "cpu")
    config = (bs.backscatter_config() if model == "backscatter" else att.beta_config())
    return colour, z, valid, cs.fit_start(model, "cpu", G), config


def _bad(model, change):
    args = list(_fit_args(model))
    return change(args) or args


@pytest.mark.parametrize("model, change, message", [
    ("backscatter", lambda a: _fit_args("backscatter", n=2049), "1..2048 samples"),
    ("attenuation", lambda a: _fit_args("attenuation", n=2049), "1..2048 samples"),
    ("backscatter", lambda a: a.__setitem__(0, a[0].double()), "colour must be torch.float32"),
    ("attenuation", lambda a: a.__setitem__(1, a[1].half()), "z must be torch.float32"),
    ("attenuation", lambda a: a.__setitem__(2, a[2].float()), "valid must be torch.bool"),
    ("backscatter", lambda a: a.__setitem__(3, a[3][:3]), "fits 12 parameters"),
    ("attenuation", lambda a: a.__setitem__(3, a[3][:, :6]), "fits 12 parameters"),
    ("attenuation", lambda a: a.__setitem__(3, a[3].expand(5, 2, 12).clone()),
     "neither one start set nor one a camera"),
    ("attenuation", lambda a: a.__setitem__(3, a[3][0]), "takes x0 of shape"),
    ("backscatter", lambda a: None, "must be a CUDA tensor"),
], ids=["backscatter-N", "attenuation-N", "dtype-colour", "dtype-z", "dtype-valid", "P-backscatter",
        "P-attenuation", "x0-batch", "x0-rank", "cpu"])
def test_sea_thru_fit_checks_raise_before_a_launch(monkeypatch, model, change, message):
    def no_library():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(cuda, "library", no_library)
    before = dict(cuda.LAUNCHES)
    with pytest.raises(ValueError, match=message):
        cuda.sea_thru_fit(model, *_bad(model, change))
    assert cuda.LAUNCHES == before


# --- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels cannot run on the CPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("model, B, n, G", [
    ("backscatter", 1, 256, 1), ("backscatter", 4, 256, 1), ("attenuation", 1, 256, 2),
    ("attenuation", 4, 256, 3), ("backscatter", 3, 20, 1), ("attenuation", 3, 33, 2),
    ("backscatter", 2, 300, 1), ("attenuation", 2, 2048, 2), ("backscatter", 1, 2048, 1)])
def test_sea_thru_fit_matches_plain_on_the_card(cuda_device, model, B, n, G):
    import chip_smoke as cs

    colour, z, valid = cs.fit_samples(model, B, n, cuda_device, seed=B + n)
    x0 = cs.fit_start(model, cuda_device, G)
    if model == "attenuation" and G == 3:  # starts of each camera's own
        x0 = (x0 + 0.01 * torch.arange(B, device=cuda_device)[:, None, None]).contiguous()
    call = (model, colour, z, valid, x0, cs.FIT_CONFIG[model]())
    before = dict(cuda.LAUNCHES)
    cs.require_same_fit("test", call)  # every camera alone as in its batch, too
    got = cuda.sea_thru_fit(*call)
    assert cuda.LAUNCHES["sea_thru_fit"] > before["sea_thru_fit"]
    assert torch.isfinite(got.x).all() and int(got.n_accepted.min()) > 0


@pytest.mark.gpu
def test_fits_launch_once_each_on_the_card(cuda_device):
    import chip_smoke as cs

    rgb, z, valid = cs.fit_samples("backscatter", 2, 256, cuda_device)
    E, _, _ = cs.fit_samples("attenuation", 2, 256, cuda_device)
    cuda.reset_launches()
    bs.fit_backscatter(rgb, z, valid)
    att.fit_beta(z, E, valid, X0=cs.fit_start("attenuation", cuda_device))
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {"sea_thru_fit": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(10))
def test_sea_thru_fit_adversarial_on_the_card(cuda_device, case):
    import chip_smoke as cs

    tag, call = cs.fit_adversarial(256, cuda_device)[case]
    cs.require_same_fit(tag, call)
