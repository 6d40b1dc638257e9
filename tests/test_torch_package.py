"""Package-level checks of the PyTorch port: it imports no JAX, its GPU smoke
test refuses to run without a GPU, its kernel wrappers refuse CPU tensors,
and (on a CUDA machine only) each hand-written kernel equals its plain twin.

The tests marked ``gpu`` skip without a CUDA device. This file imports no
JAX, so on a GPU machine without JAX they run with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_package.py -m gpu -q``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gradient_magnitude
from ocean_perception_tpu_torch.stereo import cost as tcost
from ocean_perception_tpu_torch.stereo import patchmatch as tpm

REPO = Path(__file__).resolve().parent.parent


def _run(code_or_args, cwd, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ocean_perception_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ocean_perception_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n"
    )
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
    # Alone in a directory, without the package, it fails too.
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8, 16)
    C = torch.zeros(8, 16, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.cost_volume(x, x, x, x, 4, 0.9, 0.1, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.pm_refresh(C, x, x, 32.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.pm_propagate(C, x, x.bfloat16(), 1, 1, 4, 5, 1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.pm_mask_background(C, x, 0.8, 1)


def test_cpu_path_launches_no_kernel():
    cuda.reset_launches()
    img = torch.from_numpy(np.random.default_rng(41).random((24, 40)).astype(np.float32))
    out = tpm.patchmatch_disparity(img, torch.roll(img, -3, 1),
                                   tpm.PatchMatchParams(max_disp=8, chunks=4, right_wta=True))
    assert out.left.shape == (24, 40)
    assert set(cuda.LAUNCHES.values()) == {0}


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda._nvcc()
    path = cuda.library_path()
    assert path.name == "libopt_kernels.so" and path.parent.parent.name == "_build"
    assert path == cuda.library_path()  # keyed by the sources and flags only


# --- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels cannot run on the CPU")
    return torch.device("cuda", 0)


def _stereo_inputs(device, H=40, W=64, D=16):
    rng = np.random.default_rng(42)
    canvas = rng.random((H, W + 8)).astype(np.float32)
    l = torch.from_numpy(canvas[:, 8:]).to(device)
    r = torch.from_numpy(canvas[:, 3 : 3 + W]).to(device)
    return l, r, D


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cost_volume_kernel_matches_plain(cuda_device, dtype):
    l, r, D = _stereo_inputs(cuda_device)
    before = cuda.LAUNCHES["cost_volume"]
    ours = tcost.cost_volume(l, r, D, 0.9, dtype=dtype)
    assert cuda.LAUNCHES["cost_volume"] == before + 1
    plain = tcost.cost_volume_plain(l, r, D, 0.9, gradient_magnitude(l), gradient_magnitude(r), dtype)
    torch.cuda.synchronize()
    assert torch.equal(ours, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [True, False])
def test_patchmatch_kernels_match_plain(cuda_device, bf16):
    l, r, D = _stereo_inputs(cuda_device)
    p = tpm.PatchMatchParams(max_disp=D, chunks=4, chunks_y=3, iters=2, right_wta=True, volume_bf16=bf16)
    C = tcost.cost_volume(l, r, D, 0.9, dtype=torch.bfloat16 if bf16 else torch.float32)
    seed = tpm.sparse_wta_seed(C, p)
    noise = tpm.unit_noise(seed.shape, p.noise_seed, device=cuda_device)

    disp, cost = cuda.pm_refresh(C, seed, noise, 8.0, 1)
    ref_disp = tpm.add_foreground_noise(seed, noise, 8.0)
    assert torch.equal(disp, ref_disp) and torch.equal(cost, tpm._full_cost_map(C, ref_disp, 1))
    for direction, axis in ((1, 1), (1, 0), (-1, 1), (-1, 0)):
        k_d, k_c = tpm._propagate(C, disp, cost, direction, axis, p)
        p_d, p_c = tpm._propagate_plain(C, disp, cost, direction, axis, p)
        assert torch.equal(k_d, p_d) and torch.equal(k_c, p_c), (direction, axis)
    assert torch.equal(tpm.mask_background(C, disp, p), tpm.mask_background_plain(C, disp, p))

    cuda.reset_launches()
    full = tpm._match_one_side(C, seed, noise, p)
    assert cuda.LAUNCHES == {"cost_volume": 0, "pm_refresh": 2, "pm_propagate": 8, "pm_mask_background": 1}
    plain = seed
    for it in range(p.iters):
        plain = tpm.add_foreground_noise(plain, noise, p.noise_scale0 / 2.0**it)
        c = tpm._full_cost_map(C, plain, 1)
        for direction, axis in ((1, 1), (1, 0), (-1, 1), (-1, 0)):
            plain, c = tpm._propagate_plain(C, plain, c, direction, axis, p)
    assert torch.equal(full, tpm.mask_background_plain(C, plain, p))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_matches_cpu_end_to_end(cuda_device):
    l, r, D = _stereo_inputs(cuda_device)
    p = tpm.PatchMatchParams(max_disp=D, chunks=4, right_wta=True, volume_bf16=True)
    gpu = tpm.patchmatch_disparity(l, r, p)
    cpu = tpm.patchmatch_disparity(l.cpu(), r.cpu(), p)
    assert torch.equal(gpu.left.cpu(), cpu.left)
