"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded through ``ctypes``. The build runs at first
use, into ``ocean_perception_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the cached library.

Each wrapper below checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if
the launch was refused, and adds one to its entry in :data:`LAUNCHES`. The
wrappers only take CUDA tensors; the plain PyTorch twins live beside the
public functions that dispatch to them (``stereo/cost.py``,
``stereo/patchmatch.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("cost_volume.cu", "patchmatch.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"cost_volume": 0, "pm_refresh": 0, "pm_propagate": 0, "pm_mask_background": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the Hopper kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return _BUILD / h.hexdigest()[:16] / "libopt_kernels.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build beside the target and rename, so a concurrent or interrupted
    # build never leaves a partial library under the final name.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(_CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "opt_cost_volume": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P],
    "opt_pm_refresh": [_P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _P],
    "opt_pm_propagate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "opt_pm_mask_background": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _require(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _volume_dims(C: torch.Tensor):
    _require(C, "C", (torch.float32, torch.bfloat16))
    if C.ndim != 3:
        raise ValueError(f"C must be (H, W, D), got {tuple(C.shape)}")
    if C.numel() >= 2**31:
        raise ValueError("volume too large for 32-bit pixel indexing")
    return C.shape[0], C.shape[1], C.shape[2], int(C.dtype == torch.bfloat16)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cost_volume(iml, imr, gl, gr, max_disp: int, alpha: float, beta: float,
                dtype: torch.dtype) -> torch.Tensor:
    """(H, W, D) X-stencil cost volume (csrc/cost_volume.cu)."""
    H, W = iml.shape
    for name, t in (("iml", iml), ("imr", imr), ("gl", gl), ("gr", gr)):
        _require(t, name, (torch.float32,), (H, W))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported volume dtype {dtype}")
    out = torch.empty((H, W, max_disp), dtype=dtype, device=iml.device)
    with torch.cuda.device(iml.device):
        err = library().opt_cost_volume(
            iml.data_ptr(), imr.data_ptr(), gl.data_ptr(), gr.data_ptr(), out.data_ptr(),
            H, W, max_disp, alpha, beta, int(dtype == torch.bfloat16), _stream(iml))
    _check(err, "cost_volume")
    LAUNCHES["cost_volume"] += 1
    return out


def pm_refresh(C, disp, noise, scale: float, patch_radius: int):
    """Foreground noise plus cost-map refresh: returns (disp', cost of disp')."""
    H, W, D, bf16 = _volume_dims(C)
    _require(disp, "disp", (torch.float32,), (H, W))
    _require(noise, "noise", (torch.float32,), (H, W))
    disp_out = torch.empty_like(disp)
    cost_out = torch.empty((H, W), dtype=C.dtype, device=C.device)
    with torch.cuda.device(C.device):
        err = library().opt_pm_refresh(
            C.data_ptr(), disp.data_ptr(), noise.data_ptr(), scale, disp_out.data_ptr(),
            cost_out.data_ptr(), H, W, D, patch_radius, bf16, _stream(C))
    _check(err, "pm_refresh")
    LAUNCHES["pm_refresh"] += 1
    return disp_out, cost_out


def pm_propagate(C, disp, cost, direction: int, axis: int, chunks: int, halo: int,
                 patch_radius: int):
    """One directional strip pass: returns the new (disp, cost)."""
    H, W, D, bf16 = _volume_dims(C)
    _require(disp, "disp", (torch.float32,), (H, W))
    _require(cost, "cost", (C.dtype,), (H, W))
    if axis not in (0, 1) or direction not in (1, -1):
        raise ValueError(f"bad pass axis={axis} direction={direction}")
    dim = W if axis == 1 else H
    if chunks < 1 or dim % chunks:
        raise ValueError(f"{chunks} strips do not tile an axis of {dim}")
    disp_out = torch.empty_like(disp)
    cost_out = torch.empty_like(cost)
    with torch.cuda.device(C.device):
        err = library().opt_pm_propagate(
            C.data_ptr(), disp.data_ptr(), cost.data_ptr(), disp_out.data_ptr(),
            cost_out.data_ptr(), H, W, D, axis, int(direction > 0), chunks, dim // chunks,
            halo, patch_radius, bf16, _stream(C))
    _check(err, "pm_propagate")
    LAUNCHES["pm_propagate"] += 1
    return disp_out, cost_out


def pm_mask_background(C, disp, improve_factor: float, patch_radius: int) -> torch.Tensor:
    """Zero disparities that do not beat improve_factor * cost(0) (interior only)."""
    H, W, D, bf16 = _volume_dims(C)
    _require(disp, "disp", (torch.float32,), (H, W))
    out = torch.empty_like(disp)
    with torch.cuda.device(C.device):
        err = library().opt_pm_mask_background(
            C.data_ptr(), disp.data_ptr(), out.data_ptr(), H, W, D, patch_radius,
            improve_factor, bf16, _stream(C))
    _check(err, "pm_mask_background")
    LAUNCHES["pm_mask_background"] += 1
    return out
