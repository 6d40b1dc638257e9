"""Build, load and launch the hand-written Hopper kernels in ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded through ``ctypes``: one ``nvcc`` per source,
all started together, then one link. The build runs at first use, into
``ocean_perception_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
cached library.

Each wrapper below checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if
the launch was refused, and adds one to its entry in :data:`LAUNCHES`. The
wrappers only take CUDA tensors; the plain PyTorch twins live beside the
public functions that dispatch to them (``stereo/cost.py``,
``stereo/patchmatch.py``, ``tracking/lk.py``).

The ``*_strip`` PatchMatch wrappers launch the same kernels as their
namesakes, reading the volume in a strip layout; each has its own entry in
:data:`LAUNCHES`, so a run shows which layout the match went through.
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
SOURCES = ("cost_volume.cu", "volume_build.cu", "patchmatch.cu", "lk.cu")
HEADERS = ("cost_terms.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"cost_volume": 0, "pm_refresh": 0, "pm_propagate": 0, "pm_mask_background": 0,
            "build_volumes": 0, "pm_refresh_strip": 0, "pm_propagate_strip": 0,
            "pm_mask_background_strip": 0, "lk_prep": 0, "lk_walk": 0}


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
    for name in SOURCES + HEADERS:
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
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        ptxas = ["-Xptxas", "-v"] if verbose else []
        jobs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(_CSRC / name)]
            jobs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, _, proc in jobs:  # wait for every job, failed or not
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
            elif verbose:
                print(err, end="")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "opt_cost_volume": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P],
    "opt_pm_refresh": [_P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _P],
    "opt_pm_propagate": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "opt_pm_mask_background": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "opt_build_volumes": [_P] * 6 + [_I] * 3 + [_F, _F] + [_I] * 3 + [_P],
    "opt_pm_refresh_strip": [_P, _P, _P, _F, _P, _P] + [_I] * 6 + [_P],
    "opt_pm_propagate_strip": [_P] * 5 + [_I] * 9 + [_P],
    "opt_pm_mask_background_strip": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
    "opt_lk_prep": [_P] * 9 + [_I] * 8 + [_F, _P],
    "opt_lk_walk": [_P] * 5 + [_I] * 6 + [_F, _P],
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


def build_volumes(iml, imr, gl, gr, max_disp: int, alpha: float, beta: float, chunks_x: int,
                  chunks_y: int, dtype: torch.dtype):
    """(V_row, V_col): the cost volume in both strip layouts
    (csrc/volume_build.cu); see stereo/cost.py for the layouts."""
    H, W = iml.shape
    for name, t in (("iml", iml), ("imr", imr), ("gl", gl), ("gr", gr)):
        _require(t, name, (torch.float32,), (H, W))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported volume dtype {dtype}")
    if chunks_x < 1 or W % chunks_x or chunks_y < 1 or H % chunks_y:
        raise ValueError(f"{chunks_x} x {chunks_y} strips do not tile a {H}x{W} image")
    if H * W * max_disp >= 2**31:
        raise ValueError("volume too large for 32-bit pixel indexing")
    V_row = torch.empty((W // chunks_x, chunks_x, max_disp, H), dtype=dtype, device=iml.device)
    V_col = torch.empty((H // chunks_y, chunks_y, max_disp, W), dtype=dtype, device=iml.device)
    with torch.cuda.device(iml.device):
        err = library().opt_build_volumes(
            iml.data_ptr(), imr.data_ptr(), gl.data_ptr(), gr.data_ptr(), V_row.data_ptr(),
            V_col.data_ptr(), H, W, max_disp, alpha, beta, chunks_x, chunks_y,
            int(dtype == torch.bfloat16), _stream(iml))
    _check(err, "build_volumes")
    LAUNCHES["build_volumes"] += 1
    return V_row, V_col


def _strip_dims(V: torch.Tensor, disp: torch.Tensor, axis: int):
    """(H, W, D, chunks, bf16) of a strip layout for (H, W) fronts: V_col
    (chunk, chunks, D, W) for axis 0, V_row (chunk, chunks, D, H) for axis 1."""
    _require(V, "V", (torch.float32, torch.bfloat16))
    _require(disp, "disp", (torch.float32,))
    if V.ndim != 4 or disp.ndim != 2:
        raise ValueError(f"need a 4-d strip volume and (H, W) fronts, got {tuple(V.shape)} "
                         f"and {tuple(disp.shape)}")
    H, W = disp.shape
    chunk, chunks, D, N = V.shape
    dim, lanes = (W, H) if axis == 1 else (H, W)
    if N != lanes or chunk * chunks != dim:
        raise ValueError(f"strip volume {tuple(V.shape)} does not fit {H}x{W} fronts "
                         f"along axis {axis}")
    if V.numel() >= 2**31:
        raise ValueError("volume too large for 32-bit pixel indexing")
    return H, W, D, chunks, int(V.dtype == torch.bfloat16)


def pm_refresh_strip(V_col, disp, noise, scale: float, patch_radius: int):
    """pm_refresh over V_col (chunk_y, chunks_y, D, W)."""
    H, W, D, chunks, bf16 = _strip_dims(V_col, disp, 0)
    _require(noise, "noise", (torch.float32,), (H, W))
    disp_out = torch.empty_like(disp)
    cost_out = torch.empty((H, W), dtype=V_col.dtype, device=V_col.device)
    with torch.cuda.device(V_col.device):
        err = library().opt_pm_refresh_strip(
            V_col.data_ptr(), disp.data_ptr(), noise.data_ptr(), scale, disp_out.data_ptr(),
            cost_out.data_ptr(), H, W, D, chunks, patch_radius, bf16, _stream(V_col))
    _check(err, "pm_refresh_strip")
    LAUNCHES["pm_refresh_strip"] += 1
    return disp_out, cost_out


def pm_propagate_strip(V, disp, cost, direction: int, axis: int, halo: int, patch_radius: int):
    """pm_propagate over V_row (axis 1, a row pass) or V_col (axis 0); the
    pass's strips are the layout's."""
    if axis not in (0, 1) or direction not in (1, -1):
        raise ValueError(f"bad pass axis={axis} direction={direction}")
    H, W, D, chunks, bf16 = _strip_dims(V, disp, axis)
    _require(cost, "cost", (V.dtype,), (H, W))
    disp_out = torch.empty_like(disp)
    cost_out = torch.empty_like(cost)
    with torch.cuda.device(V.device):
        err = library().opt_pm_propagate_strip(
            V.data_ptr(), disp.data_ptr(), cost.data_ptr(), disp_out.data_ptr(),
            cost_out.data_ptr(), H, W, D, axis, int(direction > 0), chunks, halo, patch_radius,
            bf16, _stream(V))
    _check(err, "pm_propagate_strip")
    LAUNCHES["pm_propagate_strip"] += 1
    return disp_out, cost_out


def pm_mask_background_strip(V_col, disp, improve_factor: float, patch_radius: int) -> torch.Tensor:
    """pm_mask_background over V_col (chunk_y, chunks_y, D, W)."""
    H, W, D, chunks, bf16 = _strip_dims(V_col, disp, 0)
    out = torch.empty_like(disp)
    with torch.cuda.device(V_col.device):
        err = library().opt_pm_mask_background_strip(
            V_col.data_ptr(), disp.data_ptr(), out.data_ptr(), H, W, D, chunks, patch_radius,
            improve_factor, bf16, _stream(V_col))
    _check(err, "pm_mask_background_strip")
    LAUNCHES["pm_mask_background_strip"] += 1
    return out


def lk_prep(tmpl, srch, pts, guess, src_t, src_s, win: int, slack: int, pad: int,
            min_eig: float):
    """One LK level's prep for K points (csrc/lk.cu): returns corr (K, 2, A, A),
    scal (K, 8) and the template gate okg (K,) bool; see tracking/lk.py."""
    _require(tmpl, "tmpl", (torch.float32,))
    _require(srch, "srch", (torch.float32,))
    if tmpl.ndim != 3 or srch.ndim != 3 or tmpl.shape[1:] != srch.shape[1:]:
        raise ValueError(f"tmpl and srch must be (R, H, W) rings of one level, got "
                         f"{tuple(tmpl.shape)} and {tuple(srch.shape)}")
    K = pts.shape[0]
    for name, t in (("pts", pts), ("guess", guess)):
        _require(t, name, (torch.float32,), (K, 2))
    for name, t in (("src_t", src_t), ("src_s", src_s)):
        _require(t, name, (torch.int32,), (K,))
    if win < 1 or win % 2 == 0 or slack < 1:
        raise ValueError(f"need an odd window and slack >= 1, got win={win} slack={slack}")
    A = 2 * slack + 3
    corr = torch.empty((K, 2, A, A), dtype=torch.float32, device=tmpl.device)
    scal = torch.empty((K, 8), dtype=torch.float32, device=tmpl.device)
    okg = torch.empty((K,), dtype=torch.bool, device=tmpl.device)
    R_t, H, W = tmpl.shape
    with torch.cuda.device(tmpl.device):
        err = library().opt_lk_prep(
            tmpl.data_ptr(), srch.data_ptr(), pts.data_ptr(), guess.data_ptr(),
            src_t.data_ptr(), src_s.data_ptr(), corr.data_ptr(), scal.data_ptr(),
            okg.data_ptr(), R_t, srch.shape[0], H, W, K, win, slack, pad, min_eig,
            _stream(tmpl))
    _check(err, "lk_prep")
    LAUNCHES["lk_prep"] += 1
    return corr, scal, okg


def lk_walk(corr, scal, pos0, r: int, ws: int, pad: int, max_iters: int, eps2: float):
    """One LK level's Gauss-Newton walk for K points (csrc/lk.cu): returns
    pos (K, 2) and hit (K,) bool; see tracking/lk.py."""
    K = corr.shape[0]
    A = corr.shape[-1]
    _require(corr, "corr", (torch.float32,), (K, 2, A, A))
    _require(scal, "scal", (torch.float32,), (K, 8))
    _require(pos0, "pos0", (torch.float32,), (K, 2))
    if A > 32:
        raise ValueError(f"surfaces wider than 32 offsets (got {A}) are not supported")
    pos = torch.empty_like(pos0)
    hit = torch.empty((K,), dtype=torch.bool, device=corr.device)
    with torch.cuda.device(corr.device):
        err = library().opt_lk_walk(
            corr.data_ptr(), scal.data_ptr(), pos0.data_ptr(), pos.data_ptr(), hit.data_ptr(),
            K, A, r, ws, pad, max_iters, eps2, _stream(corr))
    _check(err, "lk_walk")
    LAUNCHES["lk_walk"] += 1
    return pos, hit
