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

``lm_solve_small`` and ``lm_row_sum`` (``csrc/lm_solve.cu``) are the
Levenberg-Marquardt step and its error sums, in an order that does not
depend on the batch (``ops/lm.py``); a float64 tensor launches the double
build of the same code (the float64 fits of ``vio/trilateration.py``),
counted under the same name. ``sea_thru_fit`` (``csrc/sea_thru_fit.cu``)
runs a whole Sea-thru fit, every LM iteration, in one launch, a block a
fit; its plain version is the fits' loop over the two
(``imaging/backscatter.py::backscatter_lm_plain``,
``imaging/attenuation.py::beta_lm_plain``).

``pm_match_strip`` launches the same kernel as ``pm_match``, reading the
volume in the two strip layouts; each has its own entry in
:data:`LAUNCHES`, so a run shows which layout the match went through.
``pm_pass`` launches one of the match's passes alone, for one block of a
frame whose rows are split across devices (``parallel/stereo_sharded.py``).

The wrappers take a batch: any leading axes in front of an image's (H, W)
(cameras) go into the one launch, the camera an index of the grid; for
``lk_track``, the camera is folded into the ring axis, a block a point of
every camera.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .windows import fold_rings

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("cost_volume.cu", "volume_build.cu", "patchmatch.cu", "lk.cu", "lm_solve.cu",
           "sea_thru_fit.cu")
HEADERS = ("cost_terms.cuh", "lm_solve.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"cost_volume": 0, "pm_match": 0, "build_volumes": 0, "pm_match_strip": 0,
            "pm_pass": 0, "lk_track": 0, "lm_solve_small": 0, "lm_row_sum": 0,
            "sea_thru_fit": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def entry_device(device) -> torch.device:
    """An entry point's device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


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
    "opt_cost_volume": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "opt_pm_match": [_P] * 6 + [_I] * 9 + [_F, _F, _I, _P],
    "opt_build_volumes": [_P] * 6 + [_I] * 4 + [_F, _F] + [_I] * 3 + [_P],
    "opt_pm_match_strip": [_P] * 7 + [_I] * 9 + [_F, _F, _I, _P],
    "opt_pm_pass": [_P] * 6 + [_I] * 13 + [_F, _F, _I, _P],
    "opt_lm_solve_small": [_P] * 4 + [_I] * 4 + [_P],
    "opt_lm_row_sum": [_P, _P, _I, _I, _P],
}
for _name in ("opt_lm_solve_small", "opt_lm_row_sum"):
    _SIGNATURES[_name + "_f64"] = _SIGNATURES[_name]


class _LKLevel(ctypes.Structure):
    _fields_ = [("tmpl", _P), ("srch", _P), ("Rt", _I), ("Rs", _I), ("H", _I), ("W", _I),
                ("win", _I)]


LK_MAX_LEVELS = 8


class _LKTrack(ctypes.Structure):
    """csrc/lk.cu's LkTrack, field for field."""
    _fields_ = [("lv", _LKLevel * LK_MAX_LEVELS), ("pts", _P), ("init", _P), ("src_t", _P),
                ("src_s", _P), ("out_pts", _P), ("status", _P), ("levels", _I), ("K", _I),
                ("slack", _I), ("pad", _I), ("max_iters", _I), ("min_eig", _F), ("eps2", _F)]


_SIGNATURES["opt_lk_track"] = [ctypes.POINTER(_LKTrack), _P]
_SIGNATURES["opt_sea_thru_fit"] = [_I] + [_P] * 8 + [_I] * 6 + [_F] * 6 + [_P]


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


def _check_size(*shape: int) -> None:
    """A launch takes fewer than 2^31 volume elements (B*H*W*D)."""
    if math.prod(shape) >= 2**31:
        raise ValueError(f"volumes of {math.prod(shape)} elements are too large for 32-bit "
                         f"indexing")


def _images(tensors):
    """(batch shape, B, H, W) of same-shaped (..., H, W) float32 images."""
    shape = tuple(tensors[0][1].shape)
    if len(shape) < 2:
        raise ValueError(f"images must be (..., H, W), got {shape}")
    for name, t in tensors:
        _require(t, name, (torch.float32,), shape)
    return shape[:-2], math.prod(shape[:-2]), shape[-2], shape[-1]


def _volume_dims(C: torch.Tensor):
    _require(C, "C", (torch.float32, torch.bfloat16))
    if C.ndim < 3:
        raise ValueError(f"C must be (..., H, W, D), got {tuple(C.shape)}")
    _check_size(C.numel())
    *batch, H, W, D = C.shape
    return tuple(batch), math.prod(batch), H, W, D, int(C.dtype == torch.bfloat16)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cost_volume(iml, imr, gl, gr, max_disp: int, alpha: float, beta: float,
                dtype: torch.dtype) -> torch.Tensor:
    """(..., H, W, D) X-stencil cost volume of (..., H, W) images, one
    launch (csrc/cost_volume.cu)."""
    batch, B, H, W = _images((("iml", iml), ("imr", imr), ("gl", gl), ("gr", gr)))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported volume dtype {dtype}")
    _check_size(B, H, W, max_disp)
    out = torch.empty((*batch, H, W, max_disp), dtype=dtype, device=iml.device)
    with torch.cuda.device(iml.device):
        err = library().opt_cost_volume(
            iml.data_ptr(), imr.data_ptr(), gl.data_ptr(), gr.data_ptr(), out.data_ptr(),
            B, H, W, max_disp, alpha, beta, int(dtype == torch.bfloat16), _stream(iml))
    _check(err, "cost_volume")
    LAUNCHES["cost_volume"] += 1
    return out


def _match_buffers(seed, noise, batch, H: int, W: int, dtype):
    """The matches' two front buffers, (..., 2, H, W) in float32 and in the
    volume's dtype, and their (..., H, W) output; checks the (..., H, W)
    seeds and the one (H, W) noise image."""
    _require(seed, "seed", (torch.float32,), (*batch, H, W))
    _require(noise, "noise", (torch.float32,), (H, W))
    return (torch.empty((*batch, 2, H, W), dtype=torch.float32, device=seed.device),
            torch.empty((*batch, 2, H, W), dtype=dtype, device=seed.device),
            torch.empty_like(seed))


def _match_checks(iters: int, chunks_x: int, chunks_y: int, H: int, W: int) -> None:
    if iters < 1:
        raise ValueError(f"the match kernel needs iters >= 1, got {iters}")
    if chunks_x < 1 or W % chunks_x or chunks_y < 1 or H % chunks_y:
        raise ValueError(f"{chunks_x} x {chunks_y} strips do not tile a {H}x{W} image")


def pm_match(C, seed, noise, iters: int, noise_scale0: float, chunks_x: int, chunks_y: int,
             halo: int, patch_radius: int, improve_factor: float) -> torch.Tensor:
    """The whole one-side PatchMatch match over the (..., H, W, D) volumes C
    from the (..., H, W) seeds, with one (H, W) noise image for all, in one
    launch: per iteration the noise and cost refresh and the passes R+ C+
    R- C- (row passes in chunks_x strips, column passes in chunks_y), then
    MaskBackground. Returns the masked (..., H, W) disparities; see
    stereo/patchmatch.py::_match_plain."""
    batch, B, H, W, D, bf16 = _volume_dims(C)
    _match_checks(iters, chunks_x, chunks_y, H, W)
    disp, cost, out = _match_buffers(seed, noise, batch, H, W, C.dtype)
    with torch.cuda.device(C.device):
        err = library().opt_pm_match(
            C.data_ptr(), seed.data_ptr(), noise.data_ptr(), disp.data_ptr(), cost.data_ptr(),
            out.data_ptr(), B, H, W, D, chunks_x, chunks_y, halo, patch_radius, iters,
            noise_scale0, improve_factor, bf16, _stream(C))
    _check(err, "pm_match")
    LAUNCHES["pm_match"] += 1
    return out


def pm_pass(C, disp, cost, noise, H: int, row0: int, chunk: int, vol_row0: int,
            front_row0: int, chunks_x: int, halo: int, patch_radius: int, axis: int,
            forward: bool, fold: bool, scale: float, improve_factor: float):
    """One directional pass of the match for one block of a frame of H rows
    split into blocks of chunk rows, the block of rows [row0, row0 + chunk),
    one launch; see stereo/patchmatch.py::_block_pass_plain. C is (n, W, D),
    the frame's volume rows from vol_row0 on; disp and cost (m, W), the
    pass-start fronts from front_row0 on. axis 1 is a row pass over the
    block's rows in chunks_x x-strips, with ``fold`` the refresh by the
    (chunk, W) noise rows times scale (cost is then not read and may be
    None); axis 0 the column pass of the block's strip, with ``fold`` the
    mask. Returns the block's (chunk, W) disparities and costs, the costs
    None after the mask."""
    _require(C, "C", (torch.float32, torch.bfloat16))
    if C.ndim != 3:
        raise ValueError(f"C must be (rows, W, D), got {tuple(C.shape)}")
    _check_size(C.numel())
    n, W, D = C.shape
    refresh, mask = fold and axis == 1, fold and axis == 0
    _require(disp, "disp", (torch.float32,))
    m = disp.shape[0]
    if disp.shape != (m, W):
        raise ValueError(f"disp must be (rows, {W}), got {tuple(disp.shape)}")
    if not refresh:
        _require(cost, "cost", (C.dtype,), (m, W))
    if refresh:
        _require(noise, "noise", (torch.float32,), (chunk, W))
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (column pass) or 1 (row pass), got {axis}")
    if chunk < 1 or H % chunk or row0 % chunk or not 0 <= row0 < H or chunks_x < 1 \
            or W % chunks_x:
        raise ValueError(f"block rows [{row0}, {row0 + chunk}) with {chunks_x} x-strips do not "
                         f"tile a {H}x{W} frame")
    if axis == 1:  # the block's own rows
        need_v, need_f = (row0, row0 + chunk), (row0, row0 + chunk)
    else:  # the strip's positions, clipped, and their predecessors
        lo, hi = max(row0 - halo, 0), min(row0 + chunk + halo, H)
        need_v, need_f = (lo, hi), (max(lo - 1, 0), min(hi + 1, H))
    for name, first, rows, (a, b) in (("C", vol_row0, n, need_v), ("disp", front_row0, m, need_f)):
        if first > a or first + rows < b:
            raise ValueError(f"{name} holds frame rows [{first}, {first + rows}); the pass reads "
                             f"[{a}, {b})")
    out_d = torch.empty((chunk, W), dtype=torch.float32, device=C.device)
    out_c = None if mask else torch.empty((chunk, W), dtype=C.dtype, device=C.device)
    with torch.cuda.device(C.device):
        err = library().opt_pm_pass(
            C.data_ptr(), disp.data_ptr(), 0 if refresh else cost.data_ptr(),
            noise.data_ptr() if refresh else 0, out_d.data_ptr(),
            0 if mask else out_c.data_ptr(), H, W, D, row0, chunk, vol_row0, front_row0,
            chunks_x, halo, patch_radius, axis, int(forward), int(fold), scale, improve_factor,
            int(C.dtype == torch.bfloat16), _stream(C))
    _check(err, "pm_pass")
    LAUNCHES["pm_pass"] += 1
    return out_d, out_c


def build_volumes(iml, imr, gl, gr, max_disp: int, alpha: float, beta: float, chunks_x: int,
                  chunks_y: int, dtype: torch.dtype):
    """(V_row, V_col): the cost volumes of (..., H, W) images in both strip
    layouts, each with the leading axes in front, one launch
    (csrc/volume_build.cu); see stereo/cost.py for the layouts."""
    batch, B, H, W = _images((("iml", iml), ("imr", imr), ("gl", gl), ("gr", gr)))
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported volume dtype {dtype}")
    if chunks_x < 1 or W % chunks_x or chunks_y < 1 or H % chunks_y:
        raise ValueError(f"{chunks_x} x {chunks_y} strips do not tile a {H}x{W} image")
    _check_size(B, H, W, max_disp)
    V_row = torch.empty((*batch, W // chunks_x, chunks_x, max_disp, H), dtype=dtype,
                        device=iml.device)
    V_col = torch.empty((*batch, H // chunks_y, chunks_y, max_disp, W), dtype=dtype,
                        device=iml.device)
    with torch.cuda.device(iml.device):
        err = library().opt_build_volumes(
            iml.data_ptr(), imr.data_ptr(), gl.data_ptr(), gr.data_ptr(), V_row.data_ptr(),
            V_col.data_ptr(), B, H, W, max_disp, alpha, beta, chunks_x, chunks_y,
            int(dtype == torch.bfloat16), _stream(iml))
    _check(err, "build_volumes")
    LAUNCHES["build_volumes"] += 1
    return V_row, V_col


def pm_match_strip(V_row, V_col, seed, noise, iters: int, noise_scale0: float, halo: int,
                   patch_radius: int, improve_factor: float) -> torch.Tensor:
    """pm_match over the strip layouts of stereo/cost.py: row passes read
    V_row (..., chunk_x, chunks_x, D, H), column passes V_col (...,
    chunk_y, chunks_y, D, W); the passes' strips are the layouts' strips."""
    for name, t in (("V_row", V_row), ("V_col", V_col)):
        _require(t, name, (torch.float32, torch.bfloat16))
        if t.ndim < 4:
            raise ValueError(f"{name} must be a strip volume, got {tuple(t.shape)}")
        _check_size(t.numel())
    *batch, chunk_x, chunks_x, D, H = V_row.shape
    *batch_c, chunk_y, chunks_y, d, W = V_col.shape
    if (batch_c, d, V_col.dtype) != (batch, D, V_row.dtype) or chunk_x * chunks_x != W \
            or chunk_y * chunks_y != H:
        raise ValueError(f"strip volumes {tuple(V_row.shape)} and {tuple(V_col.shape)} do not "
                         f"hold one batch of {H}x{W} volumes in one dtype")
    _match_checks(iters, chunks_x, chunks_y, H, W)
    disp, cost, out = _match_buffers(seed, noise, batch, H, W, V_row.dtype)
    with torch.cuda.device(V_row.device):
        err = library().opt_pm_match_strip(
            V_row.data_ptr(), V_col.data_ptr(), seed.data_ptr(), noise.data_ptr(),
            disp.data_ptr(), cost.data_ptr(), out.data_ptr(), math.prod(batch), H, W, D,
            chunks_x, chunks_y, halo, patch_radius, iters, noise_scale0, improve_factor,
            int(V_row.dtype == torch.bfloat16), _stream(V_row))
    _check(err, "pm_match_strip")
    LAUNCHES["pm_match_strip"] += 1
    return out


def lk_track(tmpl_levels, srch_levels, pts, init, src_t, src_s, wins, slack: int, pad: int,
             min_eig: float, max_iters: int, eps2: float):
    """Every level of one LK direction for K points, one launch (csrc/lk.cu):
    returns the points (K, 2) and the status (K,) bool; see
    tracking/lk.py::lk_track_plain. Level l is the (R, H, W) rings
    tmpl_levels[l] and srch_levels[l], walked with window wins[l] (0 skips
    it). With K = 0 nothing is launched.

    A batch of cameras, points (*batch, K, 2) and rings (*batch, R, H, W),
    is one launch of n*K blocks, n = prod(batch): each camera's ring is
    folded into one ring of n*R frames (ops/windows.py::fold_rings) and a
    point's frame index offset to its camera's frames, so the kernel's own
    clamps never move a point to another camera. Returns (*batch, K, 2)
    and (*batch, K)."""
    levels = len(tmpl_levels)
    if not 1 <= levels <= LK_MAX_LEVELS or len(srch_levels) != levels or len(wins) != levels:
        raise ValueError(f"need 1..{LK_MAX_LEVELS} levels of templates, search images and "
                         f"windows, got {levels}, {len(srch_levels)} and {len(wins)}")
    batch = tuple(pts.shape[:-2])
    for l, (tmpl, srch) in enumerate(zip(tmpl_levels, srch_levels)):
        _require(tmpl, f"tmpl_levels[{l}]", (torch.float32,))
        _require(srch, f"srch_levels[{l}]", (torch.float32,))
        if tmpl.ndim != len(batch) + 3 or srch.ndim != tmpl.ndim \
                or tmpl.shape[-2:] != srch.shape[-2:] \
                or tuple(tmpl.shape[:len(batch)]) != batch \
                or tuple(srch.shape[:len(batch)]) != batch:
            raise ValueError(f"level {l}: templates and search images must be "
                             f"({'*batch, ' if batch else ''}R, H, W) rings of one size, got "
                             f"{tuple(tmpl.shape)} and {tuple(srch.shape)} for points "
                             f"{tuple(pts.shape)}")
    K = pts.shape[-2]
    for name, t in (("pts", pts), ("init", init)):
        _require(t, name, (torch.float32,), (*batch, K, 2))
    for name, t in (("src_t", src_t), ("src_s", src_s)):
        _require(t, name, (torch.int32,), (*batch, K))
    if batch:
        tmpl_levels, src_t = fold_rings(tmpl_levels, src_t, batch, K)
        srch_levels, src_s = fold_rings(srch_levels, src_s, batch, K)
        pts, init = pts.reshape(-1, 2), init.reshape(-1, 2)
    if any(w != 0 and (w < 3 or w % 2 == 0) for w in wins):
        raise ValueError(f"windows must be odd and >= 3 (0 skips a level), got {list(wins)}")
    if slack < 1 or 2 * slack + 3 > 32:
        raise ValueError(f"need 1 <= slack <= 14, got {slack}")
    n = pts.shape[0]
    out = torch.empty((*batch, K, 2), dtype=torch.float32, device=pts.device)
    status = torch.empty((*batch, K), dtype=torch.bool, device=pts.device)
    if n == 0:
        return out, status
    args = _LKTrack(pts=pts.data_ptr(), init=init.data_ptr(), src_t=src_t.data_ptr(),
                    src_s=src_s.data_ptr(), out_pts=out.data_ptr(), status=status.data_ptr(),
                    levels=levels, K=n, slack=slack, pad=pad, max_iters=max_iters,
                    min_eig=min_eig, eps2=eps2)
    for l, (tmpl, srch, win) in enumerate(zip(tmpl_levels, srch_levels, wins)):
        args.lv[l] = _LKLevel(tmpl.data_ptr(), srch.data_ptr(), tmpl.shape[0], srch.shape[0],
                              tmpl.shape[1], tmpl.shape[2], win)
    with torch.cuda.device(pts.device):
        err = library().opt_lk_track(ctypes.byref(args), _stream(pts))
    _check(err, "lk_track")
    LAUNCHES["lk_track"] += 1
    return out, status


LM_MAX_P = 16


LM_DTYPES = (torch.float32, torch.float64)


def _lm_entry(name: str, dtype: torch.dtype):
    """The float or the double build of an LM launch."""
    return getattr(library(), name + ("_f64" if dtype == torch.float64 else ""))


def lm_solve_small(J, r, lam, marquardt: bool) -> torch.Tensor:
    """Each system's damped LM step, one launch (csrc/lm_solve.cu, a block
    a system): (..., N, P) J, (..., N) r and (...) lam, all float32 or all
    float64, give the (..., P) solution of (JtJ + lam * damp) x = -Jtr; see
    ops/lm.py::lm_step_plain."""
    if J.ndim < 2:
        raise ValueError(f"J must be (..., N, P), got {tuple(J.shape)}")
    *batch, N, P = J.shape
    if not 1 <= P <= LM_MAX_P:
        raise ValueError(f"lm_solve_small takes 1..{LM_MAX_P} parameters, got {P}")
    _require(J, "J", LM_DTYPES)
    _require(r, "r", (J.dtype,), (*batch, N))
    _require(lam, "lam", (J.dtype,), batch)
    _check_size(J.numel())
    delta = torch.empty((*batch, P), dtype=J.dtype, device=J.device)
    with torch.cuda.device(J.device):
        err = _lm_entry("opt_lm_solve_small", J.dtype)(
            J.data_ptr(), r.data_ptr(), lam.data_ptr(), delta.data_ptr(), math.prod(batch), N,
            P, int(marquardt), _stream(J))
    _check(err, "lm_solve_small")
    LAUNCHES["lm_solve_small"] += 1
    return delta


def lm_row_sum(x) -> torch.Tensor:
    """Sums over the last axis of (..., N) x, float32 or float64, in the
    pairwise tree order, one launch (csrc/lm_solve.cu, a warp a row); see
    ops/lm.py::tree_sum_plain."""
    if x.ndim < 1:
        raise ValueError("x must have a last axis to sum")
    _require(x, "x", LM_DTYPES)
    _check_size(x.numel())
    out = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lm_entry("opt_lm_row_sum", x.dtype)(x.data_ptr(), out.data_ptr(), out.numel(),
                                                   x.shape[-1], _stream(x))
    _check(err, "lm_row_sum")
    LAUNCHES["lm_row_sum"] += 1
    return out


# The Sea-thru fits of sea_thru_fit: the parameters of both models, the
# samples a fit (K <= 64 leaves a segment of the trees), and the kernel's
# code of each model.
SEA_THRU_P = 12
SEA_THRU_MAX_N = 2048
SEA_THRU_MODELS = {"backscatter": 0, "attenuation": 1}


def _fit_operand(t, name: str, dtype, shape) -> None:
    """dtype and shape first, so that a bad argument raises before the
    device is looked at."""
    if t.dtype != dtype:
        raise ValueError(f"sea_thru_fit: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"sea_thru_fit: {name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def sea_thru_fit(model: str, colour, z, valid, x0, config):
    """One Sea-thru LM fit a block, every iteration in one launch
    (csrc/sea_thru_fit.cu): ``model`` "backscatter" (colour the (..., N, 3)
    rgb samples, x0 the (12,) start or one a camera, (..., 12)) or
    "attenuation" (colour the illuminant E, x0 (G, 12) starts or (..., G,
    12), G fits a camera); z (..., N) float32, valid (..., N) bool; config an
    ``ops/lm.py::LMConfig``. Returns ``LMResult`` (x, error, lambda_,
    n_accepted) with x0's shape, the batch in front. See
    imaging/backscatter.py::backscatter_lm_plain and
    imaging/attenuation.py::beta_lm_plain, the plain versions."""
    from .lm import LMResult

    if model not in SEA_THRU_MODELS:
        raise ValueError(f"sea_thru_fit: model must be one of {list(SEA_THRU_MODELS)}, got "
                         f"{model!r}")
    if z.ndim < 1:
        raise ValueError("sea_thru_fit: z must be (..., N)")
    *batch, N = z.shape
    if not 1 <= N <= SEA_THRU_MAX_N:
        raise ValueError(f"sea_thru_fit takes 1..{SEA_THRU_MAX_N} samples a fit, got {N}")
    if x0.shape[-1:] != (SEA_THRU_P,):
        raise ValueError(f"sea_thru_fit fits {SEA_THRU_P} parameters, got x0 of shape "
                         f"{tuple(x0.shape)}")
    _fit_operand(z, "z", torch.float32, z.shape)
    _fit_operand(colour, "colour", torch.float32, (*batch, N, 3))
    _fit_operand(valid, "valid", torch.bool, (*batch, N))
    starts = 0 if model == "backscatter" else 1  # x0's axes of a camera's fits
    if x0.ndim < 1 + starts:
        raise ValueError(f"sea_thru_fit: {model} takes x0 of shape "
                         f"{'(..., 12)' if starts == 0 else '(..., G, 12)'}, got {tuple(x0.shape)}")
    lead = x0.shape[:x0.ndim - 1 - starts]
    fit_shape = (*batch, *x0.shape[len(lead):-1])
    G = math.prod(x0.shape[len(lead):-1])
    if lead and all(s == 0 for s in x0.stride()[:len(lead)]):
        x0 = x0[(0,) * len(lead)]  # one start expanded over the cameras: read it once
        lead = ()
    if tuple(lead) not in ((), tuple(batch)):
        raise ValueError(f"sea_thru_fit: x0 of shape {tuple(x0.shape)} is neither one start "
                         f"set nor one a camera of {tuple(batch)}")
    _fit_operand(x0, "x0", torch.float32, x0.shape)
    for name, t in (("colour", colour), ("z", z), ("valid", valid), ("x0", x0)):
        _require(t, name, (t.dtype,))
    if config.max_iters < 0:
        raise ValueError(f"sea_thru_fit: max_iters must be >= 0, got {config.max_iters}")
    f32 = [float(np.float32(v)) for v in (
        config.lambda0_scale, config.lambda_up,
        # lam / lambda_down on a CUDA tensor: lam times the float reciprocal.
        np.float32(1.0) / np.float32(config.lambda_down),
        config.step_size, config.min_lambda, config.max_lambda)]
    x = torch.empty((*fit_shape, SEA_THRU_P), dtype=torch.float32, device=z.device)
    error = torch.empty(fit_shape, dtype=torch.float32, device=z.device)
    lam = torch.empty_like(error)
    n_acc = torch.empty(fit_shape, dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        err = library().opt_sea_thru_fit(
            SEA_THRU_MODELS[model], colour.data_ptr(), z.data_ptr(), valid.data_ptr(),
            x0.data_ptr(), x.data_ptr(), error.data_ptr(), lam.data_ptr(), n_acc.data_ptr(),
            math.prod(batch), G, N, int(bool(lead)), config.max_iters,
            int(config.marquardt_diag), *f32, _stream(z))
    _check(err, "sea_thru_fit")
    LAUNCHES["sea_thru_fit"] += 1
    return LMResult(x=x, error=error, lambda_=lam, n_accepted=n_acc)
