#!/usr/bin/env python
"""Shape of pm_propagate's row-pass walk on one NVIDIA GPU.

``csrc/patchmatch.cu`` resolves ``kSpecHwd`` steps of a row pass's walk per
round trip to the (H, W, D) volume and ``kSpecRowStrips`` to V_row (column
passes do not speculate), with ``kLanes`` rows to a block. This script
builds that source once for each triple in ``VARIANTS`` (a copy with the
constants replaced, into
``ocean_perception_tpu_torch/_build/``), checks every build's
``pm_propagate`` and ``pm_propagate_strip`` bit for bit against their plain
twins at the 720p shapes of ``chip_smoke.py`` (all four passes, bf16 and
float32, seeded and adversarial fronts), and times each pass of each layout
in bf16 for every build, in turns (the builds in order, then reversed), by
``torch.profiler`` and by CUDA-graph replay. A depth of 1 is the walk
without speculation.

Prints one line per build, pass and layout, then the card's name and power
limit, then one JSON object with the mean device time a pass of each build.

Run: ``python pm_spec_sweep.py`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gradient_magnitude, pyr_down, to_grayscale
from ocean_perception_tpu_torch.stereo import cost as sc
from ocean_perception_tpu_torch.stereo import patchmatch as pm

# (kSpecHwd, kSpecRowStrips, kLanes): the row-pass walk's depth on the
# (H, W, D) volume and on V_row, and the rows of a row-pass block.
VARIANTS = ((1, 1, 16), (2, 1, 16), (3, 1, 16), (4, 1, 16), (8, 1, 16), (4, 2, 16), (4, 1, 32))


def set_constant(src: str, name: str, value: int) -> str:
    pattern = re.compile(rf"constexpr int {name} = \d+;")
    if len(pattern.findall(src)) != 1:
        raise RuntimeError(f"patchmatch.cu must define {name} exactly once")
    return pattern.sub(f"constexpr int {name} = {value};", src)


def build_variant(hwd: int, row_strips: int, lanes: int) -> ctypes.CDLL:
    """patchmatch.cu with kSpecHwd = hwd, kSpecRowStrips = row_strips and
    kLanes = lanes, as a library with the pm entry points."""
    src = (cuda._CSRC / "patchmatch.cu").read_text()
    for name, value in (("kSpecHwd", hwd), ("kSpecRowStrips", row_strips), ("kLanes", lanes)):
        src = set_constant(src, name, value)
    out_dir = cuda._BUILD / "spec_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = str(out_dir / f"libpm_spec{hwd}_{row_strips}_{lanes}.so")
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cu = os.path.join(tmp, "patchmatch.cu")
        with open(cu, "w") as f:
            f.write(src)
        proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                               lib, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {hwd, row_strips, lanes}:\n{proc.stderr}")
    spills = sorted(set(re.findall(r"\d+ bytes spill stores", proc.stderr)))
    print(f"[build] {hwd, row_strips, lanes}: {spills}")
    dll = ctypes.CDLL(lib)
    for name in ("opt_pm_propagate", "opt_pm_propagate_strip"):
        fn = getattr(dll, name)
        fn.argtypes = cuda._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return dll


def main() -> int:
    _, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    left, right = (torch.as_tensor(a, device=dev) for a in cs.make_inputs(cs.make_canvas()))
    iml, imr = pyr_down(to_grayscale(left)), pyr_down(to_grayscale(right))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    Hs, Ws = iml.shape
    D = cs.MAX_DISP // cs.SCALE
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    pr = p.patch_radius
    vols = {}
    for dtype in (torch.bfloat16, torch.float32):
        C = sc.cost_volume_plain(iml, imr, D, p.alpha, gl, gr, dtype)
        v_row, v_col = sc.build_strip_volumes_plain(iml, imr, gl, gr, D, p.alpha, p.chunks,
                                                    p.chunks_y, dtype)
        vols[dtype] = C, v_row, v_col
    seed = pm.sparse_wta_seed(vols[torch.bfloat16][0], p)
    noise = pm.unit_noise((Hs, Ws), p.noise_seed, device=dev)

    def strips(axis):
        return pm._effective_chunks(Ws if axis == 1 else Hs, p.chunks)

    def hwd(C):
        return (lambda d, c, direction, axis: cuda.pm_propagate(C, d, c, direction, axis,
                                                                strips(axis), p.halo, pr),
                lambda d, c, direction, axis: pm._propagate_plain(C, d, c, direction, axis, p))

    def strip(v_row, v_col):
        def V(axis):
            return v_row if axis == 1 else v_col
        return (lambda d, c, direction, axis: cuda.pm_propagate_strip(V(axis), d, c, direction,
                                                                      axis, p.halo, pr),
                lambda d, c, direction, axis: pm._propagate_strip_plain(V(axis), d, c, direction,
                                                                        axis, p))

    libs = {v: build_variant(*v) for v in VARIANTS}
    for v, lib in libs.items():
        cuda.library = lambda lib=lib: lib
        for dtype, (C, v_row, v_col) in vols.items():
            fronts = {"seeded": pm._refresh_plain(C, seed, noise, p.noise_scale0, pr),
                      "adversarial": cs.adversarial_fronts(C, (Hs, Ws))}
            cs.check_passes(f"{v} pm_propagate {dtype}", *hwd(C), fronts)
            cs.check_passes(f"{v} pm_propagate_strip {dtype}", *strip(v_row, v_col), fronts)

    C, v_row, v_col = vols[torch.bfloat16]
    d0, c0 = pm._refresh_plain(C, seed, noise, p.noise_scale0, pr)
    layouts = {"pm_propagate": hwd(C)[0], "pm_propagate_strip": strip(v_row, v_col)[0]}
    times = {(v, name, i): [] for v in VARIANTS for name in layouts for i in range(4)}
    for order in (VARIANTS, VARIANTS[::-1]):
        for v in order:
            cuda.library = lambda lib=libs[v]: lib
            for name, kernel in layouts.items():
                for i, (direction, axis) in enumerate(cs.PASSES):
                    def call(direction=direction, axis=axis, kernel=kernel):
                        return kernel(d0, c0, direction, axis)
                    times[(v, name, i)].append((cs.profiler_ms(name, call), cs.graph_ms(call)))

    result = {}
    for v in VARIANTS:
        for name in layouts:
            per_pass = []
            for i, (direction, axis) in enumerate(cs.PASSES):
                prof = [t[0] for t in times[(v, name, i)]]
                prof = statistics.mean(prof) if None not in prof else None
                graph = statistics.mean(t[1] for t in times[(v, name, i)])
                per_pass.append(dict(profiler_ms=prof, graph_ms=graph))
                print(f"[sweep] {v} {name} dir={direction:+d} axis={axis}: "
                      f"device {cs.fmt_ms(prof)} (profiler), {graph:.5f} ms (graph replay)")
            profiled = all(t["profiler_ms"] is not None for t in per_pass)
            key = "profiler_ms" if profiled else "graph_ms"
            result.setdefault(str(v), {})[name] = dict(
                device_ms=statistics.mean(t[key] for t in per_pass),
                device_method="profiler" if profiled else "graph replay", passes=per_pass)
    print(smi)
    print(json.dumps({"variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
