#!/usr/bin/env python
"""Device time of the two cost-volume kernels, in turns with an earlier
version of their sources, on one NVIDIA GPU.

Builds ``csrc/cost_volume.cu`` and ``csrc/volume_build.cu`` (with
``cost_terms.cuh``) as one library for each of: the sources in ``--parent``
(default ``ocean_perception_tpu_torch/_build/parent_csrc/``, which must hold
the three files of the version to compare with, for example written there
with ``git show <commit>:ocean_perception_tpu_torch/csrc/<file>``); those of
each ``--compare NAME=DIR``; this checkout's sources; and each entry of
``VARIANTS``, this checkout's sources with another tile. Each build goes
into ``ocean_perception_tpu_torch/_build/cost_turns/`` (``turns.py``).

Every build's ``cost_volume`` and ``build_volumes`` are checked bit for bit
against their plain twins at the 720p shapes of ``chip_smoke.py`` (bf16 and
float32). Then each kernel is timed in both dtypes by ``torch.profiler`` and
by CUDA-graph replay, in turns: the builds in order, then reversed (parent,
compared, this, variants..., variants..., this, compared, parent), so that
the card's drift shows.

Prints one line per build, kernel, dtype and turn, then the card's name and
power limit, then one JSON object with each build's mean device time.

Run: ``python cost_turns.py [--parent DIR] [--compare NAME=DIR ...]`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import turns
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gradient_magnitude, pyr_down, to_grayscale
from ocean_perception_tpu_torch.stereo import cost as sc
from ocean_perception_tpu_torch.stereo import patchmatch as pm

FILES = ("cost_volume.cu", "volume_build.cu", "cost_terms.cuh")
# name: edits. Each edit (source, old, new) replaces the one occurrence of
# old in this checkout's source; each variant computes the same function
# (another tile), so it is checked bit for bit like the others.
VARIANTS = {
    "cost_volume kRun=30": [("cost_volume.cu", "constexpr int kRun = 14;",
                             "constexpr int kRun = 30;")],
}


def build(name: str, src_dir, edits=()) -> turns.Build:
    """The three files from src_dir, edits applied, as one library with the
    two cost-volume entry points."""
    texts = {f: turns.edited((src_dir / f).read_text(),
                             [(old, new) for g, old, new in edits if g == f], f"{name}: {f}")
             for f in FILES}
    return turns.Build(texts, turns.signatures(texts.values(),
                                               ("opt_cost_volume", "opt_build_volumes")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=str(cuda._BUILD / "parent_csrc"))
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=DIR",
                    help="another version's three sources to time beside the parent's")
    args = ap.parse_args()
    _, smi = cs.phase_device()
    sources = {"parent": Path(args.parent)}
    sources.update((name, Path(d)) for name, d in (c.split("=", 1) for c in args.compare))
    for name, d in sources.items():
        missing = [f for f in FILES if not (d / f).is_file()]
        if missing:
            raise FileNotFoundError(f"{name}: {d} lacks {missing}")

    dev = torch.device("cuda", 0)
    left, right = (torch.as_tensor(a, device=dev) for a in cs.make_inputs(cs.make_canvas()))
    iml, imr = pyr_down(to_grayscale(left)), pyr_down(to_grayscale(right))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    Hs, Ws = iml.shape
    D = cs.MAX_DISP // cs.SCALE
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    g = sc.strip_geometry(Hs, Ws, D, p.chunks, p.chunks_y)
    a, b = float(np.float32(p.alpha)), float(np.float32(1.0 - p.alpha))
    dtypes = (torch.bfloat16, torch.float32)
    plain = {dt: sc.cost_volume_plain(iml, imr, D, p.alpha, gl, gr, dt) for dt in dtypes}
    strips = {dt: sc.strips_from_volume(plain[dt], g) for dt in dtypes}

    calls = {}
    for dt in dtypes:
        calls[("cost_volume", dt)] = lambda dt=dt: cuda.cost_volume(iml, imr, gl, gr, D, a, b, dt)
        calls[("build_volumes", dt)] = lambda dt=dt: cuda.build_volumes(
            iml, imr, gl, gr, D, a, b, g.chunks_x, g.chunks_y, dt)

    builds = {name: build(name, d) for name, d in sources.items()}
    builds["this"] = build("this", cuda._CSRC)
    builds.update({name: build(name, cuda._CSRC, edits) for name, edits in VARIANTS.items()})
    libs = {name: turns.loaded(lib, builds[name].files.values())
            for name, lib in turns.build_all("cost_turns", builds).items()}
    for name, lib in libs.items():
        cuda.library = lambda lib=lib: lib
        for dt in dtypes:
            cs.require_equal(f"{name} cost_volume {dt}", calls[("cost_volume", dt)](), plain[dt])
            for got, want in zip(calls[("build_volumes", dt)](), strips[dt]):
                cs.require_equal(f"{name} build_volumes {dt}", got, want)
        print(f"[check] {name}: cost_volume and build_volumes bit-identical to their twins "
              f"in bf16 and float32")

    times = {(name, key): [] for name in libs for key in calls}
    for _, name in turns.turn_order(libs):
        cuda.library = lambda lib=libs[name]: lib
        for (kernel, dt), fn in calls.items():
            t = (cs.profiler_ms(kernel, fn), cs.graph_ms(fn))
            times[(name, (kernel, dt))].append(t)
            print(f"[turns] {name} {kernel} {dt}: device {cs.fmt_ms(t[0])} (profiler), "
                  f"{t[1]:.5f} ms (graph replay)")

    result = {}
    for (name, (kernel, dt)), ts in times.items():
        prof = [t[0] for t in ts]
        result.setdefault(name, {})[f"{kernel} {dt}"] = dict(
            profiler_ms=statistics.mean(prof) if None not in prof else "not measured",
            graph_ms=statistics.mean(t[1] for t in ts), turns=[list(t) for t in ts])
    print(smi)
    print(json.dumps({"builds": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
