#!/usr/bin/env python
"""Device time of ``pm_pass`` by kind of pass, in turns with an earlier
version of ``csrc/patchmatch.cu``, on one NVIDIA GPU.

Builds ``patchmatch.cu`` as one library for each of: the source in
``--parent FILE`` (default
``ocean_perception_tpu_torch/_build/parent_pass/patchmatch.cu``, for
example written there with ``git show
<commit>:ocean_perception_tpu_torch/csrc/patchmatch.cu``; skipped when
absent), each ``--compare NAME=FILE``, this checkout's source, and each
entry of ``VARIANTS``, this source with constants replaced. Every build's
nvcc starts together (``turns.py``), each into
``ocean_perception_tpu_torch/_build/pass_turns/``, and ptxas's registers,
stack frames and spills are printed for each.

The inputs are ``chip_smoke.py`` phase 18's: the 720p scene at half
resolution, its rows over N = 2 and 4 blocks, ``sharded_patchmatch`` at
D = 64 in bf16 with every ``pm_pass`` call of a frame recorded (24 at N=2,
48 at N=4). Every build is first checked bit for bit against
``_block_pass_plain`` on each recorded call and on its adversarial forms
(``chip_smoke.adversarial_block_args``: the adversarial seed and the tie
volume). Then, for each N and kind of pass (R+ with the refresh, R-, C+/C-,
the last C- with the mask), a frame's launches of that kind are timed by
``torch.profiler`` (the device time of every kernel in the window, which
must all be ``pm_pass``) and by CUDA-graph replay, in turns: the builds in
order, then in reverse (A B B A), so that the card's drift shows.

Prints one line a build, N, kind and turn, then the card's name and power
limit, then one JSON object with each build's mean µs a launch.

Run: ``python pass_turns.py [--parent FILE] [--compare NAME=FILE ...]``
(needs one GPU and nvcc; no network; about 3 minutes, 2 of them nvcc).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import threading
from pathlib import Path

import torch

import chip_smoke as cs
import turns
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import pyr_down, to_grayscale
from ocean_perception_tpu_torch.parallel.mesh import make_mesh
from ocean_perception_tpu_torch.parallel.stereo_sharded import sharded_patchmatch
from ocean_perception_tpu_torch.stereo import patchmatch as pm

SIGNATURES = {"opt_pm_pass": cuda._SIGNATURES["opt_pm_pass"]}
# name: {constant: value}, each replacing the one definition of a constant
# of patchmatch.cu; every variant computes the same function.
VARIANTS = {
    "16 words a batch": {"kWalkWords": 16},
    "1 walk a block": {"kWalkWarps": 1},
    "4 walks a block": {"kWalkWarps": 4},
    "rows as row_pass": {"kWalkRows": 0},
}
KINDS = {(1, True): "R+ (refresh)", (1, False): "R-", (0, False): "C+/C-", (0, True): "last C- (mask)"}


def variant(text: str, consts: dict, name: str) -> str:
    return turns.edited(text, [(re.search(rf"constexpr int {c} = \d+;", text).group(0),
                                f"constexpr int {c} = {v};") for c, v in consts.items()],
                        f"{name}: patchmatch.cu")


def record_frames(dev) -> dict:
    """{N: [(block_pass arguments, outputs)]}: every pm_pass of one frame of
    phase 18's sharded match, with this checkout's library."""
    left, right = (torch.as_tensor(a, device=dev) for a in cs.make_inputs(cs.make_canvas()))
    gray_l, gray_r = to_grayscale(left), to_grayscale(right)
    for _ in range(cs.SCALE.bit_length() - 1):
        gray_l, gray_r = pyr_down(gray_l), pyr_down(gray_r)
    pmp = pm.PatchMatchParams(max_disp=cs.MAX_DISP // cs.SCALE, right_wta=True, volume_bf16=True)
    frames = {}
    for n in cs.SHARD_BLOCKS:
        mesh = make_mesh(axis_names=("strip",), devices=[dev] * n)
        frames[n] = cs.record_block_passes(lambda: sharded_patchmatch(gray_l, gray_r, mesh, pmp))[1]
    return frames


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=cuda._BUILD / "parent_pass" / "patchmatch.cu")
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=FILE",
                    help="another patchmatch.cu with this checkout's opt_pm_pass")
    args = ap.parse_args()
    _, smi = cs.phase_device()
    dev = torch.device("cuda", 0)

    this = (cuda._CSRC / "patchmatch.cu").read_text()
    builds = {}
    if args.parent.is_file():
        builds["parent"] = turns.Build({"patchmatch.cu": args.parent.read_text()}, SIGNATURES)
    else:
        print(f"[build] no {args.parent}: the parent is not timed")
    for name, f in (c.split("=", 1) for c in args.compare):
        builds[name] = turns.Build({"patchmatch.cu": Path(f).read_text()}, SIGNATURES)
    builds["this"] = turns.Build({"patchmatch.cu": this}, SIGNATURES)
    for name, consts in VARIANTS.items():
        builds[name] = turns.Build({"patchmatch.cu": variant(this, consts, name)}, SIGNATURES)
    # The whole library (the recorded frames need cost_volume too) builds
    # beside the turns' builds.
    whole = threading.Thread(target=cuda.build)
    whole.start()
    libs = turns.build_all("pass_turns", builds)
    whole.join()
    default = cuda.library

    frames = record_frames(dev)
    inputs = {n: {"the path's": [a for a, _ in calls],
                  **{adv: [cs.adversarial_block_args(a, adv) for a, _ in calls]
                     for adv in ("adversarial seed", "tie volume")}}
              for n, calls in frames.items()}
    want = {(n, tag): [pm._block_pass_plain(*a) for a in calls]
            for n, sets in inputs.items() for tag, calls in sets.items()}

    def use(name):
        cuda.library = lambda: libs[name]

    for name in libs:
        use(name)
        for (n, tag), refs in want.items():
            for a, ref in zip(inputs[n][tag], refs):
                ours = pm.block_pass(*a)
                for x, y in zip(ours, ref):
                    if (x is None) != (y is None) or (x is not None and not cs.same_bits(x, y)):
                        raise AssertionError(f"{name}: N={n}, {tag} inputs, pass (axis {a[5]}, "
                                             f"fold {a[6]}, rows {a[7].row0}+) differs from the twin")
        print(f"[check] {name}: bit-identical to _block_pass_plain on every pass of a frame at "
              f"N = {', '.join(map(str, frames))}, on the path's, the adversarial seed's and the "
              f"tie volume's inputs")

    kinds = {(n, kind): [a for a, _ in calls if (a[5], a[6]) == key]
             for n, calls in frames.items() for key, kind in KINDS.items()}
    times = {}
    for turn, name in turns.turn_order(libs):
        use(name)
        for (n, kind), calls in kinds.items():
            fn = lambda calls=calls: [pm.block_pass(*a) for a in calls]  # noqa: E731
            prof = turns.kernels_ms(fn, cs.N_TIMED, names=["pm_pass"])
            t = dict(profiler_us=None if prof is None else prof * 1e3 / len(calls),
                     graph_us=cs.graph_ms(fn) * 1e3 / len(calls))
            times.setdefault((name, n, kind), []).append(t)
            print(f"[turn {turn}] {name} N={n} {kind} x{len(calls)}: "
                  + ("not measured" if prof is None else f"{t['profiler_us']:.2f} us")
                  + f" (profiler), {t['graph_us']:.2f} us (graph replay) a launch")
    cuda.library = default

    result = {}
    for (name, n, kind), ts in times.items():
        prof = [t["profiler_us"] for t in ts]
        result.setdefault(name, {}).setdefault(f"N={n}", {})[kind] = dict(
            profiler_us=statistics.mean(prof) if None not in prof else "not measured",
            graph_us=statistics.mean(t["graph_us"] for t in ts))
    if "parent" in result:
        for name in result:
            ratios = [result[name][f"N={n}"][kind]["profiler_us"]
                      / result["parent"][f"N={n}"][kind]["profiler_us"]
                      for n in frames for kind in KINDS.values()
                      if isinstance(result[name][f"N={n}"][kind]["profiler_us"], float)
                      and isinstance(result["parent"][f"N={n}"][kind]["profiler_us"], float)]
            if ratios:
                print(f"[ratio] {name} against the parent, profiler: "
                      + ", ".join(f"{r:.3f}" for r in ratios) + " (N and kind in order)")
    print(smi)
    print(json.dumps({"builds": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
