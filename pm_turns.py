#!/usr/bin/env python
"""Device time of the PatchMatch match, in turns with an earlier version of
``csrc/patchmatch.cu``, on one NVIDIA GPU.

Builds ``patchmatch.cu`` as one library for each of: the source in
``--parent`` (default ``ocean_perception_tpu_torch/_build/parent_csrc/``,
which must hold an earlier version's ``patchmatch.cu`` with its per-stage
entry points ``opt_pm_refresh``, ``opt_pm_propagate``,
``opt_pm_mask_background`` and their ``_strip`` forms, for example written
there with ``git show <commit>:ocean_perception_tpu_torch/csrc/patchmatch.cu``;
skipped when absent); each ``--compare NAME=FILE``, another version of
``patchmatch.cu`` with this checkout's entry points ``opt_pm_match`` and
``opt_pm_match_strip`` (with or without the batch size, ``turns.py``);
this checkout's source, one cooperative launch a
match; and each entry of ``VARIANTS``, this source with one constant
replaced. Each build goes into ``ocean_perception_tpu_torch/_build/pm_turns/``
(``turns.py``).

The match is the 720p path's: ``chip_smoke.py``'s scene at half
resolution, its (H, W, D) volume and strip layouts in bf16, the path's seed
and noise. The parent runs a match as its 16 launches (3 refreshes, 12
passes, the mask). Every build's match on both layouts is first checked bit
for bit against ``_match_plain``, on the path's seed and on an adversarial
one. Then a match on each layout is timed by ``torch.profiler`` (the device
time of all its kernels), by CUDA-graph replay (a match's launches captured
in one graph, gaps included) and by one Python call (the host's enqueue
included), in turns: the builds in order, then in reverse, so that the
card's drift shows.

Then this checkout's kernel is built once more with ``%globaltimer`` stamps
(``stamped``): thread 0 of every block records when the block starts each
pass (after the grid barrier) and when it has finished its work items. Run
on the (H, W, D) match, they give each pass's span (the first start to the
last finish), the slowest block's work and the gap from a pass's last
finish to the next pass's first start (the barrier).

Then this checkout's (H, W, D) match is timed once right after its volume
was read whole (hot in L2) and once right after a 256 MB buffer was written
(the 50 MB L2 flushed of it), ten times each in turns: CUDA events around
the match alone, the host's enqueue hidden behind a sleep kernel queued
first.

Prints one line per build, layout and turn, the stamps' spans, the hot and
cold times, then the card's name and power limit, then one JSON object with
each build's mean times.

Run: ``python pm_turns.py [--parent DIR] [--compare NAME=FILE ...]`` (needs one GPU and
nvcc; no network).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

import torch

import chip_smoke as cs
import turns
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gradient_magnitude, pyr_down, to_grayscale
from ocean_perception_tpu_torch.stereo import cost as sc
from ocean_perception_tpu_torch.stereo import patchmatch as pm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGNATURES = {
    "opt_pm_refresh": [_P, _P, _P, _F, _P, _P] + [_I] * 5 + [_P],
    "opt_pm_propagate": [_P] * 5 + [_I] * 10 + [_P],
    "opt_pm_mask_background": [_P] * 3 + [_I] * 4 + [_F, _I, _P],
    "opt_pm_refresh_strip": [_P, _P, _P, _F, _P, _P] + [_I] * 6 + [_P],
    "opt_pm_propagate_strip": [_P] * 5 + [_I] * 9 + [_P],
    "opt_pm_mask_background_strip": [_P] * 3 + [_I] * 5 + [_F, _I, _P],
}
THIS_SIGNATURES = {k: cuda._SIGNATURES[k] for k in ("opt_pm_match", "opt_pm_match_strip")}
# name: {constant: value}, each replacing the one definition of a constant
# of patchmatch.cu; every variant computes the same function.
VARIANTS = {
    "spec 2": {"kSpecHwd": 2},
    "2 blocks an SM": {"kMinBlocks": 2},
    "32 columns an item": {"kColumns": 32},
    "64 columns an item": {"kColumns": 64},
}


MAX_BLOCKS, MAX_PASSES = 1024, 64
STAMP_START = "    if (ph > 0) cg::this_grid().sync();\n"
STAMP_END = "      }\n    }\n  }\n}\n\n// Blocks of kernel that can be resident"


def stamped(text: str) -> str:
    """patchmatch.cu with thread 0 of every block writing %globaltimer into
    g_stamps[block][pass][0] after each pass's barrier and into [1] once
    the block's work items of the pass are done, and opt_stamps to read
    them."""
    stamp = ("if (threadIdx.x == 0) {{ unsigned long long t; asm volatile(\"mov.u64 %0, "
             "%%globaltimer;\" : \"=l\"(t)); g_stamps[(blockIdx.x * {p} + ph) * 2 + {i}] = t; }}")
    text = turns.edited(text, [
        (STAMP_START, STAMP_START + "    " + stamp.format(p=MAX_PASSES, i=0) + "\n"),
        (STAMP_END, "      }\n    }\n    __syncthreads();\n    " + stamp.format(p=MAX_PASSES, i=1)
         + STAMP_END[len("      }\n    }"):]),
    ], "patchmatch.cu")
    return turns.with_stamps(text, "unsigned long long", MAX_BLOCKS * MAX_PASSES * 2)


def pass_spans(lib, run, passes: int) -> None:
    """Each pass's span, slowest block and barrier gap on one run of the
    stamped build (the third, so that the code and data are warm)."""
    cuda.library = lambda: lib
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    raw = torch.zeros(MAX_BLOCKS * MAX_PASSES * 2, dtype=torch.int64)
    cuda._check(lib.opt_stamps(ctypes.c_void_p(raw.data_ptr())), "opt_stamps")
    t = raw.reshape(MAX_BLOCKS, MAX_PASSES, 2)[:, :passes].double()
    t = t[t[:, 0, 0] > 0]  # the blocks of the launch
    t0 = float(t[:, 0, 0].min())
    spans = []
    for ph in range(passes):
        start, end = t[:, ph, 0] - t0, t[:, ph, 1] - t0
        gap = float(t[:, ph + 1, 0].min() - t0 - end.max()) if ph + 1 < passes else 0.0
        spans.append(float(end.max() - start.min()))
        print(f"[stamps] pass {ph} ({'R+ C+ R- C-'.split()[ph % 4]}): starts {float(start.min()) / 1e3:.2f} "
              f"us, span {spans[-1] / 1e3:.2f} us, slowest block {float((end - start).max()) / 1e3:.2f} "
              f"us, then {gap / 1e3:.2f} us to the next pass's first start")
    total = float(t[:, passes - 1, 1].max() - t0)
    print(f"[stamps] {t.shape[0]} blocks; passes {sum(spans) / 1e3:.2f} us of the launch's "
          f"{total / 1e3:.2f} us (first start to last finish), barriers the rest")


def parent_match(lib, vol, seed, noise, p, strips: bool) -> torch.Tensor:
    """The parent's match: 3 refreshes, 12 passes and the mask, one launch
    each, on vol (the (H, W, D) volume, or (V_row, V_col))."""
    H, W = seed.shape
    V_row, V_col = vol if strips else (vol, vol)
    D, dtype = (V_row.shape[2], V_row.dtype) if strips else (vol.shape[2], vol.dtype)
    bf16, pr = int(dtype == torch.bfloat16), p.patch_radius
    s = torch.cuda.current_stream().cuda_stream
    chunks = {1: sc._effective_chunks(W, p.chunks), 0: sc._effective_chunks(H, pm._strips(p, 0))}

    def fronts():
        return (torch.empty((H, W), dtype=torch.float32, device=seed.device),
                torch.empty((H, W), dtype=dtype, device=seed.device))

    disp = seed.float().contiguous()
    for it in range(p.iters):
        d, c = fronts()
        scale = p.noise_scale0 / 2.0**it
        if strips:
            err = lib.opt_pm_refresh_strip(V_col.data_ptr(), disp.data_ptr(), noise.data_ptr(),
                                           scale, d.data_ptr(), c.data_ptr(), H, W, D, chunks[0],
                                           pr, bf16, s)
        else:
            err = lib.opt_pm_refresh(vol.data_ptr(), disp.data_ptr(), noise.data_ptr(), scale,
                                     d.data_ptr(), c.data_ptr(), H, W, D, pr, bf16, s)
        cuda._check(err, "parent refresh")
        disp, cost = d, c
        for direction, axis in pm.PASSES:
            d, c = fronts()
            n = chunks[axis]
            if strips:
                err = lib.opt_pm_propagate_strip(
                    (V_row if axis == 1 else V_col).data_ptr(), disp.data_ptr(), cost.data_ptr(),
                    d.data_ptr(), c.data_ptr(), H, W, D, axis, int(direction > 0), n, p.halo, pr,
                    bf16, s)
            else:
                err = lib.opt_pm_propagate(
                    vol.data_ptr(), disp.data_ptr(), cost.data_ptr(), d.data_ptr(), c.data_ptr(),
                    H, W, D, axis, int(direction > 0), n, (W if axis == 1 else H) // n, p.halo,
                    pr, bf16, s)
            cuda._check(err, "parent pass")
            disp, cost = d, c
    out = torch.empty_like(disp)
    if strips:
        err = lib.opt_pm_mask_background_strip(V_col.data_ptr(), disp.data_ptr(), out.data_ptr(),
                                               H, W, D, chunks[0], pr, p.improve_factor, bf16, s)
    else:
        err = lib.opt_pm_mask_background(vol.data_ptr(), disp.data_ptr(), out.data_ptr(), H, W,
                                         D, pr, p.improve_factor, bf16, s)
    cuda._check(err, "parent mask")
    return out


def hot_and_cold(run, C, dev) -> None:
    """The match's time right after C was read whole, and right after a
    256 MB buffer was written: median and range of 10 of each."""
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    words = C.view(torch.int16)
    times = {"hot": [], "cold": []}
    run()
    for _ in range(10):
        for state in times:
            if state == "hot":
                words.sum()
            else:
                scratch.fill_(1)
            torch.cuda._sleep(1_000_000)  # about 0.5 ms: the host enqueues the match meanwhile
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times[state].append(start.elapsed_time(end))
    for state, t in times.items():
        print(f"[l2] the match with its volume {state}: median {statistics.median(t):.5f} ms "
              f"(range {min(t):.5f}-{max(t):.5f}) over {len(t)} runs")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=cuda._BUILD / "parent_csrc")
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=FILE",
                    help="another patchmatch.cu with this checkout's entry points")
    args = ap.parse_args()
    _, smi = cs.phase_device()
    dev = torch.device("cuda", 0)

    this = (cuda._CSRC / "patchmatch.cu").read_text()
    builds = {}
    parent_cu = args.parent / "patchmatch.cu"
    if parent_cu.is_file():
        builds["parent"] = turns.Build({"patchmatch.cu": parent_cu.read_text()}, PARENT_SIGNATURES)
    else:
        print(f"[build] no {parent_cu}: the parent is not timed")
    for name, f in (c.split("=", 1) for c in args.compare):
        text = Path(f).read_text()
        builds[name] = turns.Build({"patchmatch.cu": text},
                                   turns.signatures([text], THIS_SIGNATURES))
    builds["this"] = turns.Build({"patchmatch.cu": this}, THIS_SIGNATURES)
    for name, consts in VARIANTS.items():
        text = turns.edited(this, [(re.search(rf"constexpr int {c} = \d+;", this).group(0),
                                    f"constexpr int {c} = {v};") for c, v in consts.items()],
                            f"{name}: patchmatch.cu")
        builds[name] = turns.Build({"patchmatch.cu": text}, THIS_SIGNATURES)
    builds["stamped"] = turns.Build({"patchmatch.cu": stamped(this)},
                                    dict(THIS_SIGNATURES, opt_stamps=[_P]))
    libs = {name: lib if name == "parent" else turns.loaded(lib, builds[name].files.values())
            for name, lib in turns.build_all("pm_turns", builds).items()}
    stamps = libs.pop("stamped")

    left, right = (torch.as_tensor(a, device=dev) for a in cs.make_inputs(cs.make_canvas()))
    iml, imr = pyr_down(to_grayscale(left)), pyr_down(to_grayscale(right))
    gl, gr = gradient_magnitude(iml), gradient_magnitude(imr)
    D = cs.MAX_DISP // cs.SCALE
    p = pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    C = sc.cost_volume_plain(iml, imr, D, p.alpha, gl, gr, torch.bfloat16)
    V = sc.build_strip_volumes_plain(iml, imr, gl, gr, D, p.alpha, p.chunks, p.chunks_y,
                                     torch.bfloat16)
    seed = pm.sparse_wta_seed(C, p)
    noise = pm.unit_noise(iml.shape, p.noise_seed, device=dev)
    seeds = {"the path's": (seed, noise),
             "an adversarial": cs.adversarial_seed(tuple(seed.shape), D, dev)}
    layouts = {"(H, W, D)": (C, False), "strips": (V, True)}
    want = {(lay, tag): pm._match_plain(C, C, s, n, p) for lay in layouts
            for tag, (s, n) in seeds.items()}

    def match_fn(name, layout, s, n):
        vol, strips = layouts[layout]
        if name == "parent":
            return lambda: parent_match(libs[name], vol, s, n, p, strips)

        def call():
            cuda.library = lambda: libs[name]
            if strips:
                return pm._match_one_side_strips(*vol, s, n, p)
            return pm._match_one_side(vol, s, n, p)
        return call

    for name in libs:
        for layout in layouts:
            for tag, (s, n) in seeds.items():
                cs.require_equal(f"{name} {layout}, {tag} seed", match_fn(name, layout, s, n)(),
                                 want[(layout, tag)])
        print(f"[check] {name}: bit-identical to _match_plain on both layouts and seeds")

    times = {(name, layout): [] for name in libs for layout in layouts}
    for turn, name in turns.turn_order(libs):
        for layout in layouts:
            fn = match_fn(name, layout, seed, noise)
            t = dict(profiler_ms=turns.kernels_ms(fn, cs.N_TIMED), graph_ms=cs.graph_ms(fn),
                     call_ms=cs.call_ms(fn))
            times[(name, layout)].append(t)
            print(f"[turn {turn}] {name} {layout}: device {cs.fmt_ms(t['profiler_ms'])} "
                  f"(profiler, all kernels), {t['graph_ms']:.5f} ms (graph replay); call "
                  f"{t['call_ms']:.4f} ms")
    pass_spans(stamps, lambda: pm._match_one_side(C, seed, noise, p), 4 * p.iters)
    hot_and_cold(match_fn("this", "(H, W, D)", seed, noise), C, dev)

    result = {}
    for (name, layout), ts in times.items():
        prof = [t["profiler_ms"] for t in ts]
        result.setdefault(name, {})[layout] = dict(
            profiler_ms=statistics.mean(prof) if None not in prof else "not measured",
            graph_ms=statistics.mean(t["graph_ms"] for t in ts),
            call_ms=statistics.mean(t["call_ms"] for t in ts))
    print(smi)
    print(json.dumps({"builds": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
