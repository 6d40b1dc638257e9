#!/usr/bin/env python
"""Device time of ``lm_solve_small``, in turns with an earlier version of
``csrc/lm_solve.cu``, beside ``torch.linalg.solve_ex``, on one NVIDIA GPU.

Builds ``lm_solve.cu`` as one library for each of: the source ``--parent``
(default ``ocean_perception_tpu_torch/_build/parent_csrc/lm_solve.cu``, for
example written there with ``git show
<commit>:ocean_perception_tpu_torch/csrc/lm_solve.cu``); this checkout's
source; each ``--compare NAME=FILE``; and each entry of ``VARIANTS``, this
checkout's source with another block size. Each build goes into ``ocean_perception_tpu_torch/_build/lm_turns/``
(``turns.py``), and ptxas's registers and spills are printed.

The systems are the perception step's own: the ``lm_solve_small`` launches
of one 720p ``perception_step`` (``chip_smoke.py``'s scene and config; its
fits run by their loop with the LM kernels, ``chip_smoke.fits_by_loop``),
recorded at one camera (M = 1, the backscatter fit, and 2, the attenuation
fit's two starts) and at four (M = 4 and 8). M = 3 and 12, the attenuation
fit with a carried guess, are the first systems of the attenuation's
launches one after another. Beside them, float64 ``trilaterate``'s (1, 8, 3)
(``chip_smoke.py`` phase 17 (e)). Every build is checked bit for bit against
``lm_step_plain`` on each, and on ``chip_smoke.lm_adversarial``'s batch
(integer bits, NaNs in their places). Then each build, and
``torch.linalg.solve_ex`` on the same damped systems, is timed at each
shape by ``torch.profiler`` and by CUDA-graph replay, in turns: in order,
then in reverse (parent, this, variants..., solve_ex, solve_ex, variants...,
this, parent), so that the card's drift shows. Then this checkout's kernel
is built once more with ``clock64()`` stamps at its phase boundaries
(``stamped``): the cycles a block spends in each phase. Last, ``torch.sum`` over
trilaterate's float64 error sums, the library call beside ``lm_row_sum``'s
float64 build, both ways.

Prints one line per build, shape and turn, each shape's chain bound
(``chip_smoke.lm_chain``), then the card's name and power limit, then one
JSON object with the means.

Run: ``python lm_turns.py [--parent FILE] [--compare NAME=FILE ...]`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
import turns
from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
from ocean_perception_tpu_torch.ops import cuda, lm
from ocean_perception_tpu_torch.vio.trilateration import trilaterate

FILE = "lm_solve.cu"
ENTRIES = ("opt_lm_solve_small", "opt_lm_solve_small_f64")
# name: edits of this checkout's source, each (old, new) replacing the one
# occurrence of old; each variant computes the same function.
VARIANTS = {
    "128 threads": [("constexpr int kSolveThreads = 256;", "constexpr int kSolveThreads = 128;")],
    "512 threads": [("constexpr int kSolveThreads = 256;", "constexpr int kSolveThreads = 512;")],
}
SOLVE_EX = "solve_ex"
# Phase boundaries of lm_solve_small_kernel: (the text a stamp goes in front
# of, the stamp's slot); thread 0 writes them.
STAMPS = [
    ("  const long long m = blockIdx.x;\n", 0),
    ("  // Column c (P: r) at leaf n from device memory, 0 past N.", 1),
    ("  // (3) A thread an entry: its S segment sums by the pairwise tree.", 2),
    ("  if (warp != 0) return;", 3),
    ("  solve_rows<(kP > 0 ? kP : kMaxP)>", 4),
    ("#pragma unroll\n  for (int i = C - 1; i >= 0; --i) {", 5),
    ("}\n\ntemplate <class T, int K>\n__global__ void __launch_bounds__(kRowWarps * 32)", 6),
]
N_SLOTS = 8
PHASES = ("staging", "segment sums", "entry sums", "damping", "elimination",
          "back substitution")


def build(name: str, path: Path, edits=()) -> turns.Build:
    text = turns.edited(path.read_text(), edits, f"{name}: {FILE}")
    return turns.Build({FILE: text}, turns.signatures([text], ENTRIES))


def stamped(text: str) -> str:
    """lm_solve.cu with thread 0 of every block writing clock64() into
    g_stamps[block][slot] at each of STAMPS, and opt_stamps to read them."""
    def stamp(slot):
        return f"  if (threadIdx.x == 0) g_stamps[blockIdx.x * {N_SLOTS} + {slot}] = clock64();\n"

    edits = [(line, stamp(slot) + line) for line, slot in STAMPS]
    return turns.with_stamps(turns.edited(text, edits, FILE), "long long", 4096 * N_SLOTS)


def phase_cycles(lib, systems: dict) -> None:
    """Cycles a block spends in each phase of lm_solve_small on each set of
    systems (the third run, so that code and data are warm): mean and
    largest over the blocks."""
    cuda.library = lambda: lib
    for key, (J, r, lam, marquardt) in systems.items():
        for _ in range(3):
            cuda.lm_solve_small(J, r, lam, marquardt)
        torch.cuda.synchronize()
        raw = torch.zeros(4096 * N_SLOTS, dtype=torch.int64)
        cuda._check(lib.opt_stamps(ctypes.c_void_p(raw.data_ptr())), "opt_stamps")
        t = raw[:J.shape[0] * N_SLOTS].reshape(-1, N_SLOTS).double()
        parts = [(name, t[:, i + 1] - t[:, i]) for i, name in enumerate(PHASES)]
        parts.append(("total", t[:, len(PHASES)] - t[:, 0]))
        print(f"[phases] {key}, cycles a block (mean/max): "
              + ", ".join(f"{n} {float(v.mean()):.0f}/{float(v.max()):.0f}" for n, v in parts))
    # The same launch of one system right after a launch that ran the kernel
    # on every SM, so that every SM's instruction cache holds its code.
    J, r, lam, marquardt = next(iter(systems.values()))
    sms = torch.cuda.get_device_properties(J.device).multi_processor_count
    many = [t[:1].expand(sms, *t.shape[1:]).contiguous() for t in (J, r, lam)]
    for _ in range(3):
        cuda.lm_solve_small(*many, marquardt)
        cuda.lm_solve_small(J[:1], r[:1], lam[:1], marquardt)
    torch.cuda.synchronize()
    raw = torch.zeros(4096 * N_SLOTS, dtype=torch.int64)
    cuda._check(lib.opt_stamps(ctypes.c_void_p(raw.data_ptr())), "opt_stamps")
    t = raw[:N_SLOTS].double()
    print(f"[phases] one system after {sms} on every SM, cycles: "
          + ", ".join(f"{n} {float(t[i + 1] - t[i]):.0f}" for i, n in enumerate(PHASES))
          + f", total {float(t[len(PHASES)] - t[0]):.0f}")


def step_systems(calls: list, sizes) -> dict:
    """{M: (J, r, lam, marquardt)} of M systems each: the first recorded
    launch of M systems, or else the first M systems of the launches with
    the most, one after another."""
    launches = []
    for J, r, lam, marquardt in calls:
        N, P = J.shape[-2:]
        launches.append((J.reshape(-1, N, P), r.reshape(-1, N), lam.reshape(-1), marquardt))
    out = {}
    for M in sizes:
        exact = [a for a in launches if a[0].shape[0] == M]
        if exact:
            out[M] = exact[0]
            continue
        most = max(a[0].shape[0] for a in launches)
        pool = [a for a in launches if a[0].shape[0] == most]
        if len({a[3] for a in pool}) != 1 or len(pool) * most < M:
            raise RuntimeError(f"cannot stack {M} systems from launches of {most}")
        J, r, lam = (torch.cat([a[k] for a in pool])[:M].contiguous() for k in range(3))
        out[M] = (J, r, lam, pool[0][3])
    return out


def graph_or_none(fn) -> float | None:
    """chip_smoke.graph_ms of a library call, None where its capture fails."""
    try:
        return cs.graph_ms(fn)
    except RuntimeError as e:
        print(f"[graph] not captured: {e}")
        return None


def recorded(dev) -> tuple[dict, list]:
    """The perception step's systems at one camera and at four, trilaterate's
    float64 systems, keyed by name; and trilaterate's float64 row sums."""
    canvas = cs.make_canvas()
    cam = PinholeCamera.create(700.0, 700.0, cs.W / 2, cs.H / 2, cs.H, cs.W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=cs.MAX_DISP, internal_scale=cs.SCALE)
    pairs = [cs.make_inputs(canvas, i) for i in range(cs.N_CAMERAS)]
    left = torch.as_tensor(np.stack([l for l, _ in pairs]), device=dev)
    right = torch.as_tensor(np.stack([r for _, r in pairs]), device=dev)
    systems = {}
    for batch, sizes in (((0,), (1, 2, 3)), (slice(None), (4, 8, 12))):
        with cs.fits_by_loop():  # the step's fits are one sea_thru_fit launch each
            calls = cs.record_lm_calls(lambda: perception_step(left[batch], right[batch], rig,
                                                               config, device=dev))
        for M, args in step_systems(calls["lm_solve_small"], sizes).items():
            systems[f"step M={M}"] = args

    rng = np.random.default_rng(8)
    p_true = np.array([3.0, -4.0, -12.0])
    beacons = rng.uniform(-50, 50, (cs.TRI_BEACONS, 3))
    ranges = np.linalg.norm(beacons - p_true, axis=1) + rng.normal(0, 0.01, cs.TRI_BEACONS)
    mask = np.ones(cs.TRI_BEACONS, bool)
    mask[cs.TRI_MASKED] = False
    ranges[cs.TRI_MASKED] = 1e3
    args = [torch.as_tensor(a, device=dev) for a in (beacons, ranges, np.full(cs.TRI_BEACONS, 0.01))]
    calls = cs.record_lm_calls(lambda: trilaterate(*args, torch.as_tensor(mask, device=dev)))
    J, r, lam, marquardt = calls["lm_solve_small"][0]
    N, P = J.shape[-2:]
    systems["trilaterate f64"] = (J.reshape(-1, N, P), r.reshape(-1, N), lam.reshape(-1), marquardt)
    return systems, [a[0] for a in calls["lm_row_sum"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=str(cuda._BUILD / "parent_csrc" / FILE))
    ap.add_argument("--compare", action="append", default=[], metavar="NAME=FILE",
                    help="another version's lm_solve.cu to time beside the parent's")
    args = ap.parse_args()
    _, smi = cs.phase_device()
    parent = Path(args.parent)
    if not parent.is_file():
        raise FileNotFoundError(f"no parent source {parent}")
    dev = torch.device("cuda", 0)
    systems, row_sums = recorded(dev)

    builds = {"parent": build("parent", parent)}
    builds.update((name, build(name, Path(f))) for name, f in (c.split("=", 1) for c in args.compare))
    builds["this"] = build("this", cuda._CSRC / FILE)
    builds.update({name: build(name, cuda._CSRC / FILE, edits) for name, edits in VARIANTS.items()})
    this_text = builds["this"].files[FILE]
    builds["stamped"] = turns.Build({FILE: stamped(this_text)},
                                    dict(builds["this"].signatures, opt_stamps=[ctypes.c_void_p]))
    libs = turns.build_all("lm_turns", builds)
    stamps = libs.pop("stamped")
    real_library = cuda.library
    for name, lib in libs.items():
        cuda.library = lambda lib=lib: lib
        adversarial = set()
        for key, (J, r, lam, marquardt) in systems.items():
            cs.require_equal(f"{name} {key}", cuda.lm_solve_small(J, r, lam, marquardt),
                             lm.lm_step_plain(J, r, lam, marquardt))
            if (J.shape[-2:], J.dtype) not in adversarial:
                cs.require_lm_adversarial(f"{name} {key}", *J.shape[-2:], J.dtype, dev)
                adversarial.add((J.shape[-2:], J.dtype))
        print(f"[check] {name}: bit-identical to lm_step_plain on every shape and on the "
              f"adversarial batch")

    damped = {key: lm.damped_system(J, r, lam, m) for key, (J, r, lam, m) in systems.items()}
    for key, (J, *_rest) in systems.items():
        ch = cs.lm_chain(*J.shape[-2:])
        print(f"[chain] {key} {tuple(J.shape)}: {ch['chain_ops']} dependent operations, "
              f"{1e3 * ch['chain_ms']:.4f} us at {cs.OP_CYCLES} cycles an operation, "
              f"{cs.CLOCK_HZ / 1e9:.2f} GHz; bound {1e3 * cs.lm_bound('lm_solve_small', systems[key])['bound_ms']:.4f} us")

    times = {}
    for turn, name in turns.turn_order([*libs, SOLVE_EX]):
        for key, (J, r, lam, marquardt) in systems.items():
            if name == SOLVE_EX:
                A, b = damped[key]
                fn = lambda A=A, b=b: torch.linalg.solve_ex(A, b)
                t = (cs.library_ms(fn), graph_or_none(fn))
            else:
                cuda.library = lambda lib=libs[name]: lib
                fn = lambda J=J, r=r, lam=lam, m=marquardt: cuda.lm_solve_small(J, r, lam, m)
                t = (cs.profiler_ms("lm_solve_small", fn), cs.graph_ms(fn))
            times.setdefault((name, key), []).append(t)
            print(f"[turns {turn}] {name} {key} {tuple(J.shape)}: device {cs.fmt_ms(t[0])} "
                  f"(profiler), {cs.fmt_ms(t[1])} (graph replay)")

    phase_cycles(stamps, systems)
    cuda.library = real_library
    sums = {}
    for x in row_sums:
        key = str(tuple(x.shape))
        if key in sums:
            continue
        kernel = lambda x=x: cuda.lm_row_sum(x)
        library = lambda x=x: torch.sum(x, dim=-1)
        sums[key] = dict(lm_row_sum=[cs.profiler_ms("lm_row_sum", kernel), cs.graph_ms(kernel)],
                         torch_sum=[cs.library_ms(library), graph_or_none(library)])
        k, t = sums[key]["lm_row_sum"], sums[key]["torch_sum"]
        print(f"[row sums f64] {key}: lm_row_sum {cs.fmt_ms(k[0])} (profiler), "
              f"{cs.fmt_ms(k[1])} (graph replay); torch.sum {cs.fmt_ms(t[0])} (profiler), "
              f"{cs.fmt_ms(t[1])} (graph replay)")

    result = {}
    for (name, key), ts in times.items():
        prof = [t[0] for t in ts]
        graph = [t[1] for t in ts]
        result.setdefault(name, {})[key] = dict(
            profiler_ms=statistics.mean(prof) if None not in prof else "not measured",
            graph_ms=statistics.mean(graph) if None not in graph else "not measured",
            turns=[list(t) for t in ts])
    print(smi)
    print(json.dumps({"builds": result, "row_sums_f64": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
