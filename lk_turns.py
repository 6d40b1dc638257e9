#!/usr/bin/env python
"""Device time of a frame's LK, in turns with an earlier version of
``csrc/lk.cu``, on one NVIDIA GPU.

Builds ``lk.cu`` as one library for each of: the source in ``--parent``
(default ``ocean_perception_tpu_torch/_build/parent_csrc/``, which must hold
the earlier version's ``lk.cu`` with its per-level entry points
``opt_lk_prep`` and ``opt_lk_walk``, for example written there with
``git show <commit>:ocean_perception_tpu_torch/csrc/lk.cu``); this
checkout's source (``opt_lk_track``); and each entry of ``VARIANTS``, this
checkout's source with one part of its design taken out. Each build goes
into ``ocean_perception_tpu_torch/_build/turns_lk/``.

The frame is the one ``chip_smoke.py`` records: ``full_frontend_step`` at
720p on its moving sequence, 4 warm-up frames, then frame 4's two
``lk_track`` calls (forward, then backward; K=200, 4 levels, window 21).
The parent runs each direction as its 8 launches, ``lk_prep`` then
``lk_walk`` for each level, with the level update in PyTorch between them
to find each launch's inputs; only those 16 launches are then timed, on
those inputs. This checkout and its variants run the frame's 2 launches.
Every build's points and status are checked bit for bit against
``lk_track_plain`` first. Then a frame is timed by ``torch.profiler`` (the
device time of all its kernels) and by CUDA-graph replay (its launches
captured in one graph, gaps included), in turns: the builds in order, then
again (parent, this, variants..., parent, this, variants...), so that the
card's drift shows.

Last, this checkout's kernel is built once more with ``clock64()`` stamps
at its stage boundaries (``stamped``) and run on the frame: per direction,
the mean and the largest count of cycles a block spends in each stage.

Prints one line per build and turn, the stage cycles, then the card's name
and power limit, then one JSON object with each build's mean times.

Run: ``python lk_turns.py [--parent DIR]`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType

import chip_smoke as cs
from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.mesher.landmark_graph import LandmarkGraph
from ocean_perception_tpu_torch.mesher.object_mesher import ObjectMesherDeviceParams
from ocean_perception_tpu_torch.models.perception import PerceptionConfig, full_frontend_step
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import to_grayscale
from ocean_perception_tpu_torch.tracking import lk
from ocean_perception_tpu_torch.tracking.stereo_tracker import StereoTrackerState

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGNATURES = {
    "opt_lk_prep": [_P] * 9 + [_I] * 8 + [_F, _P],
    "opt_lk_walk": [_P] * 5 + [_I] * 6 + [_F, _P],
}
# name: edits (old, new), each replacing the one occurrence of old in this
# checkout's lk.cu; every variant computes the same function.
VARIANTS = {
    "full sums": [("constexpr float kTwoTapMax = 1e37f;", "constexpr float kTwoTapMax = -1.f;")],
    "runtime window": [("(d.win == 21 && d.A == 11) ?", "false ?")],
    "rows one at a time": [("constexpr int kRowsA = 8;", "constexpr int kRowsA = 1;")],
}


# Stage boundaries of lk_track_kernel: (the line a stamp goes in front of,
# the stamp's slot). Slots 0-6 are Phase A's; level l's slack-window
# fetch, surfaces and walk end at 7+3l, 8+3l and 9+3l.
STAMPS = [
    ("  // --- Phase A: the template side of every level.", "0"),
    ("  // A2-A3: the recentred template", "1"),
    ("  // A4: central differences", "2"),
    ("  // A5: gxx, gxy, gyy, tgx, tgy row sums", "3"),
    ("  // A6: the rows top to bottom", "4"),
    ("  // --- Phase B: coarse to fine.", "5"),
    ("      // B2: the surfaces, and whether the walk may take two taps.", "7 + 3 * l"),
    ("      // B3: the walk and the level update.", "8 + 3 * l"),
    ("    if (tid == 0) {\n      if (l > 0) {", "9 + 3 * l"),
]
N_SLOTS = 7 + 3 * 8
STAGES = ("template fetch", "recentring", "gradients", "window sums", "inverse")


def stamped(text: str) -> str:
    """lk.cu with thread 0 of every block writing clock64() into
    g_stamps[block][slot] at each of STAMPS, and opt_stamps to read them."""
    for line, slot in STAMPS:
        if text.count(line) != 1:
            raise RuntimeError(f"lk.cu must hold {line!r} exactly once")
        text = text.replace(line, f"  if (threadIdx.x == 0) g_stamps[blockIdx.x * {N_SLOTS} + "
                                  f"{slot}] = clock64();\n" + line)
    anchor = "namespace {\n"
    return (text.replace(anchor, anchor + f"__device__ long long g_stamps[4096 * {N_SLOTS}];\n", 1)
            + "\nextern \"C\" int opt_stamps(long long* out) {\n"
            f"  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * 4096 * {N_SLOTS});\n}}\n")


def stage_cycles(lib, calls: list) -> None:
    """Each direction's stage cycles a block on the frame (the third run of
    each, so that the code and data are warm): mean and largest."""
    cuda.library = lambda: lib
    for direction, (_, args, kwargs, launch) in zip(("forward", "backward"), calls):
        for _ in range(3):
            cuda.lk_track(*launch)
        torch.cuda.synchronize()
        raw = torch.zeros(4096 * N_SLOTS, dtype=torch.int64)
        cuda._check(lib.opt_stamps(ctypes.c_void_p(raw.data_ptr())), "opt_stamps")
        t = raw[:launch[2].shape[0] * N_SLOTS].reshape(-1, N_SLOTS).double()
        parts = [(name, t[:, i + 1] - t[:, i]) for i, name in enumerate(STAGES)]
        prev = t[:, 6 - 1]
        for lvl in range(len(args[0]) - 1, -1, -1):
            if kwargs["wins"][lvl] is None:
                continue
            fetch, surf, walk = (t[:, 7 + 3 * lvl + j] for j in range(3))
            parts += [(f"level {lvl} fetch", fetch - prev), (f"level {lvl} surfaces", surf - fetch),
                      (f"level {lvl} walk", walk - surf)]
            prev = walk
        parts.append(("total", prev - t[:, 0]))
        print(f"[stages] {direction}, cycles a block (mean/max): "
              + ", ".join(f"{n} {float(v.mean()):.0f}/{float(v.max()):.0f}" for n, v in parts))


def build(name: str, text: str, signatures: dict) -> ctypes.CDLL:
    out_dir = cuda._BUILD / "turns_lk" / re.sub(r"\W+", "_", name)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    (out_dir / "lk.cu").write_text(text)
    lib = out_dir / "lib.so"
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                           str(lib), str(out_dir / "lk.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    usage = re.findall(r"Used \d+ registers[^\n]*|\d+ bytes stack frame[^\n]*", proc.stderr)
    print(f"[build] {name}: {sorted(set(usage))}")
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in signatures.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def record_frame() -> list:
    """The two lk_track calls of chip_smoke.py's recorded frontend frame."""
    dev = torch.device("cuda", 0)
    canvas = cs.make_canvas()
    cam = PinholeCamera.create(700.0, 700.0, cs.W / 2, cs.H / 2, cs.H, cs.W)
    rig = StereoCamera.create(cam, cam, baseline=0.12)
    config = PerceptionConfig(engine="patchmatch", max_disp=cs.MAX_DISP, internal_scale=cs.SCALE)
    params = ObjectMesherDeviceParams()
    frames = [tuple(torch.as_tensor(a, device=dev) for a in cs.make_inputs(canvas, i))
              for i in range(5)]
    state = StereoTrackerState.create(params.tracker, image_shape=(cs.H, cs.W), device=dev)
    graph = LandmarkGraph.create(params.tracker.capacity, device=dev)
    prev = to_grayscale(frames[0][0])
    for i in range(4):
        out, prev = full_frontend_step(state, graph, prev, *frames[i], rig, config, params,
                                       device=dev)
        state, graph = out.tracker_state, out.graph
    calls = cs.record_lk_calls(lambda: full_frontend_step(state, graph, prev, *frames[4], rig,
                                                          config, params, device=dev))
    torch.cuda.synchronize()
    return calls


def parent_launches_of(lib, launches: list, keep: list):
    """The parent's per-level entry points as (prep, walk) functions of
    tensors, with the arguments of tracking/lk.py's lk_prep_plain and
    lk_walk_plain; each launch (entry point, arguments but the stream) is
    appended to launches and its tensors to keep."""
    def launch(fn, a, tensors):
        cuda._check(getattr(lib, fn)(*a, torch.cuda.current_stream().cuda_stream), fn)
        launches.append((fn, a))
        keep.extend(tensors)

    def prep(tmpl, srch, pts, guess, src_t, src_s, *, win, slack, pad, min_eig_threshold):
        K, A = pts.shape[0], 2 * slack + 3
        pts, guess = pts.contiguous(), guess.contiguous()
        corr = torch.empty((K, 2, A, A), dtype=torch.float32, device=pts.device)
        scal = torch.empty((K, 8), dtype=torch.float32, device=pts.device)
        okg = torch.empty((K,), dtype=torch.bool, device=pts.device)
        launch("opt_lk_prep", (tmpl.data_ptr(), srch.data_ptr(), pts.data_ptr(), guess.data_ptr(),
                               src_t.data_ptr(), src_s.data_ptr(), corr.data_ptr(),
                               scal.data_ptr(), okg.data_ptr(), tmpl.shape[0], srch.shape[0],
                               tmpl.shape[1], tmpl.shape[2], K, win, slack, pad,
                               lk._f32(min_eig_threshold)),
               (tmpl, srch, pts, guess, src_t, src_s, corr, scal, okg))
        return corr, scal, okg

    def walk(corr, scal, pos0, *, r, ws, pad, max_iters, eps):
        pos0 = pos0.contiguous()
        pos = torch.empty_like(pos0)
        hit = torch.empty((pos0.shape[0],), dtype=torch.bool, device=pos0.device)
        launch("opt_lk_walk", (corr.data_ptr(), scal.data_ptr(), pos0.data_ptr(), pos.data_ptr(),
                               hit.data_ptr(), corr.shape[0], corr.shape[-1], r, ws, pad,
                               max_iters, lk._f32(eps * eps)),
               (corr, scal, pos0, pos, hit))
        return pos, hit

    return prep, walk


def parent_direction(prep, walk, args, kwargs):
    """One direction as the parent ran it: for each level, coarse to fine,
    prep then walk, and the level update between them (tracking/lk.py's
    loop before lk_track). Returns (points, status)."""
    tmpl_levels, srch_levels, points, init, src_t, src_s = args
    slack, pad, wins = kwargs["slack"], kwargs["pad"], kwargs["wins"]
    levels = len(tmpl_levels)
    guess = init / 2.0 ** (levels - 1)
    ok = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for lvl in range(levels - 1, -1, -1):
        win = wins[lvl]
        if win is not None:
            H, W = tmpl_levels[lvl].shape[1], tmpl_levels[lvl].shape[2]
            corr, scal, okg = prep(tmpl_levels[lvl], srch_levels[lvl], points / 2.0 ** lvl, guess,
                                   src_t, src_s, win=win, slack=slack, pad=pad,
                                   min_eig_threshold=kwargs["min_eig_threshold"])
            pos, hit = walk(corr, scal, guess, r=win // 2, ws=win + 2 * (slack + 1), pad=pad,
                            max_iters=kwargs["max_iters"], eps=kwargs["eps"])
            in_img = ((pos[:, 0] >= 0) & (pos[:, 0] <= W - 1)
                      & (pos[:, 1] >= 0) & (pos[:, 1] <= H - 1))
            ok_l = okg & in_img & torch.isfinite(pos).all(dim=-1) & ~hit
            guess = torch.where(ok_l[:, None], pos, guess)
            if lvl == 0:
                ok = ok_l
        if lvl > 0:
            guess = guess * 2.0
    return guess, ok


def frame_profiler_us(fn, names: set, n: int = cs.N_TIMED) -> float | None:
    """Device time of one frame in us: torch.profiler over n calls of fn(),
    every kernel's device time over n. None where it recorded none. Fails
    if the window ran a kernel not in names."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if not any(name in e.key for name in names):
            raise AssertionError(f"the profiled window also ran {e.key!r}")
        total += e.device_time_total
    return total / n if total > 0 else None


def require_flow(tag: str, got, want) -> None:
    for a, b in zip(got, want):
        cs.require_equal(tag, a.float().nan_to_num(-1e30), b.float().nan_to_num(-1e30))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=str(cuda._BUILD / "parent_csrc"))
    args = ap.parse_args()
    _, smi = cs.phase_device()
    parent_src = Path(args.parent) / "lk.cu"
    if not parent_src.is_file():
        raise FileNotFoundError(f"{parent_src} is missing")
    this_src = (cuda._CSRC / "lk.cu").read_text()

    calls = record_frame()
    if [c[0] for c in calls] != ["lk_track"] * 2:
        raise AssertionError(f"expected a forward and a backward lk_track, got {len(calls)} calls")
    want = [lk.lk_track_plain(*a, **kw) for _, a, kw, _ in calls]

    libs = {"parent": build("parent", parent_src.read_text(), PARENT_SIGNATURES)}
    sig = {"opt_lk_track": cuda._SIGNATURES["opt_lk_track"]}
    libs["this"] = build("this", this_src, sig)
    for name, edits in VARIANTS.items():
        text = this_src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: lk.cu must hold {old!r} exactly once")
            text = text.replace(old, new)
        libs[name] = build(name, text, sig)

    # A check of every build, and the parent's frame as its launches, each
    # launch checked against its twin on the same inputs.
    for name in libs:
        if name == "parent":
            continue
        cuda.library = lambda lib=libs[name]: lib
        for i, (_, _, _, launch) in enumerate(calls):
            require_flow(f"{name} direction {i}", cuda.lk_track(*launch), want[i])
        print(f"[check] {name}: 2 launches a frame, bit-identical to lk_track_plain")
    # The parent is the yardstick, not this change: where a launch differs
    # from its twin, that is printed and the launch is timed all the same.
    parent_launches, keep, differ = [], [], []
    prep, walk = parent_launches_of(libs["parent"], parent_launches, keep)

    def checked(kernel, twin):
        def call(*a, **kw):
            got = kernel(*a, **kw)
            for j, (g, w) in enumerate(zip(got, twin(*a, **kw))):
                g, w = g.float().nan_to_num(-1e30), w.float().nan_to_num(-1e30)
                if not torch.equal(g, w):
                    differ.append(f"launch {len(parent_launches)} ({parent_launches[-1][0]}) "
                                  f"output {j}: max |diff| {cs.max_abs(g, w)}")
            return got
        return call

    for i, (_, a, kw, _) in enumerate(calls):
        parent_direction(checked(prep, lk.lk_prep_plain), checked(walk, lk.lk_walk_plain), a, kw)
    torch.cuda.synchronize()
    print(f"[check] parent: {len(parent_launches)} launches a frame; against their twins: "
          + ("; ".join(differ) if differ else "each bit-identical"))

    def parent_frame():
        lib = libs["parent"]
        for fn, a in parent_launches:
            cuda._check(getattr(lib, fn)(*a, torch.cuda.current_stream().cuda_stream), fn)

    def this_frame():
        for _, _, _, launch in calls:
            cuda.lk_track(*launch)

    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            if name == "parent":
                fn, kernels = parent_frame, {"lk_prep_kernel", "lk_walk_kernel"}
            else:
                cuda.library = lambda lib=lib: lib
                fn, kernels = this_frame, {"lk_track_kernel"}
            t = (frame_profiler_us(fn, kernels), 1e3 * cs.graph_ms(fn))
            times[name].append(t)
            print(f"[turns] {name}: a frame's LK {cs.fmt_ms(None if t[0] is None else t[0] / 1e3)} "
                  f"(profiler), {t[1] / 1e3:.5f} ms (graph replay)")

    stage_cycles(build("stamped", stamped(this_src),
                       {"opt_lk_track": cuda._SIGNATURES["opt_lk_track"],
                        "opt_stamps": [ctypes.c_void_p]}), calls)

    result = {}
    for name, ts in times.items():
        prof = [t[0] for t in ts]
        result[name] = dict(profiler_us=statistics.mean(prof) if None not in prof else "not measured",
                            graph_us=statistics.mean(t[1] for t in ts), turns=[list(t) for t in ts])
    print(smi)
    print(json.dumps({"frame_lk": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
