#!/usr/bin/env python
"""``perception_step`` as one CUDA graph a frame, for several checkouts of
this repository in turns, on one NVIDIA GPU.

Each argument is the root of a checkout: this one, or an earlier commit
unpacked with ``git archive <commit> | tar -x -C DIR``. In turns, the
checkouts in order and then in reverse (A B B A), a fresh Python process in
each builds its kernels, captures ``chip_smoke.py``'s 720p frame of
``perception_step`` (PatchMatch, enhancement on) in one CUDA graph on each
volume layout, and replays it over ``N_FRAMES`` perturbed frames, five
times; it prints the median ms/frame of each layout and the sum of frame
0's disparity, so that the checkouts can be seen to agree.

Prints one line per checkout and turn, the card's name and power limit,
then one JSON object with each checkout's ms/frame in every turn.

Run: ``python graph_turns.py DIR [DIR ...]`` (needs one GPU and nvcc; no network).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

CHILD = r"""
import dataclasses, json, statistics, torch
import chip_smoke as cs
from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
from ocean_perception_tpu_torch.ops import cuda

cuda.library()
dev = torch.device("cuda", 0)
left, right = (torch.as_tensor(a, device=dev) for a in cs.make_inputs(cs.make_canvas()))
cam = PinholeCamera.create(700.0, 700.0, cs.W / 2, cs.H / 2, cs.H, cs.W)
rig = StereoCamera.create(cam, cam, baseline=0.12)
config = PerceptionConfig(engine="patchmatch", max_disp=cs.MAX_DISP, internal_scale=cs.SCALE)
frames = [left + float(i) * 1e-6 for i in range(cs.N_FRAMES)]
out = {}
for name, cfg in (("(H, W, D)", config), ("strips", dataclasses.replace(config, use_strip_volumes=True))):
    static = frames[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        perception_step(static, right, rig, cfg, device=dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = perception_step(static, right, rig, cfg, device=dev)
    graph.replay()
    runs = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for f in frames:
            static.copy_(f)
            graph.replay()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / len(frames))
    static.copy_(frames[0])
    graph.replay()
    out[name] = dict(ms_frame=statistics.median(runs), runs=runs,
                     disparity_sum=float(res.disparity.double().sum()))
print(json.dumps(out))
"""


def main() -> int:
    dirs = [Path(d).resolve() for d in sys.argv[1:]]
    if not dirs:
        raise SystemExit("usage: python graph_turns.py DIR [DIR ...]")
    _, smi = cs.phase_device()
    results = {str(d): [] for d in dirs}
    for turn, d in enumerate(dirs + dirs[::-1]):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=d, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{d} failed:\n{proc.stderr[-4000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        results[str(d)].append(r)
        print(f"[turn {turn}] {d.name}: " + "; ".join(
            f"{k} {v['ms_frame']:.4f} ms/frame (runs {', '.join(f'{x:.4f}' for x in v['runs'])}), "
            f"disparity sum {v['disparity_sum']:.6e}" for k, v in r.items()))
    print(smi)
    print(json.dumps({"checkouts": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
