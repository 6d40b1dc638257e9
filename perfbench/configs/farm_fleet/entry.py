"""The ``farm_fleet`` configuration: the farm perception node's processing.

A fleet call hands N cameras' uint8 mono stereo pairs to the port's
``multi_camera_frontend_step`` (enhance, disparity, depth, tracking, the
landmark graph) with the tracker states, landmark graphs and previous grays
of the call before, as the farm node dispatches it; the mesher's parameters
are the port's own loader on the frozen ``ObjectMesherNode.yaml`` beside
this file, the rest ``config.json``'s. The call is replayed from one CUDA
graph captured in set-up, as the repository's smoke test captures it (the
step's state is a tree of dataclasses, which ``ops/graphs.py::GraphedStep``
does not flatten); the graph also reduces the call's outputs to a digest,
which the host reads back, so no output can go unproduced. Closed loop: the
next call starts once the host holds the last call's digest.

The check, after the window: calls 0 and 1 of set-up and WINDOW_SAMPLES
calls of the window drawn from the seed. The plain reference
(``reference/``, written anew, float64) follows the program stage by
stage: its disparity from the frames; the depth, from the program's
disparity; the tracker's frame, from the program's state before the call
(call 0 from the reference's own initial state); the landmark graph, from
the program's graph before the call and its tracker's output. Each of the
program's outputs is compared with the reference's recomputation of it.
The enhanced image is not compared: on this scene the Sea-thru fits step
into regions that rounding picks, so the port's own CPU and GPU paths
disagree on it (PERF.md, section 2). The control takes the program's
place: the reference computed in bfloat16, the precision below the
configuration's float32, following itself.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
from pathlib import Path
from typing import Optional

import torch

from perfbench.harness import traffic
from perfbench.harness.spec import load_module

UNIT = "fleet call"
SPANS = ("copy-in", "replay", "digest read-back", "sample")
TRACE_UNITS = 12
WARM_CALLS = 6          # set-up calls after the capture (calls 0 and 1 are checked)
WINDOW_SAMPLES = 2      # calls of the window kept for the check, drawn from the seed

# The numbers compared with the reference, each the worst over the checked
# calls and cameras, and the limit each is held to, set between the
# program's largest reading and the control's smallest (PERF.md, section 2).
LIMITS = {
    "disparity_px_off": 1024,      # pixels whose validity differs or disparity is > 0.01 px off
    "depth_rel_err": 1e-5,         # largest relative depth gap (a validity mismatch reads 1)
    "gray_ring_max_abs": 1e-5,     # largest gap of the returned gray and the new pyramid ring
    "track_px_max": 0.5,           # largest gap of a landmark's pixel, both sides' same slot
    "track_slots_differ": 4,       # slots whose landmark, misses, age or disparities differ
    "graph_entries_differ": 16,    # graph weights, slot ids, cluster labels, foreground pixels
}
# A foreground pixel's decision is a tie where its gradient lies this close
# to the threshold (a few float32 roundings of a value near 0.08); ties are
# not compared.
FOREGROUND_TIE = 1e-6
DISPARITY_TOL = 0.01


def leaves(obj) -> list:
    """The tensors of a tree of tensors, tuples and dataclasses, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in leaves(getattr(obj, f.name))]
    if isinstance(obj, tuple):
        return [t for o in obj for t in leaves(o)]
    raise TypeError(f"not a tensor tree: {type(obj)}")


def copy_tree(dst, src) -> None:
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def clone_tree(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: clone_tree(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        items = [clone_tree(o) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    raise TypeError(f"not a tensor tree: {type(obj)}")


def digest(out, gray) -> torch.Tensor:
    """(B, 7) float64 sums of every output kind, a camera a row."""
    p, m, t = out.perception, out.mesher, out.tracker_state.table
    parts = [p.disparity.sum(dim=(-2, -1)), p.depth.sum(dim=(-2, -1)),
             p.enhanced_left.sum(dim=(-3, -2, -1)), t.pixels.sum(dim=(-2, -1)),
             out.graph.weights.sum(dim=(-2, -1)), m.labels.sum(dim=-1).float(),
             gray.sum(dim=(-2, -1))]
    return torch.stack([x.double() for x in parts], dim=-1)


class Program:
    """The system under test, built and warmed up (set-up)."""

    def __init__(self, values: dict, mix: dict, seed: int, device: str, config_dir: Path):
        from ocean_perception_tpu_torch.config.bindings import load_mesher_params
        from ocean_perception_tpu_torch.config.yaml_parser import YamlParser
        from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
        from ocean_perception_tpu_torch.imaging.enhance import EnhanceParams
        from ocean_perception_tpu_torch.models.perception import PerceptionConfig
        from ocean_perception_tpu_torch.ops.image import pyr_down
        from ocean_perception_tpu_torch.parallel.sharded_pipeline import (
            create_fleet_frontend_state, multi_camera_frontend_step)

        self.values, self.dev = values, torch.device(device)
        self.cuda = self.dev.type == "cuda"
        H, W = int(values["height"]), int(values["width"])
        self.inputs = traffic.make(mix, seed, self.dev, height=H, width=W)
        self.B = self.inputs.cameras
        parser = YamlParser(node_path=str(Path(config_dir) / values["node_yaml"]))
        config = PerceptionConfig(max_disp=int(values["max_disp"]),
                                  internal_scale=int(values["internal_scale"]),
                                  engine=str(values["engine"]),
                                  max_depth=float(values["max_depth_m"]),
                                  enhance=EnhanceParams(**(values["enhance"] or {})),
                                  run_enhance=values["enhance"] is not None)
        params = load_mesher_params(parser).device
        s = int(values["mesher_scale"])
        cam = PinholeCamera.create(values["fx"], values["fx"], values["cx"], values["cy"], H, W)
        rig = StereoCamera.create(cam, cam, baseline=values["baseline_m"])
        dev = self.dev

        def step_fn(st, gr, prev, left, right):
            out, gray = multi_camera_frontend_step(st, gr, prev, left, right, rig, config,
                                                   params, mesher_scale=s, device=dev)
            return out, gray, digest(out, gray)

        state, graph = create_fleet_frontend_state(self.B, params, image_shape=(H // s, W // s),
                                                   device=dev)
        left, right = self.inputs.frames(0)
        # The farm node's first previous grays: the left frames at mesher scale.
        prev = left.float() / torch.full((), 255.0, device=dev)
        for _ in range(s.bit_length() - 1):
            prev = pyr_down(prev)
        self.args = (state, graph, prev, left.clone(), right.clone())  # the static inputs
        if self.cuda:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step_fn(*self.args)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outs = step_fn(*self.args)
            self.host = torch.empty((self.B, 7), dtype=torch.float64, pin_memory=True)
        else:
            self.step_fn = step_fn
            self.host = torch.empty((self.B, 7), dtype=torch.float64)
        self.i, self.failed, self.data = 0, 0, {"call_ms": [], "traced": [], "cameras": self.B}
        self.rng = random.Random(seed)
        self.seen = 0
        # Set-up calls; call 0 is kept for the check (the reference starts it
        # from its own initial state), and so is call 1 with its state.
        self.samples = []
        for k in range(WARM_CALLS):
            self._call()
            if k < 2:   # the static inputs still hold the state this call started from
                state_in = clone_tree(self.args[:3]) if k else None
                self.samples.append((k, state_in, clone_tree(self.outs)))
        self.slots = [(None, clone_tree(self.args[:3]), clone_tree(self.outs))
                      for _ in range(WINDOW_SAMPLES)]
        # The first profiled call's inputs, for the rooflines' work counts.
        self.traced = (None, clone_tree(self.args[:3]))
        self.data["call_ms"].clear()
        self.data["traced"].clear()

    def _call(self, traced: bool = False) -> None:
        """Fleet call self.i: the frames handed over, the replay, the digest
        on the host."""
        i = self.i
        if self.cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        with torch.profiler.record_function(UNIT):
            with torch.profiler.record_function("copy-in"):
                if i > 0:
                    out, gray, _ = self.outs
                    copy_tree(self.args[:3], (out.tracker_state, out.graph, gray))
                left, right = self.inputs.frames(i)
                self.args[3].copy_(left)
                self.args[4].copy_(right)
            with torch.profiler.record_function("replay"):
                if self.cuda:
                    self.graph.replay()
                else:
                    self.outs = self.step_fn(*self.args)
            with torch.profiler.record_function("digest read-back"):
                self.host.copy_(self.outs[2], non_blocking=self.cuda)
                if self.cuda:
                    t1.record()
                    t1.synchronize()
                if not bool(torch.isfinite(self.host).all()):
                    self.failed += 1
        if self.cuda:
            self.data["call_ms"].append(t0.elapsed_time(t1))
            self.data["traced"].append(traced)
        self.i += 1

    def step(self, traced: bool = False) -> None:
        """One fleet call of the window; a reservoir sample of the window's
        calls (drawn from the seed) keeps its inputs and outputs, and so does
        the first profiled call."""
        self._call(traced)
        # The static inputs still hold the state this call started from.
        if traced and self.traced[0] is None:
            with torch.profiler.record_function("sample"):
                copy_tree(self.traced[1], self.args[:3])
            self.traced = (self.i - 1, self.traced[1])
        self.seen += 1
        slot = self.seen - 1 if self.seen <= WINDOW_SAMPLES else self.rng.randrange(self.seen)
        if slot < WINDOW_SAMPLES:
            with torch.profiler.record_function("sample"):
                _, state_in, outs = self.slots[slot]
                copy_tree(state_in, self.args[:3])
                copy_tree(outs, self.outs)
                self.slots[slot] = (self.i - 1, state_in, outs)

    def release(self) -> None:
        """Free the program's graph and buffers; keep what the check needs."""
        self.graph = self.step_fn = self.outs = self.args = None
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def checked_calls(self) -> list:
        """(call, program state before it or None, program outputs), in order."""
        return self.samples + [s for s in self.slots if s[0] is not None]

    def check(self, record, control: bool = False) -> list:
        """Compare the checked calls with the plain reference. With
        ``control``, the control takes the program's place: the reference
        computed in bfloat16, following its own stages."""
        ref = Reference(self.values, self.dev)
        worst = dict.fromkeys(LIMITS, 0)
        detail = record.data.setdefault("check_detail", [])
        for k, state_in, outs in self.checked_calls():
            left, right = self.inputs.frames(k)
            got = ref.stages(state_in, left, right, torch.bfloat16) if control \
                else Outputs.of_program(outs, self.B)
            want = ref.stages(state_in, left, right, torch.float64, follow=got)
            for b in range(self.B):
                numbers = compare(got, want, b)
                for name, v in numbers.items():
                    worst[name] = max(worst[name], v)
                if any(v > LIMITS[n] for n, v in numbers.items()):
                    detail.append([f"call {k} camera {b}", "control" if control else "program",
                                   numbers])
        record.data["checked_calls"] = [k for k, _, _ in self.checked_calls()]
        i, state_in = self.traced
        if i is not None and not control:
            # The rooflines' work counts: the reference's run of the first
            # profiled call, its data-dependent steps on these inputs.
            work = {}
            left, right = self.inputs.frames(i)
            ref.stages(state_in, left, right, torch.float64, work=work)
            record.data["roofline_calls"] = work
        return [(name, worst[name], LIMITS[name]) for name in LIMITS]


@dataclasses.dataclass
class Outputs:
    """One fleet call's outputs, the program's or the reference's, a list
    entry or a leading axis a camera."""

    disparity: torch.Tensor     # (B, H, W)
    depth: torch.Tensor         # (B, H, W)
    gray: torch.Tensor          # (B, h, w) at mesher scale
    tracker: list               # a reference.tracker.State a camera
    weights: torch.Tensor       # (B, K, K)
    graph_ids: torch.Tensor     # (B, K)
    labels: torch.Tensor        # (B, K)
    foreground: torch.Tensor    # (B, h, w) bool
    foreground_tie: Optional[torch.Tensor] = None   # (B, h, w) bool, the reference's ties

    @classmethod
    def of_program(cls, outs, B: int) -> "Outputs":
        out, gray, _ = outs
        p, st = out.perception, out.tracker_state
        return cls(p.disparity, p.depth, gray,
                   [_state(st, b, torch.float32) for b in range(B)], out.graph.weights,
                   out.graph.ids, out.mesher.labels, out.mesher.foreground)


def _state(st, b: int, dtype: torch.dtype):
    """Camera b of a program's tracker state as the reference's State."""
    tracker = _reference_module("tracker")
    t = st.table
    return tracker.State(
        ids=t.ids[b].long(), pixels=t.pixels[b].to(dtype), disparities=t.disparities[b].to(dtype),
        kf_pixels=t.kf_pixels[b].to(dtype), kf_disparities=t.kf_disparities[b].to(dtype),
        ages=t.ages[b].long(), missed=t.missed[b].long(), frame_idx=int(st.frame_idx[b]),
        last_kf_frame=int(st.last_kf_frame[b]), next_id=int(st.next_lmk_id[b]),
        ring=[lvl[b].to(dtype) for lvl in st.ring])


def _reference_module(name: str):
    pkg = f"perfbench_reference_{Path(__file__).resolve().parent.name}"
    load_module(Path(__file__).resolve().parent / "reference", pkg)
    return importlib.import_module(f"{pkg}.{name}")


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| (NaN equal to NaN; a NaN against a number, inf)."""
    a, b = a.double(), b.double()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a - b).abs())
    return float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0


def compare(got: Outputs, want: Outputs, b: int) -> dict:
    """The numbers of LIMITS for camera b of one call."""
    dg, dw = got.disparity[b].double(), want.disparity[b].double()
    off = ((dg > 0) != (dw > 0)) | ((dg - dw).abs() > DISPARITY_TOL)
    zg, zw = got.depth[b].double(), want.depth[b].double()
    either = (zg > 0) | (zw > 0)
    rel = torch.where((zg > 0) & (zw > 0), (zg - zw).abs() / zw.clamp_min(1e-30), 1.0)
    ring = max(_gap(a, r) for a, r in zip(got.tracker[b].ring, want.tracker[b].ring))
    tg, tw = got.tracker[b], want.tracker[b]
    same = (tg.ids == tw.ids) & (tg.ids >= 0)
    px = max(_gap(tg.pixels[same], tw.pixels[same]), _gap(tg.kf_pixels[same],
                                                          tw.kf_pixels[same]))
    slots = (tg.ids != tw.ids) | (same & ((tg.missed != tw.missed) | (tg.ages != tw.ages)
                                          | ((tg.disparities - tw.disparities.to(
                                              tg.disparities.dtype)).abs() > DISPARITY_TOL)
                                          | ((tg.kf_disparities - tw.kf_disparities.to(
                                              tg.disparities.dtype)).abs() > DISPARITY_TOL)))
    scalars = sum(getattr(tg, n) != getattr(tw, n)
                  for n in ("frame_idx", "last_kf_frame", "next_id"))
    graph = int((got.weights[b].double() != want.weights[b].double()).sum()) \
        + int((got.graph_ids[b].long() != want.graph_ids[b].long()).sum()) \
        + int((got.labels[b].long() != want.labels[b].long()).sum()) \
        + int(((got.foreground[b] != want.foreground[b]) & ~want.foreground_tie[b]).sum())
    return {
        "disparity_px_off": int(off.sum()),
        "depth_rel_err": float(torch.where(either, rel, 0.0).max()),
        "gray_ring_max_abs": max(ring, _gap(got.gray[b], want.gray[b])),
        "track_px_max": px,
        "track_slots_differ": int(slots.sum()) + int(scalars),
        "graph_entries_differ": graph,
    }


class Reference:
    """The plain reference (``reference/``), its parameters from the
    configuration's file."""

    def __init__(self, values: dict, dev: torch.device):
        self.image, self.stereo = _reference_module("image"), _reference_module("stereo")
        self.enh, self.tracker = _reference_module("enhance"), _reference_module("tracker")
        self.mesher = _reference_module("mesher")
        self.v, self.dev = values, dev
        self.m = values["mesher"]
        self.t = self.m["tracker"]
        self.scale = int(values["mesher_scale"])
        s = float(self.scale)
        self.fxb = float(torch.tensor(values["fx"], dtype=torch.float32)
                         * torch.tensor(values["baseline_m"], dtype=torch.float32)
                         / torch.tensor(s, dtype=torch.float32))

    def initial(self, B: int, shape, dtype: torch.dtype):
        """The cameras' initial tracker states and graphs."""
        K, R = self.t["capacity"], self.t["retrack_frames_k"] + 1
        states, graphs = [], []
        for _ in range(B):
            h, w = shape
            ring = []
            for _ in range(self.t["lk"]["max_level"] + 1):
                ring.append(torch.zeros((R, h, w), dtype=dtype, device=self.dev))
                h, w = (h + 1) // 2, (w + 1) // 2
            z = torch.zeros(K, dtype=torch.long, device=self.dev)
            states.append(self.tracker.State(
                ids=z - 1, pixels=torch.zeros((K, 2), dtype=dtype, device=self.dev),
                disparities=torch.full((K,), -1.0, dtype=dtype, device=self.dev),
                kf_pixels=torch.zeros((K, 2), dtype=dtype, device=self.dev),
                kf_disparities=torch.full((K,), -1.0, dtype=dtype, device=self.dev),
                ages=z.clone(), missed=z.clone(), frame_idx=0, last_kf_frame=-(10 ** 6),
                next_id=0, ring=ring))
            graphs.append((torch.zeros((K, K), dtype=dtype, device=self.dev), z - 1))
        return states, graphs

    def stages(self, state_in, left_u8: torch.Tensor, right_u8: torch.Tensor,
               dtype: torch.dtype, follow: Optional[Outputs] = None,
               work: Optional[dict] = None) -> Outputs:
        """One fleet call of (B, H, W) uint8 frames in ``dtype``, from the
        program's state before it (None: the reference's own start). With
        ``follow``, each stage takes its inputs from follow's outputs of the
        stage before instead of its own."""
        v, im = self.v, self.image
        B, H, W = left_u8.shape
        disp = self.stereo.disparity(left_u8, right_u8, int(v["max_disp"]),
                                     int(v["internal_scale"]), dtype, work)
        depth = self.stereo.depth(follow.disparity.to(dtype) if follow else disp, v["fx"],
                                  v["baseline_m"], float(v["max_depth_m"]))
        gray_full = im.gray_of_mono(left_u8, dtype)
        if work is not None and v["enhance"] is not None:
            # The Sea-thru fits' steps, for their roofline (not compared).
            rgb = (left_u8.to(dtype) / 255.0)[..., None].expand(B, H, W, 3)
            for b in range(B):
                self.enh.enhance(rgb[b], depth[b], gray_full[b], v["enhance"], work)
        gray, gray_r = gray_full, im.gray_of_mono(right_u8, dtype)
        for _ in range(self.scale.bit_length() - 1):
            gray, gray_r = im.pyr_down(gray), im.pyr_down(gray_r)
        if state_in is None:
            states, graphs = self.initial(B, gray.shape[-2:], dtype)
        else:
            st, gr, _ = state_in
            states = [_state(st, b, dtype) for b in range(B)]
            graphs = [(gr.weights[b].to(dtype), gr.ids[b].long()) for b in range(B)]
        new = [self.tracker.step(states[b], gray[b], gray_r[b], self.fxb, self.t, work)
               for b in range(B)]
        weights, ids, labels, fg, ties = [], [], [], [], []
        for b in range(B):
            src = follow.tracker[b] if follow else new[b]
            f, tie = self.mesher.foreground(gray[b], self.m["foreground_ksize"],
                                            self.m["foreground_min_gradient"], FOREGROUND_TIE)
            w, lab = self.mesher.update(graphs[b][0], graphs[b][1], src.ids, src.pixels.to(dtype),
                                        src.disparities.to(dtype),
                                        follow.foreground[b] if follow else f, self.fxb, self.m)
            weights.append(w)
            ids.append(src.ids)
            labels.append(lab)
            fg.append(f)
            ties.append(tie)
        return Outputs(disp, depth, gray, new, torch.stack(weights), torch.stack(ids),
                       torch.stack(labels), torch.stack(fg), torch.stack(ties))
