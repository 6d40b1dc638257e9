"""The stage spans of the fleet call (``utils/profiling.py``: ``annotate``
and ``StageClock``) on the CPU, at the dry run's tiny shapes: 2 cameras of
64x96 uint8 mono frames through ``multi_camera_frontend_step``, PatchMatch
at internal_scale 2 with enhancement, the dry run's tracker and graph.

- by calls under a clock, the step gives the six stages in order, their
  spans apart from one another and inside the call;
- without a clock the step's outputs are bit for bit those with one, and
  the clock records nothing;
- ``annotate`` with no clock active is a bare ``record_function``;
- the farm node with ``time_stages`` sums each stage's device ms;
- on a card (marked ``gpu``), the tiny step captured in a CUDA graph under
  a clock: two replays read differently, and every span lies inside the
  call's CUDA-event time.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.fabric.messages import ImageMessage, StereoImageMessage
from ocean_perception_tpu_torch.fabric.nodes.farm_perception_node import FarmPerceptionNode
from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus
from ocean_perception_tpu_torch.models.perception import PerceptionConfig
from ocean_perception_tpu_torch.ops.image import to_grayscale
from ocean_perception_tpu_torch.parallel.dryrun import tiny_inputs, tiny_mesher_params, tiny_rig
from ocean_perception_tpu_torch.parallel.sharded_pipeline import (create_fleet_frontend_state,
                                                                  multi_camera_frontend_step,
                                                                  prepare_frames)
from ocean_perception_tpu_torch.utils.profiling import StageClock, annotate

STAGES = ("prep", "stereo", "enhance", "lk", "tracker", "landmark_graph")
# Each span of a call, in order: prep opens in the fleet entry and in the
# perception step, lk in the frontend (the tracker's grays) and in the tracker.
SPANS = ["prep", "prep", "stereo", "enhance", "lk", "lk", "tracker", "landmark_graph"]
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet(device):
    """The tiny fleet call's arguments on ``device``: two calls' frames."""
    left, right = tiny_inputs(B)
    u8 = [(x[..., 1] * 255).to(torch.uint8).to(device) for x in (left, right)]
    moved = [x.roll(-2, dims=-1) for x in u8]
    mp = tiny_mesher_params()
    state, graph = create_fleet_frontend_state(B, mp, image_shape=tuple(u8[0].shape[-2:]),
                                               device=device)
    prev = to_grayscale(prepare_frames(u8[0], device))
    cfg = PerceptionConfig(engine="patchmatch", max_disp=32, internal_scale=2)
    return dict(state=state, graph=graph, prev=prev, frames=[u8, moved], rig=tiny_rig(),
                cfg=cfg, mp=mp)


def _step(f, state, graph, prev, left, right):
    return multi_camera_frontend_step(state, graph, prev, left, right, f["rig"], f["cfg"],
                                      f["mp"], device=left.device)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        return [t for fl in dataclasses.fields(obj) for t in _leaves(getattr(obj, fl.name))]
    return [t for o in obj for t in _leaves(o)]


def test_fleet_step_by_calls_gives_the_six_stages_in_order():
    f = _fleet("cpu")
    with StageClock("cpu") as clock:
        t0 = time.perf_counter()
        with annotate("call"):
            _step(f, f["state"], f["graph"], f["prev"], *f["frames"][0])
        took_ms = (time.perf_counter() - t0) * 1e3
    (outer, call_start, call_end), *spans = clock.read()
    assert outer == "call" and call_start == 0.0 and call_end <= took_ms
    names = [name for name, _, _ in spans]
    assert names == SPANS and tuple(dict.fromkeys(names)) == STAGES
    for (_, a, b), (_, c, _) in zip(spans, spans[1:]):
        assert a <= b <= c
    assert spans[0][1] >= 0.0 and spans[-1][2] <= call_end
    assert all(b > a for _, a, b in spans)


def test_a_clock_changes_no_output_and_none_records_nothing():
    f = _fleet("cpu")
    idle = StageClock("cpu")
    runs = []
    for clock in (StageClock("cpu"), None):
        state, graph, prev = f["state"], f["graph"], f["prev"]
        outs = []
        for left, right in f["frames"]:
            if clock is None:
                out, prev = _step(f, state, graph, prev, left, right)
            else:
                with clock:
                    out, prev = _step(f, state, graph, prev, left, right)
                assert [name for name, _, _ in clock.read()] == SPANS
            state, graph = out.tracker_state, out.graph
            outs.append((out, prev))
        runs.append(_leaves(outs))
    assert len(runs[0]) == len(runs[1]) > 20
    for x, y in zip(*runs):
        assert x.dtype == y.dtype and torch.equal(x.nan_to_num(-7.0), y.nan_to_num(-7.0))
    assert idle.read() == []


def test_annotate_with_no_clock_active_records_nothing():
    clock = StageClock("cpu")
    region = annotate("region")
    assert isinstance(region, torch.profiler.record_function)
    with region:
        torch.ones(2) + 1
    assert clock.read() == []
    with clock:
        with annotate("inside"):
            torch.ones(2) + 1
        with pytest.raises(RuntimeError, match="already active"):
            with StageClock("cpu"):
                pass
    with annotate("after"):
        torch.ones(2) + 1
    assert [name for name, _, _ in clock.read()] == ["inside"]


def test_farm_node_sums_each_stage_with_time_stages():
    f = _fleet("cpu")
    frames = [[x.numpy() for x in pair] for pair in f["frames"]]
    totals = []
    for time_stages in (True, False):
        bus = InProcessBus()
        node = FarmPerceptionNode(bus, f["rig"], n_cameras=B, perception_config=f["cfg"],
                                  mesher_params=f["mp"], max_sync_wait_sec=30.0, device="cpu",
                                  time_stages=time_stages)
        try:
            for k, (left, right) in enumerate(frames):
                ts = (k + 1) * 100_000_000
                for cam in range(B):
                    bus.publish(f"sensors/stereo/cam{cam}", StereoImageMessage(
                        timestamp=ts, camera_id=cam, left=ImageMessage.from_array(ts, left[cam]),
                        right=ImageMessage.from_array(ts, right[cam])))
                assert node.wait_steps(k + 1, 120.0), f"fleet step {k + 1} never fired"
        finally:
            node.close()
        assert node.step_failures == 0
        totals.append(node.stage_totals())
    assert set(totals[0]) == set(STAGES) and all(v > 0 for v in totals[0].values())
    assert totals[1] == {}


@pytest.mark.gpu
def test_graph_replays_record_the_stages_on_the_device_clock():
    """The tiny step captured in a CUDA graph under a clock (the events are
    graph nodes): each replay's spans are read after it, two replays on
    different frames read differently, and every span lies inside the
    call's CUDA-event time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's kernels and the graph run only there")
    f = _fleet("cuda")
    left, right = (x.clone() for x in f["frames"][0])
    args = (f["state"], f["graph"], f["prev"], left, right)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _step(f, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with StageClock("cuda") as clock:
        with torch.cuda.graph(graph):
            with annotate("call"):
                _step(f, *args)
    readings = []
    for frame in f["frames"]:
        left.copy_(frame[0])
        right.copy_(frame[1])
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        spans = clock.read()
        assert [name for name, _, _ in spans] == ["call"] + SPANS
        (_, start, end), inner = spans[0], spans[1:]
        assert start == 0.0 and 0.0 < end <= t0.elapsed_time(t1)
        assert all(0.0 <= a <= b <= end for _, a, b in inner)
        readings.append(np.array([[a, b] for _, a, b in spans]))
    assert not np.array_equal(readings[0], readings[1])
