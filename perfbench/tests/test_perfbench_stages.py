"""The stage helper (``harness/stages.py``) on the CPU: placing a call's
spans on a synthetic profiled stretch, the anchor's front check, the
attribution of busy and idle time (adding up to the stretch's, and to
``device_idle_pct.farm``'s reading), and the readings on a tiny run whose
steps record the port's spans under a clock.

Run: ``python -m pytest perfbench/tests -q`` from the repository's root.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import main as harness  # noqa: E402
from perfbench.harness import stages  # noqa: E402
from perfbench.harness.spec import BENCH_DIR, load_module  # noqa: E402
from perfbench.harness.trace import Interval, Stretch  # noqa: E402
from perfbench.tests.tiny import tiny_bench  # noqa: E402

CELL = "tiny_farm.tiny"
SEED = 2 ** 31 + 91

# One call's work on the device, µs from its graph's first kernel: the
# kernels of each stage (the digest's last), then the read-back copy.
KERNELS = [("prep", 0, 40), ("prep", 45, 60), ("stereo", 70, 200), ("stereo", 230, 260),
           ("enhance", 270, 330), ("lk", 340, 420), ("tracker", 450, 520),
           ("landmark_graph", 530, 600), ("digest", 605, 615)]
# The call's spans on the event clock, ms from the outer span's start: the
# outer span opens 1 µs before the first kernel and closes 1 µs after the
# digest's, so each span lands 1 µs early on the stretch.
SPANS = [(stages.OUTER, 0.0, 0.617), ("prep", 0.0005, 0.065), ("stereo", 0.065, 0.267),
         ("enhance", 0.267, 0.336), ("lk", 0.336, 0.426), ("tracker", 0.426, 0.526),
         ("landmark_graph", 0.526, 0.604), (stages.DIGEST, 0.604, 0.617)]


def synthetic(n_calls: int = 3):
    """A stretch of n_calls units, 1000 µs apart, and the record of its
    traced calls."""
    units, spans, ops, kernels = [], [], [], []
    for c in range(n_calls):
        u = 1000.0 * c
        units.append(Interval("fleet call", u, u + 900))
        spans += [Interval("copy-in", u, u + 80), Interval("replay", u + 80, u + 90),
                  Interval("digest read-back", u + 90, u + 890)]
        ops.append(Interval("Memcpy DtoD", u + 20, u + 25))
        g0 = u + 100
        for name, a, b in KERNELS:
            k = Interval(f"{name}_kernel", g0 + a, g0 + b)
            ops.append(k)
            kernels.append(k)
        ops.append(Interval("Memcpy DtoH (Device -> Pinned)", g0 + 630, g0 + 640))
    stretch = Stretch(start_us=0.0, end_us=1000.0 * (n_calls - 1) + 900, units=units,
                      spans=spans, device_ops=ops, kernels=kernels)
    data = {"stages": [{"traced": True, "spans": [list(s) for s in SPANS]}
                       for _ in range(n_calls)]}
    return SimpleNamespace(stretch=stretch, data=data)


def test_placed_spans_anchor_at_the_graphs_last_kernel_and_meet_the_front():
    rec = synthetic()
    placed = stages.place(rec.stretch, rec)
    assert len(placed) == 3
    for c, p in enumerate(placed):
        outer = p.spans[0]
        assert outer.name == stages.OUTER
        assert outer.end_us == pytest.approx(1000.0 * c + 100 + 615)
        assert outer.start_us == pytest.approx(1000.0 * c + 100 - 2)
        assert p.front_gap_us == pytest.approx(-2.0)
        assert abs(p.front_gap_us) <= stages.FRONT_US
    assert stages.boundaries_in_kernels(rec.stretch, placed) == (3 * 7 * 2, 0)


def test_busy_and_idle_by_stage_add_up_to_the_stretch_and_its_idle_share():
    rec = synthetic()
    att = stages.attribute(rec.stretch, stages.place(rec.stretch, rec))
    assert sum(att.busy_us.values()) == pytest.approx(rec.stretch.busy_us())
    stage_busy = sum(att.busy_us.get(s, 0.0) for s in stages.STAGES)
    rest = sum(v for k, v in att.busy_us.items() if k not in stages.STAGES)
    assert stage_busy + rest == pytest.approx(rec.stretch.busy_us())
    # Each stage's idle share, weighted back by its spans' time, with the
    # idle outside the stages, is device_idle_pct.farm's reading.
    span_us = {k: att.busy_us.get(k, 0.0) + att.idle_us.get(k, 0.0)
               for k in set(att.busy_us) | set(att.idle_us)}
    weighted = sum(att.idle_pct(k) / 100 * span_us[k] for k in span_us if span_us[k] > 0)
    reader = load_module(BENCH_DIR / "metrics" / "device_idle_pct.farm.py",
                         "test_stages_device_idle")
    assert 100 * weighted / (rec.stretch.end_us - rec.stretch.start_us) \
        == pytest.approx(reader.read(rec))
    # The stages' own pieces: 3 calls, each stage's kernels inside its span.
    assert att.busy_us["prep"] == pytest.approx(3 * 55)
    assert att.idle_us["prep"] == pytest.approx(3 * (64.5 - 55))
    assert att.busy_us["stereo"] == pytest.approx(3 * 160)
    assert att.kernels == {"prep": 6, "stereo": 6, "enhance": 3, "lk": 3, "tracker": 3,
                           "landmark_graph": 3, stages.DIGEST: 3}
    assert att.busy_us[stages.OUTSIDE] == pytest.approx(3 * (5 + 10))
    assert stages.idle_pct(rec, "stereo") == pytest.approx(100 * 42 / 202)


def test_a_late_anchor_fails_the_front_check_and_cuts_kernels():
    """Spans read 20 µs short of the graph's: the placed start misses the
    replay's first kernel by more than FRONT_US, and the stages' boundaries
    land inside kernels."""
    rec = synthetic(n_calls=1)
    rec.data["stages"][0]["spans"][0][2] -= 0.020
    (p,) = stages.place(rec.stretch, rec)
    assert p.front_gap_us == pytest.approx(18.0)
    assert abs(p.front_gap_us) > stages.FRONT_US
    total, cut = stages.boundaries_in_kernels(rec.stretch, [p])
    assert total == 14 and cut >= 4


def test_stage_ms_is_the_median_over_the_untraced_calls():
    spans = [[stages.OUTER, 0.0, 9.0], ["prep", 0.0, 1.0], ["stereo", 1.0, 3.0],
             ["prep", 3.0, 3.5]]
    rec = SimpleNamespace(stretch=None, data={"stages": [
        {"traced": False, "spans": spans},
        {"traced": False, "spans": [[n, a, b * 2] if n == "prep" else [n, a, b]
                                    for n, a, b in spans]},
        {"traced": False, "spans": spans},
        {"traced": True, "spans": [[n, a, b + 10] for n, a, b in spans]}]})
    assert stages.stage_times(spans) == {stages.OUTER: 9.0, "prep": 1.5, "stereo": 2.0}
    assert stages.stage_ms(rec, "prep") == pytest.approx(1.5)
    assert stages.stage_ms(rec, "stereo") == pytest.approx(2.0)
    assert stages.stage_ms(rec, "stereo", traced=True) == pytest.approx(12.0)
    assert stages.stage_ms(rec, "enhance") is None


class _Staged:
    """The entry's program, each window step run under a clock on the CPU
    inside one outer span and its spans kept, as an entry that records
    stages does on a card."""

    def __init__(self, spec):
        self.entry = spec.entry(spec.cell(CELL))
        self.prog = None

    def __call__(self, **kwargs):
        from ocean_perception_tpu_torch.utils.profiling import StageClock, annotate

        prog = self.entry.Program(**kwargs)
        clock, step = StageClock("cpu"), prog.step
        prog.data["stages"] = []

        def staged(traced=False):
            with clock:
                with annotate(stages.OUTER):
                    step(traced)
            prog.data["stages"].append({"traced": traced, "spans": clock.read()})

        prog.step = staged
        self.prog = prog
        return prog


def test_no_stages_read_none():
    """A run whose entry records no stages: nothing to read, on a stretch
    or without one."""
    for rec in (SimpleNamespace(stretch=synthetic().stretch, data={}),
                SimpleNamespace(stretch=None, data={"call_ms": [7.0]})):
        assert stages.place(rec.stretch, rec) == []
        for s in stages.STAGES:
            assert stages.idle_pct(rec, s) is None and stages.stage_ms(rec, s) is None


def test_the_readings_on_a_tiny_traced_run(tmp_path):
    """The port's spans through a whole tiny traced run: each stage reads a
    time on the host's clock (no device trace on the CPU, so no idle)."""
    spec = tiny_bench(tmp_path)
    factory = _Staged(spec)
    result = harness.run_cell(spec, CELL, SEED, 0.3, True, 0.0, device="cpu",
                              require_chip=False, program_factory=factory)
    assert result["correct"] is True
    rec = SimpleNamespace(stretch=None, data=factory.prog.data)
    for s in stages.STAGES:
        assert stages.idle_pct(rec, s) is None
        assert stages.stage_ms(rec, s) > 0
    assert len(stages.calls(rec, traced=True)) == spec.entry(spec.cell(CELL)).TRACE_UNITS
    assert sum(stages.stage_ms(rec, s) for s in stages.STAGES) \
        < stages.stage_ms(rec, stages.OUTER)
