"""The fleet call's stages, from the program's own spans: their device time
on every call, and their place on a profiled stretch's timeline.

The port's ``utils/profiling.annotate`` opens a span at each layer boundary
of the fleet call; under a ``StageClock`` each span is a pair of timing
CUDA events, nodes of the captured graph, recorded again on every replay.
An entry that captures its step under a clock and reads the clock after
each call keeps, in ``record.data["stages"]``, one entry a call of the
window: ``{"traced": bool, "spans": [[name, start_ms, end_ms], ...]}``, the
spans in order of entry on the device's clock, from the outer span around
the whole step (``OUTER``, first; the graph starts and ends on its events)
with the digest's span (``DIGEST``) inside it. A name may open more than
once in a call; a stage's time is then the sum of its spans.

A reader gets stage ``s``'s device ms in a call from ``stage_times(spans)[s]``
and its median over the untraced calls from :func:`stage_ms`. On a profiled
stretch, :func:`place` puts each traced call's spans on the profiler's
clock, anchored at the graph's end: the outer span ends with the unit's
last kernel before the digest's read-back copy, and every boundary lies
that kernel's end less its distance from the outer span's end on the
event clock. The anchor is checked at the front: the outer span's placed
start against the replay's first kernel. :func:`attribute` then gives
every stretch of busy and idle device time to the innermost placed span
that covers it (``OUTSIDE`` where none does: copy-in, read-back, the host
between calls), so the stages' busy and idle time, with the rest, add up
to the stretch's. Each :class:`Placed` keeps ``front_gap_us``, the outer
span's placed start less the replay's first kernel, and :func:`idle_pct`
gives a stage's idle share of its placed spans.

A run whose entry records no stages, or whose stretch holds no placed
call, has nothing to read: every function here then returns None or an
empty result, and never raises for it.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Optional

from .trace import Interval, Stretch, _is_copy, merged

STAGES = ("prep", "stereo", "enhance", "lk", "tracker", "landmark_graph")
OUTER = "fleet step"
DIGEST = "digest"
OUTSIDE = "outside"
REPLAY = "replay"       # the harness span around graph.replay()
FRONT_US = 5.0          # the anchor's front check


def calls(rec, traced: bool) -> list:
    """The recorded spans of the window's traced or untraced calls."""
    return [c["spans"] for c in rec.data.get("stages") or () if bool(c["traced"]) == traced
            and c["spans"]]


def stage_times(spans) -> dict:
    """Device ms a name in one call: the sum of its spans."""
    out: dict = {}
    for name, start, end in spans:
        out[name] = out.get(name, 0.0) + (end - start)
    return out


def stage_ms(rec, stage: str, traced: bool = False) -> Optional[float]:
    """The median over the window's untraced (or traced) calls of the
    stage's device ms in a call."""
    times = [stage_times(s).get(stage) for s in calls(rec, traced)]
    times = [t for t in times if t is not None]
    return statistics.median(times) if times else None


@dataclasses.dataclass
class Placed:
    """One profiled call's spans on the profiler's clock."""

    unit: Interval
    spans: list              # Interval a span, the outer span first
    front_gap_us: Optional[float]   # placed start of OUTER minus the replay's first kernel


def place(stretch: Optional[Stretch], rec) -> list:
    """The traced calls' spans placed on the stretch, one Placed a unit (the
    traced calls and the stretch's units in order, one to one); a unit
    without a read-back copy or a kernel before it is left out."""
    traced = calls(rec, traced=True)
    if stretch is None or not traced or len(traced) != len(stretch.units):
        return []
    kernels = sorted(stretch.kernels, key=lambda k: k.start_us)
    starts = [k.start_us for k in kernels]
    out = []
    for unit, spans in zip(stretch.units, traced):
        if spans[0][0] != OUTER:
            continue
        copies = [op for op in stretch.device_ops if _is_copy(op.name)
                  and unit.start_us <= op.start_us < unit.end_us]
        if not copies:
            continue
        readback = max(copies, key=lambda op: op.start_us)
        i = bisect.bisect_left(starts, readback.start_us)
        if i == 0 or kernels[i - 1].start_us < unit.start_us:
            continue
        anchor = kernels[i - 1].end_us
        outer_end = spans[0][2]
        placed = [Interval(name, anchor - (outer_end - a) * 1e3, anchor - (outer_end - b) * 1e3)
                  for name, a, b in spans]
        replay = [s for s in stretch.spans if s.name == REPLAY
                  and unit.start_us <= s.start_us < unit.end_us]
        gap = None
        if replay:
            j = bisect.bisect_left(starts, replay[0].start_us)
            if j < len(kernels) and kernels[j].start_us < readback.start_us:
                gap = placed[0].start_us - kernels[j].start_us
        out.append(Placed(unit, placed, gap))
    return out


def boundaries_in_kernels(stretch: Stretch, placed: list, tol_us: float = 1.0) -> tuple:
    """(boundaries, those inside a kernel by more than tol_us): the start
    and end of every placed span but the outer one. A span's events run
    between two kernels of the graph, so a right placement cuts none; the
    outer span's start is left out, since the profiler delays the graph's
    first kernel after it (PERF.md, section 5)."""
    kernels = sorted(stretch.kernels, key=lambda k: k.start_us)
    starts = [k.start_us for k in kernels]
    total = cut = 0
    for p in placed:
        for s in p.spans[1:]:
            for t in (s.start_us, s.end_us):
                total += 1
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and kernels[i].start_us + tol_us < t < kernels[i].end_us - tol_us:
                    cut += 1
    return total, cut


@dataclasses.dataclass
class Attribution:
    """Busy and idle device µs of the stretch, and the kernels that started
    in it, by the innermost placed span (OUTSIDE where none)."""

    busy_us: dict
    idle_us: dict
    kernels: dict

    def idle_pct(self, name: str) -> Optional[float]:
        total = self.busy_us.get(name, 0.0) + self.idle_us.get(name, 0.0)
        return 100.0 * self.idle_us.get(name, 0.0) / total if total > 0 else None


def _owner(placed: list, unit_starts: list, t: float) -> str:
    """The innermost placed span covering the time t, or OUTSIDE."""
    i = bisect.bisect_right(unit_starts, t) - 1
    best = None
    for k in (i, i + 1):   # a call's spans may start a little before its host unit
        if 0 <= k < len(placed):
            for s in placed[k].spans:
                if s.start_us <= t < s.end_us and (best is None or s.us < best.us):
                    best = s
    return OUTSIDE if best is None else best.name


def attribute(stretch: Optional[Stretch], placed: list) -> Optional[Attribution]:
    """Cut the stretch at every edge of the device's busy intervals and of
    the placed spans; each piece, busy or idle, goes to the innermost span
    that covers its middle, and each kernel to the one that covers its
    middle. None without a placed call."""
    if stretch is None or not placed or not stretch.device_ops:
        return None
    lo, hi = stretch.start_us, stretch.end_us
    busy = merged(stretch.device_ops, lo, hi)
    edges = {lo, hi}
    for a, b in busy:
        edges.update((a, b))
    for p in placed:
        for s in p.spans:
            edges.update(t for t in (s.start_us, s.end_us) if lo < t < hi)
    edges = sorted(edges)
    unit_starts = [p.unit.start_us for p in placed]
    busy_us: dict = {}
    idle_us: dict = {}
    j = 0
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        while j < len(busy) and busy[j][1] <= mid:
            j += 1
        into = busy_us if j < len(busy) and busy[j][0] <= mid else idle_us
        name = _owner(placed, unit_starts, mid)
        into[name] = into.get(name, 0.0) + (b - a)
    kernels: dict = {}
    for k in stretch.kernels:
        mid = (k.start_us + k.end_us) / 2
        if lo <= mid < hi:
            name = _owner(placed, unit_starts, mid)
            kernels[name] = kernels.get(name, 0) + 1
    return Attribution(busy_us, idle_us, kernels)


def idle_pct(rec, stage: str) -> Optional[float]:
    """The share of the stage's spans, over the profiled calls placed on
    the stretch, in which no device operation ran."""
    att = attribute(rec.stretch, place(rec.stretch, rec))
    return None if att is None else att.idle_pct(stage)
