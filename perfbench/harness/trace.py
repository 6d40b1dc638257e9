"""A profiled stretch of the window, reduced to what the per-layer readers
and the result's ``breakdown`` need.

``torch.profiler`` records the host's ``record_function`` spans (the
harness's own, around its calls into the program) and every kernel, copy
and set the device ran, on one clock. The busy time is the union of the
device's intervals; an idle gap is named by the host span that covers its
middle, so the breakdown says what the host was doing while the card
waited.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.autograd import DeviceType


@dataclasses.dataclass
class Interval:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Stretch:
    """The profiled stretch: its host spans and device operations, the
    units of work it ran (each a host interval), on the profiler's clock."""

    start_us: float
    end_us: float
    units: list          # Interval per unit of work (a fleet call, a frame)
    spans: list          # Interval per harness span
    device_ops: list     # Interval per kernel, copy or set on the device
    kernels: list        # the kernels alone

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_us(self) -> float:
        return sum(b - a for a, b in merged(self.device_ops, self.start_us, self.end_us))

    def kernels_in(self, unit: Interval) -> list:
        """The kernels that started inside one unit's host interval."""
        return [k for k in self.kernels if unit.start_us <= k.start_us < unit.end_us]


def merged(ops: list, lo: float, hi: float) -> list:
    """The union of the ops' intervals, clipped to [lo, hi], as sorted pairs."""
    out = []
    for op in sorted(ops, key=lambda o: o.start_us):
        a, b = max(op.start_us, lo), min(op.end_us, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def reduce(prof: torch.profiler.profile, span_names: set, unit_name: str) -> Stretch:
    """The stretch of a finished profile: host spans named in span_names,
    one unit per ``unit_name`` span, every device operation."""
    spans, units, ops, kernels = [], [], [], []
    for e in prof.events():
        tr = e.time_range
        iv = Interval(e.name, float(tr.start), float(tr.end))
        if e.device_type == DeviceType.CUDA:
            if e.name == unit_name or e.name in span_names \
                    or getattr(e, "is_user_annotation", False):
                continue  # a host span's shadow on the device's timeline
            ops.append(iv)
            if not _is_copy(e.name):
                kernels.append(iv)
        elif e.name == unit_name:
            units.append(iv)
        elif e.name in span_names:
            spans.append(iv)
    if not units:
        raise RuntimeError(f"the profile holds no {unit_name!r} span")
    units.sort(key=lambda u: u.start_us)
    return Stretch(start_us=units[0].start_us, end_us=units[-1].end_us, units=units,
                   spans=spans, device_ops=ops, kernels=kernels)


def _is_copy(name: str) -> bool:
    n = name.lower()
    return n.startswith("memcpy") or n.startswith("memset")


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the host span that covers each gap's middle ("no span" outside
    them), each list the ``top`` largest, in seconds."""
    by_op: dict = {}
    for k in stretch.device_ops:
        by_op[k.name] = by_op.get(k.name, 0.0) + k.us / 1e6
    busy = merged(stretch.device_ops, stretch.start_us, stretch.end_us)
    gaps, t = [], stretch.start_us
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if stretch.end_us > t:
        gaps.append((t, stretch.end_us))
    by_host: dict = {}
    for a, b in gaps:
        host = _covering(stretch.spans, (a + b) / 2) or "no span"
        by_host[host] = by_host.get(host, 0.0) + (b - a) / 1e6
    order = lambda d: sorted(([_short(k), v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(by_op), "idle_gaps": order(by_host)}


def _covering(spans: list, t: float) -> Optional[str]:
    """The innermost span that covers the time t."""
    best = None
    for s in spans:
        if s.start_us <= t < s.end_us and (best is None or s.us < best.us):
            best = s
    return None if best is None else best.name


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."
