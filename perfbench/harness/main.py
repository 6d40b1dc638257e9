"""One run of one cell: set-up, a measured window, the check of what the
window produced against the plain reference, and one result line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration supplies ``entry.py`` with a ``Program`` class:
``Program(values, mix, seed, device, config_dir)`` builds the system under
test and its inputs and warms up every shape it will use (set-up);
``step(traced)`` runs one unit of work (closed loop: it returns when the
unit's output is consumed on the host); ``release()`` frees the program's
state; ``check(record)`` compares the window's sampled outputs with the
plain reference and returns ``[(name, value, limit), ...]``, each value at
most its limit in a correct run. ``UNIT`` names the unit's host span, and
``TRACE_UNITS`` says how many units the profiled stretch of a ``--trace 1``
run holds.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` a short steady stretch of the window is profiled and the
metrics are the per-layer ones. Each metric is read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

from . import spec as spec_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "ocean_perception_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (``ocean_perception_tpu_torch`` is the port, allowed)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started, from its start time in
    ``/proc/self/stat``; where that is unreadable, since ``fallback_t0``
    (a ``perf_counter`` reading taken at the script's first line)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - fallback_t0


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    values: dict = dataclasses.field(default_factory=dict)   # the configuration's file
    mix: dict = dataclasses.field(default_factory=dict)      # the traffic mix
    data: dict = dataclasses.field(default_factory=dict)     # what the entry recorded
    stretch: Optional[object] = None                         # trace.Stretch with --trace 1
    power_limit: str = "not read"


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(spec: spec_mod.Spec, name: str, seed: int, seconds: float, trace: bool,
             t0_fallback: float, device: str = "cuda", require_chip: bool = True,
             program_factory=None) -> dict:
    """One run; returns the result object (the last line's content).
    ``require_chip=False`` and ``device`` let a CPU test drive a run;
    ``program_factory`` lets it put a broken program in the entry's place."""
    import torch

    cell = spec.cell(name)
    if require_chip:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            raise SystemExit(f"the cell {name} needs {cell.chips} CUDA device(s); "
                             f"torch sees {have}: no result")
    rec = Record(cell=name, seed=seed, seconds=seconds, trace=trace,
                 values=spec.config_values(cell), mix=spec.traffic(cell))
    entry = spec.entry(cell)
    factory = program_factory or entry.Program
    prog = factory(values=rec.values, mix=rec.mix, seed=seed, device=device,
                   config_dir=spec.config_dir(cell))

    from . import trace as trace_mod

    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.setup_s = process_age_s(t0_fallback)
    # The profiled stretch starts once the window is steady and holds
    # TRACE_UNITS units; the window runs on past --seconds until it is done.
    trace_at = min(1.0, seconds / 4)
    prof, traced_left = None, 0
    while True:
        if trace and rec.stretch is None and prof is None and time.perf_counter() - t0 >= trace_at:
            prof = trace_mod.profiler()
            prof.__enter__()
            traced_left = entry.TRACE_UNITS
        prog.step(traced=prof is not None)
        rec.attempted += 1
        if prof is not None:
            traced_left -= 1
            if traced_left == 0:
                prof.__exit__(None, None, None)
                rec.stretch, prof = prof, None
        if time.perf_counter() - t0 >= seconds and prof is None \
                and (not trace or rec.stretch is not None):
            break
    rec.window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec.failed = prog.failed
    rec.data = prog.data
    if rec.stretch is not None:
        rec.stretch = trace_mod.reduce(rec.stretch, set(entry.SPANS), entry.UNIT)
    prog.release()
    checks = prog.check(rec)
    rec.power_limit = power_limit() if cuda else "not read (CPU run)"

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": rec.attempted,
        "failed": rec.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips if cuda else 0,
            "memory_peak_bytes": int(peak),
            "power_limit": rec.power_limit,
        },
    }
    if rec.stretch is not None:
        result["device"]["busy_s"] = rec.stretch.busy_us() / 1e6
        result["device"]["window_s"] = rec.stretch.seconds
        result["breakdown"] = trace_mod.breakdown(rec.stretch)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv=None, t0_fallback: Optional[float] = None) -> int:
    t0_fallback = time.perf_counter() if t0_fallback is None else t0_fallback
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = spec_mod.BENCH_DIR.parent
    try:
        spec = spec_mod.Spec.load(root)
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          t0_fallback)
    except SystemExit as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except Exception:  # a run that fails prints no result
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}, which the benchmark may not "
              "load: no result", file=sys.stderr)
        return 3
    print(f"correct {result['correct']} on {result['device']['kind']} "
          f"({result['device']['power_limit']})", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0
