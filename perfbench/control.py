"""The two readings that a cell's limits are set from, on the chip.

    python perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a window of --seconds,
then the numbers compared for the program against the plain reference (the
lower reading) and for the control in the program's place (the upper
reading: the reference computed one precision below the configuration's,
see the configuration's ``entry.py``). One JSON line a seed; the benchmark's
own runs never run the control.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402

from perfbench.harness.main import Record  # noqa: E402
from perfbench.harness.spec import BENCH_DIR, Spec  # noqa: E402


def readings(spec: Spec, name: str, seed: int, seconds: float, device: str = "cuda") -> dict:
    import torch

    cell = spec.cell(name)
    rec = Record(cell=name, seed=seed, seconds=seconds, trace=False,
                 values=spec.config_values(cell), mix=spec.traffic(cell))
    prog = spec.entry(cell).Program(values=rec.values, mix=rec.mix, seed=seed, device=device,
                                    config_dir=spec.config_dir(cell))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        prog.step()
        rec.attempted += 1
    prog.release()
    t1 = time.perf_counter()
    lower = {n: v for n, v, _ in prog.check(rec)}
    t2 = time.perf_counter()
    upper = {n: v for n, v, _ in prog.check(rec, control=True)}
    t3 = time.perf_counter()
    del prog
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {"seed": seed, "calls": rec.attempted, "checked": rec.data.get("checked_calls"),
            "check_s": t2 - t1, "control_s": t3 - t2,
            "program": lower, "control": upper,
            "program_detail": [d for d in rec.data.get("check_detail", []) if d[1] == "program"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = Spec.load(BENCH_DIR.parent)
    for seed in args.seeds:
        print(json.dumps(readings(spec, args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
