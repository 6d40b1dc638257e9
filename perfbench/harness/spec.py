"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells (``workloads``),
their configurations and traffic mixes, and the metrics. Everything that
belongs to one of them sits in files of its own under ``perfbench/``:

- a configuration ``<config>``: the folder ``configs/<config>/``, holding
  ``config.json`` (the sizes as run), ``entry.py`` (builds the system under
  test and drives one unit of its work) and the plain reference beside them;
- a traffic mix ``<traffic>``: ``traffic/<traffic>.json``, the parameters
  that the general generator (``harness/traffic.py``) reads;
- a metric ``<metric>``: ``metrics/<metric>.py``, a reader with
  ``read(record) -> float | None``.

So a later change adds a configuration, a mix or a metric as new files and
an entry in ``BENCHMARK.json``, and edits none of the harness.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``, with what it names resolved."""

    name: str
    chips: int
    config: dict          # the configuration's entry in BENCHMARK.json
    traffic_name: str
    end_to_end: tuple     # metric entries this cell reports with --trace 0
    per_layer: tuple      # metric entries this cell reports with --trace 1


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # A per-layer metric without a list goes with every cell that reports
    # the end-to-end metric it moves.
    return metric.get("moves") in e2e_names if "moves" in metric else True


class Spec:
    """``BENCHMARK.json`` and the folder of files it names."""

    def __init__(self, benchmark: dict, bench_dir: Path = BENCH_DIR):
        self.data = benchmark
        self.dir = Path(bench_dir)

    @classmethod
    def load(cls, root: Path, bench_dir: Path = BENCH_DIR) -> "Spec":
        path = Path(root) / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {root}")
        return cls(json.loads(path.read_text()), bench_dir)

    def cell(self, name: str) -> Cell:
        found = [w for w in self.data["workloads"] if w["name"] == name]
        if not found:
            known = ", ".join(w["name"] for w in self.data["workloads"])
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {known})")
        w = found[0]
        configs = [c for c in self.data["configs"] if c["name"] == w["config"]]
        if not configs:
            raise KeyError(f"workload {name!r} names the unknown configuration {w['config']!r}")
        e2e = tuple(m for m in self.data["end_to_end"] if _reports(m, name, set()))
        names = {m["name"] for m in e2e}
        per_layer = tuple(m for m in self.data["per_layer"] if _reports(m, name, names))
        return Cell(name=name, chips=int(w["chips"]), config=configs[0],
                    traffic_name=w["traffic"], end_to_end=e2e, per_layer=per_layer)

    def config_dir(self, cell: Cell) -> Path:
        return self.dir / "configs" / cell.config["name"]

    def config_values(self, cell: Cell) -> dict:
        """The configuration's file, as BENCHMARK.json names it."""
        return json.loads((self.dir.parent / cell.config["file"]).read_text())

    def traffic(self, cell: Cell) -> dict:
        return json.loads((self.dir / "traffic" / f"{cell.traffic_name}.json").read_text())

    def entry(self, cell: Cell) -> ModuleType:
        return load_module(self.config_dir(cell) / "entry.py",
                           f"perfbench_config_{cell.config['name']}")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{name}.py",
                           "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path``, or the package in the folder ``path``, as
    the module ``name`` (once a process); a package's relative imports work."""
    if name in sys.modules:
        return sys.modules[name]
    path = Path(path)
    if path.is_dir():
        spec = importlib.util.spec_from_file_location(
            name, path / "__init__.py", submodule_search_locations=[str(path)])
    elif path.is_file():
        spec = importlib.util.spec_from_file_location(name, path)
    else:
        raise FileNotFoundError(f"{path} does not exist")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module
