"""The benchmark's harness on the CPU, at tiny shapes: a whole run, its last
line, the faults that must make ``correct`` false, the control, the traffic
generator, the by-name discovery of configurations, mixes and metrics, and
the imports the benchmark may not make.

Run: ``python -m pytest perfbench/tests -q`` from the repository's root.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.control import readings  # noqa: E402
from perfbench.harness import main as harness  # noqa: E402
from perfbench.harness import traffic  # noqa: E402
from perfbench.harness.spec import BENCH_DIR, Spec  # noqa: E402
from perfbench.tests.tiny import tiny_bench  # noqa: E402

CELL = "tiny_farm.tiny"
SEED = 2 ** 31 + 77  # seeds may exceed 32 signed bits


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


def run(spec, program_factory=None, trace=False, seconds=0.3):
    return harness.run_cell(spec, CELL, SEED, seconds, trace, 0.0, device="cpu",
                            require_chip=False, program_factory=program_factory)


def test_tiny_run_is_correct_and_its_result_line_has_its_keys(spec):
    result = run(spec)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "camera_fps"}  # no CUDA events on the CPU
    for m in result["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.loads(json.dumps(result))


def test_traced_run_reports_no_device_number_from_the_cpu(spec):
    result = run(spec, trace=True)
    assert result["correct"] is True
    assert result["metrics"] == {}  # every per-layer reader finds no device trace
    assert result["device"]["window_s"] > 0


class _Broken:
    """The entry's program with one fault planted where it produces."""

    def __init__(self, spec, fault):
        self.entry = spec.entry(spec.cell(CELL))
        self.fault = fault

    def __call__(self, **kwargs):
        prog = self.entry.Program(**kwargs)
        step_fn, fault = prog.step_fn, self.fault

        def broken(st, gr, prev, left, right):
            out, gray, dig = step_fn(st, gr, prev, left, right)
            if fault == "state unchanged":
                out = out._replace(tracker_state=st, graph=gr)
            elif fault == "half the batch":
                half = left.shape[0] // 2
                out2, gray2, dig2 = step_fn(*(_first(x, half) for x in (st, gr, prev, left,
                                                                        right)))
                out, gray = _tile(out2, left.shape[0]), _tile(gray2, left.shape[0])
            elif fault == "answer altered":
                d = out.perception.disparity.clone()
                d[..., 5, 7] += 1.0
                out = out._replace(perception=out.perception._replace(disparity=d))
            return out, gray, dig

        prog.step_fn = broken
        return prog


def _first(obj, n):
    if isinstance(obj, torch.Tensor):
        return obj[:n]
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _first(getattr(obj, f.name), n)
                                           for f in dataclasses.fields(obj)})
    items = [_first(o, n) for o in obj]
    return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)


def _tile(obj, n):
    """The first cameras' outputs repeated over all n cameras."""
    if isinstance(obj, torch.Tensor):
        return obj.repeat_interleave(n // obj.shape[0], dim=0) if obj.ndim else obj
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _tile(getattr(obj, f.name), n)
                                           for f in dataclasses.fields(obj)})
    items = [_tile(o, n) for o in obj]
    return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "answer altered"])
def test_a_broken_program_is_not_correct(spec, fault):
    result = run(spec, program_factory=_Broken(spec, fault))
    assert result["correct"] is False, (fault, result["checks"])


def test_the_control_fails_the_limits(spec):
    r = readings(spec, CELL, SEED, 0.3, device="cpu")
    limits = spec.entry(spec.cell(CELL)).LIMITS
    assert all(r["program"][k] <= limits[k] for k in limits), r
    assert any(r["control"][k] > limits[k] for k in limits), r


def test_traffic_is_the_same_for_a_seed_and_differs_across_seeds():
    mix = json.loads((BENCH_DIR / "traffic" / "cam4.json").read_text())
    a = traffic.make(mix, SEED, "cpu", height=24, width=40)
    b = traffic.make(mix, SEED, "cpu", height=24, width=40)
    c = traffic.make(mix, SEED + 1, "cpu", height=24, width=40)
    assert torch.equal(a.left, b.left) and torch.equal(a.right, b.right)
    assert not torch.equal(a.left, c.left)
    assert a.left.shape == c.left.shape == (mix["reverse_every"] + 1, mix["cameras"], 24, 40)
    # The scene pans pan_px a frame, reverses every reverse_every frames,
    # and the right view is the left moved by the true disparity.
    d, pan, period = mix["true_disparity"], mix["pan_px"], mix["reverse_every"]
    left1, _ = a.frames(1)
    left0, right0 = a.frames(0)
    assert torch.equal(left1[..., :-pan], left0[..., pan:])
    assert torch.equal(right0[..., :-d], left0[..., d:])
    assert [a.position(i) for i in (0, 1, period, period + 1, 2 * period)] == [0, 1, period,
                                                                              period - 1, 0]


def test_a_new_configuration_mix_and_metric_are_found_by_name(tmp_path):
    """tiny_bench writes a configuration, a mix and a metric's list into a
    folder of its own; a further metric file is found by its name alone."""
    spec = tiny_bench(tmp_path)
    (spec.dir / "metrics" / "calls_done.py").write_text(
        "def read(rec):\n    return float(rec.attempted)\n")
    spec.data["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": [CELL]})
    result = run(spec)
    assert result["metrics"]["calls_done"]["value"] == result["attempted"]
    assert spec.cell(CELL).config["name"] == "tiny_farm"


def test_the_real_benchmark_names_files_that_exist():
    spec = Spec.load(ROOT)
    for w in spec.data["workloads"]:
        cell = spec.cell(w["name"])
        assert (spec.config_dir(cell) / "entry.py").is_file()
        assert spec.config_values(cell)["name"] == cell.config["name"]
        assert spec.traffic(cell)["kind"] in traffic.KINDS
        for m in cell.end_to_end + cell.per_layer:
            assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "farm_fleet.cam4",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_references_import_nothing_of_the_port():
    refs = [p for p in (BENCH_DIR / "configs").glob("*/reference") if p.is_dir()]
    assert refs
    for ref in refs:
        for path in ref.rglob("*.py"):
            assert "ocean_perception_tpu_torch" not in _imports(path), path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ocean_perception_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib"]
