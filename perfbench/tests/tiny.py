"""A tiny copy of the benchmark for the CPU tests: the farm_fleet
configuration's entry and reference at a size a test run holds, in a
folder of its own, found by name as the real ones are. It runs no
enhancement, which the cell runs and does not compare
(test_perfbench_enhance.py holds the reference's at the cell's own size)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.harness.spec import BENCH_DIR, Spec

TINY_YAML = """\
ObjectMesher:
  foreground_ksize: 15
  foreground_min_gradient: 20.0
  edge_min_foreground_percent: 0.9
  edge_max_depth_change: 1.0
  vertex_min_obs: 3
  min_obs_connect_edge: 2
  min_obs_disconnect_edge: 2

  StereoTracker:
    stereo_max_depth: 20.0
    stereo_min_depth: 0.2
    retrack_frames_k: 3
    trigger_keyframe_min_lmks: 10
    trigger_keyframe_k: 3

    FeatureDetector:
      max_features_per_frame: 32
      min_distance_btw_tracked_and_detected_features: 10
      gftt_quality_level: 0.01
      gftt_block_size: 9
      gftt_use_harris_corner_detector: 0
      gftt_k: 0.04

    FeatureTracker:
      klt_maxiters: 30
      klt_epsilon: 0.01
      klt_winsize: 21
      klt_max_level: 1

    StereoMatcher:
      templ_cols: 15
      templ_rows: 11
      max_disp: 24
      max_matching_cost: 0.15
      bidirectional: 1
      subpixel_refinement: 0
"""


def tiny_values() -> dict:
    values = json.loads((BENCH_DIR / "configs" / "farm_fleet" / "config.json").read_text())
    values.update(name="tiny_farm", height=64, width=96, fx=80.0, cx=48.0, cy=32.0, max_disp=32,
                  internal_scale=2, mesher_scale=1, enhance=None)
    m = values["mesher"]
    m.update(min_obs_connect_edge=2.0, min_obs_disconnect_edge=2.0)
    t = m["tracker"]
    t.update(capacity=32, trigger_keyframe_k=3)
    t["detector"].update(max_features=32, min_distance=10.0)
    t["lk"].update(max_level=1)
    t["matcher"].update(max_disp=24, templ_cols=15)
    return values


def tiny_bench(tmp: Path, cameras: int = 2) -> Spec:
    """A benchmark folder under tmp holding the tiny configuration
    ``tiny_farm`` (the farm_fleet entry and reference, tiny sizes), the mix
    ``tiny`` and the real metrics; returns its Spec."""
    bench = tmp / "perfbench"
    cfg = bench / "configs" / "tiny_farm"
    shutil.copytree(BENCH_DIR / "configs" / "farm_fleet", cfg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (cfg / "config.json").write_text(json.dumps(tiny_values()))
    (cfg / tiny_values()["node_yaml"]).write_text(TINY_YAML)
    shutil.copytree(BENCH_DIR / "metrics", bench / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((BENCH_DIR / "traffic" / "cam4.json").read_text())
    mix.update(cameras=cameras, reverse_every=4)
    (bench / "traffic").mkdir()
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    real = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    cell = "tiny_farm.tiny"
    data = {
        "configs": [{"name": "tiny_farm", "source": "test", "why": "test", "reduced": [],
                     "file": "perfbench/configs/tiny_farm/config.json"}],
        "workloads": [{"name": cell, "config": "tiny_farm", "traffic": "tiny", "chips": 1,
                       "why": "test"}],
        "end_to_end": [dict(m, workloads=[cell]) if "workloads" in m else m
                       for m in real["end_to_end"] if m["name"] in ("setup_s", "camera_fps",
                                                                     "fleet_call_ms_p95")],
        "per_layer": [dict(m, workloads=[cell]) for m in real["per_layer"]
                      if m["name"].endswith(".farm")],
    }
    return Spec(data, bench)
