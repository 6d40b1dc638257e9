"""The port's config reader and loaders against the JAX package's.

- ``load_opencv_yaml`` gives PyYAML's tree (through the JAX reader) on every
  file under ``config/``, on the temporary files of
  ``tests/test_config_bindings.py``, and on a fixture of the scalars and
  layouts the shipped files do not use (YAML 1.1 booleans, ``1e-3`` as a
  string, octal and sexagesimal integers, quoted scalars, block sequences
  of mappings, flow sequences over several lines, ``!!opencv-matrix``);
- each loader's result equals the JAX loader's, through ``convert.py``;
- ``load_rig`` on every shared rig equals ``stereo_camera_from_jax`` of JAX's;
- with ``yaml`` and ``cv2`` unimportable (the GPU machine's installation),
  ``config`` and ``fabric`` import and both nodes build from the shipped
  YAML.
"""

import glob
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ocean_perception_tpu.config import bindings as jb
from ocean_perception_tpu.config import yaml_parser as jy
from ocean_perception_tpu_torch import convert
from ocean_perception_tpu_torch.config import bindings as tb
from ocean_perception_tpu_torch.config import yaml_parser as ty

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(glob.glob(str(REPO / "config" / "**" / "*.yaml"), recursive=True))
NODE = str(REPO / "config" / "nodes" / "ObjectMesherNode.yaml")
FARM = str(REPO / "config" / "nodes" / "FarmPerceptionNode.yaml")
SHARED = str(REPO / "config" / "shared" / "Farmsim.yaml")

ODD = """\
%YAML:1.0
---
a: 1e-3
b: yes
c: off
d: 0x1F
e: 017
f: 1:30
g: 1_000
h: .5
i: -.inf
j: ~
k: 'it''s # not a comment'
l: "tab\\there # not one either"
m: [1, [2, 3], 'x, y',
    4.5, ]
n:
- one
- two: 2
  three: 3
-
  - nested
o: !!opencv-matrix
  rows: 2
  cols: 1
  data: [1., 2.]
p: 1.5e+3
q: null
r:   # empty
s: +12
t: 0b101
u: 0
v: -0
w: 1.0.0
y: http://a.b/c
z: cam{i}
On: 1
"0": zero
nested:
  deeper:
    - a: 1
      b: [x, y]
    - - 1
      - 2
  after: True
"""


def _same(a, b) -> bool:
    """Tree equality with types: 1 == True == 1.0 do not count as equal."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_reader_equals_pyyaml_on_shipped_files(path):
    assert _same(ty.load_opencv_yaml(path), jy.load_opencv_yaml(path))


@pytest.mark.parametrize("text", [
    ODD,
    "klt_winsize: 17\nklt_bwd_levels: 2\nklt_bwd_zncc_min: 0.25\nklt_zncc_gate: 1\n",
    "klt_winsize: 21\n",
    "",
    "# only a comment\n",
], ids=["odd", "lk_zncc", "lk_default", "empty", "comment"])
def test_reader_equals_pyyaml_on_fixtures(tmp_path, text):
    path = tmp_path / "f.yaml"
    path.write_text(text)
    assert _same(ty.load_opencv_yaml(str(path)), jy.load_opencv_yaml(str(path)))


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  block\n", "a: {b: 1}\n",
                                  "a: 2001-12-14\n", "a: !!str 1\n"])
def test_reader_refuses_what_it_does_not_read(tmp_path, text):
    path = tmp_path / "f.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        ty.load_opencv_yaml(str(path))


def _parsers(node=NODE, shared=SHARED):
    return (jy.YamlParser(node_path=node, shared_path=shared),
            ty.YamlParser(node_path=node, shared_path=shared))


@pytest.mark.parametrize("node", [NODE, FARM])
def test_mesher_and_tracker_loaders_equal_jax(node):
    jp, tp = _parsers(node)
    jm, tm = jb.load_mesher_params(jp), tb.load_mesher_params(tp)
    assert tm == convert.object_mesher_params_from_jax(jm)
    st = "ObjectMesher/StereoTracker"
    assert tb.load_tracker_params(tp.subtree(st)) == convert.stereo_tracker_params_from_jax(
        jb.load_tracker_params(jp.subtree(st)))
    assert tb.load_detector_params(tp.subtree(st + "/FeatureDetector")) == \
        convert.detector_params_from_jax(jb.load_detector_params(jp.subtree(st + "/FeatureDetector")))
    assert tb.load_lk_params(tp.subtree(st + "/FeatureTracker")) == \
        convert.lk_params_from_jax(jb.load_lk_params(jp.subtree(st + "/FeatureTracker")))
    assert tb.load_matcher_params(tp.subtree(st + "/StereoMatcher")) == \
        convert.stripe_matcher_params_from_jax(jb.load_matcher_params(jp.subtree(st + "/StereoMatcher")))


def test_lk_loader_reads_the_zncc_keys(tmp_path):
    """The fixture of tests/test_config_bindings.py: the ZNCC gate's keys and
    their defaults."""
    y = tmp_path / "trk.yaml"
    y.write_text("klt_winsize: 17\nklt_bwd_levels: 2\nklt_bwd_zncc_min: 0.25\nklt_zncc_gate: 1\n")
    lk = tb.load_lk_params(ty.YamlParser(str(y)))
    assert lk == convert.lk_params_from_jax(jb.load_lk_params(jy.YamlParser(str(y))))
    assert (lk.window, lk.bwd_levels, lk.bwd_zncc_min, lk.zncc_gate) == (17, 2, 0.25, True)


@pytest.mark.parametrize("rig", ["Farmsim", "HIMB", "ACFR", "ZEDMini"])
def test_load_rig_equals_jax(rig):
    shared = str(REPO / "config" / "shared" / f"{rig}.yaml")
    jp, tp = _parsers(NODE, shared)
    assert tb.load_rig(tp) == convert.stereo_camera_from_jax(jb.load_rig(jp))
    j_rig, j_tl, j_tr = jp.get_stereo_rig()
    t_rig, t_tl, t_tr = tp.get_stereo_rig()
    np.testing.assert_array_equal(t_tl, j_tl)
    np.testing.assert_array_equal(t_tr, j_tr)


def test_params_base_loads_nested_dataclasses(tmp_path):
    from ocean_perception_tpu_torch.config import ParamsBase, params
    from ocean_perception_tpu_torch.config.params import field_vector, subparams

    @params
    class Inner(ParamsBase):
        k: int = 1

    @params
    class Outer(ParamsBase):
        alpha: float = 0.5
        flag: bool = False
        g: np.ndarray = field_vector(3, [0, 0, 0], yaml_id="/shared/n_gravity")
        inner: Inner = subparams(Inner)

    y = tmp_path / "p.yaml"
    y.write_text("alpha: 0.25\nflag: 1\nInner:\n  k: 7\n")
    p = Outer.from_files(str(y), SHARED)
    assert (p.alpha, p.flag, p.inner.k) == (0.25, True, 7)
    np.testing.assert_array_equal(p.g, [0, 9.81, 0])


def test_config_and_fabric_need_neither_pyyaml_nor_opencv():
    """The GPU machine's installation: no yaml, no cv2. The packages import
    and both nodes build from the shipped YAML (on the CPU)."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["yaml"] = None
        sys.modules["cv2"] = None
        import ocean_perception_tpu_torch.config, ocean_perception_tpu_torch.fabric
        from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus
        from ocean_perception_tpu_torch.fabric.nodes import farm_perception_node as fpn
        from ocean_perception_tpu_torch.fabric.nodes import object_mesher_node as omn
        farm = fpn.from_config(InProcessBus(), {FARM!r}, {SHARED!r}, device="cpu")
        assert farm.n_cameras == 4 and farm.config.internal_scale == 4
        farm.close()
        node = omn.from_config(InProcessBus(), {NODE!r}, {SHARED!r}, device="cpu")
        assert node.channel_output == "object_mesher/mesh"
        assert "yaml" not in [m for m in sys.modules if sys.modules[m] is not None]
        print("ok")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
