"""The reference's Sea-thru enhancement against the port's at the cell's own
size, on the CPU: one camera of the cell's mix at Farmsim's 672x376, the
port's perception step and the reference's enhancement of the same frame
from the port's depth, in float64 and in bfloat16. The cell does not
compare the enhanced image (PERF.md, section 2): where the backscatter fit
accepts a step on its scene, rounding picks the fits' path. This frame's
fit accepts none, and there the two agree to rounding, and bfloat16 does
not.

Run: ``python -m pytest perfbench/tests -q`` from the repository's root.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import traffic  # noqa: E402
from perfbench.harness.spec import BENCH_DIR, load_module  # noqa: E402

CONFIG = BENCH_DIR / "configs" / "farm_fleet"
AGREE = 1e-4   # the largest gap of a colour value that rounding alone leaves


@pytest.fixture(scope="module")
def frame():
    """(values, the port's outputs, the frame's uint8 left view) of frame 1
    of one camera of the cell's mix."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.imaging.enhance import EnhanceParams
    from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step

    values = json.loads((CONFIG / "config.json").read_text())
    mix = json.loads((BENCH_DIR / "traffic" / "cam4.json").read_text())
    mix.update(cameras=1, reverse_every=4)
    H, W = values["height"], values["width"]
    left, right = traffic.make(mix, 2 ** 31 + 77, "cpu", height=H, width=W).frames(1)
    cam = PinholeCamera.create(values["fx"], values["fx"], values["cx"], values["cy"], H, W)
    rig = StereoCamera.create(cam, cam, baseline=values["baseline_m"])
    config = PerceptionConfig(max_disp=values["max_disp"], internal_scale=values["internal_scale"],
                              max_depth=values["max_depth_m"],
                              enhance=EnhanceParams(**values["enhance"]))
    unit = torch.full((), 255.0)
    rgb = [(v.float() / unit)[..., None].expand(*v.shape, 3) for v in (left, right)]
    out = perception_step(*rgb, rig, config, device="cpu")
    return values, out, left


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_enhancement_agrees_with_the_port_to_rounding_and_bfloat16_does_not(frame, dtype):
    values, out, left = frame
    load_module(CONFIG / "reference", "perfbench_reference_farm_fleet")
    ref = {m: importlib.import_module(f"perfbench_reference_farm_fleet.{m}")
           for m in ("enhance", "image")}
    rgb = (left[0].to(dtype) / 255.0)[..., None].expand(*left.shape[1:], 3)
    work = {}
    got = ref["enhance"].enhance(rgb, out.depth[0].to(dtype),
                                 ref["image"].gray_of_mono(left[0], dtype), values["enhance"],
                                 work)
    gap = float((got.double() - out.enhanced_left[0].double()).abs().max())
    if dtype == torch.float64:
        assert work["sea_thru_fit"][0][0]["accepted"] == 0   # the backscatter fit's steps
        assert gap <= AGREE, gap
    else:
        assert gap > 100 * AGREE, gap
