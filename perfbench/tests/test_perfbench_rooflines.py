"""The roofline readers' arithmetic on the CPU: PERF.md section 6's bound
column where it depends on shapes alone, and the frozen copies against the
repository's smoke test (``chip_smoke.py``), whose functions they copy, on
the same synthetic inputs.

Run: ``python -m pytest perfbench/tests -q`` from the repository's root.
"""

from __future__ import annotations

import importlib
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness.peaks import bound_us  # noqa: E402
from perfbench.harness.spec import BENCH_DIR, load_module  # noqa: E402


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "test_metric_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def smoke():
    return load_module(ROOT / "chip_smoke.py", "test_chip_smoke")


@pytest.mark.parametrize("B, bound", [(1, 9.90), (4, 39.62)])
def test_cost_volume_bound_is_perf_md_s(B, bound):
    """K1 at the 720p step's half resolution (360x640, D=64, bf16)."""
    nbytes = reader("cost_volume.roofline_pct.farm").volume_bytes(B, 360, 640, 64)
    assert round(bound_us(nbytes), 2) == bound


def _lk_call(B, K=200, levels=4, win=21, slack=4, H=720, W=1280):
    """The smoke test's record of one lk_track launch of B cameras, and the
    steps each point moved a level."""
    tmpl = [torch.zeros(B * 4, H >> lvl, W >> lvl) for lvl in range(levels)]
    points = torch.zeros(B, K, 2)
    kwargs = dict(wins=[win] * levels, slack=slack, pad=0, min_eig_threshold=1e-9,
                  max_iters=30, eps=0.01)
    g = torch.Generator().manual_seed(3)
    steps = [(lvl, torch.randint(0, 8, (B, K), generator=g)) for lvl in range(levels)]
    return (tmpl, tmpl, points), kwargs, steps


def _lk_levels(kwargs, steps, b):
    """Camera b's levels as the reference records them: (level, window,
    steps moved by all its points)."""
    return [(lvl, kwargs["wins"][lvl], int(moved[b].sum())) for lvl, moved in steps]


@pytest.mark.parametrize("B, bound", [(1, 2.66), (4, 10.65)])
def test_lk_bound_is_perf_md_s(B, bound):
    """K5+K6 at 720p: 200 points, 4 levels of window 21, slack 4 (the walk's
    steps move the bound by well under its last digit); a launch's cameras
    add."""
    args, kwargs, steps = _lk_call(B)
    m = reader("lk_track.roofline_pct.farm")
    work = [m.lk_work(200, _lk_levels(kwargs, steps, b)) for b in range(B)]
    assert round(bound_us(sum(w[0] for w in work), sum(w[1] for w in work)), 2) == bound


@pytest.mark.parametrize("B", [1, 2])
def test_lk_work_equals_the_smoke_tests(smoke, B):
    args, kwargs, steps = _lk_call(B, K=16, H=64, W=96)
    m = reader("lk_track.roofline_pct.farm")
    work = [m.lk_work(16, _lk_levels(kwargs, steps, b)) for b in range(B)]
    want = smoke.lk_bounds(("lk_track", args + (None, None, None), kwargs), steps, [])
    got = bound_us(sum(w[0] for w in work), sum(w[1] for w in work))
    assert got == pytest.approx(1e3 * want["bound_ms"], rel=1e-12)


def _fit_call(model, G, accepted):
    """The smoke test's record of one camera's fit launch."""
    N = 256
    config = types.SimpleNamespace(max_iters=10 if model == "backscatter" else 20)
    result = types.SimpleNamespace(error=torch.zeros(1, G),
                                   n_accepted=torch.tensor([accepted]))
    call = (model, torch.zeros(1, N, 3), torch.zeros(1, N), torch.ones(1, N, dtype=torch.bool),
            torch.zeros(G, 12), config)
    fit = dict(model=model, N=N, fits=G, starts=G, iters=config.max_iters, accepted=accepted)
    return call, result, fit


@pytest.mark.parametrize("model, G, accepted", [("backscatter", 1, 3), ("attenuation", 2, 17)])
def test_fit_work_equals_the_smoke_tests(smoke, model, G, accepted):
    call, result, fit = _fit_call(model, G, accepted)
    nbytes, ops = reader("sea_thru_fit.roofline_pct.farm").fit_work(fit)
    want = smoke.fit_bound(call, result)
    assert bound_us(nbytes, ops) == pytest.approx(1e3 * want["bound_ms"], rel=1e-12)


def test_backscatter_bound_is_perf_md_s():
    """The backscatter fit at N = 256, 10 iterations, one fit, no step
    accepted: PERF.md's 0.0029 us (operations)."""
    _, _, fit = _fit_call("backscatter", 1, 0)
    nbytes, ops = reader("sea_thru_fit.roofline_pct.farm").fit_work(fit)
    assert round(bound_us(nbytes, ops), 4) == 0.0029


def test_match_volume_reads_equal_the_smoke_tests(smoke):
    """The elements a match reads: by the frozen VolumeReads on the
    reference's match, and by the smoke test's on the port's plain passes,
    on the same volume, seeds and noise, at a small size on the CPU. The
    two matches are written apart; their reads are the same elements."""
    from ocean_perception_tpu_torch.stereo import patchmatch as port_pm

    load_module(BENCH_DIR / "configs" / "farm_fleet" / "reference",
                "perfbench_reference_farm_fleet")
    ref_pm = importlib.import_module("perfbench_reference_farm_fleet.stereo")
    g = torch.Generator().manual_seed(5)
    H, W, D = 24, 48, 8
    C = torch.rand(H, W, D, generator=g).bfloat16()
    pp = port_pm.PatchMatchParams(max_disp=D, right_wta=True, volume_bf16=True)
    seed = port_pm.sparse_wta_seed(C, pp)
    noise = port_pm.unit_noise((H, W), pp.noise_seed)
    m = reader("pm_match.roofline_pct.farm")
    nbytes = m.match_bytes(C, seed.double(), noise.double(), ref_pm.match)
    reads = smoke.VolumeReads([C], pp.patch_radius)
    with reads:
        port_pm._match_passes(C, C, seed, noise, pp)
    reads.offsets[0].pop(0)   # the seed's cost, which the first refresh replaces
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    reads.offsets[0].append((yy * C.stride(0) + xx * C.stride(1)).flatten())
    elements = int(torch.unique(torch.cat(reads.offsets[0])).numel())
    assert nbytes == H * W * 8 + elements * 2
    assert H * W < elements < H * W * D
