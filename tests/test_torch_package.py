"""Package-level checks of the PyTorch port: it imports no JAX, its GPU smoke
test refuses to run without a GPU, its kernel wrappers refuse CPU tensors,
the CPU paths launch no kernel, and (on a CUDA machine only) each
hand-written kernel equals its plain twin.

The tests marked ``gpu`` skip without a CUDA device. This file imports no
JAX, so on a GPU machine without JAX they run with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_package.py -m gpu -q``.
"""

import os
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gradient_magnitude
from ocean_perception_tpu_torch.stereo import cost as tcost
from ocean_perception_tpu_torch.stereo import patchmatch as tpm
from ocean_perception_tpu_torch.tracking import lk as tlk

REPO = Path(__file__).resolve().parent.parent
# Host syncs a full_frontend_step frame keeps (PERF.md, section 5): the
# mesher half's, each named there by file and line.
FRONTEND_SYNCS = 0


def _run(code_or_args, cwd, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ocean_perception_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ocean_perception_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n"
    )
    proc = _run(code, REPO)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
    # Alone in a directory, without the package, it fails too.
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8, 16)
    C = torch.zeros(8, 16, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.cost_volume(x, x, x, x, 4, 0.9, 0.1, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.pm_match(C, x, x, 3, 32.0, 4, 2, 5, 1, 0.8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.build_volumes(x, x, x, x, 4, 0.9, 0.1, 4, 2, torch.bfloat16)
    V_row = torch.zeros(4, 4, 4, 8, dtype=torch.bfloat16)
    V_col = torch.zeros(4, 2, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.pm_match_strip(V_row, V_col, x, x, 3, 32.0, 5, 1, 0.8)
    ring, pts, src = torch.zeros(2, 8, 16), torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.lk_track([ring], [ring], pts, pts, src, src, [7], 4, 5, 1e-9, 30, 1e-4)


@pytest.mark.parametrize("extra", [dict(right_wta=True), dict(right_wta=True, use_strip_volumes=True),
                                   dict(right_wta=False)])
def test_cpu_path_launches_no_kernel(extra):
    cuda.reset_launches()
    img = torch.from_numpy(np.random.default_rng(41).random((24, 40)).astype(np.float32))
    out = tpm.patchmatch_disparity(img, torch.roll(img, -3, 1),
                                   tpm.PatchMatchParams(max_disp=8, chunks=4, **extra))
    assert out.left.shape == (24, 40)
    assert set(cuda.LAUNCHES.values()) == {0}


def _frontend_setup(device, H=48, W=64, K=16, seed=43, batch=None):
    """A small full_frontend_step configuration and a 3-frame sequence that
    moves 2 px a frame, with an 8 px stereo disparity; with ``batch``, the
    state of that many cameras."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.mesher.landmark_graph import LandmarkGraph
    from ocean_perception_tpu_torch.mesher.object_mesher import ObjectMesherDeviceParams
    from ocean_perception_tpu_torch.models.perception import PerceptionConfig
    from ocean_perception_tpu_torch.tracking.detector import DetectorParams
    from ocean_perception_tpu_torch.tracking.stereo_tracker import (StereoTrackerParams,
                                                                    StereoTrackerState)
    from ocean_perception_tpu_torch.tracking.stripe_match import StripeMatcherParams

    rng = np.random.default_rng(seed)
    canvas = rng.random((H, W + 32)).astype(np.float32)
    frames = [(torch.from_numpy(np.repeat(canvas[:, 2 * i: 2 * i + W, None], 3, 2)).to(device),
               torch.from_numpy(np.repeat(canvas[:, 2 * i + 8: 2 * i + 8 + W, None], 3, 2)).to(device))
              for i in range(3)]
    cam = PinholeCamera.create(100.0, 100.0, W / 2, H / 2, H, W)
    tracker = StereoTrackerParams(capacity=K, detector=DetectorParams(max_features=K, min_distance=8),
                                  lk=tlk.LKParams(max_level=1),
                                  matcher=StripeMatcherParams(max_disp=16, templ_cols=9, templ_rows=7))
    config = PerceptionConfig(max_disp=16, internal_scale=1, run_enhance=False, chunks=4)
    return dict(device=device, frames=frames, rig=StereoCamera.create(cam, cam, 0.1), config=config,
                params=ObjectMesherDeviceParams(tracker=tracker, neighbor_radius_px=30.0),
                state=StereoTrackerState.create(tracker, image_shape=(H, W), device=device,
                                                batch=batch),
                graph=LandmarkGraph.create(K, device=device, batch=batch))


def _fleet_setup(device, cameras=3):
    """_frontend_setup's configuration on cameras of unlike scenes (their
    own canvases), one frame of each in every batched frame."""
    setups = [_frontend_setup(device, seed=43 + b) for b in range(cameras)]
    fleet = _frontend_setup(device, batch=cameras)
    fleet["frames"] = [tuple(torch.stack(side) for side in zip(*frame))
                       for frame in zip(*(s["frames"] for s in setups))]
    return fleet, setups


def _run_frontend(setup):
    from ocean_perception_tpu_torch.models.perception import full_frontend_step
    from ocean_perception_tpu_torch.ops.image import to_grayscale

    state, graph = setup["state"], setup["graph"]
    prev = to_grayscale(setup["frames"][0][0])
    outs = []
    for left, right in setup["frames"]:
        out, prev = full_frontend_step(state, graph, prev, left, right, setup["rig"],
                                       setup["config"], setup["params"], device=setup["device"])
        state, graph = out.tracker_state, out.graph
        outs.append(out)
    return outs


def test_cpu_frontend_launches_no_kernel():
    cuda.reset_launches()
    outs = _run_frontend(_frontend_setup("cpu"))
    assert set(cuda.LAUNCHES.values()) == {0}
    table = outs[-1].tracker_state.table
    assert (table.ids >= 0).sum() >= 8 and (table.missed == 0).sum() >= 8


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda._nvcc()
    path = cuda.library_path()
    assert path.name == "libopt_kernels.so" and path.parent.parent.name == "_build"
    assert path == cuda.library_path()  # keyed by the sources and flags only


# --- on the card -----------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels cannot run on the CPU")
    return torch.device("cuda", 0)


def _stereo_inputs(device, H=40, W=64, D=16):
    rng = np.random.default_rng(42)
    canvas = rng.random((H, W + 8)).astype(np.float32)
    l = torch.from_numpy(canvas[:, 8:]).to(device)
    r = torch.from_numpy(canvas[:, 3 : 3 + W]).to(device)
    return l, r, D


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cost_volume_kernel_matches_plain(cuda_device, dtype):
    l, r, D = _stereo_inputs(cuda_device)
    before = cuda.LAUNCHES["cost_volume"]
    ours = tcost.cost_volume(l, r, D, 0.9, dtype=dtype)
    assert cuda.LAUNCHES["cost_volume"] == before + 1
    plain = tcost.cost_volume_plain(l, r, D, 0.9, gradient_magnitude(l), gradient_magnitude(r), dtype)
    torch.cuda.synchronize()
    assert torch.equal(ours, plain)


def _match_plain_loop(C_row, C_col, seed, noise, p):
    """The match as the stages' plain twins compose it, the mask on a fresh
    lookup: refresh, R+ C+ R- C- per iteration, then mask_background_plain."""
    disp = seed
    for it in range(p.iters):
        disp, cost = tpm._refresh_plain(C_col, disp, noise, p.noise_scale0 / 2.0**it, 1)
        for direction, axis in tpm.PASSES:
            disp, cost = tpm._propagate_plain(C_row if axis == 1 else C_col, disp, cost,
                                              direction, axis, p)
    return tpm.mask_background_plain(C_col, disp, p)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [True, False])
def test_patchmatch_kernels_match_plain(cuda_device, bf16):
    """pm_match, the whole match in one launch, against the plain loop."""
    l, r, D = _stereo_inputs(cuda_device)
    p = tpm.PatchMatchParams(max_disp=D, chunks=4, chunks_y=3, iters=2, right_wta=True, volume_bf16=bf16)
    C = tcost.cost_volume(l, r, D, 0.9, dtype=torch.bfloat16 if bf16 else torch.float32)
    seed = tpm.sparse_wta_seed(C, p)
    noise = tpm.unit_noise(seed.shape, p.noise_seed, device=cuda_device)

    cuda.reset_launches()
    full = tpm._match_one_side(C, seed, noise, p)
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {"pm_match": 1}
    assert torch.equal(full, tpm._match_plain(C, C, seed, noise, p))
    assert torch.equal(full, _match_plain_loop(C, C, seed, noise, p))
    assert 0 < (full > 0).float().mean() < 1
    torch.cuda.synchronize()


def _adversarial_seed(C, seed=5):
    """A seed and a noise image on which the match's lookups tie and clamp:
    disparities on the half-integer grid over [0, D + 4), a quarter of them 0
    (background), so past x - pr at the left edge and past D - 1; noise on
    the 1/64 grid, so the refreshed disparities stay on the half-integer
    grid."""
    rng = np.random.default_rng(seed)
    H, W, D = C.shape
    disp = np.floor(rng.uniform(0, D + 4, (H, W)) * 2).astype(np.float32) / 2
    disp[rng.random((H, W)) < 0.25] = 0
    noise = (rng.integers(-64, 64, (H, W)) / 64).astype(np.float32)
    return torch.from_numpy(disp).to(C.device), torch.from_numpy(noise).to(C.device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,W,D,chunks,chunks_y", [
    (40, 72, 24, 4, 2),   # 40 rows: a partial row block; w = 28 and 30
    (45, 70, 32, 1, 1),   # one strip: a row pass of w = 80, over two staged segments
    (33, 100, 20, 5, 3),  # 33 rows, one past two blocks; w = 30 and 21
    (24, 300, 16, 3, 2),  # 300 columns: a partial column tile of 44
])
def test_propagate_kernels_on_adversarial_fronts(cuda_device, dtype, H, W, D, chunks, chunks_y):
    """pm_match and pm_match_strip against the plain loop where the compare
    flips often, lookups tie and the x - pr clamp and the mask fire, in
    geometries whose row counts and scan lengths are no multiple of the row
    passes' work item (16 rows), speculation depth (4) or staged segment
    (64 positions), and whose first strips lie at x < D."""
    l, r, _ = _stereo_inputs(cuda_device, H, W, D)
    gl, gr = gradient_magnitude(l), gradient_magnitude(r)
    p = tpm.PatchMatchParams(max_disp=D, chunks=chunks, chunks_y=chunks_y, iters=3)
    C = tcost.cost_volume(l, r, D, 0.9, gl, gr, dtype=dtype)
    vr, vc = tcost.build_strip_volumes(l, r, gl, gr, D, 0.9, chunks, chunks_y, dtype)
    seed, noise = _adversarial_seed(C)
    want = _match_plain_loop(C, C, seed, noise, p)
    assert 0 < (want > 0).float().mean() < (seed > 0).float().mean()
    cuda.reset_launches()
    assert torch.equal(tpm._match_one_side(C, seed, noise, p), want)
    assert torch.equal(tpm._match_one_side_strips(vr, vc, seed, noise, p), want)
    assert cuda.LAUNCHES["pm_match"] == cuda.LAUNCHES["pm_match_strip"] == 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_build_volumes_kernel_matches_plain(cuda_device, dtype):
    l, r, D = _stereo_inputs(cuda_device)
    gl, gr = gradient_magnitude(l), gradient_magnitude(r)
    before = cuda.LAUNCHES["build_volumes"]
    ours = tcost.build_strip_volumes(l, r, gl, gr, D, 0.9, 4, 3, dtype)
    assert cuda.LAUNCHES["build_volumes"] == before + 1
    plain = tcost.build_strip_volumes_plain(l, r, gl, gr, D, 0.9, 4, 3, dtype)
    torch.cuda.synchronize()
    for a, b in zip(ours, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [True, False])
def test_strip_patchmatch_kernels_match_plain(cuda_device, bf16):
    l, r, D = _stereo_inputs(cuda_device)
    p = tpm.PatchMatchParams(max_disp=D, chunks=4, chunks_y=3, iters=2, right_wta=True,
                             volume_bf16=bf16, use_strip_volumes=True)
    dtype = torch.bfloat16 if bf16 else torch.float32
    vr, vc = tcost.build_strip_volumes(l, r, gradient_magnitude(l), gradient_magnitude(r), D, 0.9,
                                       p.chunks, p.chunks_y, dtype)
    C = tcost.volume_from_col_strips(vc)
    seed = tpm.sparse_wta_seed(C, p)
    noise = tpm.unit_noise(seed.shape, p.noise_seed, device=cuda_device)

    cuda.reset_launches()
    full = tpm._match_one_side_strips(vr, vc, seed, noise, p)
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {"pm_match_strip": 1}
    assert torch.equal(full, _match_plain_loop(tcost.volume_from_row_strips(vr), C, seed, noise, p))
    assert torch.equal(full, tpm._match_one_side(C, seed, noise, p))
    gpu = tpm.patchmatch_disparity(l, r, p)
    cpu = tpm.patchmatch_disparity(l.cpu(), r.cpu(), p)
    assert torch.equal(gpu.left.cpu(), cpu.left) and torch.equal(gpu.right.cpu(), cpu.right)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_gpu_matches_cpu_end_to_end(cuda_device):
    l, r, D = _stereo_inputs(cuda_device)
    p = tpm.PatchMatchParams(max_disp=D, chunks=4, right_wta=True, volume_bf16=True)
    gpu = tpm.patchmatch_disparity(l, r, p)
    cpu = tpm.patchmatch_disparity(l.cpu(), r.cpu(), p)
    assert torch.equal(gpu.left.cpu(), cpu.left)


@pytest.mark.gpu
@pytest.mark.parametrize("engine,extra", [("sgm", {}), ("wta", {}),
                                          ("patchmatch", dict(right_wta=False)),
                                          ("patchmatch", dict(right_wta=True, cost="zncc"))])
def test_engines_gpu_match_cpu(cuda_device, engine, extra):
    """The other stereo configurations on the card against the CPU: within
    1e-3 px on >= 99% of pixels (torch sums the SGM and ZNCC terms on the
    card in its own order)."""
    from ocean_perception_tpu_torch.stereo import api as tapi

    l, r, D = _stereo_inputs(cuda_device)
    kw = dict(engine=engine, max_disp=D,
              patchmatch_params=tpm.PatchMatchParams(max_disp=D, chunks=4, **extra))
    gpu = tapi.estimate_disparity(l, r, **kw)
    cpu = tapi.estimate_disparity(l.cpu(), r.cpu(), **kw)
    assert ((gpu.left.cpu() - cpu.left).abs() <= 1e-3).float().mean() >= 0.99


def _lk_levels(device, rng, huge=False):
    """A 3-frame ring and a current frame, 4 levels from 90x160 down."""
    ring = rng.random((3, 90, 160)).astype(np.float32)
    cur = np.roll(ring[1:2], (1, -2), (1, 2)) * 0.5 + 0.25
    if huge:  # values the kernel's two-tap sums must not take
        ring[0, 40:44, 60:64] = 3e38
        ring[2, 10, 10] = np.inf
        cur[0, 50, 100:103] = -np.inf
    levels = [(ring, cur)]
    for _ in range(3):
        levels.append(tuple(np.ascontiguousarray(a[:, ::2, ::2]) for a in levels[-1]))
    return ([torch.from_numpy(r).to(device) for r, _ in levels],
            [torch.from_numpy(c).to(device) for _, c in levels])


def _lk_points(device, rng, K):
    pts = np.stack([rng.uniform(-5, 165, K), rng.uniform(-5, 95, K)], 1).astype(np.float32)
    special = [(np.nan, np.nan), (0.0, 0.0), (159.0, 89.0), (-50.0, 20.0), (80.0, 45.0)]
    n = min(K, len(special))
    pts[:n] = np.array(special[:n], np.float32).reshape(n, 2)
    return torch.from_numpy(pts).to(device)


def _check_lk_track(rings, curs, pts, src, wins):
    """lk_track against lk_track_plain forward (templates from the ring)
    and backward (searching the ring), one launch a direction."""
    K = pts.shape[0]
    kw = dict(wins=wins, slack=4, pad=12, min_eig_threshold=1.5e-9, max_iters=30, eps=0.01)
    zero = torch.zeros_like(src)
    fwd_init = pts + 1.25
    for tmpl, srch, st, ss, points, init in ((rings, curs, src, zero, pts, fwd_init),
                                             (curs, rings, zero, src, None, None)):
        if points is None:  # backward: from the forward points, as _round_trip does
            points = init = got[0]
        before = cuda.LAUNCHES["lk_track"]
        got = tlk.lk_track(tmpl, srch, points, init, st, ss, **kw)
        assert cuda.LAUNCHES["lk_track"] == before + (1 if K else 0)
        want = tlk.lk_track_plain(tmpl, srch, points, init, st, ss, **kw)
        assert torch.equal(got[0].nan_to_num(-1e30), want[0].nan_to_num(-1e30))
        assert torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("wins", [[21, 15, 21, None], [15, 15, 15, 15]], ids=["21-15-skip", "15"])
@pytest.mark.parametrize("K", [0, 1, 33, 200, 257])
def test_lk_track_matches_plain(cuda_device, K, wins):
    """lk_track on 4 levels (windows 21 and 15, a skipped level) with NaN
    points, points outside the image and on its borders, and a per-point
    template frame."""
    rng = np.random.default_rng(44 + K)
    rings, curs = _lk_levels(cuda_device, rng)
    src = torch.from_numpy(rng.integers(0, 3, K).astype(np.int32)).to(cuda_device)
    pts, ok = _check_lk_track(rings, curs, _lk_points(cuda_device, rng, K), src, wins)
    if K >= 200:
        assert ok.float().mean() > 0.3  # the walk tracks most points both ways


@pytest.mark.gpu
def test_lk_track_full_sums_on_huge_values(cuda_device):
    """Values too large (or not finite) for the two-tap sums send the kernel
    down the full sums, which keep the twin's infinities and NaNs."""
    rng = np.random.default_rng(46)
    rings, curs = _lk_levels(cuda_device, rng, huge=True)
    K = 64
    pts = _lk_points(cuda_device, rng, K)
    pts[5:16] = torch.tensor([61.0, 41.5], device=cuda_device)  # on the 3e38 block
    src = torch.zeros(K, dtype=torch.int32, device=cuda_device)
    _check_lk_track(rings, curs, pts, src, [21, 21, 15, 7])


@pytest.mark.gpu
def test_frontend_gpu_matches_cpu(cuda_device):
    cuda.reset_launches()
    gpu = _run_frontend(_frontend_setup(cuda_device))
    assert cuda.LAUNCHES["lk_track"] == 3 * 2  # forward and backward, every level at once
    cpu = _run_frontend(_frontend_setup("cpu"))
    for g, c in zip(gpu, cpu):
        assert torch.equal(g.mesher.labels.cpu(), c.mesher.labels)
        assert torch.equal(g.tracker_state.table.ids.cpu(), c.tracker_state.table.ids)
        assert torch.allclose(g.mesher.pixels.cpu(), c.mesher.pixels, atol=1e-3)


def sync_sites(fn) -> list:
    """One entry per host sync made by fn(), as torch.cuda.set_sync_debug_mode
    reports it: the port's frames of the Python stack at the sync, innermost
    first."""
    sites = []

    def record(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1]
            # The port's frames, or else the innermost three of any file.
            frames = [f for f in stack if "ocean_perception_tpu_torch" in f.filename] or stack[-3:]
            sites.append(" <- ".join(f"{Path(f.filename).name}:{f.lineno}" for f in frames[::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


@pytest.mark.gpu
@pytest.mark.parametrize("strips", [False, True])
def test_perception_step_makes_no_host_sync(cuda_device, strips):
    """A perception_step frame, enhancement on, on either volume layout,
    reads nothing back to the host and copies nothing from it once its
    constants are on the card."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step

    H, W = 64, 96
    canvas = np.random.default_rng(45).random((H, W + 8)).astype(np.float32)
    left = torch.from_numpy(np.repeat(canvas[:, :W, None], 3, 2)).to(cuda_device)
    right = torch.from_numpy(np.repeat(canvas[:, 8:8 + W, None], 3, 2)).to(cuda_device)
    cam = PinholeCamera.create(100.0, 100.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, 0.1)
    config = PerceptionConfig(max_disp=32, internal_scale=2, chunks=4, use_strip_volumes=strips)
    perception_step(left, right, rig, config, device=cuda_device)  # puts the constants there
    torch.cuda.synchronize()
    assert sync_sites(lambda: perception_step(left, right, rig, config, device=cuda_device)) == []


@pytest.mark.gpu
def test_frontend_host_syncs(cuda_device):
    """full_frontend_step keeps FRONTEND_SYNCS host syncs a frame."""
    setup = _frontend_setup(cuda_device)
    _run_frontend(setup)  # puts the constants there
    torch.cuda.synchronize()
    sites = sync_sites(lambda: _run_frontend(setup))
    assert len(sites) == 3 * FRONTEND_SYNCS, sites


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,W,D", [
    (37, 61, 13),   # no side a multiple of 8 or of a tile: every store scalar
    (40, 72, 13),   # rows of both strip layouts 16-byte aligned, D odd
    (44, 60, 24),   # H and W not multiples of 8: the strip layouts' rows unaligned
    (9, 200, 70),   # D past one block's disparities and not a multiple of 8
    (48, 60, 16),   # V_row rows aligned, V_col rows not
    (36, 64, 8),    # V_col rows aligned, V_row rows not
])
def test_cost_kernels_on_ragged_shapes(cuda_device, dtype, H, W, D):
    """cost_volume and build_volumes against their twins on shapes that
    break the 16-byte vector paths and the tiles."""
    l, r, _ = _stereo_inputs(cuda_device, H, W, D)
    gl, gr = gradient_magnitude(l), gradient_magnitude(r)
    plain = tcost.cost_volume_plain(l, r, D, 0.9, gl, gr, dtype)
    assert torch.equal(tcost.cost_volume(l, r, D, 0.9, gl, gr, dtype=dtype), plain)
    g = tcost.strip_geometry(H, W, D, 16, None)
    ours = tcost.build_strip_volumes(l, r, gl, gr, D, 0.9, 16, None, dtype)
    for a, b in zip(ours, tcost.strips_from_volume(plain, g)):
        assert a.shape == b.shape and torch.equal(a, b)
    torch.cuda.synchronize()


# --- a batch of cameras on the card ----------------------------------------


def _batched_inputs(device, B=3, H=40, W=64, D=16):
    """B stereo pairs of different scenes and true disparities, (B, H, W)."""
    ls, rs = [], []
    for b in range(B):
        canvas = np.random.default_rng(60 + b).random((H, W + 8)).astype(np.float32)
        ls.append(canvas[:, 8:])
        rs.append(canvas[:, 8 - (2 + b): 8 - (2 + b) + W])
    return (torch.from_numpy(np.stack(ls)).to(device), torch.from_numpy(np.stack(rs)).to(device),
            D)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batched_kernels_match_batched_twins(cuda_device, dtype):
    """K1, K4, pm_match and pm_match_strip on 3 cameras, each one launch,
    against their twins on the same batch (bit for bit) and, camera by
    camera, against their one-camera launches; the match on the path's
    seeds and on adversarial ones."""
    l, r, D = _batched_inputs(cuda_device)
    gl, gr = gradient_magnitude(l), gradient_magnitude(r)
    p = tpm.PatchMatchParams(max_disp=D, chunks=4, chunks_y=3, iters=2)
    cuda.reset_launches()
    C = tcost.cost_volume(l, r, D, 0.9, gl, gr, dtype=dtype)
    vr, vc = tcost.build_strip_volumes(l, r, gl, gr, D, 0.9, p.chunks, p.chunks_y, dtype)
    assert cuda.LAUNCHES["cost_volume"] == cuda.LAUNCHES["build_volumes"] == 1
    assert torch.equal(C, tcost.cost_volume_plain(l, r, D, 0.9, gl, gr, dtype))
    for got, want in zip((vr, vc), tcost.build_strip_volumes_plain(l, r, gl, gr, D, 0.9, p.chunks,
                                                                   p.chunks_y, dtype)):
        assert got.shape[0] == 3 and torch.equal(got, want)
    noise = tpm.unit_noise(l.shape[-2:], p.noise_seed, device=cuda_device)
    adversarial = [_adversarial_seed(C[b], seed=5 + b) for b in range(3)]
    seeds = {"path": tpm.sparse_wta_seed(C, p),
             "adversarial": torch.stack([s for s, _ in adversarial])}
    C_row = tcost.volume_from_row_strips(vr)
    for tag, seed in seeds.items():
        cuda.reset_launches()
        got = tpm._match_one_side(C, seed, noise, p)
        got_s = tpm._match_one_side_strips(vr, vc, seed, noise, p)
        assert cuda.LAUNCHES["pm_match"] == cuda.LAUNCHES["pm_match_strip"] == 1, tag
        want = tpm._match_plain(C, C, seed, noise, p)
        assert torch.equal(got, want) and torch.equal(got_s, want), tag
        assert torch.equal(tpm._match_plain(C_row, C, seed, noise, p), want)
        for b in range(3):
            assert torch.equal(got[b], tpm._match_one_side(C[b], seed[b], noise, p)), (tag, b)
            assert torch.equal(got_s[b], tpm._match_one_side_strips(vr[b], vc[b], seed[b], noise,
                                                                     p)), (tag, b)
        assert 0 < (got > 0).float().mean() < 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("strips", [False, True])
def test_batched_perception_step_on_the_card(cuda_device, strips):
    """perception_step on 3 cameras of different scenes: each stereo kernel
    of its path launches once a call and the Sea-thru LM kernels once a
    step, each camera's disparity, depth and enhanced image equal its
    one-camera step's bit for bit, no host sync, and the CPU agrees."""
    from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
    from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step

    H, W = 64, 96
    ls, rs = [], []
    for b in range(3):
        canvas = np.random.default_rng(70 + b).random((H, W + 16)).astype(np.float32)
        ls.append(np.repeat(canvas[:, 16:, None], 3, 2))
        rs.append(np.repeat(canvas[:, 16 - 6 - 2 * b: 16 - 6 - 2 * b + W, None], 3, 2))
    left = torch.from_numpy(np.stack(ls)).to(cuda_device)
    right = torch.from_numpy(np.stack(rs)).to(cuda_device)
    cam = PinholeCamera.create(100.0, 100.0, W / 2, H / 2, H, W)
    rig = StereoCamera.create(cam, cam, 0.1)
    config = PerceptionConfig(max_disp=32, internal_scale=2, chunks=4, use_strip_volumes=strips)
    perception_step(left, right, rig, config, device=cuda_device)  # puts the constants there
    torch.cuda.synchronize()
    cuda.reset_launches()
    out = perception_step(left, right, rig, config, device=cuda_device)
    want = {"build_volumes": 1, "pm_match_strip": 1} if strips else {"cost_volume": 1,
                                                                     "pm_match": 1}
    # The enhancement's Sea-thru fits: one launch each.
    want.update(sea_thru_fit=2)
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == want
    assert out.disparity.shape == (3, H, W) and out.enhanced_left.shape == (3, H, W, 3)
    for b in range(3):
        one = perception_step(left[b], right[b], rig, config, device=cuda_device)
        assert torch.equal(out.disparity[b], one.disparity)
        assert torch.equal(out.depth[b], one.depth)
        assert torch.equal(out.enhanced_left[b], one.enhanced_left)
    cpu = perception_step(left.cpu(), right.cpu(), rig, config, device="cpu")
    assert ((out.disparity.cpu() - cpu.disparity).abs() <= 1e-3).float().mean() >= 0.99
    assert sync_sites(lambda: perception_step(left, right, rig, config, device=cuda_device)) == []


@pytest.mark.gpu
def test_enhance_sequence_keeps_its_guess_on_the_card(cuda_device):
    """EnhanceSequence's frames make no host sync: the carried beta_D guess
    is chosen on the card; one camera and a batch of two."""
    from ocean_perception_tpu_torch.imaging.enhance import EnhanceSequence

    rng = np.random.default_rng(46)
    image = torch.from_numpy(rng.uniform(0.05, 0.9, (2, 48, 64, 3)).astype(np.float32))
    z = torch.from_numpy(rng.uniform(1.0, 4.0, (2, 48, 64)).astype(np.float32))
    for frame, ranges in ((image[0], z[0]), (image, z)):
        seq = EnhanceSequence(device=cuda_device)
        frame, ranges = frame.to(cuda_device), ranges.to(cuda_device)
        seq(frame, ranges)  # puts the constants there
        torch.cuda.synchronize()
        assert sync_sites(lambda: seq(frame, ranges)) == []
        assert seq.guess.device.type == "cuda" and seq.guess.shape == frame.shape[:-3] + (12,)


@pytest.mark.gpu
@pytest.mark.parametrize("engine,extra", [("patchmatch", dict(right_wta=False)),
                                          ("patchmatch", dict(right_wta=True, cost="zncc")),
                                          ("sgm", {}), ("wta", {})])
def test_batched_engines_on_the_card(cuda_device, engine, extra):
    """The other stereo configurations on 3 cameras: the kernels launch
    once a call (the two-sided match once a side), each camera's left map
    equals its one-camera call's on the card, and the CPU agrees."""
    from ocean_perception_tpu_torch.stereo import api as tapi

    l, r, D = _batched_inputs(cuda_device)
    kw = dict(engine=engine, max_disp=D,
              patchmatch_params=tpm.PatchMatchParams(max_disp=D, chunks=4, **extra))
    cuda.reset_launches()
    got = tapi.estimate_disparity(l, r, **kw)
    want = {"cost_volume": 1} if extra.get("cost") != "zncc" else {}
    if engine == "patchmatch":
        want["pm_match"] = 2 if not extra["right_wta"] else 1
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == want
    for b in range(3):
        assert torch.equal(got.left[b], tapi.estimate_disparity(l[b], r[b], **kw).left), b
    cpu = tapi.estimate_disparity(l.cpu(), r.cpu(), **kw)
    assert ((got.left.cpu() - cpu.left).abs() <= 1e-3).float().mean() >= 0.99


@pytest.mark.gpu
def test_batched_lk_track_matches_plain(cuda_device):
    """lk_track on 3 cameras in one launch a direction (unlike rings, each
    camera its own points, frames and dead slots: NaN points in 0, 60 and
    150 of its 200 slots), bit-identical to its twin on the batch and to
    one launch a camera."""
    rings, curs = [], []
    for b in range(3):
        r, c = _lk_levels(cuda_device, np.random.default_rng(60 + b))
        rings.append(r)
        curs.append(c)
    rings = [torch.stack(lv) for lv in zip(*rings)]
    curs = [torch.stack(lv) for lv in zip(*curs)]
    rng = np.random.default_rng(63)
    K = 200
    pts = torch.stack([_lk_points(cuda_device, rng, K) for _ in range(3)])
    for b, dead in enumerate((0, 60, 150)):
        pts[b, K - dead:] = float("nan")
    src = torch.from_numpy(rng.integers(0, 3, (3, K)).astype(np.int32)).to(cuda_device)
    zero = torch.zeros_like(src)
    kw = dict(wins=[21, 21, 15, 7], slack=4, pad=12, min_eig_threshold=1.5e-9, max_iters=30,
              eps=0.01)
    for tmpl, srch, st, ss, init in ((rings, curs, src, zero, pts + 1.25),
                                     (curs, rings, zero, src, pts)):
        cuda.reset_launches()
        got = tlk.lk_track(tmpl, srch, pts, init, st, ss, **kw)
        assert cuda.LAUNCHES["lk_track"] == 1
        want = tlk.lk_track_plain(tmpl, srch, pts, init, st, ss, **kw)
        assert torch.equal(got[0].nan_to_num(-1e30), want[0].nan_to_num(-1e30))
        assert torch.equal(got[1], want[1])
        for b in range(3):
            one = tlk.lk_track([t[b] for t in tmpl], [s[b] for s in srch], pts[b], init[b],
                               st[b], ss[b], **kw)
            assert torch.equal(got[0][b].nan_to_num(-1e30), one[0].nan_to_num(-1e30)), b
            assert torch.equal(got[1][b], one[1]), b
        assert got[1].float().mean() > 0.2


@pytest.mark.gpu
def test_batched_frontend_on_the_card(cuda_device):
    """full_frontend_step on 3 cameras of unlike scenes: lk_track launches
    twice a call, K1 and pm_match once; each camera's labels, slot ids and
    alive set equal its one-camera call's on the card, its pixels within
    1e-3 px; no host sync."""
    from ocean_perception_tpu_torch.models.perception import full_frontend_step

    fleet, setups = _fleet_setup(cuda_device)
    cuda.reset_launches()
    outs = _run_frontend(fleet)
    assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {"cost_volume": 3, "pm_match": 3,
                                                             "lk_track": 6}
    for b, setup in enumerate(setups):
        for got, one in zip(outs, _run_frontend(setup)):
            for name in ("labels", "alive"):
                assert torch.equal(getattr(got.mesher, name)[b], getattr(one.mesher, name)), b
            assert torch.equal(got.tracker_state.table.ids[b], one.tracker_state.table.ids), b
            assert torch.allclose(got.tracker_state.table.pixels[b],
                                  one.tracker_state.table.pixels, atol=1e-3), b
    assert int(outs[-1].mesher.alive.sum(-1).min()) >= 4
    out = outs[-1]
    left, right = fleet["frames"][-1]
    prev = out.tracker_state.ring[0][:, 0]

    def step():
        full_frontend_step(out.tracker_state, out.graph, prev, left, right, fleet["rig"],
                           fleet["config"], fleet["params"], device=cuda_device)

    step()
    torch.cuda.synchronize()
    assert sync_sites(step) == []
