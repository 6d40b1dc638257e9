"""The port's sharded forms on the CPU (``parallel/``), with the mesh's
devices played by repeated entries, ``["cpu"] * N``, as the JAX tests play
eight devices on one CPU.

- ``sharded_patchmatch`` equals the port's single-device engine with
  ``chunks_y = N`` bit for bit (every map, every row) at 64x96, D=32, in
  bf16 and float32, for N in {1, 2, 4}; that engine is held to JAX in
  test_torch_engines.py. A block whose work runs late changes nothing.
- ``pm_pass``'s plain twin over one block that is the whole frame equals
  the whole frame's pass pieces (``_propagate_plain``, the refresh, the
  mask), and the kernel wrapper takes CUDA tensors only. The adversarial
  block inputs the card's test uses (``chip_smoke.adversarial_seed`` and
  ``tie_volume``) make the twin's compares tie, its lookups clamp and round
  halves, and its mask both keep and zero pixels.
- ``sharded_enhance`` and ``sharded_perception_step`` equal the unsplit
  enhancement and ``perception_step`` with ``chunks_y = N`` bit for bit:
  disparity, depth and the enhanced image (a tighter bound than the
  enhance tolerance of test_torch_batched.py, which is what the card's
  smoke holds it to).
- the camera-split ``multi_camera_step`` and ``multi_camera_frontend_step``
  over a mesh of 2 entries equal their one-card calls, FleetStats included,
  bit for bit.

The comparisons with JAX's own sharded functions on its 8-device host
mesh compile for minutes on the CPU: they are marked slow, as
tests/test_parallel.py's are.
"""

import dataclasses
import sys
import time

import numpy as np
import pytest
import torch

from ocean_perception_tpu_torch.core.cameras import PinholeCamera, StereoCamera
from ocean_perception_tpu_torch.imaging.enhance import enhance_underwater
from ocean_perception_tpu_torch.models.perception import PerceptionConfig, perception_step
from ocean_perception_tpu_torch.ops import cuda
from ocean_perception_tpu_torch.ops.image import gaussian_blur
from ocean_perception_tpu_torch.parallel import (Mesh, camera_sharding, make_mesh,
                                                 multi_camera_frontend_step, multi_camera_step,
                                                 replicated, sharded_enhance,
                                                 sharded_perception_step, sharded_patchmatch,
                                                 strip_sharding)
from ocean_perception_tpu_torch.parallel import stereo_sharded
from ocean_perception_tpu_torch.parallel.dryrun import dryrun_multichip, tiny_mesher_params
from ocean_perception_tpu_torch.parallel.mesh import tree_map
from ocean_perception_tpu_torch.parallel.sharded_pipeline import create_fleet_frontend_state
from ocean_perception_tpu_torch.stereo import patchmatch as tpm
from ocean_perception_tpu_torch.stereo.cost import cost_volume
from ocean_perception_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    parallel workers, and torch's thread pool in each would oversubscribe
    the cores (these tests launch many small ops; under the suite's load
    the pools' spinning threads slow every worker's tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

H, W, D = 64, 96, 32
# init_dilate_factor 3: a seed reach of 9 rows, so 4 blocks of 16 rows
# clear the thin-strip bound (12).
PM = tpm.PatchMatchParams(max_disp=D, chunks=4, iters=2, right_wta=True, init_dilate_factor=3)


def _mesh(n, axis="strip"):
    return make_mesh(axis_names=(axis,), devices=["cpu"] * n)


@pytest.fixture(scope="module")
def pair():
    """A blurred random canvas, right(y, x - 6) == left(y, x)."""
    rng = np.random.default_rng(7)
    canvas = gaussian_blur(torch.from_numpy(rng.random((H, W + 48)).astype(np.float32)), 1.1)
    return canvas[:, 16:16 + W].contiguous(), canvas[:, 22:22 + W].contiguous()


def _rgb(H_, W_, seed=0, n=None):
    """The dry run's tinted scene (4 px disparity), each camera a little brighter."""
    rng = np.random.default_rng(seed)
    canvas = rng.random((H_, W_ + 32)).astype(np.float32)
    left = canvas[:, 16:16 + W_]
    right = np.roll(canvas, 4, axis=1)[:, 16:16 + W_]
    tint = np.array([0.35, 0.75, 0.9], np.float32)
    lf = np.clip(left[..., None] * tint + 0.05, 0, 1)
    rf = np.clip(right[..., None] * tint + 0.05, 0, 1)
    if n is None:
        return torch.from_numpy(lf), torch.from_numpy(rf)
    return (torch.from_numpy(np.stack([np.clip(lf + i * 1e-3, 0, 1) for i in range(n)])),
            torch.from_numpy(np.stack([rf] * n)))


def _rig(H_, W_):
    cam = PinholeCamera.create(80.0, 80.0, W_ / 2, H_ / 2, H_, W_)
    return StereoCamera.create(cam, cam, 0.12)


def _equal(a, b):
    return {f: torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_sharded_patchmatch_equals_the_chunks_y_engine(pair, n, bf16):
    p = dataclasses.replace(PM, volume_bf16=bf16)
    cuda.reset_launches()
    ours = sharded_patchmatch(*pair, _mesh(n), p)
    assert not any(cuda.LAUNCHES.values())  # CPU blocks run the twins
    ref = tpm.patchmatch_disparity(*pair, dataclasses.replace(p, chunks_y=n))
    assert all(_equal(ours, ref).values()), _equal(ours, ref)
    assert (ours.left > 0).float().mean() > 0.5


def test_a_late_block_does_not_change_the_result(pair, monkeypatch):
    """Block 1's passes run late on its worker thread; its neighbours'
    column passes must wait for its rows (events), not read stale ones."""
    ref = sharded_patchmatch(*pair, _mesh(4), PM)
    plain = stereo_sharded.block_pass
    late = []

    def slow_block_pass(C, disp, cost, noise, direction, axis, fold, block, p, scale=0.0):
        if block.row0 == block.chunk:
            late.append(axis)
            time.sleep(0.02)
        return plain(C, disp, cost, noise, direction, axis, fold, block, p, scale)

    monkeypatch.setattr(stereo_sharded, "block_pass", slow_block_pass)
    ours = sharded_patchmatch(*pair, _mesh(4), PM)
    assert len(late) == 4 * PM.iters
    assert all(_equal(ours, ref).values())


def test_more_blocks_than_cores_under_a_short_switch_interval():
    """12 blocks (more worker threads than this machine's cores) with the
    interpreter switching threads every microsecond: still the engine's
    result, so no exchange reads rows a neighbour has not posted."""
    rng = np.random.default_rng(11)
    canvas = gaussian_blur(torch.from_numpy(rng.random((192, W + 48)).astype(np.float32)), 1.1)
    left, right = canvas[:, 16:16 + W].contiguous(), canvas[:, 22:22 + W].contiguous()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ours = sharded_patchmatch(left, right, _mesh(12), PM)
    finally:
        sys.setswitchinterval(interval)
    ref = tpm.patchmatch_disparity(left, right, dataclasses.replace(PM, chunks_y=12))
    assert all(_equal(ours, ref).values())


def _fronts(C, p, seed=3):
    rng = np.random.default_rng(seed)
    disp = torch.from_numpy(rng.uniform(0, C.shape[2], C.shape[:2]).astype(np.float32))
    cost = tpm._full_cost_map(C, disp.to(C.device), p.patch_radius)
    return disp.to(C.device), cost


def _pass_inputs(C, p, inputs):
    """(volume, disparity and cost fronts, noise) of a frame: the path's
    volume with random fronts ("path"), with chip_smoke.adversarial_seed's
    fronts and noise ("adversarial seed"), or a chip_smoke.tie_volume of the
    volume's shape with those ("tie volume"). Each front cost is the
    volume's at its disparity, as after any pass."""
    import chip_smoke as cs

    if inputs == "path":
        return (C, *_fronts(C, p), tpm.unit_noise(C.shape[:2], p.noise_seed, C.device))
    if inputs == "tie volume":
        C = cs.tie_volume(tuple(C.shape), C.dtype, C.device)
    disp, noise = cs.adversarial_seed(tuple(C.shape[:2]), C.shape[2], C.device)
    return C, disp, tpm._full_cost_map(C, disp, p.patch_radius), noise


def _every_block_pass(Hf, n):
    """(block, direction, axis, fold) of every pass kind of every block of a
    frame of Hf rows in n blocks, the block's fronts and volume the frame's."""
    chunk = Hf // n
    return [(tpm.BlockRows(i * chunk, chunk, Hf, 0, 0), direction, axis, fold)
            for i in range(n) for direction, axis in tpm.PASSES for fold in (False, True)]


@pytest.mark.parametrize("direction,axis", tpm.PASSES, ids=["R+", "C+", "R-", "C-"])
def test_block_pass_twin_of_one_block_is_the_frame_pass(pair, direction, axis):
    p = dataclasses.replace(PM, chunks_y=1)
    C = cost_volume(*pair, D, dtype=torch.bfloat16)
    disp, cost = _fronts(C, p)
    noise = tpm.unit_noise((H, W), p.noise_seed)
    whole = tpm.BlockRows(0, H, H, 0, 0)
    for fold in (False, True):
        ours = tpm._block_pass_plain(C, disp, cost, noise, direction, axis, fold, whole, p, 8.0)
        d, c = disp, cost
        if fold and axis == 1:
            d, c = tpm._refresh_plain(C, d, noise, 8.0, p.patch_radius)
        ref = tpm._propagate_plain(C, d, c, direction, axis, p)
        if fold and axis == 0:
            ref = (tpm._mask_with_cost(C, *ref, p), None)
        assert torch.equal(ours[0], ref[0]) and (ours[1] is None) == (ref[1] is None)
        assert ours[1] is None or torch.equal(ours[1], ref[1])


class _TwinEvents(torch.overrides.TorchFunctionMode):
    """Counts, over the plain passes run under it, the cost compares that
    meet equal costs and the lookups that clamp or round a half."""

    def __init__(self, D_):
        super().__init__()
        self.D = D_
        self.ties = self.clamped = self.halves = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.lt, torch.Tensor.__lt__) and isinstance(args[1], torch.Tensor):
            self.ties += int((args[0] == args[1]).sum())
        if func is torch.round:
            d = args[0]
            self.clamped += int(((d < 0) | (d > self.D - 1)).sum())
            self.halves += int((d - d.floor() == 0.5).sum())
        return func(*args, **kwargs)


@pytest.mark.parametrize("inputs", ["adversarial seed", "tie volume"])
def test_adversarial_block_inputs_tie_clamp_and_fire_the_mask(pair, inputs):
    """The card's test holds pm_pass to its twin on these inputs: through
    the twin their cost compares meet equal costs, their lookups clamp and
    round halves, and the last C-'s mask keeps some pixels and zeroes
    others."""
    p = dataclasses.replace(PM, volume_bf16=True)
    C, disp, cost, noise = _pass_inputs(cost_volume(*pair, D, dtype=torch.bfloat16), p, inputs)
    events, kept, zeroed = _TwinEvents(D), 0, 0
    with events:
        for block, direction, axis, fold in _every_block_pass(H, 2):
            rows = slice(block.row0, block.row0 + block.chunk)
            args = (C, disp, cost, noise[rows], direction, axis, fold, block, p, 8.0)
            out = tpm._block_pass_plain(*args)
            if axis == 0 and fold:
                unmasked = tpm._block_pass_plain(*args[:6], False, *args[7:])[0]
                kept += int((out[0] > 0).sum())
                zeroed += int(((out[0] == 0) & (unmasked > 0)).sum())
    assert events.ties > 0 and events.clamped > 0 and events.halves > 0, vars(events)
    assert kept > 0 and zeroed > 0, (kept, zeroed)


def test_unit_noise_rows_are_the_whole_images_rows():
    whole = tpm.unit_noise((H, W), 123)
    assert torch.equal(tpm.unit_noise((H, W), 123, None, 16, 24), whole[16:40])


def test_pm_pass_wrapper_refuses_cpu_tensors():
    C = torch.zeros(16, W, 8, dtype=torch.bfloat16)
    x = torch.zeros(16, W)
    with pytest.raises(ValueError, match="CUDA"):
        cuda.pm_pass(C, x, x.bfloat16(), x, 64, 16, 16, 16, 16, 4, 5, 1, 1, True, True, 8.0, 0.8)


def test_thin_strips_and_uneven_heights_raise(pair):
    with pytest.raises(ValueError, match="too thin for halo exchange"):
        sharded_patchmatch(*pair, _mesh(8), PM)  # 8 rows a block, 12 needed
    with pytest.raises(ValueError, match="must divide evenly over 3 devices"):
        sharded_patchmatch(*pair, _mesh(3), PM)
    with pytest.raises(ValueError, match="right_wta"):
        sharded_patchmatch(*pair, _mesh(2), dataclasses.replace(PM, right_wta=False))
    l, r = _rgb(96, 64)
    cfg = PerceptionConfig(max_disp=16, internal_scale=2)
    with pytest.raises(ValueError, match="internal height 48 must divide over 5 devices"):
        sharded_perception_step(l, r, _rig(96, 64), cfg, _mesh(5))
    with pytest.raises(ValueError, match="patchmatch engine"):
        sharded_perception_step(l, r, _rig(96, 64), dataclasses.replace(cfg, engine="wta"),
                                _mesh(2))
    with pytest.raises(ValueError, match="power of two"):
        sharded_perception_step(l, r, _rig(96, 64), dataclasses.replace(cfg, internal_scale=3),
                                _mesh(2))


def test_entry_points_need_a_card_unless_given_cpu_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="repeat an entry"):
        make_mesh(4, devices=["cpu"] * 2)


def test_mesh_shardings_split_and_join():
    mesh = make_mesh(axis_names=("cam", "strip"), shape=(2, 2), devices=["cpu"] * 4)
    assert mesh.shape == {"cam": 2, "strip": 2} and isinstance(mesh, Mesh)
    x = torch.arange(48.0).reshape(4, 12)
    for sharding, piece in ((camera_sharding(mesh), x[2:]), (strip_sharding(mesh), x[2:]),
                            (strip_sharding(mesh, batch_axis="cam"), x[2:, 6:]),
                            (replicated(mesh), x)):
        pieces = sharding.split(x)
        assert pieces.shape == (2, 2) and torch.equal(pieces[1, 1], piece)
        assert torch.equal(sharding.join(pieces), x)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_enhance_equals_the_whole_images(n):
    rng = np.random.default_rng(3)
    image = torch.from_numpy(np.clip(rng.random((H, W, 3)) * [0.35, 0.75, 0.9] + 0.05, 0, 1)
                             .astype(np.float32))
    depth = torch.from_numpy((1.5 + 3.0 * np.arange(H)[:, None] / H
                              + 0.3 * rng.random((H, W))).astype(np.float32))
    depth[:5, :7] = 0  # empty ranges take the largest one
    ours, info = sharded_enhance(image, depth, _mesh(n))
    ref, ref_info = enhance_underwater(image, depth)
    assert torch.equal(ours, ref)
    assert all(_equal(info, ref_info).values())


@pytest.mark.parametrize("scale,n,height", [(1, 2, 64), (2, 2, 128)], ids=["full-res", "half-res"])
def test_sharded_perception_step_equals_the_chunks_y_step(scale, n, height):
    l, r = _rgb(height, W)
    cfg = PerceptionConfig(engine="patchmatch", max_disp=D, internal_scale=scale)
    ours = sharded_perception_step(l, r, _rig(height, W), cfg, _mesh(n))
    ref = perception_step(l, r, _rig(height, W), dataclasses.replace(cfg, chunks_y=n),
                          device="cpu")
    assert all(_equal(ours, ref).values()), _equal(ours, ref)
    assert (ours.disparity > 0).any()


def test_multi_camera_step_over_a_mesh_equals_the_one_card_call():
    bl, br = _rgb(H, W, seed=3, n=4)
    cfg = PerceptionConfig(engine="patchmatch", max_disp=D, internal_scale=2)
    out, stats = multi_camera_step(bl, br, _rig(H, W), cfg, mesh=_mesh(2, "cam"))
    ref, ref_stats = multi_camera_step(bl, br, _rig(H, W), cfg, device="cpu")
    assert all(_equal(out, ref).values()) and all(_equal(stats, ref_stats).values())
    with pytest.raises(ValueError, match="do not split evenly"):
        multi_camera_step(bl[:3], br[:3], _rig(H, W), cfg, mesh=_mesh(2, "cam"))


def test_multi_camera_frontend_step_over_a_mesh_equals_the_one_card_call():
    bl, br = _rgb(H, W, seed=5, n=4)
    rig = _rig(H, W)
    cfg = PerceptionConfig(engine="wta", max_disp=16, internal_scale=1)
    mp = tiny_mesher_params()
    runs = []
    for mesh in (_mesh(2, "cam"), None):
        state, graph = create_fleet_frontend_state(4, mp, device="cpu")
        grays = bl.mean(dim=-1)
        for k in range(2):
            out, grays = multi_camera_frontend_step(state, graph, grays, bl.roll(-k, 2),
                                                    br.roll(-k, 2), rig, cfg, mp, device="cpu",
                                                    mesh=mesh)
            state, graph = out.tracker_state, out.graph
        runs.append((out, grays))
    leaves = [[], []]
    for run, acc in zip(runs, leaves):
        tree_map(acc.append, run)
    assert len(leaves[0]) == len(leaves[1]) > 20
    assert all(torch.equal(a, b) for a, b in zip(*leaves))
    assert runs[0][0].mesher.alive.any()


def test_dryrun_multichip_runs_on_cpu_devices(capsys):
    dryrun_multichip(["cpu"] * 2)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "dryrun_multichip ok", "dryrun full-frontend ok", "dryrun strip-sharded enhance ok",
        "dryrun strip-sharded patchmatch ok"]
    assert "median disp 4.0" in lines[-1]


def test_profiling_names_regions_and_times_them(tmp_path):
    """annotate names a region in the trace; under a StageClock the region
    is also a span of the clock, from the clock's first mark."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.StageClock("cpu") as clock:
            t0 = time.perf_counter()
            with profiling.annotate("sharded block 0"):
                torch.ones(4) * 2
            took_ms = (time.perf_counter() - t0) * 1e3
    assert any(e.key == "sharded block 0" for e in prof.key_averages())
    assert (tmp_path / "trace.json").stat().st_size > 0
    (name, start, end), = clock.read()
    assert name == "sharded block 0" and start == 0.0 and 0.0 < end <= took_ms


@pytest.mark.gpu
@pytest.mark.parametrize("W_", [96, 100], ids=["W96", "W100"])
@pytest.mark.parametrize("D_", [24, 64, 128], ids=["D24", "D64", "D128"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_pm_pass_kernel_equals_its_twin_on_the_card(bf16, D_, W_):
    """Every pass kind of every block of a 2- and a 4-block frame, on the
    card against its twin there, bit for bit (chip_smoke.same_bits), on the
    path's volume with random fronts, on the adversarial seed and on the tie
    volume; D of 24, 64 and 128 (lines of 1, 2 and 4 words a lane), W a
    multiple of 32 and not; then the sharded match against pm_match with
    chunks_y = N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels cannot run on the CPU")
    from chip_smoke import same_bits

    dev = torch.device("cuda", 0)
    p = dataclasses.replace(PM, volume_bf16=bf16, max_disp=D_)
    rng = np.random.default_rng(7)
    canvas = gaussian_blur(torch.from_numpy(rng.random((H, W_ + 48)).astype(np.float32)), 1.1)
    l, r = (canvas[:, a:a + W_].contiguous().to(dev) for a in (16, 22))
    C = cost_volume(l, r, D_, dtype=torch.bfloat16 if bf16 else torch.float32)
    for inputs in ("path", "adversarial seed", "tie volume"):
        vol, disp, cost, noise = _pass_inputs(C, p, inputs)
        for n in (2, 4):
            for block, direction, axis, fold in _every_block_pass(H, n):
                rows = slice(block.row0, block.row0 + block.chunk)
                args = (vol, disp, cost, noise[rows], direction, axis, fold, block, p, 4.0)
                ours = tpm.block_pass(*args)
                ref = tpm._block_pass_plain(*args)
                tag = (inputs, n, block.row0, direction, axis, fold)
                assert same_bits(ours[0], ref[0]), tag
                assert (ours[1] is None) == (ref[1] is None), tag
                assert ours[1] is None or same_bits(ours[1], ref[1]), tag
    for n in (2, 4):
        cuda.reset_launches()
        ours = sharded_patchmatch(l, r, make_mesh(axis_names=("strip",), devices=[dev] * n), p)
        assert cuda.LAUNCHES["pm_pass"] == 4 * p.iters * n and cuda.LAUNCHES["pm_match"] == 0
        ref = tpm.patchmatch_disparity(l, r, dataclasses.replace(p, chunks_y=n))
        assert all(_equal(ours, ref).values())


@pytest.mark.slow
def test_sharded_patchmatch_matches_jax_sharded_patchmatch():
    """Against JAX's own sharded_patchmatch on its 8-device host mesh, at the
    geometry of tests/test_parallel.py, away from the outermost rows, where
    JAX's edge splice may differ from its own single-device engine
    (test_parallel.py's bound): the right WTA map equal, the refined left
    map within 1e-6 px (the float32 parabola arithmetic,
    test_torch_engines.py's bound) with the same valid pixels; and each
    equal on >= 99.9% of all pixels before refinement."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from ocean_perception_tpu.parallel.stereo_sharded import sharded_patchmatch as jsharded
    from ocean_perception_tpu.stereo.patchmatch import PatchMatchParams as JParams

    Hs, Ws, Ds, n = 160, 128, 24, 8
    rng = np.random.default_rng(7)
    canvas = gaussian_blur(torch.from_numpy(rng.random((Hs, Ws + 48)).astype(np.float32)), 1.1)
    left, right = canvas[:, 16:16 + Ws].contiguous(), canvas[:, 22:22 + Ws].contiguous()
    kw = dict(max_disp=Ds, chunks=4, iters=2, right_wta=True, init_dilate_factor=3)
    with jax.enable_x64(False):
        ref = jsharded(jnp.asarray(left.numpy()), jnp.asarray(right.numpy()),
                       JMesh(np.array(jax.devices()[:n]), ("strip",)), JParams(**kw))
        ref = {f: np.asarray(getattr(ref, f)) for f in ("left", "right")}
    ours = sharded_patchmatch(left, right, _mesh(n), tpm.PatchMatchParams(**kw))
    a, b = ours.left.numpy(), ref["left"]
    np.testing.assert_allclose(a[1:-1], b[1:-1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a[1:-1] > 0, b[1:-1] > 0)
    assert (np.round(a) == np.round(b)).mean() > 0.999
    np.testing.assert_array_equal(ours.right.numpy()[1:-1], ref["right"][1:-1])
    assert (ours.right.numpy() == ref["right"]).mean() > 0.999


@pytest.mark.slow
def test_sharded_perception_step_matches_jax_sharded_perception_step():
    """Against JAX's sharded_perception_step on its 8-device host mesh at
    tests/test_parallel.py's geometry (192x96, 24 rows a block): disparity
    and depth as that test holds JAX's own (equal within 1e-5 away from the
    outermost rows), the enhanced image within its 5e-2."""
    import jax
    from jax.sharding import Mesh as JMesh

    from ocean_perception_tpu.models.perception import PerceptionConfig as JConfig
    from ocean_perception_tpu.parallel import sharded_perception_step as jstep
    from ocean_perception_tpu_torch import convert

    n, Hs = 8, 192
    l, r = _rgb(Hs, W)
    jcfg = JConfig(engine="patchmatch", max_disp=16, internal_scale=1)
    with jax.enable_x64(False):
        from __graft_entry__ import _rig as jrig

        ref = jstep(l.numpy(), r.numpy(), jrig(Hs, W), jcfg,
                    JMesh(np.array(jax.devices()[:n]), ("strip",)))
        ref = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    ours = sharded_perception_step(l, r, _rig(Hs, W), convert.perception_config_from_jax(jcfg),
                                   _mesh(n))
    for f, tol in (("disparity", 1e-5), ("depth", 1e-5), ("enhanced_left", 5e-2)):
        np.testing.assert_allclose(getattr(ours, f).numpy()[1:-1], ref[f][1:-1], atol=tol)
