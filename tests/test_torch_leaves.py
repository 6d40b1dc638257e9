"""The port's leaf modules against the JAX package's, on seeded inputs:

- ``tracking/anms.py``: the same indices;
- ``planning/rrt.py``: the same plan (or none) on the same seed;
- ``tracking/lines.py`` (torch functions against JAX's ``jnp`` ones):
  within 1e-12 in float64 and 1e-5 relative in float32;
- ``tracking/visualization.py``: the same images;
- ``utils/exr.py``: the same arrays, equal to what was written, from files
  written here (no compression, ZIPS, ZIP; HALF, FLOAT and UINT channels);
- ``utils/paths.py``: the same paths.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocean_perception_tpu.planning import RrtParams as JRrtParams
from ocean_perception_tpu.planning import RrtStar as JRrtStar
from ocean_perception_tpu.tracking import anms as janms
from ocean_perception_tpu.tracking import lines as jlines
from ocean_perception_tpu.tracking import visualization as jvis
from ocean_perception_tpu.utils import exr as jexr
from ocean_perception_tpu.utils import paths as jpaths
from ocean_perception_tpu_torch.planning import RrtParams, RrtStar
from ocean_perception_tpu_torch.tracking import anms as tanms
from ocean_perception_tpu_torch.tracking import lines as tlines
from ocean_perception_tpu_torch.tracking import visualization as tvis
from ocean_perception_tpu_torch.utils import exr as texr
from ocean_perception_tpu_torch.utils import paths as tpaths


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed,n,num_ret", [(0, 400, 50), (1, 1000, 120), (2, 30, 40),
                                            (3, 300, 1)])
def test_anms_equals_jax(seed, n, num_ret):
    pts = np.random.default_rng(seed).random((n, 2)) * [640, 480]
    got = tanms.ssc_anms(pts, num_ret, rows=480, cols=640)
    np.testing.assert_array_equal(got, janms.ssc_anms(pts, num_ret, rows=480, cols=640))
    assert len(got) <= max(num_ret, 1)


def _wall(gap):
    def is_free(a, b):
        for t in np.linspace(0, 1, 20):
            p = np.asarray(a) + t * (np.asarray(b) - np.asarray(a))
            if 4.8 <= p[0] <= 5.2 and not (gap and 4.0 <= p[1] <= 6.0):
                return False
        return True
    return is_free


@pytest.mark.parametrize("gap,iters,seed", [(True, 500, 1), (False, 200, 2)])
def test_rrt_equals_jax(gap, iters, seed):
    plans = [cls(np.zeros(2), np.full(2, 10.0), _wall(gap), prm(max_iters=iters, step_size=0.8),
                 seed=seed).plan(np.array([1.0, 1.0]), np.array([9.0, 9.0]))
             for cls, prm in ((JRrtStar, JRrtParams), (RrtStar, RrtParams))]
    if gap:
        np.testing.assert_array_equal(plans[1], plans[0])
        np.testing.assert_array_equal(plans[1][[0, -1]], [[1, 1], [9, 9]])
    else:
        assert plans[0] is None and plans[1] is None


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_lines_equal_jax(dtype, tol):
    rng = np.random.default_rng(7)
    for _ in range(3):
        a0, a1, b0, b1, p = (rng.random(2).astype(dtype) * 100 for _ in range(5))
        J = {"a": jlines.LineSegment2d(jnp.asarray(a0), jnp.asarray(a1)),
             "b": jlines.LineSegment2d(jnp.asarray(b0), jnp.asarray(b1))}
        T = {"a": tlines.LineSegment2d(torch.from_numpy(a0), torch.from_numpy(a1)),
             "b": tlines.LineSegment2d(torch.from_numpy(b0), torch.from_numpy(b1))}
        d0, d1 = (dtype(x) for x in rng.random(2) * 20 + 1)
        pairs = [
            (jlines.line_equation(J["a"]), tlines.line_equation(T["a"])),
            (jlines.point_line_distance(jlines.line_equation(J["a"]), jnp.asarray(p)),
             tlines.point_line_distance(tlines.line_equation(T["a"]), torch.from_numpy(p))),
            (jlines.segment_overlap_y(J["a"], J["b"]), tlines.segment_overlap_y(T["a"], T["b"])),
            (jnp.stack(jlines.extrapolate_to_rows(J["a"], b0[1], b1[1])),
             torch.stack(tlines.extrapolate_to_rows(T["a"], torch.tensor(b0[1]),
                                                    torch.tensor(b1[1])))),
            (jnp.stack(jlines.endpoint_disparities(J["a"], J["b"])),
             torch.stack(tlines.endpoint_disparities(T["a"], T["b"]))),
            (jnp.stack(jlines.backproject_line(J["a"], d0, d1, 300.0, 310.0, 320.0, 240.0, 0.12)),
             torch.stack(tlines.backproject_line(T["a"], d0, d1, 300.0, 310.0, 320.0, 240.0, 0.12))),
        ]
        for j, t in pairs:
            assert t.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)
    # A horizontal segment: extrapolation keeps its points (dy guarded).
    flat = tlines.LineSegment2d(torch.tensor([0.0, 5.0]), torch.tensor([4.0, 5.0]))
    jflat = jlines.LineSegment2d(jnp.asarray([0.0, 5.0]), jnp.asarray([4.0, 5.0]))
    np.testing.assert_array_equal(torch.stack(tlines.extrapolate_to_rows(flat, 1.0, 2.0)).numpy(),
                                  np.asarray(jnp.stack(jlines.extrapolate_to_rows(jflat, 1.0, 2.0))))


def test_visualization_equals_jax():
    rng = np.random.default_rng(3)
    img = rng.random((40, 60)).astype(np.float32)
    pts = rng.random((12, 2)) * [60, 40]
    valid = rng.random(12) > 0.3
    disp = rng.random(12) * 10 - 1
    for name, args in (("draw_features", (img, pts, valid)),
                       ("draw_features", (np.stack([img] * 3, -1), pts)),
                       ("draw_tracks", (img, pts, pts + 2.5, valid)),
                       ("draw_stereo_matches", (img, img[::-1], pts, disp, valid)),
                       ("colorize_disparity", (img * 20 - 2,)),
                       ("colorize_disparity", (img * 20, 16.0))):
        np.testing.assert_array_equal(getattr(tvis, name)(*args), getattr(jvis, name)(*args))


def _zip(raw: bytes) -> bytes:
    """The EXR zip block encoding that utils/exr.py's reader undoes."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) % 256
    return zlib.compress(d.astype(np.uint8).tobytes())


def _write_exr(path, channels, compression):
    """A single-part scanline EXR of ``channels`` ({name: (H, W) array of
    float16, float32 or uint32}) with compression 0 (NONE), 2 (ZIPS) or 3
    (ZIP); returns how many blocks it stored compressed."""
    names = sorted(channels)
    H, W = channels[names[0]].shape
    ptype = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i", ptype[channels[n].dtype])
                      + b"\0\0\0\0" + struct.pack("<ii", 1, 1) for n in names) + b"\0"

    def attr(name, typ, data):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(data)) + data

    head = struct.pack("<ii", 0x01312F76, 2) + attr("channels", "chlist", chlist) \
        + attr("compression", "compression", bytes([compression])) \
        + attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, W - 1, H - 1)) + b"\0"
    lines = {0: 1, 2: 1, 3: 16}[compression]
    blocks, packed = [], 0
    for y in range(0, H, lines):
        raw = b"".join(channels[n][yy].tobytes() for yy in range(y, min(y + lines, H))
                       for n in names)
        data = raw if compression == 0 else _zip(raw)
        if len(data) >= len(raw):  # the format keeps a block that does not shrink raw
            data = raw
        packed += data is not raw
        blocks.append(struct.pack("<ii", y, len(data)) + data)
    offsets, pos = [], len(head) + 8 * len(blocks)
    for blk in blocks:
        offsets.append(pos)
        pos += len(blk)
    with open(path, "wb") as f:
        f.write(head + struct.pack(f"<{len(offsets)}q", *offsets) + b"".join(blocks))
    return packed


@pytest.mark.parametrize("compression", [0, 2, 3])
def test_exr_equals_jax(tmp_path, compression):
    rng = np.random.default_rng(compression)
    H, W = 37, 23
    # Values on a coarse grid, so the zip blocks shrink and are stored packed.
    chans = {"Z": (rng.integers(0, 120, (H, W)) * 0.25).astype(np.float32),
             "B": (rng.integers(0, 8, (H, W)) / 8).astype(np.float16),
             "A": rng.integers(0, 16, (H, W)).astype(np.uint32)}
    for name, sub in (("one", {"Z": chans["Z"]}), ("three", chans)):
        path = str(tmp_path / f"{name}.exr")
        assert (_write_exr(path, sub, compression) > 0) == (compression > 0)
        got, ref = texr.read_exr(path), jexr.read_exr(path)
        np.testing.assert_array_equal(got, ref)
        want = np.stack([sub[n].astype(np.float32) for n in sorted(sub)], -1)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_paths_equal_jax(monkeypatch, tmp_path):
    for env in (None, str(tmp_path)):
        if env is None:
            monkeypatch.delenv(tpaths.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(tpaths.ENV_VAR, env)
        assert tpaths.ENV_VAR == jpaths.ENV_VAR
        assert tpaths.vehicle_dir() == jpaths.vehicle_dir()
        assert tpaths.config_path("nodes", "x.yaml") == jpaths.config_path("nodes", "x.yaml")
        assert tpaths.shared_config_path("Farmsim") == jpaths.shared_config_path("Farmsim")
        assert tpaths.join("a", "b") == jpaths.join("a", "b")
