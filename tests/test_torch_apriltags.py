"""The port's AprilTag module against the JAX package's.

Detection is host numpy in both, the same code, so on the rendered cases of
``tests/test_apriltags.py`` the detections are equal exactly: ids, hamming,
corners, centers, homographies and codes. ``estimate_camera_pose`` solves on
a torch device (the CPU here) through the port's ``optimize_odometry``; it
is held to JAX's within 1e-4 in ``T``, with equal ``success`` and
``n_inliers``, as ``tests/test_torch_vio.py`` holds the odometry.
"""

import functools

import numpy as np
import pytest
import torch

from test_apriltags import (  # sibling module: rendering + board helpers
    _board_camera,
    _board_world_tags,
    _place,
    _project_w,
    _render_projected,
    _rotm,
)

from ocean_perception_tpu.tracking import apriltags as ja
from ocean_perception_tpu.tracking.tag_family_data import FAMILY_TABLES as J_TABLES
from ocean_perception_tpu_torch.tracking import apriltags as ta
from ocean_perception_tpu_torch.tracking.tag_family_data import FAMILY_TABLES as T_TABLES

S, FX, FY, CX, CY, H, W = 0.19, 600.0, 600.0, 320.0, 240.0, 480, 640


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(name):
    """(image, family name, params) of a rendered case of test_apriltags.py."""
    fam = ja.TagFamily.create("tag36h11")
    if name == "upright":
        return _place(np.full((300, 400), 0.9, np.float32), ja.render_tag(fam, 42, 12, 3),
                      60, 100), "tag36h11", ja.TagDetectorParams()
    if name.startswith("rot"):
        img = _scene("upright")[0]
        return np.rot90(img, int(name[3:])).copy(), "tag36h11", ja.TagDetectorParams()
    if name in ("tag25h9", "tag16h5"):
        f = ja.TagFamily.create(name)
        return _place(np.full((260, 320), 0.85, np.float32), ja.render_tag(f, 3, 14, 3),
                      40, 80), name, ja.TagDetectorParams()
    if name == "three_tags":
        canvas = np.full((400, 640), 0.95, np.float32)
        _place(canvas, ja.render_tag(fam, 5, 10, 2), 40, 60)
        _place(canvas, ja.render_tag(fam, 77, 14, 2), 50, 320)
        _place(canvas, ja.render_tag(fam, 300, 8, 2), 240, 150)
        return canvas, "tag36h11", ja.TagDetectorParams()
    if name == "noise_and_gradient":
        canvas = _place(np.full((300, 400), 1.0, np.float32), ja.render_tag(fam, 11, 12, 3), 60, 100)
        ramp = np.linspace(1.0, 0.45, 400, dtype=np.float32)[None, :]
        rng = np.random.default_rng(7)
        img = np.clip(canvas * ramp + rng.normal(0, 0.02, canvas.shape), 0, 1)
        return img.astype(np.float32), "tag36h11", ja.TagDetectorParams()
    if name.startswith("bit_error"):
        tag = ja.render_tag(fam, 9, cell_px=12, white_border=3).copy()
        c0 = (3 + 1) * 12
        tag[c0: c0 + 12, c0: c0 + 12] = 1.0 - tag[c0 + 6, c0 + 6]
        img = _place(np.full((300, 400), 0.9, np.float32), tag, 60, 100)
        return img, "tag36h11", ja.TagDetectorParams(max_hamming=int(name[-1]))
    if name == "perspective":
        R = _rotm("x", np.deg2rad(25)) @ _rotm("y", np.deg2rad(-15)) @ _rotm("z", np.deg2rad(30)) \
            @ _rotm("x", np.pi)
        return _render_projected(fam, 7, 0.16, R, np.array([0.03, -0.02, 0.7]), FX, FY, CX, CY,
                                 H, W), "tag36h11", ja.TagDetectorParams()
    if name == "board":
        return _board_image(), "tag36h11", ja.TagDetectorParams()
    raise KeyError(name)


@functools.lru_cache(maxsize=1)
def _board_image():
    img = _board(_board_camera(_rotm("y", 0.10) @ _rotm("x", -0.07)))
    img.flags.writeable = False
    return img


def _board(cam_T_world):
    fam = ja.TagFamily.create("tag36h11")
    img = np.ones((H, W))
    for tid, wTt in _board_world_tags(S).items():
        cTt = cam_T_world @ wTt
        img = np.minimum(img, _render_projected(fam, tid, S, cTt[:3, :3], cTt[:3, 3],
                                                FX, FY, CX, CY, H, W, noise=0.0))
    rng = np.random.default_rng(3)
    return np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1)


def _params(p):
    return ta.TagDetectorParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})


def _same_detections(jd, td):
    assert [(d.tag_id, d.hamming, d.family, d.code) for d in td] == \
        [(d.tag_id, d.hamming, d.family, d.code) for d in jd]
    for a, b in zip(jd, td):
        for f in ("corners", "center", "H"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_family_tables_and_rendering_equal_jax():
    assert sorted(T_TABLES) == sorted(J_TABLES)
    for name, (bits, dim, hmin, codes) in J_TABLES.items():
        tb, td, th, tc = T_TABLES[name]
        assert (tb, td, th) == (bits, dim, hmin)
        np.testing.assert_array_equal(tc, codes)
        jf, tf = ja.TagFamily.create(name), ta.TagFamily.create(name)
        np.testing.assert_array_equal(tf.rot_codes, jf.rot_codes)
        np.testing.assert_array_equal(ta.render_tag(tf, 3, 5, 1), ja.render_tag(jf, 3, 5, 1))
        code = int(jf.codes[2]) ^ 0b101
        assert tf.decode(code, 2) == jf.decode(code, 2)


@pytest.mark.parametrize("name", ["upright", "rot1", "rot2", "rot3", "tag25h9", "tag16h5",
                                  "three_tags", "noise_and_gradient", "bit_error1",
                                  "bit_error0", "perspective", "board"])
def test_detections_equal_jax(name):
    img, family, params = _scene(name)
    jd = ja.detect_tags(img, family, params)
    td = ta.detect_tags(img, family, _params(params))
    _same_detections(jd, td)
    assert len(td) >= (0 if name == "bit_error0" else 1)


def test_tag_pose_and_corners_equal_jax():
    img, family, params = _scene("perspective")
    d = ja.detect_tags(img, family, params)[0]
    td = ta.detect_tags(img, family, _params(params))[0]
    np.testing.assert_array_equal(ta.tag_pose(td, 0.16, FX, FY, CX, CY),
                                  ja.tag_pose(d, 0.16, FX, FY, CX, CY))
    for tid, wTt in _board_world_tags(S).items():
        np.testing.assert_array_equal(ta.tag_corners_world(wTt, S), ja.tag_corners_world(wTt, S))


def _exact_detections(mod, cam_T_world, tags):
    """Detections with exactly projected corners (test_apriltags.py's
    test_estimate_camera_pose_exact_corners)."""
    dets = []
    for tid, wTt in tags.items():
        corners = _project_w(cam_T_world, mod.tag_corners_world(wTt, S), FX, FY, CX, CY)
        cTt = cam_T_world @ wTt
        K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
        Hm = K @ np.stack([cTt[:3, 0] * S / 2, cTt[:3, 1] * S / 2, cTt[:3, 3]], axis=1)
        dets.append(mod.TagDetection(tag_id=tid, hamming=0, family="tag36h11", corners=corners,
                                     center=corners.mean(0), H=Hm / Hm[2, 2], code=0))
    return dets


@pytest.fixture(scope="module")
def pose_cases():
    """Per case: the JAX and port detections and tag maps (JAX's solves
    compile once a corner count)."""
    tags = _board_world_tags(S)
    cam = _board_camera(_rotm("y", 0.12) @ _rotm("x", -0.08))
    two = {k: tags[k] for k in (0, 7)}
    img = _scene("board")[0]
    return {
        "exact_4_tags": (_exact_detections(ja, cam, tags), _exact_detections(ta, cam, tags), tags),
        "exact_2_tags": (_exact_detections(ja, cam, two), _exact_detections(ta, cam, two), two),
        "exact_1_tag": (_exact_detections(ja, cam, {23: tags[23]}),
                        _exact_detections(ta, cam, {23: tags[23]}), {23: tags[23]}),
        "rendered_board": (ja.detect_tags(img), ta.detect_tags(img), tags),
    }


@pytest.mark.parametrize("case", ["exact_4_tags", "exact_2_tags", "exact_1_tag",
                                  "rendered_board"])
def test_estimate_camera_pose_equals_jax(pose_cases, case):
    jd, td, tags = pose_cases[case]
    jw, jres = ja.estimate_camera_pose(jd, tags, S, FX, FY, CX, CY)
    tw, tres = ta.estimate_camera_pose(td, tags, S, FX, FY, CX, CY, device="cpu")
    assert bool(tres.success) == bool(jres.success)
    assert int(tres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_allclose(tres.T_10.numpy(), np.asarray(jres.T_10), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tres.error), float(jres.error), rtol=1e-3, atol=1e-5)
    assert tw.dtype == np.float64 and tres.T_10.device.type == "cpu"


def test_estimate_camera_pose_unknown_tags_and_device():
    assert ta.estimate_camera_pose([], {}, 0.2, 600, 600, 320, 240, device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ta.estimate_camera_pose([], {}, 0.2, 600, 600, 320, 240)
