"""The port's fiducial localizer node against the JAX package's, on the CPU:

- on one rendered board frame the published fix (pose and covariance)
  equals JAX's node's within 1e-4, with a non-identity ``body_T_cam``;
- the rate gate counts attempts: a frame inside ``min_period_sec`` is
  skipped, one past it is processed;
- ``from_config`` on the shipped YAMLs reads what JAX's reads;
- the node raises without a card unless it is given ``device="cpu"``, and
  its CLI comes up on the native bus;
- the loop closed into the port's state estimator node, as
  ``tests/test_fiducial_localizer.py`` closes JAX's, at the shipped
  Farmsim deployment's size: biased IMU at rest drifts the filter, one
  sighting of the shipped 2-tag map snaps it to the truth.
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from test_apriltags import _board_world_tags, _pose_rt, _render_projected, _rotm

from ocean_perception_tpu.fabric import messages as jms
from ocean_perception_tpu.fabric import pubsub as jps
from ocean_perception_tpu.fabric.nodes import fiducial_localizer_node as jfl
from ocean_perception_tpu_torch.fabric import messages as tms
from ocean_perception_tpu_torch.fabric import native_bus
from ocean_perception_tpu_torch.fabric import pubsub as tps
from ocean_perception_tpu_torch.fabric.nodes import fiducial_localizer_node as tfl
from ocean_perception_tpu_torch.tracking.apriltags import TagFamily

ROOT = os.path.join(os.path.dirname(__file__), "..")
NODE_YAML = os.path.join(ROOT, "config", "nodes", "FiducialLocalizerNode.yaml")
SHARED_YAML = os.path.join(ROOT, "config", "shared", "Farmsim.yaml")
VIO_YAML = os.path.join(ROOT, "config", "nodes", "StateEstimatorNode.yaml")
FX = FY = 600.0
CX, CY, H, W = 320.0, 240.0, 480, 640
TAG_S = 0.19


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def render_board(tags, cam_T_world, fx, fy, cx, cy, h, w):
    fam = TagFamily.create("tag36h11")
    img = np.ones((h, w))
    for tid, wTt in tags.items():
        cTt = cam_T_world @ wTt
        img = np.minimum(img, _render_projected(fam, tid, TAG_S, cTt[:3, :3], cTt[:3, 3],
                                                fx, fy, cx, cy, h, w, noise=0.0))
    return img.astype(np.float32)


def stereo(ms, ts, img):
    return ms.StereoImageMessage(timestamp=ts, left=ms.ImageMessage.from_array(ts, img),
                                 right=ms.ImageMessage.from_array(ts, img))


@pytest.fixture(scope="module")
def board():
    """The 4-tag board of test_fiducial_localizer.py, a camera yawed 90 deg
    on the body, and one rendered frame."""
    tags = _board_world_tags(TAG_S)
    R = _rotm("y", 0.10) @ _rotm("x", -0.07) @ np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    cam_T_world = _pose_rt(R, -R @ np.array([0.28, 0.22, 1.4]))
    body_T_cam = _pose_rt(_rotm("z", np.pi / 2), [0.1, 0.0, -0.05])
    img = render_board(tags, cam_T_world, FX, FY, CX, CY, H, W)
    truth = np.linalg.inv(cam_T_world) @ np.linalg.inv(body_T_cam)
    return dict(tags=tags, body_T_cam=body_T_cam, img=img, truth=truth)


def test_node_fix_equals_jax_and_gates_attempts(board):
    fixes = {}
    nodes = {}
    for name, ms, ps, mod, kw in (("jax", jms, jps, jfl, {}), ("port", tms, tps, tfl,
                                                                 {"device": "cpu"})):
        bus = ps.InProcessBus()
        fixes[name] = []
        bus.subscribe("vio/external_pose", lambda _c, m, out=fixes[name]: out.append(m))
        nodes[name] = mod.FiducialLocalizerNode(bus, FX, FY, CX, CY, board["tags"], TAG_S,
                                                body_T_cam=board["body_T_cam"], **kw)
        bus.publish("sensors/stereo", stereo(ms, 10_000_000, board["img"]))
        nodes[name].bus = bus
    j, t = fixes["jax"][0], fixes["port"][0]
    assert t.timestamp == j.timestamp and nodes["port"].num_fixes == 1
    np.testing.assert_allclose(t.pose, j.pose, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(t.covariance, j.covariance)
    np.testing.assert_allclose(t.pose[4:7], board["truth"][:3, 3], atol=5e-3)

    # Rate gate on attempts: an immediate second frame is skipped, one past
    # min_period is processed.
    bus = nodes["port"].bus
    bus.publish("sensors/stereo", stereo(tms, 10_000_001, board["img"]))
    assert nodes["port"].num_fixes == 1
    bus.publish("sensors/stereo", stereo(tms, 10_000_000 + int(0.6e9), board["img"]))
    assert nodes["port"].num_fixes == 2 and len(fixes["port"]) == 2


def test_from_config_equals_jax():
    j = jfl.from_config(jps.InProcessBus(), NODE_YAML, SHARED_YAML)
    t = tfl.from_config(tps.InProcessBus(), NODE_YAML, SHARED_YAML, device="cpu")
    assert sorted(t.tag_map) == sorted(j.tag_map) == [0, 1]
    for k in j.tag_map:
        np.testing.assert_array_equal(t.tag_map[k], j.tag_map[k])
    np.testing.assert_array_equal(t.cam_T_body, j.cam_T_body)
    np.testing.assert_array_equal(t.pose_sigma, j.pose_sigma)
    for f in ("intrinsics", "tag_size_m", "family", "min_period_ns", "min_tags", "max_error_px",
              "corner_sigma_px", "channel_output"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.device.type == "cpu"


def test_node_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.FiducialLocalizerNode(tps.InProcessBus(), FX, FY, CX, CY, {}, TAG_S)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfl.from_config(tps.InProcessBus(), NODE_YAML, SHARED_YAML)
    assert tfl.FiducialLocalizerNode(tps.InProcessBus(), FX, FY, CX, CY, {}, TAG_S,
                                     device="cpu").device.type == "cpu"


def test_main_comes_up_on_the_native_bus(monkeypatch):
    made = []

    def bus_class(native, lcm):
        cls = native_bus.bus_class(native, lcm)
        return lambda **kw: made.append(cls(**kw)) or made[-1]

    class Event(threading.Event):
        def wait(self, timeout=None):
            if timeout is None:  # main's wait for ctrl-c
                raise KeyboardInterrupt
            return super().wait(timeout)

    monkeypatch.setattr(tfl, "bus_class", bus_class)
    patched = type(threading)("threading")  # the node module's threading, its Event patched
    patched.__dict__.update(threading.__dict__, Event=Event)
    monkeypatch.setattr(tfl, "threading", patched)
    try:
        assert tfl.main(["--config", NODE_YAML, "--shared", SHARED_YAML, "--native-bus",
                         "--port", "7948", "--device", "cpu"]) == 0
        assert type(made[-1]) is native_bus.NativeUdpBus
    finally:
        for bus in made:
            bus.close()


def test_closed_loop_snaps_the_port_estimator():
    """The shipped deployment (FiducialLocalizerNode.yaml, Farmsim.yaml,
    StateEstimatorNode.yaml with keyposes held off and pose sigmas of 0.01)
    on the CPU: 2 s of IMU at rest biased by (0.15, -0.1, 0) m/s^2 drift
    the filter past 0.1 m; one sighting of the 2-tag map on a channel of
    its own snaps its position within 0.02 m of the truth."""
    from ocean_perception_tpu_torch.config.bindings import (load_rig,
                                                            load_state_estimator_params)
    from ocean_perception_tpu_torch.config.yaml_parser import YamlParser
    from ocean_perception_tpu_torch.fabric.nodes.state_estimator_node import StateEstimatorNode

    parser = YamlParser(node_path=VIO_YAML, shared_path=SHARED_YAML)
    rig = load_rig(parser)
    params = dataclasses.replace(load_state_estimator_params(parser),
                                 min_sec_btw_keyposes=1e6, max_sec_btw_keyposes=2e6)
    bus = tps.InProcessBus()
    est = StateEstimatorNode(bus, rig, params, device="cpu")
    bus.publish("vio/init_pose", tms.PoseStampedMessage(timestamp=0,
                                                        pose=np.array([1.0, 0, 0, 0, 0, 0, 0])))
    assert est._init.is_set()
    # The shipped node's settings, on a camera channel of its own so the
    # estimator's frontend never sees the (textureless) board frames.
    cfg = tfl.from_config(tps.InProcessBus(), NODE_YAML, SHARED_YAML, device="cpu")
    fid = tfl.FiducialLocalizerNode(
        bus, *cfg.intrinsics, cfg.tag_map, cfg.tag_size_m, body_T_cam=np.linalg.inv(cfg.cam_T_body),
        channel_input="fiducial/stereo", pose_sigma_t=0.01, pose_sigma_r=0.01, device="cpu")

    bias = np.array([0.15, -0.1, 0.0])
    last_t = 0
    for i in range(1, 201):
        last_t = int(i * 1e7)
        bus.publish("sensors/imu", tms.ImuMessage(last_t, np.zeros(3),
                                                  -np.asarray(params.n_gravity) + bias))
    drift = np.linalg.norm(est.est.filter_state().world_T_body[:3, 3])
    assert drift > 0.1, drift

    R = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]]) @ _rotm("y", 0.05)
    cam_T_world = _pose_rt(R, -R @ np.array([0.25, 0.02, 1.0]))
    cam = rig.left
    img = render_board(fid.tag_map, cam_T_world, cam.fx, cam.fy, cam.cx, cam.cy,
                       cam.height, cam.width)
    bus.publish("fiducial/stereo", stereo(tms, last_t, img))
    assert fid.num_fixes == 1
    truth = np.linalg.inv(cam_T_world) @ fid.cam_T_body
    p = est.est.filter_state().world_T_body[:3, 3]
    np.testing.assert_allclose(p, truth[:3, 3], atol=0.02)
