"""The port's fabric against the JAX package's (both host code, no device):

- every message type encodes to the same bytes (``encode_message``), and
  the two packages decode those bytes to equal messages;
- the LCM bridge (``to_lcm``, the struct's encoding, ``from_lcm``) gives the
  same bytes for every message type, as in ``tests/test_lcm_wire.py``'s
  round trips, and the same datagrams (short and fragmented);
- ``InProcessBus`` delivers to every subscriber of a channel, through the
  wire encoding, and to none of another;
- the shared-memory ring round trip of ``tests/test_datasets_fabric.py``,
  with the port's own native library built into its ``_build/``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from ocean_perception_tpu.fabric import lcm_wire as jlw
from ocean_perception_tpu.fabric import messages as jms
from ocean_perception_tpu_torch.fabric import lcm_wire as tlw
from ocean_perception_tpu_torch.fabric import messages as tms
from ocean_perception_tpu_torch.fabric import shm_ring
from ocean_perception_tpu_torch.fabric.pubsub import InProcessBus


def _messages(ms):
    """One message of every type, built from the same numbers."""
    rng = np.random.default_rng(0)
    gray = rng.random((6, 10)).astype(np.float32)
    rgb = rng.random((4, 5, 3)).astype(np.float32)
    u8 = (rng.random((6, 10)) * 255).astype(np.uint8)
    return {
        "image_raw": ms.ImageMessage.from_array(7, gray),
        "image_rgb": ms.ImageMessage.from_array(7, rgb),
        "image_u8": ms.ImageMessage(8, 10, 6, 1, "u8", u8.tobytes()),
        "image_jpg": ms.ImageMessage.from_array_jpg(9, rgb),
        "stereo": ms.StereoImageMessage(11, 2, ms.ImageMessage.from_array(11, gray),
                                        ms.ImageMessage.from_array(11, gray[::-1].copy())),
        "shm": ms.ShmImageHeader(12, 10, 6, 1, 5, "/dev/shm/ring"),
        "imu": ms.ImuMessage(13, np.array([0.1, -0.2, 0.3]), np.array([9.0, 0.5, -1.0])),
        "depth": ms.DepthMessage(14, 3.25),
        "range": ms.RangeMessage(15, 10.5, np.array([1.0, 2.0, 3.0]), beacon_id=2),
        "mag": ms.MagMessage(16, np.array([22.0, 0.0, -45.0])),
        "pose": ms.PoseStampedMessage(17, "world", np.array([0.5, 0.5, 0.5, 0.5, 1.0, -2.0, 3.0])),
        "mesh": ms.MeshMessage(18, rng.random((5, 3)), np.array([[0, 1, 2], [2, 3, 4]], np.int32)),
    }


def _fields_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _fields_equal(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", list(_messages(jms)))
def test_message_bytes_equal_jax(name):
    j, t = _messages(jms)[name], _messages(tms)[name]
    jb, tb = jms.encode_message(j), tms.encode_message(t)
    assert tb == jb
    _fields_equal(tms.decode_message(jb), jms.decode_message(jb))


@pytest.mark.parametrize("name", [n for n in _messages(jms) if n != "shm"])
def test_lcm_bytes_equal_jax(name):
    j, t = _messages(jms)[name], _messages(tms)[name]
    jsd, jv = jlw.to_lcm(j)
    tsd, tv = tlw.to_lcm(t)
    assert tsd.full_name == jsd.full_name
    wire = tsd.encode(tv)
    assert wire == jsd.encode(jv)
    back = tlw.from_lcm(*tlw.lt.decode_by_fingerprint(wire))
    ref = jlw.from_lcm(*jlw.lt.decode_by_fingerprint(wire))
    assert tms.encode_message(back) == jms.encode_message(ref)


@pytest.mark.parametrize("size", [7, 200_000])
def test_lcm_datagrams_equal_jax(size):
    payload = bytes(np.random.default_rng(size).integers(0, 256, size, np.uint8))
    assert tlw.encode_datagrams("chan", payload, seq=3) == \
        jlw.encode_datagrams("chan", payload, seq=3)


def test_in_process_bus_delivers_through_the_wire_encoding():
    bus = InProcessBus()
    got_a, got_b, other = [], [], []
    bus.subscribe("a", lambda ch, m: got_a.append((ch, m)))
    bus.subscribe("a", lambda ch, m: got_b.append(m))
    bus.subscribe("b", lambda ch, m: other.append(m))
    msg = _messages(tms)["mesh"]
    bus.publish("a", msg)
    assert [ch for ch, _ in got_a] == ["a"] and len(got_b) == 1 and not other
    assert got_a[0][1] is not msg  # a decoded copy, as over a socket
    _fields_equal(got_a[0][1], tms.decode_message(tms.encode_message(msg)))


def test_shm_ring_round_trip(tmp_path):
    """tests/test_datasets_fabric.py::test_shm_ring on the port's ring."""
    assert shm_ring.native_available(), "g++ and make build the ring on this machine"
    lib = Path(shm_ring._LIB_PATH)
    assert lib.is_file() and lib.parent.parent.name == "_build"
    path = str(tmp_path / "frames.ring")
    w = shm_ring.ShmRingWriter(path, n_slots=4, slot_bytes=1 << 16)
    r = shm_ring.ShmRingReader(path)
    img = np.random.rand(32, 48).astype(np.float32)
    seq = w.write(999, img)
    ts, back = r.read(seq)
    assert ts == 999
    np.testing.assert_array_equal(back, img)
    img8 = (np.random.rand(16, 16) * 255).astype(np.uint8)
    ts2, back2 = r.read(w.write(1000, img8))
    np.testing.assert_array_equal(back2, img8)
    seqs = [w.write(i, img8) for i in range(8)]
    assert r.read(seqs[0]) is None  # lapped
    w.close()
    r.close()
