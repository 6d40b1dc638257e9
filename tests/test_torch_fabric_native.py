"""The port's native transport, chaos wrapper and LCM IDL parser against the
JAX package's (all host code, no device):

- ``NativeUdpBus`` / ``NativeLcmBus`` (the port's own copy of
  ``udp_bus.cpp``, built into its ``_build/fabric/``) exchange messages both
  ways with the port's and JAX's Python buses and with JAX's native bus: a
  short message and a fragmented image, each payload equal byte for byte
  to what was sent;
- a bus whose library cannot be built raises with the compiler's output;
- ``ChaosBus`` delivers the same sequence and counts the same ``stats`` as
  JAX's on the same seed and publish sequence;
- ``lcm_gen`` parses the inline sources of ``tests/test_lcm_wire.py`` into
  the same structures and fingerprints as JAX's;
- the nodes' ``--native-bus`` / ``--lcm`` flags pick the buses JAX's pick.
"""

import shutil
import time

import numpy as np
import pytest
import torch

from ocean_perception_tpu.fabric import chaos as jchaos
from ocean_perception_tpu.fabric import lcm_gen as jgen
from ocean_perception_tpu.fabric import lcm_wire as jlw
from ocean_perception_tpu.fabric import messages as jms
from ocean_perception_tpu.fabric import native_bus as jnb
from ocean_perception_tpu.fabric import pubsub as jps
from ocean_perception_tpu_torch.fabric import chaos as tchaos
from ocean_perception_tpu_torch.fabric import lcm_gen as tgen
from ocean_perception_tpu_torch.fabric import lcm_wire as tlw
from ocean_perception_tpu_torch.fabric import messages as tms
from ocean_perception_tpu_torch.fabric import native_bus as tnb
from ocean_perception_tpu_torch.fabric import pubsub as tps

# Ports no other test module uses (each case its own, so parallel workers
# cannot hear each other).
PORTS = {"udp-port-python": 7941, "udp-jax-python": 7942, "udp-jax-native": 7943,
         "lcm-port-python": 7944, "lcm-jax-python": 7945, "lcm-jax-native": 7946}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's parallel
    workers would otherwise oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wait(cond, seconds=10.0):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def _udp_peer(kind, port):
    return {"port-python": lambda: tps.UdpMulticastBus(port=port),
            "jax-python": lambda: jps.UdpMulticastBus(port=port),
            "jax-native": lambda: jnb.NativeUdpBus(port=port)}[kind]()


def _lcm_peer(kind, port):
    return {"port-python": lambda: tlw.LcmUdpBus(port=port),
            "jax-python": lambda: jlw.LcmUdpBus(port=port),
            "jax-native": lambda: jnb.NativeLcmBus(port=port)}[kind]()


@pytest.mark.parametrize("peer", ["port-python", "jax-python", "jax-native"])
def test_native_udp_bus_interop(peer):
    """Port native -> peer and peer -> port native, a short message and a
    fragmented image (160x200 float32, ~128 KB > one 60 KB datagram); every
    received payload encodes to the bytes that were sent."""
    port = PORTS["udp-" + peer]
    native, other = tnb.NativeUdpBus(port=port), _udp_peer(peer, port)
    try:
        at_native, at_other = [], []
        native.subscribe("to/native", lambda _c, m: at_native.append(m))
        other.subscribe("to/other", lambda _c, m: at_other.append(m))
        time.sleep(0.3)  # both receive threads up
        img = np.random.default_rng(5).random((160, 200)).astype(np.float32)
        imu = tms.ImuMessage(7, np.zeros(3), np.array([1.0, 2.0, 3.0]))
        native.publish("to/other", imu)
        native.publish("to/other", tms.ImageMessage.from_array(5, img))
        other_ms = jms if peer.startswith("jax") else tms
        other.publish("to/native", other_ms.ImuMessage(8, np.ones(3), np.array([4.0, 5.0, 6.0])))
        other.publish("to/native", other_ms.ImageMessage.from_array(9, img))
        assert _wait(lambda: len(at_native) >= 2 and len(at_other) >= 2), (at_native, at_other)
        sent_out = [tms.encode_message(imu), tms.encode_message(tms.ImageMessage.from_array(5, img))]
        assert [other_ms.encode_message(m) for m in at_other] == sent_out
        sent_in = [tms.encode_message(tms.ImuMessage(8, np.ones(3), np.array([4.0, 5.0, 6.0]))),
                   tms.encode_message(tms.ImageMessage.from_array(9, img))]
        assert [tms.encode_message(m) for m in at_native] == sent_in
        np.testing.assert_array_equal(at_native[1].to_array(), img)
    finally:
        native.close()
        other.close()


@pytest.mark.parametrize("peer", ["port-python", "jax-python", "jax-native"])
def test_native_lcm_bus_interop(peer):
    """The LCM mode: LC02 (short) and LC03 (fragmented, a 300x400 u8 stereo
    pair) both ways; the LCM encodings of what arrived equal what was sent.
    A multicast bus hears its own messages too, so arrivals are told apart
    by content."""
    port = PORTS["lcm-" + peer]
    native, other = tnb.NativeLcmBus(port=port), _lcm_peer(peer, port)
    other_ms, other_lw = (jms, jlw) if peer.startswith("jax") else (tms, tlw)
    try:
        at_native, at_other = [], []
        for ch in ("small", "big"):
            native.subscribe(ch, lambda _c, m: at_native.append(m))
            other.subscribe(ch, lambda _c, m: at_other.append(m))
        time.sleep(0.3)
        frame = np.random.default_rng(1).random((300, 400)).astype(np.float32)

        def stereo(ms, ts):
            return ms.StereoImageMessage(ts, 0, ms.ImageMessage.from_array(ts, frame),
                                         ms.ImageMessage.from_array(ts, frame))

        native.publish("small", tms.DepthMessage(2, 2.5))
        native.publish("big", stereo(tms, 3))
        other.publish("small", other_ms.DepthMessage(1, 1.25))
        other.publish("big", stereo(other_ms, 4))

        def wire(lw, m):
            sd, v = lw.to_lcm(m)
            return sd.encode(v)

        def got(msgs, lw, want):
            return any(wire(lw, m) == want for m in msgs)

        from_native = [wire(tlw, tms.DepthMessage(2, 2.5)), wire(tlw, stereo(tms, 3))]
        from_other = [wire(other_lw, other_ms.DepthMessage(1, 1.25)),
                      wire(other_lw, stereo(other_ms, 4))]
        assert _wait(lambda: all(got(at_other, other_lw, w) for w in from_native)
                     and all(got(at_native, tlw, w) for w in from_other)), (at_native, at_other)
    finally:
        native.close()
        other.close()


def test_native_bus_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A source that does not compile: the bus raises, naming the error."""
    src = tmp_path / "native"
    shutil.copytree(tnb._NATIVE_DIR, src)
    (src / "udp_bus.cpp").write_text("#error broken transport source\n")
    monkeypatch.setattr(tnb, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(tnb, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnb, "_LIB_PATH", str(tmp_path / "build" / "libocean_fabric_udp.so"))
    monkeypatch.setattr(tnb, "_lib", None)
    assert not tnb.native_available()
    with pytest.raises(RuntimeError, match="broken transport source"):
        tnb.NativeUdpBus(port=PORTS["udp-port-python"])


def test_bus_flags_pick_the_buses_jax_picks():
    assert tnb.bus_class(True, False) is tnb.NativeUdpBus
    assert tnb.bus_class(True, True) is tnb.NativeLcmBus
    assert tnb.bus_class(False, True) is tlw.LcmUdpBus
    assert tnb.bus_class(False, False) is tps.UdpMulticastBus


def _recorder(ps):
    """A bus of package ``ps`` that records what is published on it."""
    class Recorder(ps.PubSub):
        def __init__(self):
            self.log = []

        def publish(self, channel, message):
            self.log.append((channel, message))

    return Recorder()


@pytest.mark.parametrize("seed,p", [(7, (0.2, 0.1, 0.2)), (3, (0.0, 0.5, 0.3)),
                                    (11, (0.45, 0.05, 0.45))])
def test_chaos_bus_equals_jax(seed, p):
    """Drops, duplicates and holdbacks on a matched channel, an unmatched
    channel always delivered, the flush at the end: the same sequence and
    the same stats as JAX's ChaosBus."""
    runs = []
    for mod, ps in ((jchaos, jps), (tchaos, tps)):
        rec = _recorder(ps)
        bus = mod.ChaosBus(rec, p_drop=p[0], p_dup=p[1], p_hold=p[2], hold_count=2, seed=seed,
                           channels={"a", "c"})
        for k in range(200):
            bus.publish("abc"[k % 3], k)
        bus.flush()
        runs.append((rec.log, dict(bus.stats)))
    assert runs[1] == runs[0]
    assert runs[0][1]["published"] == 133 and len(runs[0][0]) > 60


LCM_SOURCES = {
    "consts_and_comments": """
    package demo;
    /* block
       comment */
    struct thing_t {
      const int32_t MODE_A = 1, MODE_B = 2;
      const double SCALE = 1.5;
      int64_t utime;    // trailing comment
      double grid[4][4];
      int32_t n;
      byte data[n];
    }
    """,
    "const_dims_hex_and_commas": """
    package p;
    struct y_t {
        const int32_t N = 8, FLAGS = 0x10;
        double v[N];
        double x, y, z;
        int32_t m;
        byte data[m];
    }
    """,
    "nested_across_packages": """
    package a;
    struct inner_t { int32_t k; double w[3]; }
    struct outer_t { inner_t one; inner_t many[2]; string name; }
    """,
}
LCM_VALUES = {
    "demo.thing_t": {"utime": 7, "grid": [[float(r * 4 + c) for c in range(4)] for r in range(4)],
                     "n": 3, "data": b"\x01\x02\x03"},
    "p.y_t": {"v": [0.5] * 8, "x": 1.0, "y": 2.0, "z": 3.0, "m": 2, "data": b"ab"},
    "a.outer_t": {"one": {"k": 1, "w": [1.0, 2.0, 3.0]},
                  "many": [{"k": 2, "w": [0.0] * 3}, {"k": 3, "w": [4.0, 5.0, 6.0]}],
                  "name": "board"},
}


def _structure(sd):
    return (sd.full_name, tuple(
        (m.name, m.type if isinstance(m.type, str) else _structure(m.type), m.dims)
        for m in sd.members))


@pytest.mark.parametrize("name", list(LCM_SOURCES))
def test_lcm_gen_equals_jax(name):
    jraw, traw = jgen.parse_lcm_source(LCM_SOURCES[name]), tgen.parse_lcm_source(LCM_SOURCES[name])
    assert traw == jraw
    jdefs, tdefs = jgen.resolve_structs(jraw), tgen.resolve_structs(traw)
    assert sorted(tdefs) == sorted(jdefs)
    for full, sd in tdefs.items():
        assert _structure(sd) == _structure(jdefs[full])
        assert sd.fingerprint() == jdefs[full].fingerprint()
        if full in LCM_VALUES:
            wire = sd.encode(LCM_VALUES[full])
            assert wire == jdefs[full].encode(LCM_VALUES[full])
            assert sd.decode(wire) == jdefs[full].decode(wire)


def test_lcm_gen_rejects_what_jax_rejects():
    for src, match in (("package p; struct a_t { missing_t x; }", "unknown LCM type"),
                       ("package p; struct a_t { int32_t x }", "LCM parse error")):
        with pytest.raises(ValueError, match=match):
            jgen.resolve_structs(jgen.parse_lcm_source(src))
        with pytest.raises(ValueError, match=match):
            tgen.resolve_structs(tgen.parse_lcm_source(src))
