"""LCM UDP-multicast transport: the reference's actual wire protocol
(a copy of ``ocean_perception_tpu.fabric.lcm_wire``).

Implements the LCM UDP datagram formats (lcm-proj UDP Multicast Protocol;
reference transport = liblcm, README.md:63-67) so our nodes interoperate with
unmodified LCM peers — reference-era sensor publishers, the Unity FarmSim
bridge's C# bindings, and debugging tools like lcm-spy:

- short message (fits one datagram): ``>I`` magic 0x4c433032 ("LC02"),
  ``>I`` sequence, NUL-terminated channel, payload;
- fragmented message: ``>I`` magic 0x4c433033 ("LC03"), ``>I`` msg_seq,
  ``>I`` msg_size (payload bytes), ``>I`` fragment_offset, ``>H`` fragment
  number, ``>H`` fragment count; fragment 0's data begins with the
  NUL-terminated channel. Reassembly is keyed per sender (addr, msg_seq).

Payloads are LCM-encoded ``vehicle.*`` messages (fabric/lcm_types.py).
``LcmUdpBus`` exposes the same PubSub interface as the in-house buses:
publish/subscribe carry OUR dataclass messages (fabric/messages.py) and the
bridge functions below translate to/from the reference's lcmtypes exactly as
the reference's lcm_util helpers do (util_imu_measurement_t.hpp etc.), so a
node is transport-agnostic via a constructor flag.

Default endpoint udpm://239.255.76.67:7667, TTL 0 — LCM's own defaults.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import lcm_types as lt
from . import messages as ms
from .pubsub import DEFAULT_GROUP, DEFAULT_PORT, PubSub

MAGIC_SHORT = 0x4C433032  # "LC02"
MAGIC_FRAG = 0x4C433033   # "LC03"
# LCM fragments above the max UDP datagram (lcm_udpm.c caps at 65499 bytes
# total); we leave headroom for the 20-byte fragment header + channel.
_MAX_DGRAM = 65499
_FRAG_CHUNK = 60000
_FRAG_HDR = struct.Struct(">IIIIHH")
_SHORT_HDR = struct.Struct(">II")


# ---------------------------------------------------------------------------
# Framing (transport-agnostic, unit-testable against the spec layout)
# ---------------------------------------------------------------------------

def encode_datagrams(channel: str, payload: bytes, seq: int) -> List[bytes]:
    """Frame one message into LCM datagrams (one LC02, or N LC03 fragments)."""
    ch = channel.encode("utf-8") + b"\0"
    if _SHORT_HDR.size + len(ch) + len(payload) <= _MAX_DGRAM:
        return [_SHORT_HDR.pack(MAGIC_SHORT, seq & 0xFFFFFFFF) + ch + payload]
    first_chunk = _FRAG_CHUNK - len(ch)
    chunks = [payload[:first_chunk]]
    for off in range(first_chunk, len(payload), _FRAG_CHUNK):
        chunks.append(payload[off : off + _FRAG_CHUNK])
    out = []
    offset = 0
    for i, chunk in enumerate(chunks):
        hdr = _FRAG_HDR.pack(
            MAGIC_FRAG, seq & 0xFFFFFFFF, len(payload), offset, i, len(chunks)
        )
        out.append(hdr + (ch + chunk if i == 0 else chunk))
        offset += len(chunk)
    return out


class Reassembler:
    """Per-sender LC03 fragment reassembly with bounded partial state."""

    def __init__(self, max_partials: int = 64):
        self._partials: Dict[Tuple, dict] = {}
        self._max = max_partials

    def push(self, sender, dgram: bytes) -> Optional[Tuple[str, bytes]]:
        """Feed one datagram; returns (channel, payload) when complete."""
        magic = struct.unpack_from(">I", dgram)[0]
        if magic == MAGIC_SHORT:
            body = dgram[_SHORT_HDR.size :]
            nul = body.index(b"\0")
            return body[:nul].decode("utf-8"), body[nul + 1 :]
        if magic != MAGIC_FRAG:
            raise ValueError(f"bad LCM magic {magic:#x}")
        _, seq, msg_size, frag_off, frag_no, n_frags = _FRAG_HDR.unpack_from(dgram)
        data = dgram[_FRAG_HDR.size :]
        # Corrupt-header guards (the C++ peer has both, udp_bus.cpp): an
        # out-of-range frag_no could otherwise "complete" a message with
        # zero-filled holes, and an oversized frag_off would silently APPEND
        # past msg_size via bytearray slice assignment.
        if n_frags <= 0 or frag_no >= n_frags or msg_size < 0 or frag_off < 0:
            raise ValueError("bad LCM fragment header")
        key = (sender, seq)
        st = self._partials.get(key)
        if st is None:
            if len(self._partials) >= self._max:  # evict oldest partial
                self._partials.pop(next(iter(self._partials)))
            st = {"buf": bytearray(msg_size), "got": set(), "n": n_frags, "ch": None}
            self._partials[key] = st
        if frag_no == 0:
            nul = data.index(b"\0")
            st["ch"] = data[:nul].decode("utf-8")
            data = data[nul + 1 :]
        if frag_off + len(data) > len(st["buf"]):
            del self._partials[key]
            raise ValueError("LCM fragment exceeds declared message size")
        st["buf"][frag_off : frag_off + len(data)] = data
        st["got"].add(frag_no)
        if len(st["got"]) == st["n"] and st["ch"] is not None:
            del self._partials[key]
            return st["ch"], bytes(st["buf"])
        return None


# ---------------------------------------------------------------------------
# Bridge: our dataclass messages <-> the reference's vehicle.* lcmtypes
# (lcm_util parity: util_imu_measurement_t.hpp, util_pose3_t.hpp, ...)
# ---------------------------------------------------------------------------

def _image_to_lcm(img: ms.ImageMessage) -> dict:
    """image_t is an 8-bit type ("mono8"/"bgr8" x "jpg"/"raw",
    mmf_image_t.lcm comments); our float32 frames quantize to u8 on this
    wire, jpg/u8 payloads pass through."""
    def to_bgr(u8: np.ndarray) -> bytes:
        # The wire formats are "mono8"/"bgr8": swap our RGB channel order.
        if img.channels == 3:
            u8 = u8.reshape(img.height, img.width, 3)[..., ::-1]
        return np.ascontiguousarray(u8).tobytes()

    if img.encoding == "jpg":
        data = img.data
        if img.channels == 3:
            # Our jpg bytes hold RGB-in-BGR-slots (from_array_jpg encodes the
            # RGB array with cv2); a reference consumer decodes jpg to a BGR
            # Mat, so transcode to true-BGR content or its colors swap.
            import cv2

            arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
            ok, buf = cv2.imencode(".jpg", arr[..., ::-1])
            if not ok:
                raise ValueError("JPEG transcode failed")
            data = buf.tobytes()
        enc = "jpg"
    elif img.encoding == "u8":
        enc, data = "raw", to_bgr(np.frombuffer(img.data, np.uint8))
    elif img.encoding == "raw":
        arr = np.frombuffer(img.data, np.float32)
        u8 = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        enc, data = "raw", to_bgr(u8)
    else:
        raise ValueError(img.encoding)
    return {
        "width": img.width, "height": img.height, "channels": img.channels,
        "format": "mono8" if img.channels == 1 else "bgr8",
        "encoding": enc, "size": len(data), "data": data,
    }


def _image_from_lcm(v: dict, timestamp: int) -> ms.ImageMessage:
    data = bytes(v["data"])
    if v["format"] != "bgr8":
        enc = "jpg" if v["encoding"] == "jpg" else "u8"
    elif v["encoding"] == "jpg":
        # True-BGR jpg content from a reference publisher: decode, swap to
        # our RGB convention, deliver as u8 (re-encoding would just burn CPU
        # and quality).
        import cv2

        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        data = np.ascontiguousarray(arr[..., ::-1]).tobytes()
        enc = "u8"
    else:
        arr = np.frombuffer(data, np.uint8).reshape(v["height"], v["width"], 3)
        data = np.ascontiguousarray(arr[..., ::-1]).tobytes()  # wire BGR -> RGB
        enc = "u8"
    return ms.ImageMessage(
        timestamp, v["width"], v["height"], v["channels"], enc, data
    )


def _vec3(a) -> dict:
    a = np.asarray(a, np.float64)
    return {"x": float(a[0]), "y": float(a[1]), "z": float(a[2])}


def _unvec3(v: dict) -> np.ndarray:
    return np.array([v["x"], v["y"], v["z"]], np.float64)


def to_lcm(msg) -> Tuple[lt.LcmStructDef, dict]:
    """Our message -> (lcm struct def, value dict)."""
    h = lt.make_header(msg.timestamp)
    if isinstance(msg, ms.ImuMessage):
        return lt.IMU_MEASUREMENT_T, {
            "header": h,
            "linear_acc": _vec3(msg.linear_acceleration),
            "angular_vel": _vec3(msg.angular_velocity),
        }
    if isinstance(msg, ms.DepthMessage):
        return lt.DEPTH_MEASUREMENT_T, {"header": h, "depth": float(msg.depth)}
    if isinstance(msg, ms.RangeMessage):
        # The wire type has no beacon id field; the reference identifies
        # beacons by position (point). header.seq carries ours losslessly.
        h["seq"] = int(msg.beacon_id)
        return lt.RANGE_MEASUREMENT_T, {
            "header": h, "range": float(msg.range), "point": _vec3(msg.point),
        }
    if isinstance(msg, ms.MagMessage):
        return lt.MAG_MEASUREMENT_T, {"header": h, "field": _vec3(msg.field)}
    if isinstance(msg, ms.PoseStampedMessage):
        h["frame_id"] = msg.frame_id
        q, t = msg.pose[:4], msg.pose[4:7]
        v = {
            "header": h,
            "pose": {
                "position": _vec3(t),
                "orientation": {
                    "w": float(q[0]), "x": float(q[1]),
                    "y": float(q[2]), "z": float(q[3]),
                },
            },
        }
        if msg.covariance is not None:
            # The covariance must survive the wire (receive_pose otherwise
            # substitutes its own default and fuses the fix over/under-
            # confident): ride the extension type.
            v["covariance"] = [
                float(x) for x in np.asarray(msg.covariance, np.float64).reshape(-1)
            ]
            return lt.POSE3_COV_STAMPED_T, v
        return lt.POSE3_STAMPED_T, v
    if isinstance(msg, ms.StereoImageMessage):
        h["seq"] = int(msg.camera_id)
        return lt.STEREO_IMAGE_T, {
            "header": h,
            "img_left": _image_to_lcm(msg.left),
            "img_right": _image_to_lcm(msg.right),
        }
    if isinstance(msg, ms.ImageMessage):
        # image_t carries no header — the timestamp does not survive this
        # wire (mono image channels are viz taps; stereo frames keep theirs).
        return lt.IMAGE_T, _image_to_lcm(msg)
    if isinstance(msg, ms.MeshMessage):
        verts = np.asarray(msg.vertices, np.float64).reshape(-1, 3)
        tris = np.asarray(msg.triangles, np.int64).reshape(-1, 3)
        return lt.MESH_STAMPED_T, {
            "header": h,
            "mesh": {
                "num_vertices": len(verts),
                "vertices": [_vec3(v) for v in verts],
                "num_triangles": len(tris),
                "triangles": [{"vertex_indices": [int(i) for i in t]} for t in tris],
            },
        }
    raise TypeError(f"no LCM mapping for {type(msg).__name__}")


def from_lcm(sd: lt.LcmStructDef, v: dict):
    """(lcm struct def, value dict) -> our message; None if unmapped."""
    if sd is lt.IMU_MEASUREMENT_T:
        return ms.ImuMessage(
            v["header"]["timestamp"],
            angular_velocity=_unvec3(v["angular_vel"]),
            linear_acceleration=_unvec3(v["linear_acc"]),
        )
    if sd is lt.DEPTH_MEASUREMENT_T:
        return ms.DepthMessage(v["header"]["timestamp"], v["depth"])
    if sd is lt.RANGE_MEASUREMENT_T:
        return ms.RangeMessage(
            v["header"]["timestamp"], v["range"], _unvec3(v["point"]),
            beacon_id=max(int(v["header"]["seq"]), 0),
        )
    if sd is lt.MAG_MEASUREMENT_T:
        return ms.MagMessage(v["header"]["timestamp"], _unvec3(v["field"]))
    if sd is lt.POSE3_STAMPED_T or sd is lt.POSE3_COV_STAMPED_T:
        q = v["pose"]["orientation"]
        t = v["pose"]["position"]
        cov = (
            np.asarray(v["covariance"], np.float64).reshape(6, 6)
            if sd is lt.POSE3_COV_STAMPED_T
            else None
        )
        return ms.PoseStampedMessage(
            v["header"]["timestamp"], v["header"]["frame_id"],
            np.array([q["w"], q["x"], q["y"], q["z"], t["x"], t["y"], t["z"]]),
            covariance=cov,
        )
    if sd is lt.STEREO_IMAGE_T:
        ts = v["header"]["timestamp"]
        return ms.StereoImageMessage(
            ts, int(v["header"]["seq"]),
            _image_from_lcm(v["img_left"], ts),
            _image_from_lcm(v["img_right"], ts),
        )
    if sd is lt.IMAGE_T:
        return _image_from_lcm(v, 0)
    if sd is lt.MESH_STAMPED_T:
        m = v["mesh"]
        verts = np.array(
            [[p["x"], p["y"], p["z"]] for p in m["vertices"]], np.float32
        ).reshape(-1, 3)
        tris = np.array(
            [t["vertex_indices"] for t in m["triangles"]], np.int32
        ).reshape(-1, 3)
        return ms.MeshMessage(v["header"]["timestamp"], verts, tris)
    return None


class MmfPublisher:
    """Outbound mmf image transport: frames go into a preallocated
    memory-mapped slot file; only the small mmf_stereo_image_t descriptor
    rides the bus — the reference's zero-copy image path, usable by its
    unmodified ImageSubscriber consumers.

    Slots rotate round-robin; a descriptor is published AFTER its slot is
    fully written, and consumers read promptly (same liveness contract the
    reference's single-writer mmf file has)."""

    def __init__(self, bus: "LcmUdpBus", path: str, slot_bytes: int = 1 << 20,
                 n_slots: int = 16):
        self.bus = bus
        self.path = path
        self.slot_bytes = slot_bytes
        self.n_slots = n_slots
        self._next = 0
        self._f = open(path, "wb+")
        self._f.truncate(slot_bytes * n_slots)
        # Blocks written but whose descriptor is not yet on the bus: a later
        # write in the same publish (or a regrow relayout) must never land
        # on these bytes — e.g. left written at offset 0, then right regrows
        # and would otherwise also pick offset 0 before EITHER descriptor
        # publishes, corrupting the left frame for every reader.
        self._unpublished: list = []  # [(offset, length)]

    def _write_block(self, data: bytes) -> int:
        if len(data) > self.slot_bytes:
            # First oversized frame (e.g. 720p bgr8 raw is ~2.8 MB): regrow
            # the slot layout. Readers address blocks by absolute
            # offset+size, so relayout is safe; in-flight descriptors from
            # the old layout stay readable until their bytes are overwritten.
            while self.slot_bytes < len(data):
                self.slot_bytes *= 2
            self._next = 0
            self._f.truncate(self.slot_bytes * self.n_slots)
        off = self._next * self.slot_bytes
        for _ in range(self.n_slots):
            end = off + len(data)
            if not any(off < po + pn and po < end for po, pn in self._unpublished):
                break
            self._next = (self._next + 1) % self.n_slots
            off = self._next * self.slot_bytes
        self._next = (self._next + 1) % self.n_slots
        self._f.seek(off)
        self._f.write(data)
        self._unpublished.append((off, len(data)))
        return off

    def _desc(self, img: ms.ImageMessage) -> dict:
        v = _image_to_lcm(img)
        off = self._write_block(v["data"])
        return {
            "width": v["width"], "height": v["height"], "channels": v["channels"],
            "format": v["format"], "encoding": v["encoding"],
            "mm_filename": self.path, "offset": off, "size": v["size"],
        }

    def publish_stereo(self, channel: str, msg: ms.StereoImageMessage) -> None:
        left = self._desc(msg.left)
        right = self._desc(msg.right)
        self._f.flush()
        h = lt.make_header(msg.timestamp, msg.camera_id)
        self.bus.publish_lcm(
            channel, lt.MMF_STEREO_IMAGE_T,
            {"header": h, "img_left": left, "img_right": right},
        )
        self._unpublished.clear()

    def close(self) -> None:
        self._f.close()


class MmfReader:
    """Inbound mmf_image_t support: reads the byte block a descriptor points
    at from the publisher's memory-mapped file (ImageSubscriber parity,
    image_subscriber.cpp:29-91 — open once per filename, seek offset, read
    size, decode by encoding)."""

    def __init__(self):
        self._files: Dict[str, object] = {}

    def read(self, v: dict) -> Optional[ms.ImageMessage]:
        if v["offset"] < 0 or v["size"] <= 0:
            return None
        f = self._files.get(v["mm_filename"])
        if f is None:
            try:
                f = open(v["mm_filename"], "rb")
            except OSError:
                return None  # file not visible from this host
            self._files[v["mm_filename"]] = f
        f.seek(v["offset"])
        data = f.read(v["size"])
        return _image_from_lcm({**v, "data": data}, 0)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


# ---------------------------------------------------------------------------
# The bus
# ---------------------------------------------------------------------------

class LcmUdpBus(PubSub):
    """PubSub over real LCM wire format. Same interface and message classes
    as UdpMulticastBus — only the bytes on the network differ (they are LCM's,
    so reference-era tools and nodes can join the bus)."""

    def __init__(self, group: str = DEFAULT_GROUP, port: int = DEFAULT_PORT, ttl: int = 0):
        from .pubsub import open_multicast_pair

        self.group = group
        self.port = port
        self._tx, self._rx = open_multicast_pair(group, port, ttl)
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._raw_subs: Dict[str, List[Callable]] = defaultdict(list)
        self._byte_subs: Dict[str, List[Callable]] = defaultdict(list)
        self._patterns: List[Tuple[str, object]] = []
        self._tap: Optional[Callable] = None
        self._mmf = MmfReader()
        self._reasm = Reassembler()
        self._seq = 0
        self._foreign_drops = 0
        self._lock = threading.Lock()
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- publish -------------------------------------------------------------

    def publish(self, channel: str, message) -> None:
        sd, values = to_lcm(message)
        self.publish_encoded(channel, sd.encode(values))

    def publish_lcm(self, channel: str, sd: lt.LcmStructDef, values: dict) -> None:
        """Publish a raw lcmtype value dict (for types without a dataclass
        mapping, e.g. mmf_stereo_image_t)."""
        self.publish_encoded(channel, sd.encode(values))

    def publish_encoded(self, channel: str, payload: bytes) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        for dgram in encode_datagrams(channel, payload, seq):
            self._tx.sendto(dgram, (self.group, self.port))

    # -- subscribe -----------------------------------------------------------
    #
    # LCM semantics: the subscription string is an ANCHORED REGEX over channel
    # names (lcm_subscribe; how lcm-spy watches ".*"). Plain channel names
    # contain no metacharacters and behave as exact matches.

    def subscribe(self, channel: str, callback: Callable) -> None:
        """callback(channel, our_message) — LCM payloads with a dataclass
        mapping arrive as the same classes the other buses deliver."""
        self._subs[channel].append(callback)
        self._compile_patterns()
        self._ensure_rx()

    def subscribe_lcm(self, channel: str, callback: Callable) -> None:
        """callback(channel, struct_def, value_dict) for every known lcmtype;
        for a FOREIGN type (unknown fingerprint) it is called as
        callback(channel, None, payload_bytes) so traffic stays visible
        (lcm-spy counts undecodable messages too)."""
        self._raw_subs[channel].append(callback)
        self._compile_patterns()
        self._ensure_rx()

    def subscribe_bytes(self, channel: str, callback: Callable) -> None:
        """callback(channel, payload_bytes) with the exact reassembled wire
        payload, before any decode — the lossless hook a logger needs
        (fabric/lcm_log.py BusRecorder): foreign types and payloads our
        decoder would reject are still captured verbatim."""
        self._byte_subs[channel].append(callback)
        self._compile_patterns()
        self._ensure_rx()

    def set_tap(self, callback: Optional[Callable]) -> None:
        self._tap = callback
        if callback is not None:
            self._ensure_rx()

    def _compile_patterns(self) -> None:
        import re

        patterns = []
        for p in set(self._subs) | set(self._raw_subs) | set(self._byte_subs):
            try:
                patterns.append((p, re.compile(p)))
            except re.error:
                pass  # non-regex channel name: exact matching still applies
        # Single atomic rebind: the rx thread must never observe a partial
        # list (subscribe() on a live bus would otherwise drop messages).
        self._patterns = patterns

    def _matching(self, table: Dict[str, List[Callable]], channel: str) -> List[Callable]:
        cbs = list(table.get(channel, ()))  # exact match fast path
        for pat, rx in self._patterns:
            if pat != channel and pat in table and rx.fullmatch(channel):
                cbs.extend(table[pat])
        return cbs

    def _ensure_rx(self) -> None:
        if self._thread is None:
            self._running.set()
            self._thread = threading.Thread(target=self._rx_loop, daemon=True)
            self._thread.start()

    def _dispatch(self, channel: str, payload: bytes) -> None:
        for cb in self._matching(self._byte_subs, channel):
            cb(channel, payload)
        cbs = self._matching(self._subs, channel)
        raw_cbs = self._matching(self._raw_subs, channel)
        if not cbs and not raw_cbs and self._tap is None:
            return
        sd, values = lt.decode_by_fingerprint(payload)
        if sd is None:
            # Foreign type on a watched channel: raw subscribers still get to
            # see it (lcm-spy counts undecodable traffic); typed ones don't.
            for cb in raw_cbs:
                cb(channel, None, payload)
            return
        for cb in raw_cbs:
            cb(channel, sd, values)
        if cbs or self._tap is not None:
            msg = self._from_lcm_with_mmf(sd, values)
            if msg is None:
                return
            if self._tap is not None:
                self._tap(channel, msg)
            for cb in cbs:
                cb(channel, msg)

    def _from_lcm_with_mmf(self, sd: lt.LcmStructDef, v: dict):
        """from_lcm plus the two mmf descriptor types, which need this bus's
        file-reader state (reference-era publishers ship images this way)."""
        if sd is lt.MMF_STEREO_IMAGE_T:
            left = self._mmf.read(v["img_left"])
            right = self._mmf.read(v["img_right"])
            if left is None or right is None:
                return None
            ts = v["header"]["timestamp"]
            left.timestamp = right.timestamp = ts
            return ms.StereoImageMessage(ts, int(v["header"]["seq"]), left, right)
        if sd is lt.MMF_IMAGE_T:
            return self._mmf.read(v)
        return from_lcm(sd, v)

    def _rx_loop(self) -> None:
        while self._running.is_set():
            try:
                pkt, sender = self._rx.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                done = self._reasm.push(sender, pkt)
                if done is not None:
                    self._dispatch(*done)
            except (ValueError, struct.error, IndexError):
                # Non-LCM datagram (e.g. the in-house bus sharing this
                # group:port) or a truncated/corrupt one — struct.error
                # covers packets shorter than the LC02/LC03 headers.
                # liblcm drops these silently; warn once and
                # then only at wide intervals so a mixed bus doesn't
                # flood stderr at image-fragment rates.
                self._foreign_drops += 1
                if self._foreign_drops == 1 or self._foreign_drops % 100000 == 0:
                    import sys

                    print(
                        f"LcmUdpBus: dropped {self._foreign_drops} non-LCM "
                        f"datagram(s) on {self.group}:{self.port} (another "
                        "transport on this endpoint?)",
                        file=sys.stderr,
                    )
            except Exception:  # noqa: BLE001 — the rx thread must survive
                import traceback

                traceback.print_exc()

    def close(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=1)
        self._tx.close()
        self._rx.close()
        self._mmf.close()
