"""Wire message types (reference: lcmtypes/*.lcm, 17 schemas)
(a copy of ``ocean_perception_tpu.fabric.messages``).

Each message is a dataclass with a compact binary encoding:
  [u32 magic][u16 type id][u16 version][payload]
Payloads use little-endian struct packing + raw numpy buffers. This replaces
the LCM IDL toolchain with plain Python (the C++ side of the shm transport
shares the header layout via fabric/native/shm_ring.cpp).

Covered reference types: image_t, stereo_image_t, mmf_image_t (shm header),
imu_measurement_t, depth_measurement_t, range_measurement_t,
mag_measurement_t, pose3_stamped_t, mesh_t/mesh_stamped_t.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import ClassVar, Dict, Optional, Type

import numpy as np

MAGIC = 0x0CEA7FAB


@dataclasses.dataclass
class ImageMessage:
    TYPE_ID: ClassVar[int] = 1
    timestamp: int = 0
    width: int = 0
    height: int = 0
    channels: int = 1
    encoding: str = "raw"   # "raw" (float32) | "u8" | "jpg"
    data: bytes = b""

    def pack_payload(self) -> bytes:
        enc = self.encoding.encode()[:8].ljust(8, b"\0")
        head = struct.pack("<qiii8sI", self.timestamp, self.width, self.height, self.channels, enc, len(self.data))
        return head + self.data

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "ImageMessage":
        ts, w, h, c, enc, n = struct.unpack_from("<qiii8sI", buf)
        off = struct.calcsize("<qiii8sI")
        return cls(ts, w, h, c, enc.rstrip(b"\0").decode(), buf[off : off + n])

    @classmethod
    def from_array(cls, timestamp: int, image: np.ndarray) -> "ImageMessage":
        arr = np.ascontiguousarray(image, dtype=np.float32)
        c = 1 if arr.ndim == 2 else arr.shape[2]
        return cls(timestamp, arr.shape[1], arr.shape[0], c, "raw", arr.tobytes())

    @classmethod
    def from_array_jpg(cls, timestamp: int, image: np.ndarray, quality: int = 90) -> "ImageMessage":
        """JPEG-compressed payload (mmf_image_t 'jpg' format parity)."""
        import cv2

        u8 = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise ValueError("JPEG encode failed")
        c = 1 if u8.ndim == 2 else u8.shape[2]
        return cls(timestamp, u8.shape[1], u8.shape[0], c, "jpg", buf.tobytes())

    def to_array_u8(self) -> Optional[np.ndarray]:
        """The frame as uint8 WITHOUT the float conversion, or None when the
        payload is float ("raw"). Consumers that cast on-device (the farm
        node's batched step) ship 1 byte/pixel host->device instead of 4-12."""
        if self.encoding == "u8":
            arr = np.frombuffer(self.data, np.uint8)
            shape = (
                (self.height, self.width)
                if self.channels == 1
                else (self.height, self.width, self.channels)
            )
            return arr.reshape(shape)
        if self.encoding == "jpg":
            import cv2

            return cv2.imdecode(np.frombuffer(self.data, np.uint8), cv2.IMREAD_UNCHANGED)
        return None

    def to_array(self) -> np.ndarray:
        if self.encoding == "raw":
            arr = np.frombuffer(self.data, np.float32)
        elif self.encoding == "u8":
            arr = np.frombuffer(self.data, np.uint8).astype(np.float32) / 255.0
        elif self.encoding == "jpg":
            import cv2

            arr = cv2.imdecode(np.frombuffer(self.data, np.uint8), cv2.IMREAD_UNCHANGED)
            arr = arr.astype(np.float32) / 255.0
            return arr
        else:
            raise ValueError(self.encoding)
        shape = (self.height, self.width) if self.channels == 1 else (self.height, self.width, self.channels)
        return arr.reshape(shape)


@dataclasses.dataclass
class StereoImageMessage:
    TYPE_ID: ClassVar[int] = 2
    timestamp: int = 0
    camera_id: int = 0
    left: ImageMessage = dataclasses.field(default_factory=ImageMessage)
    right: ImageMessage = dataclasses.field(default_factory=ImageMessage)

    def pack_payload(self) -> bytes:
        l = self.left.pack_payload()
        r = self.right.pack_payload()
        return struct.pack("<qiII", self.timestamp, self.camera_id, len(l), len(r)) + l + r

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "StereoImageMessage":
        ts, cid, nl, nr = struct.unpack_from("<qiII", buf)
        off = struct.calcsize("<qiII")
        return cls(
            ts,
            cid,
            ImageMessage.unpack_payload(buf[off : off + nl]),
            ImageMessage.unpack_payload(buf[off + nl : off + nl + nr]),
        )


@dataclasses.dataclass
class ShmImageHeader:
    """mmf_image_t analog: descriptor of a frame living in a shm ring."""

    TYPE_ID: ClassVar[int] = 3
    timestamp: int = 0
    width: int = 0
    height: int = 0
    channels: int = 1
    seq: int = 0          # ring sequence number
    shm_path: str = ""    # ring file; subscriber maps lazily

    def pack_payload(self) -> bytes:
        p = self.shm_path.encode()
        return struct.pack("<qiiiqI", self.timestamp, self.width, self.height, self.channels, self.seq, len(p)) + p

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "ShmImageHeader":
        ts, w, h, c, seq, n = struct.unpack_from("<qiiiqI", buf)
        off = struct.calcsize("<qiiiqI")
        return cls(ts, w, h, c, seq, buf[off : off + n].decode())


@dataclasses.dataclass
class ImuMessage:
    TYPE_ID: ClassVar[int] = 4
    timestamp: int = 0
    angular_velocity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    linear_acceleration: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def pack_payload(self) -> bytes:
        return struct.pack("<q6d", self.timestamp, *self.angular_velocity, *self.linear_acceleration)

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "ImuMessage":
        vals = struct.unpack_from("<q6d", buf)
        return cls(vals[0], np.asarray(vals[1:4]), np.asarray(vals[4:7]))


@dataclasses.dataclass
class DepthMessage:
    TYPE_ID: ClassVar[int] = 5
    timestamp: int = 0
    depth: float = 0.0

    def pack_payload(self) -> bytes:
        return struct.pack("<qd", self.timestamp, self.depth)

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "DepthMessage":
        return cls(*struct.unpack_from("<qd", buf))


@dataclasses.dataclass
class RangeMessage:
    TYPE_ID: ClassVar[int] = 6
    timestamp: int = 0
    range: float = 0.0
    point: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    beacon_id: int = 0

    def pack_payload(self) -> bytes:
        return struct.pack("<qd3di", self.timestamp, self.range, *self.point, self.beacon_id)

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "RangeMessage":
        v = struct.unpack_from("<qd3di", buf)
        return cls(v[0], v[1], np.asarray(v[2:5]), v[5])


@dataclasses.dataclass
class MagMessage:
    TYPE_ID: ClassVar[int] = 7
    timestamp: int = 0
    field: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def pack_payload(self) -> bytes:
        return struct.pack("<q3d", self.timestamp, *self.field)

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "MagMessage":
        v = struct.unpack_from("<q3d", buf)
        return cls(v[0], np.asarray(v[1:4]))


@dataclasses.dataclass
class PoseStampedMessage:
    TYPE_ID: ClassVar[int] = 8
    timestamp: int = 0
    frame_id: str = "world"
    # [qw qx qy qz tx ty tz]
    pose: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.0, 0, 0, 0, 0, 0, 0]))
    covariance: Optional[np.ndarray] = None  # (6,6) optional

    def pack_payload(self) -> bytes:
        fid = self.frame_id.encode()[:32].ljust(32, b"\0")
        has_cov = self.covariance is not None
        out = struct.pack("<q32s7d?", self.timestamp, fid, *self.pose, has_cov)
        if has_cov:
            out += np.ascontiguousarray(self.covariance, np.float64).tobytes()
        return out

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "PoseStampedMessage":
        fmt = "<q32s7d?"
        vals = struct.unpack_from(fmt, buf)
        off = struct.calcsize(fmt)
        cov = None
        if vals[-1]:
            cov = np.frombuffer(buf[off : off + 36 * 8], np.float64).reshape(6, 6)
        return cls(vals[0], vals[1].rstrip(b"\0").decode(), np.asarray(vals[2:9]), cov)


@dataclasses.dataclass
class MeshMessage:
    TYPE_ID: ClassVar[int] = 9
    timestamp: int = 0
    vertices: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    triangles: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3), np.int32))

    def pack_payload(self) -> bytes:
        v = np.ascontiguousarray(self.vertices, np.float32)
        t = np.ascontiguousarray(self.triangles, np.int32)
        return (
            struct.pack("<qII", self.timestamp, len(v), len(t))
            + v.tobytes()
            + t.tobytes()
        )

    @classmethod
    def unpack_payload(cls, buf: bytes) -> "MeshMessage":
        ts, nv, nt = struct.unpack_from("<qII", buf)
        off = struct.calcsize("<qII")
        v = np.frombuffer(buf[off : off + nv * 12], np.float32).reshape(nv, 3)
        off += nv * 12
        t = np.frombuffer(buf[off : off + nt * 12], np.int32).reshape(nt, 3)
        return cls(ts, v, t)


_TYPES: Dict[int, Type] = {
    cls.TYPE_ID: cls
    for cls in (
        ImageMessage,
        StereoImageMessage,
        ShmImageHeader,
        ImuMessage,
        DepthMessage,
        RangeMessage,
        MagMessage,
        PoseStampedMessage,
        MeshMessage,
    )
}


def encode_message(msg) -> bytes:
    payload = msg.pack_payload()
    return struct.pack("<IHH", MAGIC, msg.TYPE_ID, 1) + payload


def decode_message(buf: bytes):
    magic, type_id, _version = struct.unpack_from("<IHH", buf)
    if magic != MAGIC:
        raise ValueError("bad message magic")
    cls = _TYPES.get(type_id)
    if cls is None:
        raise ValueError(f"unknown message type {type_id}")
    return cls.unpack_payload(buf[struct.calcsize("<IHH"):])
