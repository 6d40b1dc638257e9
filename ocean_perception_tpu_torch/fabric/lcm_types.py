"""LCM type marshalling: the reference's actual wire encoding
(a copy of ``ocean_perception_tpu.fabric.lcm_types``).

The reference fleet speaks LCM (Lightweight Communications and Marshalling,
lcm-proj.github.io) — its 16 schemas live in the reference's lcmtypes/*.lcm
and are compiled by lcm-gen at build time (lcmtypes/CMakeLists.txt). This
module implements the LCM *binary encoding* and *type fingerprint* algorithms
from the published specification so our nodes can exchange those exact
messages with unmodified reference-era producers/consumers (sensor publishers,
the Unity FarmSim bridge, lcm-spy):

- primitives are big-endian; ``string`` is an i32 length (including the
  terminating NUL) + bytes + NUL; arrays are row-major with variable sizes
  given by a previously-decoded struct member;
- every encoded top-level message is prefixed by an 8-byte fingerprint:
  the struct's lcm-gen base hash combined recursively with its members'
  hashes, each level rotated left by one bit (matches the generated
  ``_hash_recursive`` functions);
- the base hash folds member names, primitive type names and array
  dimensionality through ``h = ((h << 8) ^ (h >> 55)) + c`` starting from
  0x12345678 (lcm-gen's ``lcm_struct_hash``).

Schemas are declared with the same member order/names/types as the
reference's .lcm files (cited per struct), NOT copied code — the .lcm files
are interface definitions and the byte-level contract is the point.
"""

from __future__ import annotations

import struct as _struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

_U64 = (1 << 64) - 1

# Primitive name -> (struct format, size). byte/boolean are 1 byte each.
_PRIM_FMT = {
    "int8_t": ">b",
    "int16_t": ">h",
    "int32_t": ">i",
    "int64_t": ">q",
    "byte": ">B",
    "boolean": ">b",
    "float": ">f",
    "double": ">d",
}
PRIMITIVES = set(_PRIM_FMT) | {"string"}


def _hash_update(v: int, c: int) -> int:
    """One step of lcm-gen's definition hash: ((v << 8) ^ (v >> 55)) + c on a
    signed 64-bit value (the right shift is arithmetic)."""
    v &= _U64
    sv = v - (1 << 64) if v & (1 << 63) else v
    return (((v << 8) & _U64) ^ ((sv >> 55) & _U64)) + c & _U64


def _hash_string_update(v: int, s: str) -> int:
    v = _hash_update(v, len(s))
    for ch in s.encode("ascii"):
        v = _hash_update(v, ch)
    return v


# Array dimension: ("const", n) or ("var", "member_name"). lcm-gen hashes the
# mode as LCM_CONST=0 / LCM_VAR=1 and the size as its source string.
Dim = Tuple[str, Union[int, str]]


@dataclass(frozen=True)
class Member:
    name: str
    type: Union[str, "LcmStructDef"]  # primitive name or nested struct def
    dims: Tuple[Dim, ...] = ()


@dataclass(frozen=True)
class LcmStructDef:
    package: str
    name: str
    members: Tuple[Member, ...]

    @property
    def full_name(self) -> str:
        return f"{self.package}.{self.name}"

    # -- fingerprint ---------------------------------------------------------

    def base_hash(self) -> int:
        """lcm-gen's per-struct definition hash (lcmgen.c lcm_struct_hash)."""
        v = 0x12345678
        for m in self.members:
            v = _hash_string_update(v, m.name)
            if isinstance(m.type, str):  # primitive: type name participates
                v = _hash_string_update(v, m.type)
            v = _hash_update(v, len(m.dims))
            for mode, size in m.dims:
                v = _hash_update(v, 0 if mode == "const" else 1)
                v = _hash_string_update(v, str(size))
        return v

    def hash_recursive(self, parents: Tuple["LcmStructDef", ...] = ()) -> int:
        """Runtime hash: base + children's recursive hashes, rotl1 per level
        (matches generated ``__<type>_hash_recursive``). Recursion through a
        type already on the parent chain contributes 0."""
        if self in parents:
            return 0
        chain = parents + (self,)
        h = self.base_hash()
        for m in self.members:
            if isinstance(m.type, LcmStructDef):
                h = (h + m.type.hash_recursive(chain)) & _U64
        h &= _U64
        return (((h << 1) & _U64) + (h >> 63)) & _U64

    def fingerprint(self) -> bytes:
        # Cached: encode() prefixes and decode() checks it on EVERY message,
        # and the per-character hash walk over the whole type tree is far too
        # slow for a 200 Hz hot path. The def is frozen, so it never changes.
        fp = self.__dict__.get("_fp")
        if fp is None:
            fp = _struct.pack(">Q", self.hash_recursive())
            object.__setattr__(self, "_fp", fp)
        return fp

    # -- encode --------------------------------------------------------------

    def encode(self, values: dict) -> bytes:
        """Top-level message encoding: fingerprint + fields."""
        return self.fingerprint() + self.encode_fields(values)

    def encode_fields(self, values: dict) -> bytes:
        out: List[bytes] = []
        for m in self.members:
            self._encode_member(m, values, out)
        return b"".join(out)

    def _encode_member(self, m: Member, values: dict, out: List[bytes]) -> None:
        v = values[m.name]
        if not m.dims:
            out.append(self._encode_scalar(m.type, v))
            return
        sizes = [d[1] if d[0] == "const" else int(values[d[1]]) for d in m.dims]
        if m.type == "byte" and len(sizes) == 1:  # fast path: raw byte block
            b = bytes(v)
            if len(b) != sizes[0]:
                raise ValueError(f"{m.name}: {len(b)} bytes != declared {sizes[0]}")
            out.append(b)
            return
        self._encode_array(m.type, v, sizes, out)

    def _encode_array(self, t, v, sizes: List[int], out: List[bytes]) -> None:
        if len(v) != sizes[0]:
            raise ValueError(f"array length {len(v)} != declared {sizes[0]}")
        for item in v:
            if len(sizes) > 1:
                self._encode_array(t, item, sizes[1:], out)
            else:
                out.append(self._encode_scalar(t, item))

    @staticmethod
    def _encode_scalar(t, v) -> bytes:
        if isinstance(t, LcmStructDef):
            return t.encode_fields(v)
        if t == "string":
            b = str(v).encode("utf-8")
            return _struct.pack(">i", len(b) + 1) + b + b"\0"
        if t == "boolean":
            v = 1 if v else 0
        elif t != "float" and t != "double":
            v = int(v)
        return _struct.pack(_PRIM_FMT[t], v)

    # -- decode --------------------------------------------------------------

    def decode(self, buf: bytes) -> dict:
        """Top-level message decoding; verifies the fingerprint."""
        if buf[:8] != self.fingerprint():
            raise ValueError(
                f"fingerprint mismatch for {self.full_name}: "
                f"{buf[:8].hex()} != {self.fingerprint().hex()}"
            )
        values, _ = self.decode_fields(buf, 8)
        return values

    def decode_fields(self, buf: bytes, off: int) -> Tuple[dict, int]:
        values: dict = {}
        for m in self.members:
            if not m.dims:
                values[m.name], off = self._decode_scalar(m.type, buf, off)
                continue
            sizes = [d[1] if d[0] == "const" else int(values[d[1]]) for d in m.dims]
            # A corrupt payload with a valid fingerprint can carry negative
            # or oversized variable dims; a negative byte-count would slice
            # to b'' and WALK off BACKWARD, silently decoding every later
            # field from wrong offsets.
            if any(s < 0 for s in sizes):
                raise ValueError(f"negative array dim in {self.full_name}.{m.name}")
            if m.type == "byte" and len(sizes) == 1:
                if off + sizes[0] > len(buf):
                    raise ValueError(f"truncated {self.full_name}.{m.name}")
                values[m.name] = bytes(buf[off : off + sizes[0]])
                off += sizes[0]
                continue
            values[m.name], off = self._decode_array(m.type, buf, off, sizes)
        return values, off

    def _decode_array(self, t, buf: bytes, off: int, sizes: List[int]):
        out = []
        for _ in range(sizes[0]):
            if len(sizes) > 1:
                item, off = self._decode_array(t, buf, off, sizes[1:])
            else:
                item, off = self._decode_scalar(t, buf, off)
            out.append(item)
        return out, off

    @staticmethod
    def _decode_scalar(t, buf: bytes, off: int):
        if isinstance(t, LcmStructDef):
            return t.decode_fields(buf, off)
        if t == "string":
            (n,) = _struct.unpack_from(">i", buf, off)
            off += 4
            s = buf[off : off + n - 1].decode("utf-8")  # n includes the NUL
            return s, off + n
        (v,) = _struct.unpack_from(_PRIM_FMT[t], buf, off)
        if t == "boolean":
            v = bool(v)
        return v, off + _struct.calcsize(_PRIM_FMT[t])


# ---------------------------------------------------------------------------
# The reference's schema set (lcmtypes/*.lcm, package `vehicle`). Member
# order/names/types mirror the .lcm files exactly — that IS the wire contract.
# ---------------------------------------------------------------------------

def _d(n: int) -> Tuple[Dim, ...]:
    return (("const", n),)


def _v(name: str) -> Tuple[Dim, ...]:
    return (("var", name),)


# lcmtypes/header_t.lcm
HEADER_T = LcmStructDef("vehicle", "header_t", (
    Member("timestamp", "int64_t"),
    Member("seq", "int64_t"),
    Member("frame_id", "string"),
))

# lcmtypes/vector3_t.lcm
VECTOR3_T = LcmStructDef("vehicle", "vector3_t", (
    Member("x", "double"), Member("y", "double"), Member("z", "double"),
))

# lcmtypes/quaternion_t.lcm
QUATERNION_T = LcmStructDef("vehicle", "quaternion_t", (
    Member("w", "double"), Member("x", "double"),
    Member("y", "double"), Member("z", "double"),
))

# lcmtypes/pose3_t.lcm
POSE3_T = LcmStructDef("vehicle", "pose3_t", (
    Member("position", VECTOR3_T),
    Member("orientation", QUATERNION_T),
))

# lcmtypes/pose3_stamped_t.lcm
POSE3_STAMPED_T = LcmStructDef("vehicle", "pose3_stamped_t", (
    Member("header", HEADER_T),
    Member("pose", POSE3_T),
))

# EXTENSION (not in the reference's lcmtypes): an absolute pose fix WITH
# covariance. pose3_stamped_t cannot carry the weight a fusion consumer
# needs — dropping it on the wire would make receive_pose substitute its
# default and fuse external fixes arbitrarily over/under-confident.
# PoseStampedMessage with covariance=None still rides plain pose3_stamped_t,
# so reference-era peers interoperate on the type they know.
POSE3_COV_STAMPED_T = LcmStructDef("vehicle", "pose3_cov_stamped_t", (
    Member("header", HEADER_T),
    Member("pose", POSE3_T),
    Member("covariance", "double", _d(36)),  # row-major 6x6, [t, theta]
))

# lcmtypes/imu_measurement_t.lcm
IMU_MEASUREMENT_T = LcmStructDef("vehicle", "imu_measurement_t", (
    Member("header", HEADER_T),
    Member("linear_acc", VECTOR3_T),
    Member("angular_vel", VECTOR3_T),
))

# lcmtypes/depth_measurement_t.lcm
DEPTH_MEASUREMENT_T = LcmStructDef("vehicle", "depth_measurement_t", (
    Member("header", HEADER_T),
    Member("depth", "double"),
))

# lcmtypes/range_measurement_t.lcm
RANGE_MEASUREMENT_T = LcmStructDef("vehicle", "range_measurement_t", (
    Member("header", HEADER_T),
    Member("range", "double"),
    Member("point", VECTOR3_T),
))

# lcmtypes/mag_measurement_t.lcm
MAG_MEASUREMENT_T = LcmStructDef("vehicle", "mag_measurement_t", (
    Member("header", HEADER_T),
    Member("field", VECTOR3_T),
))

# lcmtypes/image_t.lcm
IMAGE_T = LcmStructDef("vehicle", "image_t", (
    Member("width", "int32_t"),
    Member("height", "int32_t"),
    Member("channels", "int32_t"),
    Member("format", "string"),
    Member("encoding", "string"),
    Member("size", "int32_t"),
    Member("data", "byte", _v("size")),
))

# lcmtypes/stereo_image_t.lcm
STEREO_IMAGE_T = LcmStructDef("vehicle", "stereo_image_t", (
    Member("header", HEADER_T),
    Member("img_left", IMAGE_T),
    Member("img_right", IMAGE_T),
))

# lcmtypes/mmf_image_t.lcm
MMF_IMAGE_T = LcmStructDef("vehicle", "mmf_image_t", (
    Member("width", "int32_t"),
    Member("height", "int32_t"),
    Member("channels", "int32_t"),
    Member("format", "string"),
    Member("encoding", "string"),
    Member("mm_filename", "string"),
    Member("offset", "int32_t"),
    Member("size", "int32_t"),
))

# lcmtypes/mmf_stereo_image_t.lcm
MMF_STEREO_IMAGE_T = LcmStructDef("vehicle", "mmf_stereo_image_t", (
    Member("header", HEADER_T),
    Member("img_left", MMF_IMAGE_T),
    Member("img_right", MMF_IMAGE_T),
))

# lcmtypes/mesh_triangle_t.lcm
MESH_TRIANGLE_T = LcmStructDef("vehicle", "mesh_triangle_t", (
    Member("vertex_indices", "int32_t", _d(3)),
))

# lcmtypes/mesh_t.lcm
MESH_T = LcmStructDef("vehicle", "mesh_t", (
    Member("num_vertices", "int32_t"),
    Member("vertices", VECTOR3_T, _v("num_vertices")),
    Member("num_triangles", "int32_t"),
    Member("triangles", MESH_TRIANGLE_T, _v("num_triangles")),
))

# lcmtypes/mesh_stamped_t.lcm
MESH_STAMPED_T = LcmStructDef("vehicle", "mesh_stamped_t", (
    Member("header", HEADER_T),
    Member("mesh", MESH_T),
))

ALL_TYPES: Tuple[LcmStructDef, ...] = (
    HEADER_T, VECTOR3_T, QUATERNION_T, POSE3_T, POSE3_STAMPED_T,
    POSE3_COV_STAMPED_T,
    IMU_MEASUREMENT_T, DEPTH_MEASUREMENT_T, RANGE_MEASUREMENT_T,
    MAG_MEASUREMENT_T, IMAGE_T, STEREO_IMAGE_T, MMF_IMAGE_T,
    MMF_STEREO_IMAGE_T, MESH_TRIANGLE_T, MESH_T, MESH_STAMPED_T,
)

# Receivers resolve the decoder from the wire fingerprint (the LCM frame
# carries channel + fingerprint, not a type name).
FINGERPRINT_REGISTRY: Dict[bytes, LcmStructDef] = {
    t.fingerprint(): t for t in ALL_TYPES
}


def decode_by_fingerprint(buf: bytes) -> Tuple[Optional[LcmStructDef], Optional[dict]]:
    """Decode a payload whose type is identified by its 8-byte fingerprint.
    Returns (def, values) or (None, None) for an unknown fingerprint."""
    sd = FINGERPRINT_REGISTRY.get(bytes(buf[:8]))
    if sd is None:
        return None, None
    return sd, sd.decode(buf)


def make_header(timestamp: int, seq: int = -1, frame_id: str = "body") -> dict:
    """header_t with the reference's conventions (state_estimator_lcm.cpp:238
    fills seq=-1, frame_id="body")."""
    return {"timestamp": int(timestamp), "seq": int(seq), "frame_id": frame_id}
