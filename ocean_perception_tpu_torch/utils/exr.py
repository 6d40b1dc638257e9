"""Minimal OpenEXR scanline reader (host-side, no external deps)
(a copy of ``ocean_perception_tpu.utils.exr``).

Supports the subset the datasets need: single-part scanline files,
NONE/ZIPS/ZIP compression, HALF/FLOAT/UINT channels. Used for the Sea-thru
depth maps bundled with the reference fixtures
(test/resources/test_images_enhance/depth/*.exr) and any EuRoC-style depth
exports. Returns float32 numpy arrays (H, W) or (H, W, C) with channels in
alphabetical order (EXR storage order).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0x01312F76

_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP scanlines/block


def _read_attr_header(buf: bytes, pos: int):
    attrs = {}
    while True:
        end = buf.index(b"\0", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = buf.index(b"\0", pos)
        typ = buf[pos:end].decode()
        pos = end + 1
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size
    return attrs, pos


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    channels = []
    pos = 0
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        ptype = struct.unpack_from("<i", data, pos)[0]
        pos += 16  # pixel type + pLinear/reserved + xSampling + ySampling
        channels.append((name, ptype))
    return channels


def _unzip_block(data: bytes, expected: int) -> bytes:
    raw = zlib.decompress(data)
    if len(raw) != expected:
        raise ValueError(f"EXR zip block: got {len(raw)} bytes, expected {expected}")
    # Undo delta predictor: t[i] += t[i-1] - 128 (mod 256), in cumsum form.
    base = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
    deltas = base.copy()
    deltas[1:] -= 128
    restored = np.cumsum(deltas) % 256
    restored = restored.astype(np.uint8)
    # Un-interleave: first half -> even indices, second half -> odd.
    out = np.empty_like(restored)
    half = (len(restored) + 1) // 2
    out[0::2] = restored[:half]
    out[1::2] = restored[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    attrs, pos = _read_attr_header(buf, 8)

    channels = _parse_channels(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    if compression not in _COMPRESSION_LINES:
        raise NotImplementedError(f"EXR compression {compression} not supported")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    W = x1 - x0 + 1
    H = y1 - y0 + 1

    lines_per_block = _COMPRESSION_LINES[compression]
    n_blocks = (H + lines_per_block - 1) // lines_per_block

    # Scanline offset table.
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)

    bytes_per_px = {name: np.dtype(_PIXEL_DTYPES[t]).itemsize for name, t in channels}
    line_bytes = sum(W * b for b in bytes_per_px.values())

    out = {name: np.zeros((H, W), dtype=np.float32) for name, _ in channels}

    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        block_y0 = y - y0
        n_lines = min(lines_per_block, H - block_y0)
        expected = line_bytes * n_lines
        if compression == 0 or size == expected:
            raw = data
        else:
            raw = _unzip_block(data, expected)
        p = 0
        for line in range(n_lines):
            for name, ptype in channels:  # EXR stores channels alphabetically
                dt = _PIXEL_DTYPES[ptype]
                nbytes = W * np.dtype(dt).itemsize
                row = np.frombuffer(raw[p : p + nbytes], dtype=dt)
                out[name][block_y0 + line] = row.astype(np.float32)
                p += nbytes

    names = [name for name, _ in channels]
    if len(names) == 1:
        return out[names[0]]
    return np.stack([out[n] for n in names], axis=-1)
