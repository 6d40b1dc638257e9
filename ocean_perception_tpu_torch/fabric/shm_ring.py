"""ctypes binding for the native shared-memory frame ring (port of
``ocean_perception_tpu.fabric.shm_ring``).

Reference parity: lcm_util/image_subscriber.hpp mmf path — publisher writes
frames into one mapped file, the message carries (path, seq), subscribers map
once and read in place. The port keeps its own copy of the native source
(``fabric/native/shm_ring.cpp``), built at first use with ``make`` (g++) into
the package's git-ignored ``_build/fabric/``. Without a compiler the ring is
unavailable (``native_available()`` is False) and the writer and reader raise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "fabric")
_LIB_PATH = os.path.join(_BUILD_DIR, "libocean_fabric_shm.so")
_lib = None
_lib_lock = threading.Lock()

DTYPE_U8 = 0
DTYPE_F32 = 1


def _load_native():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            # Dependency-checked: no-op when up to date, rebuilds stale libs
            # (e.g. after new native sources were added to the Makefile).
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR, f"BUILD={_BUILD_DIR}"],
                check=True, capture_output=True,
            )
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.shm_ring_create.restype = ctypes.c_void_p
        lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32]
        lib.shm_ring_open.restype = ctypes.c_void_p
        lib.shm_ring_open.argtypes = [ctypes.c_char_p]
        lib.shm_ring_close.argtypes = [ctypes.c_void_p]
        lib.shm_ring_write.restype = ctypes.c_uint64
        lib.shm_ring_write.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.shm_ring_latest_seq.restype = ctypes.c_uint64
        lib.shm_ring_latest_seq.argtypes = [ctypes.c_void_p]
        lib.shm_ring_read.restype = ctypes.c_uint32
        lib.shm_ring_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.shm_ring_slot_bytes.restype = ctypes.c_uint32
        lib.shm_ring_slot_bytes.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


class ShmRingWriter:
    """Producer side of the frame ring."""

    def __init__(self, path: str, n_slots: int = 8, slot_bytes: int = 8 << 20):
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native fabric library unavailable (g++/make missing?)")
        self._lib = lib
        self._handle = lib.shm_ring_create(path.encode(), n_slots, slot_bytes)
        if not self._handle:
            raise OSError(f"failed to create shm ring at {path}")
        self.path = path

    def write(self, timestamp_ns: int, image: np.ndarray) -> int:
        """Write a frame; returns its sequence number."""
        if image.dtype == np.uint8:
            dtype = DTYPE_U8
        else:
            image = np.ascontiguousarray(image, np.float32)
            dtype = DTYPE_F32
        c = 1 if image.ndim == 2 else image.shape[2]
        data = image.tobytes()
        seq = self._lib.shm_ring_write(
            self._handle, timestamp_ns, data, len(data),
            image.shape[1], image.shape[0], c, dtype,
        )
        if seq == 0:
            raise ValueError("frame too large for ring slot")
        return seq

    def close(self) -> None:
        if self._handle:
            self._lib.shm_ring_close(self._handle)
            self._handle = None


class ShmRingReader:
    """Consumer side; maps lazily on first read (ImageSubscriber parity)."""

    def __init__(self, path: str):
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native fabric library unavailable")
        self._lib = lib
        self._handle = lib.shm_ring_open(path.encode())
        if not self._handle:
            raise OSError(f"failed to open shm ring at {path}")
        self._buf_cap = lib.shm_ring_slot_bytes(self._handle)
        self._buf = (ctypes.c_uint8 * self._buf_cap)()

    def latest_seq(self) -> int:
        return int(self._lib.shm_ring_latest_seq(self._handle))

    def read(self, seq: int) -> Optional[Tuple[int, np.ndarray]]:
        """Returns (timestamp_ns, image) or None if the slot was recycled."""
        ts = ctypes.c_int64()
        w = ctypes.c_uint32()
        h = ctypes.c_uint32()
        c = ctypes.c_uint32()
        dt = ctypes.c_uint32()
        n = self._lib.shm_ring_read(
            self._handle, seq, self._buf, self._buf_cap,
            ctypes.byref(ts), ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(c), ctypes.byref(dt),
        )
        if n == 0:
            return None
        # NOT bytes(self._buf[:n]) — slicing a c_uint8 array materializes a
        # Python int PER BYTE (measured: 3.7 MB frame -> ~50 ms, 17 fps).
        raw = ctypes.string_at(self._buf, n)
        if dt.value == DTYPE_U8:
            arr = np.frombuffer(raw, np.uint8)
        else:
            arr = np.frombuffer(raw, np.float32)
        shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
        return int(ts.value), arr.reshape(shape)

    def read_latest(self) -> Optional[Tuple[int, np.ndarray]]:
        seq = self.latest_seq()
        return self.read(seq) if seq > 0 else None

    def close(self) -> None:
        if self._handle:
            self._lib.shm_ring_close(self._handle)
            self._handle = None
