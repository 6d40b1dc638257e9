"""Native UDP-multicast bus: the C++ transport behind the PubSub interface
(port of ``ocean_perception_tpu.fabric.native_bus``).

The reference's fabric is LCM — a C library doing UDP multicast with
fragmentation (SURVEY §5.8). ``fabric/native/udp_bus.cpp`` is this
framework's native equivalent; the wire format is byte-compatible with the
pure-Python ``UdpMulticastBus`` (and the LCM mode with ``LcmUdpBus``), so
native and Python peers of either package interoperate on the same bus.
Reassembly and the socket hot path live in C++; this wrapper only runs the
receive thread and dispatches decoded messages to subscribers.

The port keeps its own copy of the source, built at first use with ``make``
(g++) into the package's git-ignored ``_build/fabric/``, by the Makefile
that builds the shared-memory ring. A bus that cannot be built raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from .messages import decode_message, encode_message
from .pubsub import DEFAULT_GROUP, DEFAULT_PORT, PubSub

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "fabric")
_LIB_PATH = os.path.join(_BUILD_DIR, "libocean_fabric_udp.so")
_lib = None
_lib_error: Optional[str] = None
_lib_lock = threading.Lock()


def _load_native():
    """The library, built if stale; None (the reason in ``_lib_error``)
    when it cannot be built or loaded."""
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            # make is dependency-checked: a fresh checkout builds, an
            # up-to-date lib is a no-op, a stale lib (new sources) rebuilds.
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR, f"BUILD={_BUILD_DIR}", "udp"],
                check=True, capture_output=True, text=True,
            )
        except (OSError, subprocess.CalledProcessError) as e:
            # No make, or the source did not build: keep the compiler's output.
            _lib_error = f"{e}\n{getattr(e, 'stdout', '')}{getattr(e, 'stderr', '')}"
            if not os.path.exists(_LIB_PATH):
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _lib_error = f"{_LIB_PATH}: {e}"
            return None
        lib.udp_bus_create.restype = ctypes.c_void_p
        lib.udp_bus_create.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
        lib.udp_bus_create_lcm.restype = ctypes.c_void_p
        lib.udp_bus_create_lcm.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
        lib.udp_bus_close.argtypes = [ctypes.c_void_p]
        lib.udp_bus_send.restype = ctypes.c_int
        lib.udp_bus_send.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.udp_bus_poll.restype = ctypes.c_int64
        lib.udp_bus_poll.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


class NativeUdpBus(PubSub):
    """PubSub over the C++ transport. Drop-in for UdpMulticastBus."""

    _CREATE = "udp_bus_create"

    def __init__(self, group: str = DEFAULT_GROUP, port: int = DEFAULT_PORT, ttl: int = 0):
        lib = _load_native()
        if lib is None:
            raise RuntimeError(f"native UDP bus library unavailable: {_lib_error}")
        self._lib = lib
        self._h = getattr(lib, self._CREATE)(group.encode(), port, ttl)
        if not self._h:
            raise OSError(f"{self._CREATE} failed for {group}:{port}")
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._tap: Optional[Callable] = None
        self._buf = ctypes.create_string_buffer(32 << 20)
        self._ch = ctypes.create_string_buffer(512)
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._send_lock = threading.Lock()

    # Payload codec — the transport carries opaque bytes; subclasses swap
    # the encoding (NativeLcmBus uses the LCM type encoding).
    def _encode(self, message) -> bytes:
        return encode_message(message)

    def _decode(self, payload: bytes):
        return decode_message(payload)

    def publish(self, channel: str, message) -> None:
        payload = self._encode(message)
        with self._send_lock:
            rc = self._lib.udp_bus_send(self._h, channel.encode(), payload, len(payload))
        if rc != 0:
            raise OSError(f"udp_bus_send failed on {channel}")

    def subscribe(self, channel: str, callback: Callable) -> None:
        self._subs[channel].append(callback)
        self._start_rx()

    def set_tap(self, callback: Optional[Callable]) -> None:
        self._tap = callback
        if callback is not None:
            self._start_rx()

    def _start_rx(self) -> None:
        if self._thread is None:
            self._running.set()
            self._thread = threading.Thread(target=self._rx_loop, daemon=True)
            self._thread.start()

    def _rx_loop(self) -> None:
        while self._running.is_set():
            n = self._lib.udp_bus_poll(
                self._h, self._buf, len(self._buf), self._ch, len(self._ch), 200
            )
            if n <= 0:
                continue  # timeout or non-fatal error
            try:
                channel = self._ch.value.decode()
                cbs = self._subs.get(channel)
                if not cbs and self._tap is None:
                    continue
                # NOT self._buf.raw[:n] — .raw copies the whole 32 MB buffer
                # per message (measured: capped the bus at ~60 msg/s).
                msg = self._decode(ctypes.string_at(self._buf, n))
                if msg is None:
                    continue  # unmapped/foreign payload type
                if self._tap is not None:
                    self._tap(channel, msg)
                for cb in cbs or ():
                    cb(channel, msg)
            except Exception:  # noqa: BLE001 — the rx thread must survive
                # A decode failure or subscriber exception must not kill the
                # daemon receive thread (the bus would then silently drop all
                # traffic for the process lifetime).
                import traceback

                traceback.print_exc()

    def close(self) -> None:
        self._running.clear()
        stuck = False
        if self._thread is not None:
            self._thread.join(timeout=1)
            stuck = self._thread.is_alive()
            self._thread = None
        if self._h:
            if stuck:
                # A subscriber callback is still running on the rx thread:
                # freeing the bus under it is a use-after-free. Leak the
                # handle instead (process exit reclaims it).
                return
            self._lib.udp_bus_close(self._h)
            self._h = None


class NativeLcmBus(NativeUdpBus):
    """C++ transport speaking the REAL LCM wire protocol (LC02/LC03 framing
    in udp_bus.cpp, vehicle.* lcmtypes payloads via fabric/lcm_wire.py's
    bridge) — the native-runtime path into a session with unmodified LCM
    peers. mmf image descriptors are a Python-side feature; use
    fabric.lcm_wire.LcmUdpBus where inbound mmf frames are expected."""

    _CREATE = "udp_bus_create_lcm"

    def _encode(self, message) -> bytes:
        from .lcm_wire import to_lcm

        sd, values = to_lcm(message)
        return sd.encode(values)

    def _decode(self, payload: bytes):
        from .lcm_types import decode_by_fingerprint
        from .lcm_wire import from_lcm

        sd, values = decode_by_fingerprint(payload)
        if sd is None:
            return None
        return from_lcm(sd, values)


def bus_class(native: bool, lcm: bool):
    """The bus a node's ``--native-bus`` / ``--lcm`` flags select."""
    if native:
        return NativeLcmBus if lcm else NativeUdpBus
    if lcm:
        from .lcm_wire import LcmUdpBus

        return LcmUdpBus
    from .pubsub import UdpMulticastBus

    return UdpMulticastBus
