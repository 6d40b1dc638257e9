"""Channel-based pub/sub: in-process bus + UDP multicast bus
(a copy of ``ocean_perception_tpu.fabric.pubsub``).

Reference parity: LCM's model — named channels, fire-and-forget publish,
per-channel subscribe callbacks, UDP multicast transport (default group
239.255.76.67:7667, the LCM default, so wire debugging tools feel familiar).
Large payloads are fragmented (LCM-style) since UDP datagrams cap at ~64 KB.
The in-process bus serves single-process pipelines and tests with identical
semantics.
"""

from __future__ import annotations

import socket
import struct
import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from .messages import decode_message, encode_message

DEFAULT_GROUP = "239.255.76.67"
DEFAULT_PORT = 7667
_MAX_DGRAM = 60000
_FRAG_MAGIC = 0xF4A6


class PubSub:
    """Interface: publish(channel, message), subscribe(channel, cb)."""

    def publish(self, channel: str, message) -> None:
        raise NotImplementedError

    def subscribe(self, channel: str, callback: Callable) -> None:
        raise NotImplementedError

    def set_tap(self, callback: Optional[Callable]) -> None:
        """Observability hook: callback(channel, message) for EVERY decoded
        message regardless of subscriptions (channel_spy uses this)."""
        self._tap = callback

    def close(self) -> None:
        pass


def open_multicast_pair(group: str, port: int, ttl: int):
    """(tx, rx) UDP multicast sockets with the fabric's standard options —
    shared by the in-house and LCM-wire buses so socket fixes land in both."""
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
    tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    # Fragment bursts (large images) overflow the default ~208 KB buffer —
    # and the kernel SILENTLY CAPS SO_RCVBUF at net.core.rmem_max (4 MB on
    # this image), below ONE raw-f32 720p stereo message (7.4 MB ≈ 124
    # fragments). SO_RCVBUFFORCE (CAP_NET_ADMIN) lifts the cap; fall back to
    # the capped request otherwise.
    SO_RCVBUFFORCE = 33  # linux/socket.h
    try:
        rx.setsockopt(socket.SOL_SOCKET, SO_RCVBUFFORCE, 32 << 20)
    except OSError:
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("", port))
    mreq = struct.pack("4s4s", socket.inet_aton(group), socket.inet_aton("0.0.0.0"))
    rx.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
    rx.settimeout(0.2)
    return tx, rx


class InProcessBus(PubSub):
    """Synchronous loopback bus (deterministic; used by tests and tools)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._tap: Optional[Callable] = None

    def publish(self, channel: str, message) -> None:
        # Encode/decode round trip preserves wire semantics.
        data = encode_message(message)
        decoded = decode_message(data)
        if self._tap is not None:
            self._tap(channel, decoded)
        for cb in self._subs.get(channel, []):
            cb(channel, decoded)

    def subscribe(self, channel: str, callback: Callable) -> None:
        self._subs[channel].append(callback)


class UdpMulticastBus(PubSub):
    """LCM-style UDP multicast transport with fragmentation."""

    def __init__(self, group: str = DEFAULT_GROUP, port: int = DEFAULT_PORT, ttl: int = 0):
        self.group = group
        self.port = port
        self._tx, self._rx = open_multicast_pair(group, port, ttl)
        self._tap: Optional[Callable] = None
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        # Reassembly keyed by (sender addr, seq): every publisher's seq
        # counter starts at 1, so seq alone interleaves chunks from two
        # concurrent senders into a corrupted payload (LCM keys per sender).
        self._fragments: Dict[tuple, Dict[int, bytes]] = {}
        self._seq = 0
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish(self, channel: str, message) -> None:
        payload = encode_message(message)
        ch = channel.encode()
        header = struct.pack("<H", len(ch)) + ch
        data = header + payload
        if len(data) <= _MAX_DGRAM:
            self._tx.sendto(b"\x00\x00" + data, (self.group, self.port))
            return
        # Fragment.
        self._seq = (self._seq + 1) & 0xFFFFFFFF
        n_frags = (len(data) + _MAX_DGRAM - 1) // _MAX_DGRAM
        for i in range(n_frags):
            chunk = data[i * _MAX_DGRAM : (i + 1) * _MAX_DGRAM]
            frag_header = struct.pack("<HIHH", _FRAG_MAGIC, self._seq, i, n_frags)
            self._tx.sendto(frag_header + chunk, (self.group, self.port))

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

    def _dispatch(self, data: bytes) -> None:
        (n_ch,) = struct.unpack_from("<H", data)
        channel = data[2 : 2 + n_ch].decode()
        payload = data[2 + n_ch :]
        cbs = self._subs.get(channel)
        if not cbs and self._tap is None:
            return
        msg = decode_message(payload)
        if self._tap is not None:
            self._tap(channel, msg)
        for cb in cbs or ():
            cb(channel, msg)

    def _rx_loop(self) -> None:
        while self._running.is_set():
            try:
                pkt, sender = self._rx.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                tag = struct.unpack_from("<H", pkt)[0]
                if tag == 0:
                    self._dispatch(pkt[2:])
                elif tag == _FRAG_MAGIC:
                    _, seq, idx, total = struct.unpack_from("<HIHH", pkt)
                    off = struct.calcsize("<HIHH")
                    key = (sender, seq)
                    if key not in self._fragments and len(self._fragments) >= 64:
                        # Evict the oldest partial (insertion order) so
                        # sustained fragment loss stays bounded without
                        # killing live reassemblies from other senders.
                        self._fragments.pop(next(iter(self._fragments)))
                    frags = self._fragments.setdefault(key, {})
                    frags[idx] = pkt[off:]
                    if len(frags) == total:
                        data = b"".join(frags[i] for i in range(total))
                        del self._fragments[key]
                        self._dispatch(data)
            except Exception:  # noqa: BLE001 — the rx thread must survive
                # A malformed packet or a subscriber callback exception must
                # not kill the daemon receive thread (the process would then
                # silently drop all traffic for its lifetime).
                import traceback

                traceback.print_exc()

    def close(self) -> None:
        self._running.clear()
        if self._thread is not None:
            self._thread.join(timeout=1)
        self._tx.close()
        self._rx.close()
