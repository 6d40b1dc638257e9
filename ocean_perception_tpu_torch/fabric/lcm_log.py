"""LCM log-file format: record and replay (lcm-logger / lcm-logplayer parity).

The reference's operational workflow records missions with the stock LCM
tooling (README.md:63-67 — sensor drivers, the Unity simulator, and the
estimator nodes all meet on LCM; `lcm-logger` captures a session and
`lcm-logplayer` re-drives it). This module implements the same on-disk
event format, so

- logs written here replay in stock ``lcm-logplayer`` / load in
  ``lcm.EventLog``'s Python reader, and
- logs captured by stock ``lcm-logger`` against a reference-era vehicle
  replay into our nodes (and load as a dataset — datasets/lcm_log.py).

Wire format (one event, all fields BIG-endian — lcm/lcm_eventlog.c):

    u32  sync        = 0xEDA1DA01
    u64  eventnum    (monotonically increasing, starts at 0)
    u64  timestamp   (microseconds since the epoch; receive time)
    u32  channel_len
    u32  data_len
    channel_len bytes of channel name (no NUL)
    data_len bytes of raw LCM payload (fingerprint + encoded fields)

The reader resynchronizes on the sync word after a torn/corrupted event
(exactly what lcm-logplayer does), so a log truncated by a crash loses at
most the final event.

A copy of ``ocean_perception_tpu.fabric.lcm_log``, on the port's ``lcm_types``
and ``lcm_wire``.
"""

from __future__ import annotations

import io
import os
import re
import struct
import threading
import time
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

SYNC_WORD = 0xEDA1DA01
_HEADER = struct.Struct(">IQQII")  # sync, eventnum, utime, channel_len, data_len
# Sanity caps used during resync: LCM channel names are short (the C
# implementation caps them well under this) and payloads are bounded by
# what the UDP layer will reassemble. Anything larger is a corrupt header.
_MAX_CHANNEL = 1024
_MAX_DATA = 256 << 20


class LogEvent(NamedTuple):
    eventnum: int
    timestamp_us: int  # receive time, microseconds since epoch
    channel: str
    data: bytes


class LcmLogWriter:
    """Append LCM events to a log file. Thread-safe (recorders write from a
    bus rx thread while the owner may flush/close from another)."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        mode = "ab" if append else "wb"
        self._f: Optional[io.BufferedWriter] = open(path, mode)
        self._lock = threading.Lock()
        self._eventnum = 0
        if append and os.path.getsize(path) > 0:
            # Continue the event numbering of the existing log.
            last = None
            with LcmLogReader(path) as reader:
                for last in reader:
                    pass
            if last is not None:
                self._eventnum = last.eventnum + 1

    def write(self, channel: str, data: bytes, timestamp_us: Optional[int] = None) -> int:
        """Append one event; returns its eventnum. ``timestamp_us`` defaults
        to the current wall clock (lcm-logger semantics: receive time)."""
        if timestamp_us is None:
            timestamp_us = int(time.time() * 1e6)
        ch = channel.encode()
        with self._lock:
            f = self._f
            if f is None:
                raise ValueError("writer is closed")
            num = self._eventnum
            self._eventnum += 1
            f.write(_HEADER.pack(SYNC_WORD, num, timestamp_us, len(ch), len(data)))
            f.write(ch)
            f.write(data)
        return num

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LcmLogReader:
    """Iterate events of an LCM log; resyncs past corruption.

    Also supports random access by file offset (``read_at``) so consumers
    can index a log once and lazily decode big payloads later
    (datasets/lcm_log.py does this for stereo frames).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._lock = threading.Lock()

    # -- sequential ------------------------------------------------------

    def events(self, with_offsets: bool = False) -> Iterator:
        """Yield LogEvent (or (offset, LogEvent) when with_offsets).

        Iteration uses its own file handle, so ``read_at`` stays usable
        mid-iteration (the lock only guards the shared random-access
        handle)."""
        with open(self.path, "rb") as f:
            while True:
                off = f.tell()
                ev = self._read_event(f)
                if ev is None:
                    return
                if ev is _RESYNC:
                    continue
                yield (off, ev) if with_offsets else ev

    def __iter__(self) -> Iterator[LogEvent]:
        return self.events()

    def read_at(self, offset: int) -> LogEvent:
        """Read the single event at a known file offset."""
        with self._lock:
            self._f.seek(offset)
            ev = self._read_event(self._f)
        if ev is None or ev is _RESYNC:
            raise ValueError(f"no valid event at offset {offset} of {self.path}")
        return ev

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals -------------------------------------------------------

    def _read_event(self, f):
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            return None
        sync, num, utime, clen, dlen = _HEADER.unpack(head)
        if sync != SYNC_WORD or clen > _MAX_CHANNEL or dlen > _MAX_DATA:
            # Corrupt header: scan forward for the next sync word, one byte
            # past where this header started.
            if not self._resync(f, f.tell() - _HEADER.size + 1):
                return None
            return _RESYNC
        ch = f.read(clen)
        data = f.read(dlen)
        if len(ch) < clen or len(data) < dlen:
            return None  # truncated final event (crash mid-write)
        try:
            channel = ch.decode()
        except UnicodeDecodeError:
            if not self._resync(f, f.tell() - dlen - clen - _HEADER.size + 1):
                return None
            return _RESYNC
        return LogEvent(num, utime, channel, data)

    @staticmethod
    def _resync(f, start: int) -> bool:
        magic = struct.pack(">I", SYNC_WORD)
        f.seek(start)
        buf = b""
        base = start
        while True:
            chunk = f.read(1 << 16)
            if not chunk:
                return False
            buf += chunk
            i = buf.find(magic)
            if i >= 0:
                f.seek(base + i)
                return True
            base += len(buf) - 3
            buf = buf[-3:]  # keep a possible split magic prefix


_RESYNC = object()  # sentinel: a corrupt region was skipped


# ---------------------------------------------------------------------------
# Bus recording
# ---------------------------------------------------------------------------


class BusRecorder:
    """Record a live bus session to an LCM log (lcm-logger parity).

    - On :class:`~.lcm_wire.LcmUdpBus`, events are the exact reassembled
      wire payloads (foreign types included — a logger must not be lossy).
    - On the in-house transports (UdpMulticastBus / InProcessBus /
      NativeBus), decoded messages are re-encoded as LCM payloads via
      :func:`~.lcm_wire.to_lcm`, so the log is ALWAYS standard LCM format
      regardless of which transport carried the session. This uses the
      bus tap (fires for every message independent of subscriptions).
    """

    def __init__(self, bus, writer: LcmLogWriter, pattern: str = ".*"):
        self.bus = bus
        self.writer = writer
        self.dropped = 0  # messages that could not be encoded to LCM
        self.count = 0
        self._rx = re.compile(pattern)

        from .lcm_wire import LcmUdpBus

        if isinstance(bus, LcmUdpBus):
            bus.subscribe_bytes(pattern, self._on_bytes)
        else:
            # Chain rather than clobber an existing tap (channel_spy and a
            # recorder may share a bus; the tap slot is single-owner).
            prev = getattr(bus, "_tap", None)

            def tap(ch, m):
                if prev is not None:
                    prev(ch, m)
                self._on_message(ch, m)

            bus.set_tap(tap)

    def _on_bytes(self, channel: str, payload: bytes) -> None:
        self.writer.write(channel, payload)
        self.count += 1

    def _on_message(self, channel: str, message) -> None:
        if not self._rx.fullmatch(channel):
            return
        from .lcm_wire import to_lcm

        try:
            sd, values = to_lcm(message)
        except (TypeError, ValueError, KeyError):
            self.dropped += 1
            return
        self.writer.write(channel, sd.encode(values))
        self.count += 1

    def stop(self) -> None:
        self.writer.flush()


# ---------------------------------------------------------------------------
# Playback
# ---------------------------------------------------------------------------


def play_log(
    bus,
    path: str,
    speed: float = 1.0,
    pattern: str = ".*",
    loop: bool = False,
    max_events: Optional[int] = None,
    should_stop: Optional[Callable[[], bool]] = None,
) -> int:
    """Re-publish a log's events onto ``bus`` (lcm-logplayer parity).

    Pacing follows the recorded receive timestamps scaled by ``speed``
    (<= 0 publishes as fast as possible). On an LcmUdpBus the original
    payload bytes go out verbatim; on the in-house transports each payload
    is decoded to our message classes first (events whose type has no
    dataclass mapping — e.g. mmf descriptors pointing at files that no
    longer exist — are skipped and counted in the return value's
    complement). Returns the number of events published.
    """
    exact = hasattr(bus, "publish_encoded")
    rx = re.compile(pattern)
    published = 0

    if not exact:
        from . import lcm_types as lt
        from .lcm_wire import from_lcm

    while True:
        last_utime: Optional[int] = None
        with LcmLogReader(path) as reader:
            for ev in reader:
                if should_stop is not None and should_stop():
                    return published
                if max_events is not None and published >= max_events:
                    return published
                if not rx.fullmatch(ev.channel):
                    continue
                if speed > 0 and last_utime is not None:
                    dt = (ev.timestamp_us - last_utime) * 1e-6 / speed
                    if dt > 0:
                        time.sleep(min(dt, 10.0))
                last_utime = ev.timestamp_us
                if exact:
                    bus.publish_encoded(ev.channel, ev.data)
                    published += 1
                else:
                    sd, values = lt.decode_by_fingerprint(ev.data)
                    if sd is None:
                        continue
                    try:
                        msg = from_lcm(sd, values)
                    except (TypeError, ValueError, KeyError):
                        continue
                    if msg is None:
                        continue
                    bus.publish(ev.channel, msg)
                    published += 1
        if not loop:
            return published


def log_summary(path: str) -> dict:
    """Per-channel counts/types/time-span of a log (lcm-log info parity)."""
    from . import lcm_types as lt

    channels: dict = {}
    n = 0
    t0 = t1 = None
    for ev in LcmLogReader(path):
        n += 1
        t0 = ev.timestamp_us if t0 is None else t0
        t1 = ev.timestamp_us
        st = channels.setdefault(ev.channel, {"count": 0, "bytes": 0, "type": None})
        st["count"] += 1
        st["bytes"] += len(ev.data)
        if st["type"] is None:
            sd = lt.FINGERPRINT_REGISTRY.get(ev.data[:8])
            st["type"] = sd.full_name if sd is not None else "unknown"
    return {
        "path": path,
        "events": n,
        "start_us": t0,
        "end_us": t1,
        "duration_s": 0.0 if (t0 is None or t1 is None) else (t1 - t0) * 1e-6,
        "channels": channels,
    }
