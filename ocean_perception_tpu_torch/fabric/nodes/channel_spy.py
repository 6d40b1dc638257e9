"""Channel spy: live traffic monitor for a running fabric session (port of
``ocean_perception_tpu.fabric.nodes.channel_spy``).

Reference-parity with the LCM ecosystem's ``lcm-spy`` (README.md:63-67 —
"LCM channels double as observability taps"): subscribe every channel,
print a per-channel table of message type, count, rate, and last timestamp.

Works on both transports:
- ``--lcm``: real LCM wire — spies on reference-era publishers too
  (subscription pattern ".*", LCM's anchored-regex semantics);
- default: the in-house UDP bus (every datagram carries its channel).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lcm", action="store_true", help="spy on real LCM wire")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--interval", type=float, default=2.0, help="print period (s)")
    ap.add_argument("--duration", type=float, default=None, help="exit after N seconds")
    ap.add_argument("--pattern", default=".*", help="anchored channel regex")
    args = ap.parse_args(argv)

    stats: dict = {}
    lock = threading.Lock()

    def record(channel: str, type_name: str, timestamp) -> None:
        with lock:
            st = stats.setdefault(
                channel, {"n": 0, "type": type_name, "t_wall": [], "ts": None}
            )
            st["n"] += 1
            st["type"] = type_name
            st["ts"] = timestamp
            st["t_wall"].append(time.time())
            del st["t_wall"][:-512]  # rate window (bounded memory)

    def on_lcm(ch, sd, v):
        if sd is None:  # foreign fingerprint: count it like lcm-spy does
            record(ch, f"unknown(0x{bytes(v[:8]).hex()})", None)
        else:
            record(ch, sd.full_name, (v.get("header") or {}).get("timestamp"))

    if args.lcm:
        from ..lcm_wire import LcmUdpBus

        bus = LcmUdpBus(port=args.port) if args.port else LcmUdpBus()
        bus.subscribe_lcm(args.pattern, on_lcm)
    else:
        from ..pubsub import UdpMulticastBus

        import re

        bus = UdpMulticastBus(port=args.port) if args.port else UdpMulticastBus()
        # Supported observability hook: fires for every decoded message
        # regardless of subscriptions (works on the native bus too).
        pat = re.compile(args.pattern)

        def tap(ch, m):
            if pat.fullmatch(ch):
                record(ch, type(m).__name__, getattr(m, "timestamp", None))

        bus.set_tap(tap)

    print("spying... (ctrl-c to stop)", flush=True)
    t0 = time.time()
    try:
        while args.duration is None or time.time() - t0 < args.duration:
            time.sleep(args.interval)
            with lock:
                rows = sorted(stats.items())
                lines = [f"{'CHANNEL':<28} {'TYPE':<30} {'COUNT':>7} {'HZ':>7}  LAST_TS"]
                now = time.time()
                for ch, st in rows:
                    w = [t for t in st["t_wall"] if now - t <= 5.0]
                    # Rate over the ACTUAL window span (a fixed divisor would
                    # clamp fast channels once the sample buffer saturates).
                    span = (now - w[0]) if w else 1.0
                    hz = len(w) / max(span, 1e-3) if len(w) > 1 else len(w) / 5.0
                    lines.append(
                        f"{ch:<28} {st['type']:<30} {st['n']:>7} {hz:>7.1f}  {st['ts']}"
                    )
            print("\n".join(lines) + "\n", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        bus.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
