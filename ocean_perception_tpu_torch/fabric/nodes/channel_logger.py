"""Channel logger: record / replay / inspect LCM-format session logs (port of
``ocean_perception_tpu.fabric.nodes.channel_logger``).

Parity with the LCM ecosystem's ``lcm-logger`` + ``lcm-logplayer`` (the
reference's operational record/replay workflow, README.md:63-67). The log
file is the standard LCM event format (fabric/lcm_log.py), so it
round-trips with stock LCM tooling in both directions.

Subcommands:
  record  — subscribe (anchored regex) and append every event to a log
  play    — re-publish a log with recorded timing (speed / loop / pattern)
  info    — per-channel summary (count, type, bytes, rate)

Works on both transports: ``--lcm`` records the exact wire payloads of a
real LCM session; the default in-house bus records by re-encoding each
decoded message as its LCM type, so the resulting log is standard either
way (and `play` onto either transport).
"""

from __future__ import annotations

import argparse
import sys
import time


def _make_bus(args):
    if args.lcm:
        from ..lcm_wire import LcmUdpBus

        return LcmUdpBus(port=args.port) if args.port else LcmUdpBus()
    from ..pubsub import UdpMulticastBus

    return UdpMulticastBus(port=args.port) if args.port else UdpMulticastBus()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record", help="record bus traffic to an LCM log")
    rec.add_argument("--out", required=True, help="log file to write")
    rec.add_argument("--pattern", default=".*", help="anchored channel regex")
    rec.add_argument("--lcm", action="store_true", help="record the real LCM wire")
    rec.add_argument("--port", type=int, default=None)
    rec.add_argument("--append", action="store_true")
    rec.add_argument("--duration", type=float, default=None, help="stop after N seconds")

    play = sub.add_parser("play", help="re-publish a log onto the bus")
    play.add_argument("--path", required=True)
    play.add_argument("--pattern", default=".*")
    play.add_argument("--speed", type=float, default=1.0, help="<=0: as fast as possible")
    play.add_argument("--loop", action="store_true")
    play.add_argument("--max-events", type=int, default=None)
    play.add_argument("--lcm", action="store_true", help="publish on the real LCM wire")
    play.add_argument("--port", type=int, default=None)

    info = sub.add_parser("info", help="summarize a log")
    info.add_argument("--path", required=True)

    args = ap.parse_args(argv)

    if args.cmd == "info":
        from ..lcm_log import log_summary

        s = log_summary(args.path)
        print(f"{s['path']}: {s['events']} events, {s['duration_s']:.1f} s")
        dur = max(s["duration_s"], 1e-9)
        print(f"{'CHANNEL':<28} {'TYPE':<30} {'COUNT':>7} {'HZ':>7} {'BYTES':>10}")
        for ch, st in sorted(s["channels"].items()):
            print(
                f"{ch:<28} {st['type']:<30} {st['count']:>7}"
                f" {st['count'] / dur:>7.1f} {st['bytes']:>10}"
            )
        return 0

    if args.cmd == "play":
        from ..lcm_log import play_log

        bus = _make_bus(args)
        try:
            n = play_log(
                bus, args.path, speed=args.speed, pattern=args.pattern,
                loop=args.loop, max_events=args.max_events,
            )
            print(f"published {n} events", flush=True)
        except KeyboardInterrupt:
            pass
        finally:
            bus.close()
        return 0

    # record
    from ..lcm_log import BusRecorder, LcmLogWriter

    bus = _make_bus(args)
    writer = LcmLogWriter(args.out, append=args.append)
    recorder = BusRecorder(bus, writer, pattern=args.pattern)
    print(f"recording to {args.out} (ctrl-c to stop)", flush=True)
    t0 = time.time()
    try:
        while args.duration is None or time.time() - t0 < args.duration:
            time.sleep(0.25)
    except KeyboardInterrupt:
        pass
    finally:
        recorder.stop()
        bus.close()
        writer.close()
        print(f"wrote {recorder.count} events ({recorder.dropped} unencodable dropped)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
