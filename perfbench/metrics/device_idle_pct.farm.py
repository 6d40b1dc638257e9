"""device_idle_pct.farm: the share of the profiled stretch of fleet calls in
which no kernel, copy or set ran on the card (the union of the device's
intervals, from torch.profiler)."""


def read(rec):
    s = rec.stretch
    if s is None or s.end_us <= s.start_us or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_us() / (s.end_us - s.start_us))
