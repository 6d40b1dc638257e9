"""fleet_call_ms_p95: the 95th percentile over every fleet call of the
window, each from a CUDA event recorded as its frames are handed over to one
recorded after its digest has reached pinned host memory (the device's own
clock)."""

import statistics


def read(rec):
    times = [t for t, traced in zip(rec.data.get("call_ms", ()), rec.data.get("traced", ()))
             if not traced]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[-1]
