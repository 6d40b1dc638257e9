"""kernels_per_call.farm: the CUDA kernels a fleet call ran (torch.profiler):
every kernel that started inside the profiled stretch of calls (the
replayed step and the digest it ends with), over the calls in it. Each
call ends in a wait for its digest, so no kernel of a call runs outside
the stretch."""


def read(rec):
    s = rec.stretch
    if s is None or not s.kernels:
        return None
    n = sum(1 for k in s.kernels if s.start_us <= k.start_us < s.end_us)
    return n / len(s.units)
