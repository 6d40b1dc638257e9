"""sea_thru_fit.roofline_pct.farm: the Sea-thru fit kernel (``imaging/``,
``ops/lm.py`` -> ``csrc/sea_thru_fit.cu``, a whole LM fit a block; the
backscatter and the attenuation fit, one launch each, every camera in it)
against its roofline on the first profiled call.

Bytes and operations (frozen from the repository's smoke test,
``fit_bound``): the samples read once (the colour triple, z and valid), the
starts and results written once; the residual and Jacobian of every sample
and the normal equations' P(P+1)/2 + P dot products at the start and after
each accepted step, every iteration's solve and every error, with the
accepted steps the reference's fit took on these inputs (the reference's
run of that call, ``roofline_calls``)."""

import re

from perfbench.harness.peaks import bound_us, kernel_us

KERNEL = re.compile(r"sea_thru_fit_kernel")
# Operations a sample's residual and Jacobian, and its error, take.
FIT_SAMPLE_OPS = {"backscatter": (85, 39), "attenuation": (94, 42)}


def fit_work(fit: dict) -> tuple:
    """(bytes, operations) of one camera's share of a fit launch: fit =
    {"model", "N" samples, "fits", "starts", "iters", "accepted" steps}."""
    N, P, fits = fit["N"], 12, fit["fits"]
    nbytes = N * (4 * 3 + 4 + 1) + 4 * P * fit["starts"] + fits * 4 * (P + 3)
    res_ops, err_ops = FIT_SAMPLE_OPS[fit["model"]]
    solve = 2 * P * P + sum((P - k - 1) * (3 + 2 * (P - k - 1)) for k in range(P)) + P * P
    normal = N * res_ops + 2 * N * (P * (P + 1) // 2 + P)
    iters = fit["iters"]
    ops = (fit["accepted"] + fits) * normal \
        + fits * (iters * solve + (iters + 1) * (N * err_ops + N))
    return nbytes, ops


def read(rec):
    s, calls = rec.stretch, rec.data.get("roofline_calls", {}).get("sea_thru_fit")
    if s is None or not calls:
        return None
    (device_us,) = kernel_us([s.kernels_in(s.units[0])], KERNEL)
    if device_us <= 0:
        return None
    total = 0.0
    for launch in zip(*calls):  # a launch a model, every camera's fits in it
        work = [fit_work(f) for f in launch]
        total += bound_us(sum(b for b, _ in work), sum(f for _, f in work))
    return 100.0 * total / device_us
