"""The table of peaks and the roofline's least time.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full 700 W
power limit): 3.35 TB/s of HBM, 67 TFLOP/s of float32 and 34 TFLOP/s of
float64 outside the tensor cores. A share of the roofline is stated against
these, with the card's power limit printed beside it.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12


def bound_us(nbytes: float, flops: float = 0.0, peak_ops: float = PEAK_F32_PER_S) -> float:
    """The least time the card could take, in us: bytes over the memory
    rate or operations over the rate of their type, whichever is larger."""
    return 1e6 * max(nbytes / PEAK_BYTES_PER_S, flops / peak_ops)


def kernel_us(units: list, pattern) -> list:
    """For each unit (the kernels of one call), the summed device time in us
    of its kernels whose name matches ``pattern`` (a compiled regex)."""
    return [sum(k.us for k in u if pattern.search(k.name)) for u in units]
