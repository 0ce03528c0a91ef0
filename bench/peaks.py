"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates at the full 700 W power limit): the float32 rate outside
the tensor cores and the HBM3 bandwidth.  The roofline and MFU shares of
``bench/metrics`` are taken against these."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops) -> float:
    """The least time the card could take for ``ops``, an iterable of
    (flops, bytes): each bounded by the larger of its two terms."""
    return sum(max(f / FP32_FLOPS, b / HBM_BYTES_PER_S) for f, b in ops)
