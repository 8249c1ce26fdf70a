"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; at its
700 W power limit): HBM3 bandwidth and float32 outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
