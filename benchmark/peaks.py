"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full power limit of 700 W).  Every run prints the card's
own power limit beside them."""

#: float32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: device-memory bytes a second (HBM3)
HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory peak."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
