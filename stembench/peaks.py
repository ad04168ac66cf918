"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), the yardstick of every roofline
share."""

HBM_BYTES_S = 3.35e12       # HBM3 bandwidth
INT32_OPS_S = 67e12         # 32-bit rate outside the tensor cores, taken
                            # for the stemmer's integer work


def least_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the chip could take: the larger of its bytes over
    the bandwidth and its operations over the integer rate."""
    return max(n_bytes / HBM_BYTES_S, n_ops / INT32_OPS_S)
