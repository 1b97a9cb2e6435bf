"""One NVIDIA H100 SXM5 80 GB, NVIDIA's data sheet ("H100 SXM" column),
dense rates at the 700 W power limit."""

PEAK_FLOPS_BF16 = 989e12     # bf16 tensor cores
PEAK_FLOPS_F32 = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3

PEAK_BY_DTYPE = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


def bound_s(nbytes: float, ops: float, dtype: str = "bfloat16") -> float:
    """The least seconds a kernel takes that moves ``nbytes`` (each input
    read once, each output written once) and does ``ops`` operations of
    ``dtype``: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BY_DTYPE[dtype])
