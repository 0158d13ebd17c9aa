"""Published dense peaks of one NVIDIA H100 SXM (data sheet, without
sparsity, at its 700 W limit).

A float32 step is held against the TF32 tensor-core rate: a float32-accurate
product can run on the tensor cores with split operands (the port's SENSE
and attention kernels do), so the 67 TFLOP/s of the FMA pipes is a rate
such a step could pass.
"""

FLOPS = {"bfloat16": 989e12, "float32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: operations over the peak of
    `precision` or bytes over the memory bandwidth, whichever is larger."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
