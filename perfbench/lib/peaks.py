"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W power limit), the yardstick of every roofline share
and ``mfu`` metric."""

from __future__ import annotations

__all__ = ["BF16_FLOPS", "F32_ACCURATE_FLOPS", "HBM_BYTES_PER_S",
           "TF32_FLOPS", "bound_s"]

#: bf16 and fp16 on the tensor cores, FLOP/s
BF16_FLOPS = 989e12
#: TF32 on the tensor cores, FLOP/s
TF32_FLOPS = 495e12
#: the ceiling for f32-accurate arithmetic: TF32's rate over the three
#: TF32 products an f32-accurate product takes (3xTF32). The same work
#: then reads the same share whatever implements it, the CUDA cores'
#: 67 TFLOP/s included
F32_ACCURATE_FLOPS = TF32_FLOPS / 3
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
