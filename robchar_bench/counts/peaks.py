"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W; NVIDIA's data
sheet, dense rates) and the roofline bound, frozen from chip_smoke.py:425-432
(``F32_PEAK``, ``HBM_RATE``, ``BF16_PEAK``) and chip_smoke.py:520-527
(``_bound``); ``F64_PEAK`` and the float64 term are the benchmark's own."""

#: float32 outside the tensor cores, FLOP/s
F32_PEAK = 67e12
#: HBM3, bytes/s
HBM_RATE = 3.35e12
#: dense bf16 on the tensor cores, FLOP/s
BF16_PEAK = 989e12
#: float64 outside the tensor cores (the data sheet's FP64 column), FLOP/s
F64_PEAK = 34e12


def bound_s(flops: float, nbytes: float, bf16_flops: float = 0.0,
            f64_flops: float = 0.0) -> float:
    """The least time the chip could take: the larger of the operations over
    their peaks (``flops`` at the float32 rate, ``bf16_flops`` at the bf16
    tensor-core rate, ``f64_flops`` at the float64 rate) and the bytes over
    the HBM rate; seconds."""
    return max(flops / F32_PEAK + bf16_flops / BF16_PEAK
               + f64_flops / F64_PEAK, nbytes / HBM_RATE)
