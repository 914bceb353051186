"""The frozen copies agree with their originals at the paths' shapes."""

import os
import sys

import pytest

from robchar_bench import harness, trace
from robchar_bench.counts import herm_jacobi, peaks, sym_grad

sys.path.insert(0, harness.ROOT)
chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("n", [5, 7, 10])
def test_kernel_counts_equal_the_smoke_runs(n):
    assert herm_jacobi.flops(n) == chip_smoke._herm_flops(n, 5)
    assert sym_grad.flops(n) == chip_smoke._grad_flops(n, 5)
    assert herm_jacobi.nbytes(n) * 131072 == 4 * 131072 * (2 * n * n + 2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sweeps_and_bytes_follow_the_dtype(dtype):
    import torch

    from code_robchar_tpu_torch.ops import realform

    for n in range(2, 11):
        assert herm_jacobi.sweeps(dtype, n) == \
            realform._sweeps_for(getattr(torch, dtype), n)
        size = getattr(torch, dtype).itemsize
        assert herm_jacobi.nbytes(n, size) == size * (2 * n * n + 2)
    assert herm_jacobi.sweeps("float32", 7) == herm_jacobi.SWEEPS
    with pytest.raises(ValueError):
        herm_jacobi.sweeps("bfloat16", 7)


def test_float64_term_of_the_bound():
    assert peaks.F64_PEAK == 34e12
    assert peaks.bound_s(0.0, 0.0, 0.0, 34e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 0.0, 0.0, 34e12) == pytest.approx(2.0)
    assert peaks.bound_s(1e9, 3.35e12, 0.0, 1e9) == pytest.approx(1.0)


def test_peaks_and_bound_equal_the_smoke_runs():
    assert (peaks.F32_PEAK, peaks.HBM_RATE, peaks.BF16_PEAK) == \
        (chip_smoke.F32_PEAK, chip_smoke.HBM_RATE, chip_smoke.BF16_PEAK)
    for flops, nbytes, bf16 in ((1e12, 1e9, 0.0), (1e9, 1e12, 0.0),
                                (1e10, 1e9, 1e13)):
        ms, _ = chip_smoke._bound(flops, nbytes, bf16)
        assert peaks.bound_s(flops, nbytes, bf16) * 1e3 == pytest.approx(ms)


def test_busy_time_equals_the_zoo_profile_tool():
    sys.path.insert(0, os.path.join(harness.ROOT, "tools"))
    profile_zoo = pytest.importorskip("profile_zoo")

    class Ev:
        def __init__(self, s, e):
            self.time_range = type("R", (), {"start": s, "end": e})

    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (7.0, 7.5)]
    assert trace.busy_us(spans) == profile_zoo._busy_us(
        [Ev(s, e) for s, e in spans]) == 4.5
