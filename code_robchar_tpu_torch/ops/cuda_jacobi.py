"""CUDA kernel for the batched split-complex Jacobi transfer fidelity
(counterpart of code_robchar_tpu/ops/pallas_jacobi.py, Hermitian kernel).

``fidelity_herm`` is the dispatch of the MC engine's hot op:

- a CPU tensor goes to the plain torch version
  (ops/realform.fidelity_herm_lanes, round-robin order);
- a CUDA float32 tensor goes to the hand-written kernel
  ``csrc/herm_jacobi_fidelity.cu`` (built by utils/build.py on first use,
  bound with ctypes); a CUDA float64 tensor raises ``ValueError`` — the
  kernel, like the TPU kernel it replaces, is float32 only.

There is no fallback: a kernel that fails to build or launch raises.
``LAUNCHES`` counts the kernel's launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from code_robchar_tpu_torch.ops import realform
from code_robchar_tpu_torch.ops.realform import pair_schedule  # noqa: F401
from code_robchar_tpu_torch.utils import build

#: kernel launches in this process (never incremented by the CPU path)
LAUNCHES = 0
#: matrix sizes the kernel is instantiated for
MIN_N, MAX_N = 2, 10
#: rotation threshold of the float32 kernel (pallas_jacobi.py hard-codes it)
EPS = realform._eps_for(torch.float32)


@functools.cache
def _entry():
    fn = build.load().herm_jacobi_fidelity
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(ar, ai, t, in_spin, out_spin):
    """Raise ValueError for what the kernel does not take (besides the
    device): a dtype other than float32, a non-contiguous tensor, shapes
    other than ar, ai (n, n, B) and t (B,), n outside MIN_N..MAX_N, a spin
    outside 0..n-1."""
    for name, x in (("ar", ar), ("ai", ai), ("t", t)):
        if x.dtype != torch.float32:
            raise ValueError(f"the CUDA Jacobi kernel is float32 only; {name} "
                             f"is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = ar.shape[0]
    b = ar.shape[-1]
    if ar.shape != (n, n, b) or ai.shape != ar.shape or t.shape != (b,):
        raise ValueError(f"expected ar, ai (n, n, B) and t (B,), got "
                         f"{tuple(ar.shape)}, {tuple(ai.shape)}, "
                         f"{tuple(t.shape)}")
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the kernel is built for n in {MIN_N}..{MAX_N}, "
                         f"got n={n}")
    if not (0 <= in_spin < n and 0 <= out_spin < n):
        raise ValueError(f"spins ({in_spin}, {out_spin}) out of range for "
                         f"n={n}")


def fidelity_herm_cuda(ar: torch.Tensor, ai: torch.Tensor, t: torch.Tensor,
                       in_spin: int, out_spin: int,
                       sweeps: int | None = None) -> torch.Tensor:
    """Launch the kernel: ar/ai (n, n, B), t (B,), contiguous float32 on
    one CUDA device -> fid (B,) on the current stream, not synchronised."""
    global LAUNCHES
    for name, x in (("ar", ar), ("ai", ai), ("t", t)):
        if x.device.type != "cuda" or x.device != ar.device:
            raise ValueError(f"{name} must lie on one CUDA device, got "
                             f"{x.device}")
    _check(ar, ai, t, in_spin, out_spin)
    n = ar.shape[0]
    b = ar.shape[-1]
    if sweeps is None:
        sweeps = realform._sweeps_for(torch.float32, n)
    fid = torch.empty(b, dtype=torch.float32, device=ar.device)
    if b == 0:
        return fid
    stream = torch.cuda.current_stream(ar.device).cuda_stream
    err = _entry()(ar.data_ptr(), ai.data_ptr(), t.data_ptr(),
                   fid.data_ptr(), n, in_spin, out_spin, sweeps, EPS, b,
                   ar.device.index, stream)
    if err != 0:
        raise RuntimeError(f"herm_jacobi_fidelity launch failed: CUDA error "
                           f"{err} (n={n}, B={b})")
    LAUNCHES += 1
    return fid


def fidelity_herm(ar: torch.Tensor, ai: torch.Tensor, t: torch.Tensor,
                  in_spin: int, out_spin: int,
                  sweeps: int | None = None) -> torch.Tensor:
    """Lanes-layout transfer fidelity: ar/ai (n, n, B) split Hermitian,
    t (B,) -> (B,).  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if ar.device.type == "cpu":
        return realform.fidelity_herm_lanes(ar, ai, t, in_spin, out_spin,
                                            sweeps, order="roundrobin")
    return fidelity_herm_cuda(ar, ai, t, in_spin, out_spin, sweeps)
