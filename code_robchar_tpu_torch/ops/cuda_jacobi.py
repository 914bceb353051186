"""CUDA kernels for the batched Jacobi transfer objectives (counterpart of
code_robchar_tpu/ops/pallas_jacobi.py).

Three dispatches, one per kernel:

- ``fidelity_herm``: the MC engine's split-complex Hermitian fidelity,
  ``csrc/herm_jacobi_fidelity.cu`` (plain version
  ops/realform.fidelity_herm_lanes);
- ``transfer_amp_sym`` (and ``fidelity_sym``): the optimizer zoo's real
  symmetric transfer amplitude, ``csrc/sym_jacobi_amp.cu`` (plain version
  ops/realform.transfer_amp_sym_lanes);
- ``infidelity_and_gradient_sym``: the zoo's exact infidelity and
  Daleckii-Krein gradient, ``csrc/sym_jacobi_grad.cu`` (plain version
  ops/realform.infidelity_and_gradient_sym_lanes).

Each sends a CPU tensor to its plain torch version (round-robin order)
and a CUDA float32 tensor to its hand-written kernel (built by
utils/build.py on first use, bound with ctypes); a CUDA float64 tensor
raises ``ValueError`` — the kernels, like the TPU kernels they replace,
are float32 only.

There is no fallback: a kernel that fails to build or launch raises.
``LAUNCHES``, ``SYM_AMP_LAUNCHES`` and ``SYM_GRAD_LAUNCHES`` count each
kernel's launches, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from code_robchar_tpu_torch.ops import realform
from code_robchar_tpu_torch.ops.realform import pair_schedule  # noqa: F401
from code_robchar_tpu_torch.utils import build

#: launches in this process of herm_jacobi_fidelity, sym_jacobi_amp and
#: sym_jacobi_grad (never incremented by the CPU path)
LAUNCHES = 0
SYM_AMP_LAUNCHES = 0
SYM_GRAD_LAUNCHES = 0
#: matrix sizes the kernel is instantiated for
MIN_N, MAX_N = 2, 10
#: rotation threshold of the float32 kernel (pallas_jacobi.py hard-codes it)
EPS = realform._eps_for(torch.float32)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # pointers, then n, in_spin, out_spin, sweeps, eps, B, device, stream
    "herm_jacobi_fidelity": [_P] * 4,
    "sym_jacobi_amp": [_P] * 3,
    "sym_jacobi_grad": [_P] * 4,
}


@functools.cache
def _entry(name: str):
    fn = getattr(build.load(), name)
    fn.argtypes = _ARGTYPES[name] + [_I, _I, _I, _I, ctypes.c_float,
                                     ctypes.c_longlong, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, tensors, n, in_spin, out_spin, sweeps, b):
    """Call the C entry ``name`` on the current stream of the tensors'
    device; raise on a launch error."""
    if sweeps is None:
        sweeps = realform._sweeps_for(torch.float32, n)
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry(name)(*(x.data_ptr() for x in tensors), n, in_spin,
                       out_spin, sweeps, EPS, b, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} (n={n}, "
                           f"B={b})")


def _check_tensors(**tensors):
    """Raise ValueError unless every tensor is a contiguous float32 one."""
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise ValueError(f"the CUDA Jacobi kernels are float32 only; "
                             f"{name} is {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_on_card(**tensors):
    """Raise ValueError unless every tensor lies on one CUDA device."""
    first = next(iter(tensors.values())).device
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != first:
            raise ValueError(f"{name} must lie on one CUDA device, got "
                             f"{x.device}")


def _check_sizes(n, in_spin, out_spin):
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the kernels are built for n in {MIN_N}..{MAX_N}, "
                         f"got n={n}")
    if not (0 <= in_spin < n and 0 <= out_spin < n):
        raise ValueError(f"spins ({in_spin}, {out_spin}) out of range for "
                         f"n={n}")


def _check(ar, ai, t, in_spin, out_spin):
    """Raise ValueError for what the Hermitian kernel does not take
    (besides the device): a dtype other than float32, a non-contiguous
    tensor, shapes other than ar, ai (n, n, B) and t (B,), n outside
    MIN_N..MAX_N, a spin outside 0..n-1."""
    _check_tensors(ar=ar, ai=ai, t=t)
    n = ar.shape[0]
    b = ar.shape[-1]
    if ar.shape != (n, n, b) or ai.shape != ar.shape or t.shape != (b,):
        raise ValueError(f"expected ar, ai (n, n, B) and t (B,), got "
                         f"{tuple(ar.shape)}, {tuple(ai.shape)}, "
                         f"{tuple(t.shape)}")
    _check_sizes(n, in_spin, out_spin)


def fidelity_herm_cuda(ar: torch.Tensor, ai: torch.Tensor, t: torch.Tensor,
                       in_spin: int, out_spin: int,
                       sweeps: int | None = None) -> torch.Tensor:
    """Launch the Hermitian kernel: ar/ai (n, n, B), t (B,), contiguous
    float32 on one CUDA device -> fid (B,) on the current stream, not
    synchronised."""
    global LAUNCHES
    _check_on_card(ar=ar, ai=ai, t=t)
    _check(ar, ai, t, in_spin, out_spin)
    n, b = ar.shape[0], ar.shape[-1]
    fid = torch.empty(b, dtype=torch.float32, device=ar.device)
    if b == 0:
        return fid
    _launch("herm_jacobi_fidelity", (ar, ai, t, fid), n, in_spin, out_spin,
            sweeps, b)
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


def transfer_amp_sym_cuda(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                          out_spin: int, sweeps: int | None = None):
    """Launch the real symmetric amplitude kernel: a (n, n, B) symmetric
    (only its lower triangle and diagonal are read), t (B,), contiguous
    float32 on one CUDA device -> (phr, phi), each (B,), on the current
    stream, not synchronised."""
    global SYM_AMP_LAUNCHES
    _check_on_card(a=a, t=t)
    _check_tensors(a=a, t=t)
    n, b = a.shape[0], a.shape[-1]
    if a.shape != (n, n, b) or t.shape != (b,):
        raise ValueError(f"expected a (n, n, B) and t (B,), got "
                         f"{tuple(a.shape)}, {tuple(t.shape)}")
    _check_sizes(n, in_spin, out_spin)
    amp = torch.empty((2, b), dtype=torch.float32, device=a.device)
    if b:
        _launch("sym_jacobi_amp", (a, t, amp), n, in_spin, out_spin, sweeps,
                b)
        SYM_AMP_LAUNCHES += 1
    return amp[0], amp[1]


def infidelity_and_gradient_sym_cuda(h0: torch.Tensor, xs: torch.Tensor,
                                     in_spin: int, out_spin: int,
                                     sweeps: int | None = None):
    """Launch the exact-gradient kernel: h0 (n, n) symmetric, xs (B, n+1),
    contiguous float32 on one CUDA device -> (err (B,), grad (B, n+1)) on
    the current stream, not synchronised."""
    global SYM_GRAD_LAUNCHES
    _check_on_card(h0=h0, xs=xs)
    _check_tensors(h0=h0, xs=xs)
    n, b = h0.shape[-1], xs.shape[0]
    if h0.shape != (n, n) or xs.shape != (b, n + 1):
        raise ValueError(f"expected h0 (n, n) and xs (B, n+1), got "
                         f"{tuple(h0.shape)}, {tuple(xs.shape)}")
    _check_sizes(n, in_spin, out_spin)
    err = torch.empty(b, dtype=torch.float32, device=xs.device)
    grad = torch.empty((b, n + 1), dtype=torch.float32, device=xs.device)
    if b:
        _launch("sym_jacobi_grad", (h0, xs, err, grad), n, in_spin, out_spin,
                sweeps, b)
        SYM_GRAD_LAUNCHES += 1
    return err, grad


def transfer_amp_sym(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                     out_spin: int, sweeps: int | None = None):
    """Lanes-layout real symmetric transfer amplitude: a (n, n, B), t (B,)
    -> (phr, phi).  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if a.device.type == "cpu":
        return realform.transfer_amp_sym_lanes(a, t, in_spin, out_spin,
                                               sweeps, order="roundrobin")
    return transfer_amp_sym_cuda(a, t, in_spin, out_spin, sweeps)


def fidelity_sym(a: torch.Tensor, t: torch.Tensor, in_spin: int,
                 out_spin: int, sweeps: int | None = None) -> torch.Tensor:
    """|amplitude|^2 of ``transfer_amp_sym``: a (n, n, B), t (B,) -> (B,)."""
    phr, phi = transfer_amp_sym(a, t, in_spin, out_spin, sweeps)
    return phr * phr + phi * phi


def infidelity_and_gradient_sym(h0: torch.Tensor, xs: torch.Tensor,
                                in_spin: int, out_spin: int,
                                sweeps: int | None = None):
    """Exact (infidelity, gradient): h0 (n, n), xs (B, n+1) ->
    (err (B,), grad (B, n+1)).  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if xs.device.type == "cpu":
        return realform.infidelity_and_gradient_sym_lanes(
            h0, xs, in_spin, out_spin, sweeps, order="roundrobin")
    return infidelity_and_gradient_sym_cuda(h0, xs, in_spin, out_spin,
                                            sweeps)
