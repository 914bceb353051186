"""Numeric configuration: dtype helpers, the device resolver, TF32 off.

The JAX package picks its regime from the global x64 flag
(code_robchar_tpu/config.py); here every function takes its dtype
explicitly, so the parity regime (float64, the CPU tests) and the
throughput regime (float32, the CUDA kernel) are chosen by the caller's
inputs.

TF32 is switched off for both matmul and cuDNN: the reference lost 1e-2
of gradient accuracy on device when its Daleckii-Krein contractions ran in
a reduced-precision matmul, so the float32 products of the port run in
full float32, the Daleckii-Krein contractions of the Jacobi kernels among
them.  The one stated exception is the PPO critic regression on the card
(ops/critic.py ``fast_dot=True``): bfloat16 operands with float32 sums, as
the JAX package computes it on its device.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def real_dtype(dtype: torch.dtype = torch.float32) -> torch.dtype:
    """The real dtype of ``dtype`` (complex128 -> float64; reals map to
    themselves)."""
    return _REAL.get(dtype, dtype)


def complex_dtype(dtype: torch.dtype = torch.float32) -> torch.dtype:
    """The complex dtype of ``dtype`` (float32 -> complex64; complex
    dtypes map to themselves)."""
    return _COMPLEX.get(dtype, dtype)


def resolve_device(device=None) -> torch.device:
    """The device to compute on.

    ``None`` means the current CUDA device, as an explicit ``"cuda"``
    does.  A CUDA device raises when CUDA is unavailable — it never turns
    into the CPU; the CPU is taken only when the caller asks for it
    (``device="cpu"``, as the CPU tests do)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was requested but torch.cuda.is_available() "
            "is False")
    return device
