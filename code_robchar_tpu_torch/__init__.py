"""code_robchar_tpu_torch — the PyTorch + CUDA port of code_robchar_tpu.

The JAX package ``code_robchar_tpu`` stays the reference; this package
mirrors its subpackage and function names so every port module has an
obvious counterpart, and is held against it by the ``tests/test_torch_*``
parity suite on the CPU.  It imports ``torch`` and numpy only — never jax,
never the JAX package.

Layout (the Monte-Carlo characterisation slice):

- ``config``   dtype helpers, the device resolver, TF32 off
- ``ops``      counter-based threefry PRNG (``prng``), chain Hamiltonians
               (``chain``), structured noise and the lanes-layout assembly
               (``noise``), the plain Jacobi transfer fidelity
               (``realform``) and its hand-written CUDA kernel binding
               (``cuda_jacobi``)
- ``metrics``  RIM / Wasserstein metrics, DKW bands, the metric registry
- ``mc``       the chunked Monte-Carlo sweep and its fused metric reduction
- ``utils``    the nvcc build of ``csrc/*.cu`` and its ctypes loader
- ``csrc``     CUDA C++ kernel sources (sm_90a)
"""

__version__ = "0.1.0"

from code_robchar_tpu_torch import config as config  # noqa: F401
