"""code_robchar_tpu_torch — the PyTorch + CUDA port of code_robchar_tpu.

The JAX package ``code_robchar_tpu`` stays the reference; this package
mirrors its subpackage and function names so every port module has an
obvious counterpart, and is held against it by the ``tests/test_torch_*``
parity suite on the CPU.  It imports ``torch`` and numpy only — never jax,
never the JAX package.

Layout (every module of the JAX package has its counterpart here):

- ``config``   dtype helpers, the device resolver, TF32 off
- ``ops``      counter-based threefry PRNG with jax's randint and binomial
               (``prng``), chain Hamiltonians (``chain``), structured
               noise, the lanes-layout assembly, the fixed ensembles and
               the shot-noise protocols (``noise``), the plain Jacobi
               solvers, amplitudes and exact gradient (``realform``), the
               hand-written CUDA kernels' binding and dispatch
               (``cuda_jacobi``), the PPO rollout and critic kernels'
               dispatch and plain versions (``rollout``, ``critic``), the
               probe kernels' (``probes``), Sobol restart streams
               (``sobol``), complex-eigh fidelities and gradient
               (``propagate``)
- ``metrics``  RIM / Wasserstein metrics, DKW bands, the metric registry,
               the host-side statistical helpers (ranks, CDFs, VN test)
- ``mc``       the chunked Monte-Carlo sweep, its fused metric reduction,
               the bootstrap std of a statistic, and ``MCDataSim``, the
               cached characterisation (.mc / .mcm files either package
               loads)
- ``exp``      the drivers CLI (``python -m
               code_robchar_tpu_torch.exp.drivers``), ``Experiment`` and
               its controller stores (.le), the namer and the flags
- ``perf``     the probe path: the probe kernels' K-sweeps on the card
- ``parallel`` the device mesh: sharded MC sweeps and metrics, zoo
               batches, Adam streams and PPO agents, block by block over
               an ordered list of devices; the multi-device dry run
- ``models``   the zoo's batched objectives, run loop, L-BFGS, NMPlus,
               Adam and SNOB, and their registry; the exact-SNOBFIT
               adapter and its vendored engine; PPO's environment,
               actor-critic, masked Adam and trainer
- ``utils``    the nvcc build of ``csrc/*.cu`` and its ctypes loader, the
               record protocol, deadlines, cache names and JSON IO, the
               native .mc codec (``native_io``, g++ of ``csrc/mccodec.cpp``)
- ``csrc``     CUDA C++ kernel sources (sm_90a) and their shared header;
               the C++ cache codec
"""

__version__ = "0.1.0"

from code_robchar_tpu_torch import config as config  # noqa: F401
