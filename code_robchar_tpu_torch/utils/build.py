"""Build the CUDA sources of the package with nvcc and load them with ctypes.

Each ``csrc/*.cu`` is compiled to an object by its own nvcc process, all
started together, and the objects are linked once into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         --resource-usage -c -o <obj> csrc/<kernel>.cu        (one per source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/libkernels_<sha1>.so <objs>

The file name carries the SHA-1 of the flags and of every ``csrc/*.cu`` and
``csrc/*.cuh``, so an edited source or shared header builds anew and an
unchanged tree is loaded from ``build/``.  The compilers' reports
(registers, stack and spills per kernel instance, from
``--resource-usage``) are kept beside the library as ``.log``.  Nothing is
built at import: the first kernel launch builds.  A missing nvcc or a
failed build raises with the compiler's output.

It is also the one seam between the ops modules and the library: each
``extern "C"`` entry (its last arguments ``int device, void* stream``, its
return a ``cudaError_t``) is declared once by ``kernel`` beside its
wrapper, and ``check_*`` are the checks every wrapper makes first.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--resource-usage")
#: shared memory one block of the sm_90a target can use (227 KB)
SMEM_PER_BLOCK = 232448
#: matrix sizes the kernels are instantiated for
MIN_N, MAX_N = 2, 10
#: launches in this process of each C entry, by its name (never
#: incremented by the CPU routes or by a failed launch)
LAUNCHES: collections.Counter = collections.Counter()
#: the declared C entries: each one's arguments before (device, stream)
ENTRIES: dict = {}
#: the argument types of the entries
P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: str          # the shared library
    log: str           # nvcc's output (resource usage per kernel)
    seconds: float     # wall time of this call, 0-ish when cached
    cached: bool       # True when the library was already built


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels of code_robchar_tpu_torch cannot be "
                           "built")
    return nvcc


def _digest(paths) -> str:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; (return codes, outputs)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], outs


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library for the current content of
    ``csrc/*.cu`` and ``csrc/*.cuh`` exists; return where it is."""
    start = time.perf_counter()
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    stem = os.path.join(BUILD_DIR, f"libkernels_{_digest(sources + headers)}")
    lib, log_path = stem + ".so", stem + ".log"
    if os.path.exists(lib):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildResult(lib, log, time.perf_counter() - start, True)

    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{stem}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    try:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(sources, objs)]
        rcs, outs = _run_all(cmds)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                os.path.join(tmp, "lib.so"), *objs]
        if not any(rcs):
            rc, out = _run_all([link])
            cmds, rcs, outs = cmds + [link], rcs + rc, outs + out
        log = "".join(f"$ {' '.join(cmd)}\n{out}"
                      for cmd, out in zip(cmds, outs))
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({max(rcs)}):\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        # atomic: a concurrent loader sees all or none
        os.replace(os.path.join(tmp, "lib.so"), lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildResult(lib, log, time.perf_counter() - start, False)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process."""
    return ctypes.CDLL(build().path)


def kernel(name: str, *argtypes):
    """Declare the C entry ``name`` of the library, whose arguments are
    ``argtypes`` and then (int device, void* stream), and return its
    launcher ``launch(device, *args)``: it calls the entry with ``args``,
    ``device.index`` and the device's current stream, raises
    ``RuntimeError`` on a non-zero return and adds one to
    ``LAUNCHES[name]`` after a successful one.  The library is built,
    loaded and the entry bound on the first call, not here."""
    ENTRIES[name] = argtypes
    scalars = [i for i, t in enumerate(argtypes) if t is not P]
    fn = None

    def launch(device, *args):
        nonlocal fn
        if fn is None:
            fn = getattr(load(), name)
            fn.argtypes = [*argtypes, I, P]
            fn.restype = ctypes.c_int
        err = fn(*args, device.index,
                 torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                               f"({', '.join(str(args[i]) for i in scalars)}"
                               f" on {device})")
        LAUNCHES[name] += 1

    launch.__name__ = launch.__qualname__ = name
    return launch


def check_device(**tensors) -> None:
    """Raise ValueError unless every tensor lies on one CUDA device."""
    first = next(iter(tensors.values())).device
    for name, x in tensors.items():
        if x.device.type != "cuda" or x.device != first:
            raise ValueError(f"{name} must lie on one CUDA device, got "
                             f"{x.device}")


def check_layout(ints=None, **tensors) -> None:
    """Raise ValueError unless every tensor is float32 (one named in the
    dict ``ints``: of the dtype given there), then unless every tensor is
    contiguous."""
    for name, x in tensors.items():
        want = (ints or {}).get(name, torch.float32)
        if x.dtype != want and want == torch.float32:
            raise ValueError(f"the CUDA kernels are float32 only; {name} is "
                             f"{x.dtype}")
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}, got {x.dtype}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_n(n: int, *spins: int) -> None:
    """Raise ValueError unless the kernels are instantiated for n x n
    matrices (MIN_N..MAX_N) and every spin lies in 0..n-1."""
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"the kernels are built for n in {MIN_N}..{MAX_N}, "
                         f"got n={n}")
    if not all(0 <= s < n for s in spins):
        raise ValueError(f"spins {spins} out of range for n={n}")
